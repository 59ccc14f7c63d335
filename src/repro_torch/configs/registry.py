"""Architecture registry: ``--arch <id>`` resolution (a copy of the
reference's, so ``get(name)`` resolves identically in both packages)."""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig, smoke_variant
from .falcon_mamba_7b import CONFIG as _falcon_mamba
from .gemma2_27b import CONFIG as _gemma2
from .qwen1_5_0_5b import CONFIG as _qwen
from .starcoder2_15b import CONFIG as _sc15
from .starcoder2_3b import CONFIG as _sc3
from .seamless_m4t_medium import CONFIG as _seamless
from .grok_1_314b import CONFIG as _grok
from .mixtral_8x22b import CONFIG as _mixtral
from .internvl2_76b import CONFIG as _internvl
from .zamba2_2_7b import CONFIG as _zamba

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in [
        _falcon_mamba, _gemma2, _qwen, _sc15, _sc3, _seamless, _grok,
        _mixtral, _internvl, _zamba,
    ]
}


def get(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return smoke_variant(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]


def all_names():
    return sorted(ARCHS)
