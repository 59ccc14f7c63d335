"""The port's device rule: ``device=None`` means the GPU.

Every public function that makes tensors takes ``device``; ``None`` means
``"cuda"``, and asking for CUDA on a machine without a card raises rather
than carrying on elsewhere.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve(device: Device = None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None; raises when
    CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for but no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
