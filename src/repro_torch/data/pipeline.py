"""Deterministic synthetic images (twin of the reference's
``data/pipeline.py`` ``ImagePipeline``).

Every batch is a pure function of (seed, offset), drawn with the port's
jax-identical threefry: the labels equal the reference's exactly, the
images to within ``prng.normal``'s tolerance (torch's erfinv is not
XLA's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import prng
from ..device import Device, resolve as resolve_device


@dataclasses.dataclass(frozen=True)
class ImagePipeline:
    """Synthetic CIFAR-like images with linearly separable structure (a
    Gaussian prototype per class plus unit noise), deterministic by index."""

    n_classes: int = 10
    hw: int = 32
    seed: int = 0

    def take(self, n: int, offset: int = 0,
             device: Device = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images (n, 3, hw, hw) float32 and labels (n,) int64, on
        ``device`` (default the GPU)."""
        device = resolve_device(device)
        key = prng.fold_in(prng.PRNGKey(self.seed, device), offset)
        kx, _ = prng.split(key)
        ys = torch.arange(n, device=device) % self.n_classes
        protos = prng.normal(prng.PRNGKey(self.seed + 1, device),
                             (self.n_classes, 3, self.hw, self.hw)) * 1.5
        noise = prng.normal(kx, (n, 3, self.hw, self.hw))
        return protos[ys] + noise, ys
