"""Deterministic synthetic data pipelines (twin of the reference's
``data/pipeline.py``).

Every batch is a pure function of (seed, step), drawn with the port's
jax-identical threefry, so checkpoint/restart never replays or skips
data: ``TokenPipeline``'s tokens and labels equal the reference's
exactly; ``ImagePipeline``'s labels exactly, its images to within
``prng.normal``'s tolerance (torch's erfinv is not XLA's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..core import prng
from ..device import Device, resolve as resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Synthetic LM corpus: a fixed random stream in which every odd
    position repeats its predecessor plus one (mod vocab), so cross-entropy
    demonstrably falls during training."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, device: Device = None) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"}: (batch, seq_len) int64 on ``device``
        (default the GPU); labels are the next token, -1 at the last
        position."""
        device = resolve_device(device)
        key = prng.fold_in(prng.PRNGKey(self.seed, device), step)
        k1, _ = prng.split(key)
        base = prng.randint(k1, (self.batch, self.seq_len), 0, self.vocab)
        shifted = torch.roll(base, 1, dims=1)
        odd = (torch.arange(self.seq_len, device=device) % 2).bool()
        tokens = torch.where(odd, (shifted + 1) % self.vocab, base)
        labels = torch.cat([tokens[:, 1:], torch.full((self.batch, 1), -1,
                                                       dtype=tokens.dtype,
                                                       device=device)], dim=1)
        return {"tokens": tokens, "labels": labels}


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
