"""Fixed-point codec between floats and Z/2^64 ring elements.

Same CrypTen scale as the reference: x = round(x_f * 2^16).  ``decode``
repeats the reference's float32 steps (magnitude split into two 32-bit
words, each converted, then hi * 2^32 + lo), so it is bit-identical to it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import Device
from . import ring

DEFAULT_FRAC_BITS = 16


def encode(x_f: torch.Tensor, frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """float -> ring. Requires |x_f * 2^frac| < 2^31."""
    xi = torch.round(x_f.to(torch.float32) * (2.0 ** frac_bits)).to(torch.int32)
    return ring.from_int32(xi)


def decode(x: torch.Tensor, frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """ring -> float32 (approximate above 2^24 magnitudes)."""
    neg = x < 0
    mag = torch.where(neg, -x, x)
    hi = ((mag >> 32) & ring.MASK32).to(torch.float32)
    lo = (mag & ring.MASK32).to(torch.float32)
    val = hi * (2.0 ** 32) + lo
    val = torch.where(neg, -val, val)
    return val / (2.0 ** frac_bits)


def decode_np(x: torch.Tensor, frac_bits: int = DEFAULT_FRAC_BITS) -> np.ndarray:
    """Exact host-side decode via numpy int64 (test oracle)."""
    s = ring.to_uint64_np(x).view(np.int64)
    return s.astype(np.float64) / (2.0 ** frac_bits)


def encode_np(x_f: np.ndarray, frac_bits: int = DEFAULT_FRAC_BITS,
              device: Device = None) -> torch.Tensor:
    """Exact host-side encode via numpy (test oracle)."""
    xi = np.round(np.asarray(x_f, np.float64) * 2.0 ** frac_bits).astype(np.int64)
    return ring.from_uint64_np(xi.view(np.uint64), device)
