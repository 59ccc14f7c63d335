"""Z/2^64 ring arithmetic on int64 tensors.

The reference (``repro.core.ring``) stores each ring element as two uint32
limbs because a TPU has no fast 64-bit integer path.  PyTorch has int64 on
both the CPU and the GPU, and its add, sub, mul and left shift wrap modulo
2^64, so here a ring tensor is ONE int64 tensor whose bit pattern is the
element.  Signed interpretation is applied only at fixed-point decode.

Shifts: ``>>`` on int64 is arithmetic, so logical right shifts mask the
vacated high bits.  The reduced-ring bits x[k:m] are taken straight from
the int64 shares and packed by ``kernels.ops.pack_ring``.

Add, sub, neg and mul are the tensor operators (``+ - * -x``), which wrap
modulo 2^64; this module holds what is not an operator.  Converters at the
boundary map to and from the reference's ``(lo, hi)`` uint32 limbs and
numpy uint64.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import Device, resolve as resolve_device
from . import prng

MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Construction and conversion
# ---------------------------------------------------------------------------

def from_int32(x) -> torch.Tensor:
    """Embed signed 32-bit values into Z/2^64 (two's-complement extend)."""
    return torch.as_tensor(x).to(torch.int32).to(torch.int64)


def from_uint64_np(x: np.ndarray, device: Device = None) -> torch.Tensor:
    """numpy uint64 -> int64 ring tensor on ``device`` (default the GPU)."""
    x = np.ascontiguousarray(np.asarray(x, np.uint64))
    return torch.from_numpy(x.view(np.int64).copy()).to(resolve_device(device))


def to_uint64_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def from_limbs(lo, hi, device: Device = None) -> torch.Tensor:
    """The reference's (lo, hi) uint32 limbs -> int64 ring tensor."""
    lo = np.asarray(lo, np.uint64)
    hi = np.asarray(hi, np.uint64)
    return from_uint64_np(lo | (hi << np.uint64(32)), device)


def to_limbs(x: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """int64 ring tensor -> the reference's (lo, hi) uint32 limbs."""
    u = to_uint64_np(x)
    return ((u & np.uint64(MASK32)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """Uniformly random ring elements: low then high word, one key each."""
    k1, k2 = prng.split(key)
    return prng.bits(k1, shape) | (prng.bits(k2, shape) << 32)


# ---------------------------------------------------------------------------
# Shifts (bit extraction for the A2B input is the ``pack_ring`` kernel)
# ---------------------------------------------------------------------------

def rshift_arith(a: torch.Tensor, n: int) -> torch.Tensor:
    """Arithmetic (sign-extending) right shift of the 64-bit value."""
    return a >> n if n else a
