"""The benchmark's own counter-based generator: weights and inputs from a
seed, made on the device in a few elementwise passes.

Value ``i`` of stream ``tag`` under ``seed`` is splitmix64 of a base
derived from (seed, tag) plus ``i`` times the golden-ratio increment, in
int64 torch ops that wrap as uint64 would.  The same seed gives the same
words on the CPU and on the card, so the CPU tests see the weights and
images a run on the card uses (the float transforms below may differ in
the last bit between devices).  Nothing here comes from the program.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
_CHUNK = 1 << 24                 # values per pass, bounds the temporaries


def _signed(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _mix_int(z: int) -> int:
    z = (z ^ (z >> 30)) * _MIX1 & _M64
    z = (z ^ (z >> 27)) * _MIX2 & _M64
    return z ^ (z >> 31)


def key(seed: int, *tags) -> int:
    """A 64-bit stream key from the run's seed and any ints or strings."""
    z = _mix_int((int(seed) & _M64) ^ 0x5EED)
    for t in tags:
        if isinstance(t, str):
            t = int.from_bytes(t.encode(), "little") % (1 << 61)
        z = _mix_int((z + _GOLDEN * (1 + (int(t) & _M64))) & _M64)
    return z


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def words(k: int, start: int, n: int, device) -> torch.Tensor:
    """Words ``start .. start + n`` of stream ``k`` as int64 (uint64 bits)."""
    z = torch.arange(start, start + n, dtype=torch.int64, device=device)
    z = z * _signed(_GOLDEN) + _signed(_mix_int(k))
    z = (z ^ _srl(z, 30)) * _signed(_MIX1)
    z = (z ^ _srl(z, 27)) * _signed(_MIX2)
    return z ^ _srl(z, 31)


def _unit(w: torch.Tensor) -> torch.Tensor:
    """The top 53 bits as a float64 in (0, 1)."""
    return (_srl(w, 11).to(torch.float64) + 0.5) * 2.0 ** -53


def normal(k: int, shape: Tuple[int, ...], device,
           dtype=torch.float32) -> torch.Tensor:
    """Standard normal values of stream ``k`` (Box-Muller over pairs of
    words), made in passes of at most 2^24 values."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for lo in range(0, n, _CHUNK):
        m = min(_CHUNK, n - lo)
        u = _unit(words(k, 2 * lo, 2 * m, device)).view(m, 2)
        z = torch.sqrt(-2.0 * torch.log(u[:, 0])) * torch.cos(2 * math.pi * u[:, 1])
        out[lo:lo + m] = z.to(dtype)
    return out.view(shape)


def uniform(k: int, shape: Tuple[int, ...], device, lo: float = 0.0,
            hi: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Uniform values on (lo, hi) of stream ``k``."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for a in range(0, n, _CHUNK):
        m = min(_CHUNK, n - a)
        out[a:a + m] = (lo + (hi - lo) * _unit(words(k, a, m, device))).to(dtype)
    return out.view(shape)
