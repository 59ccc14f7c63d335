"""Plain PyTorch versions of the port's four CUDA kernels.

The wrappers in ``kernels/ops.py`` run these for CPU tensors; the tests and
``chip_smoke.py`` hold each CUDA kernel against them on the card.  Packed
words are int32 bit patterns, ring values int64, ``sel`` one word per
party (all-ones on party 0).
"""
from __future__ import annotations

import torch


def _per_party(sel: torch.Tensor, ndim: int) -> torch.Tensor:
    return sel.reshape((-1,) + (1,) * (ndim - 1))


def beaver_and(d_open, e_open, a, b, c, sel) -> torch.Tensor:
    """z = c ^ (d & b) ^ (e & a) ^ (sel & d & e) on (P, ..., W) words."""
    s = _per_party(sel, d_open.ndim)
    return c ^ (d_open & b) ^ (e_open & a) ^ (s & d_open & e_open)


def _shift_planes(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Plane i of the result is plane i - shift of x; zeros below."""
    if shift == 0:
        return x
    pad = torch.zeros(x.shape[:-2] + (shift,) + x.shape[-1:], dtype=x.dtype,
                      device=x.device)
    return torch.cat([pad, x[..., :-shift, :]], dim=-2)


def ks_mask(g, p, a, b, shift: int):
    """Pre-exchange half of a Kogge-Stone level:
    d = [p, p] ^ a ;  e = [g >> shift, p >> shift] ^ b  (plane shifts)."""
    lhs = torch.cat([p, p], dim=-2)
    rhs = torch.cat([_shift_planes(g, shift), _shift_planes(p, shift)], dim=-2)
    return lhs ^ a, rhs ^ b


def ks_combine(d, d_other, e, e_other, a, b, c, sel, g):
    """Post-exchange half: open (d, e), Beaver-AND, g' = g ^ z[:w],
    p' = z[w:]."""
    z = beaver_and(d ^ d_other, e ^ e_other, a, b, c, sel)
    w = g.shape[-2]
    return g ^ z[..., :w, :], z[..., w:, :]


def ring_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int64 [M, K] @ int32 [K, N] mod 2^64 -> int64 [M, N].

    Broadcast multiply and sum over K in chunks (int64 products and sums
    wrap mod 2^64); works on any device, since PyTorch has no int64 matmul
    on CUDA."""
    m, k = x.shape
    n = w.shape[1]
    w64 = w.to(torch.int64)
    out = torch.zeros((m, n), dtype=torch.int64, device=x.device)
    chunk = max(1, (1 << 24) // max(1, m * n))
    for k0 in range(0, k, chunk):
        part = x[:, k0:k0 + chunk, None] * w64[None, k0:k0 + chunk, :]
        out += part.sum(dim=1)
    return out
