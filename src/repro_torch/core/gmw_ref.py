"""Frozen pre-fusion GMW reference: the seed implementation (twin of the
reference's ``core/gmw_ref.py``).

This module keeps the original one-``swap``-per-call protocol as it
shipped before the round-fused engine of ``core/gmw.py``: each
Kogge-Stone level's opening is its own exchange, the cone-pruned path
scatters by index assignment on clones (the reference's ``.at[].set``),
and every local step is its own plain torch op.  It reaches exactly one
kernel, as the reference does: ``and_open`` calls ``ops.beaver_and`` in
its plain form (the opened (d, e) given), which launches
``hb_beaver_and`` on the card.  Bit extraction, packing and unpacking
stay plain torch here; nothing goes through ``pack_ring``, ``ks_step``
or ``cone_step``.

It exists for two reasons:
  1. regression oracle: the fused engine's outputs must be bit-identical
     to it for the exact (k=64, m=0) path and the reduced-ring configs
     (``tests/test_torch_seed_oracle.py``, ``chip_smoke.py``'s
     ``seed-oracle`` phase);
  2. baseline: its exchanges are the "before" count the fused engine's
     rounds are compared with (31 swaps against 10 rounds on
     ``BENCH_relu.json``'s ``multigroup`` case).

Do not optimise this file; it is intentionally the "before" snapshot.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import beaver, prng
from .schedule import cone_sets, n_levels


def and_open(x, y, triple: beaver.BinTriple, comm) -> torch.Tensor:
    """z = x & y on XOR-shared packed words. One swap (round) of (d, e)."""
    from ..kernels import ops as kops      # lazy, as the reference

    d = x ^ triple.a
    e = y ^ triple.b
    opened = comm.swap(torch.stack([d, e], dim=1))  # single exchange
    d_open = d ^ opened[:, 0]
    e_open = e ^ opened[:, 1]
    p0 = comm.party_is(0, x).reshape(-1)
    sel = torch.where(p0, -1, 0).to(torch.int32)
    return kops.beaver_and(d_open, e_open, triple.a, triple.b, triple.c, sel)


def _shift_planes(x: torch.Tensor, d: int) -> torch.Tensor:
    """Plane-axis shift: out[..., i, :] = x[..., i-d, :], zeros below."""
    if d == 0:
        return x
    pad = torch.zeros(x.shape[:-2] + (d,) + x.shape[-1:], dtype=x.dtype,
                      device=x.device)
    return torch.cat([pad, x[..., :-d, :]], dim=-2)


def adder_msb(xw: torch.Tensor, yw: torch.Tensor, triples: beaver.ReluTriples,
              comm, w: int, cone: bool = False) -> torch.Tensor:
    """XOR shares of the MSB of (x + y mod 2^w): seed implementation."""
    p0 = xw ^ yw                      # initial propagate (local)
    if w == 1:
        return p0[..., 0, :]
    L = n_levels(w)
    if not cone:
        g = and_open(xw, yw, triples.bin_init, comm)   # initial generate
        p = p0
        for lvl in range(L):
            d = 1 << lvl
            g_sh = _shift_planes(g, d)
            p_sh = _shift_planes(p, d)
            lhs = torch.cat([p, p], dim=-2)               # (P, 2w, W)
            rhs = torch.cat([g_sh, p_sh], dim=-2)
            tri = triples.bin_levels[lvl]
            out = and_open(lhs, rhs, tri, comm)           # one round
            g = g ^ out[..., :w, :]
            p = out[..., w:, :]
        return p0[..., w - 1, :] ^ g[..., w - 2, :]

    init_pos, level_sets = cone_sets(w)
    ip = torch.tensor(init_pos, device=xw.device)
    g_sub = and_open(xw[..., ip, :], yw[..., ip, :], triples.bin_init, comm)
    g = torch.zeros_like(xw)
    g[..., ip, :] = g_sub
    p = p0
    for lvl in range(L):
        d = 1 << lvl
        pos = level_sets[lvl]
        if not pos:
            continue
        ii = torch.tensor(pos, device=xw.device)
        im = torch.tensor([i - d for i in pos], device=xw.device)
        p_i = p[..., ii, :]
        lhs = torch.cat([p_i, p_i], dim=-2)
        rhs = torch.cat([g[..., im, :], p[..., im, :]], dim=-2)
        tri = triples.bin_levels[lvl]
        out = and_open(lhs, rhs, tri, comm)               # one round
        n = len(pos)
        g_new = g.clone()
        g_new[..., ii, :] = g[..., ii, :] ^ out[..., :n, :]
        p_new = p.clone()
        p_new[..., ii, :] = out[..., n:, :]
        g, p = g_new, p_new
    return p0[..., w - 1, :] ^ g[..., w - 2, :]


def a2b_prepare(key, v_packed: torch.Tensor, comm) -> Tuple[torch.Tensor, torch.Tensor]:
    """XOR shares of party 0's and party 1's packed values (one round)."""
    r = prng.bits(key, tuple(v_packed.shape)).to(torch.int32)
    masked = v_packed ^ r
    other_mask = comm.swap(r)
    p0 = comm.party_is(0, v_packed)
    x0_shares = torch.where(p0, masked, other_mask)
    x1_shares = torch.where(p0, other_mask, masked)
    return x0_shares, x1_shares


def beaver_mul(x: torch.Tensor, y: torch.Tensor, triple: beaver.ArithTriple,
               comm) -> torch.Tensor:
    e = x - triple.a
    f = y - triple.b
    ef = torch.stack([e, f], dim=1)
    other = comm.swap(ef)                            # single exchange
    e_open = e + other[:, 0]
    f_open = f + other[:, 1]
    z = triple.c + (e_open * triple.b + f_open * triple.a)
    p0 = comm.party_is(0, z)
    corr = e_open * f_open
    return torch.where(p0, z + corr, z)


def b2a_bit(bits: torch.Tensor, triple: beaver.ArithTriple, comm) -> torch.Tensor:
    b = bits.to(torch.int64)
    zeros = torch.zeros_like(b)
    p0 = comm.party_is(0, b)
    x = torch.where(p0, b, zeros)
    y = torch.where(p0, zeros, b)
    xy = beaver_mul(x, y, triple, comm)
    return b - (xy << 1)


def _extract_bits(x: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Bits m..k-1 as one value per element, k - m <= 32 (the arithmetic
    shift's sign fill lies above bit k - m - 1, which the mask drops)."""
    return (x >> m) & ((1 << (k - m)) - 1)


def _bitplanes(v: torch.Tensor, w: int) -> torch.Tensor:
    """(...) values -> (w, ...) {0, 1} planes, LSB first."""
    idx = torch.arange(w, dtype=v.dtype, device=v.device).reshape((w,) + (1,) * v.ndim)
    return (v[None] >> idx) & 1


def _extract_planes(x: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Bits m..k-1 as (k - m, ...) {0, 1} planes (w up to 64)."""
    return torch.stack([(x >> (m + i)) & 1 for i in range(k - m)], dim=0)


def _pack_bits(planes: torch.Tensor) -> torch.Tensor:
    """(..., w, E) {0, 1} -> (..., w, W) int32 packed words (E padded)."""
    e = planes.shape[-1]
    n_words = (e + 31) // 32
    planes = torch.nn.functional.pad(planes.to(torch.int64), (0, n_words * 32 - e))
    grouped = planes.reshape(planes.shape[:-1] + (n_words, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=planes.device)
    return (grouped << shifts).sum(dim=-1).to(torch.int32)


def _unpack_bits(words: torch.Tensor, n_elements: int) -> torch.Tensor:
    """(..., W) packed words -> (..., E) {0, 1} int32."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return flat[..., :n_elements]


def drelu(key, x: torch.Tensor, triples: beaver.ReluTriples, comm,
          k: int = 64, m: int = 0, cone: bool = False) -> torch.Tensor:
    w = k - m
    n = x.shape[-1]
    if w <= 32:
        v = _extract_bits(x, k, m)                  # (P, E), local
        planes = _bitplanes(v, w)                   # (w, P, E)
    else:
        planes = _extract_planes(x, k, m)           # (w, P, E)
    planes = torch.movedim(planes, 0, 1)            # (P, w, E)
    packed = _pack_bits(planes)                     # (P, w, W)
    x0s, x1s = a2b_prepare(key, packed, comm)       # 1 round
    sign_packed = adder_msb(x0s, x1s, triples, comm, w, cone=cone)
    sign_bits = _unpack_bits(sign_packed, n)        # (P, E)
    s = b2a_bit(sign_bits, triples.b2a, comm)       # shares of sign in {0,1}
    p0 = comm.party_is(0, s)
    return torch.where(p0, 1 - s, -s)


def relu(key, x: torch.Tensor, triples: beaver.ReluTriples, comm,
         k: int = 64, m: int = 0, cone: bool = False) -> torch.Tensor:
    d = drelu(key, x, triples, comm, k, m, cone=cone)
    return beaver_mul(x, d, triples.mult, comm)
