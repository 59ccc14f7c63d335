"""Plain PyTorch versions of the port's CUDA kernels.

The wrappers in ``kernels/ops.py`` run these for CPU tensors; the tests and
``chip_smoke.py`` hold each CUDA kernel against them on the card.  Packed
words are int32 bit patterns, ring values int64, ``sel`` one word per
party (all-ones on party 0).
"""
from __future__ import annotations

from typing import Optional

import math

import torch

# The most K one int32 shift accumulator of the ring_matmul kernel takes:
# one k adds at most 4 * 255 * 128 + 255 to a shift's sum, so K <= 16416.
FOLD_K = 16384
# The most K one work unit of the ring_matmul_ss kernel sums into its int32
# shift accumulators: one k adds at most 8 * 255^2 to a shift's
# (non-negative) sum, so 4096 of K stay below 2^31.  A longer K is split
# into units whose 64-bit partials add in the ring.
SPLIT_K_SS = 4096


def _per_party(sel: torch.Tensor, ndim: int) -> torch.Tensor:
    return sel.reshape((-1,) + (1,) * (ndim - 1))


def beaver_and(d_open, e_open, a, b, c, sel) -> torch.Tensor:
    """z = c ^ (d & b) ^ (e & a) ^ (sel & d & e) on (P, ..., W) words."""
    s = _per_party(sel, d_open.ndim)
    return c ^ (d_open & b) ^ (e_open & a) ^ (s & d_open & e_open)


def beaver_and_open(d, e, a, b, c, sel, d_other, e_other) -> torch.Tensor:
    """The opening form: open this party's sent (d, e) with the peer's
    halves, then ``beaver_and``."""
    return beaver_and(d ^ d_other, e ^ e_other, a, b, c, sel)


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


def ks_step(sent, d_other, e_other, a, b, c, sel, g, a_next, b_next,
            shift: int):
    """``ks_combine`` of one dense level (its sent (d, e) stacked in
    ``sent``, (P, 2, 2w, W)), then ``ks_mask`` of the next (a_next,
    b_next, plane ``shift``), stacked as the next send buffer; g is
    updated in place to g'.  Returns (g, send)."""
    g_new, p_new = ks_combine(sent[:, 0], d_other, sent[:, 1], e_other, a, b, c,
                              sel, g)
    d, e = ks_mask(g_new, p_new, a_next, b_next, shift)
    g.copy_(g_new)
    return g, torch.stack([d, e], dim=1)


def _rows(first: int, step: int, n: int) -> slice:
    return slice(first, first + step * (n - 1) + 1, step)


def ks_level(g, p, z, first: int, step: int):
    """Cone-adder level combine, in place: with n = z.shape[-2] // 2 and the
    level's planes first, first + step, ..., g[rows] ^= z[:n] and
    p[rows] = z[n:], the reference's ``(g ^ z_g, z_p)`` at those planes."""
    n = z.shape[-2] // 2
    rows = _rows(first, step, n)
    g[..., rows, :] ^= z[..., :n, :]
    p[..., rows, :] = z[..., n:, :]
    return g, p


def cone_step(sent, d_other, e_other, a, b, c, sel, g, p, level=None,
              nxt=None, a_next=None, b_next=None):
    """The cone adder's work between two exchanges: ``beaver_and`` of the
    round's opened (d, e); then g = z after the initial AND (``level``
    None), or ``ks_level`` at the level's rows (``level`` = (first,
    step)); g (P, w-1, W) and p (P, w, W) are updated in place.  Returns
    the next cone level's payload (``nxt`` = (first', step', shift')), the
    reference's lhs = [p[rows'], p[rows']] and rhs = [g[rows' - shift'],
    p[rows' - shift']] masked by a_next and b_next and stacked, or, with
    ``nxt`` None, the sign plane p[w-1] ^ g[w-2]."""
    z = beaver_and_open(sent[:, 0], sent[:, 1], a, b, c, sel, d_other, e_other)
    if level is None:
        g.copy_(z)
    else:
        ks_level(g, p, z, *level)
    if nxt is None:
        return p[:, -1] ^ g[:, -1]
    first, step, shift = nxt
    n = a_next.shape[-2] // 2
    rows, src = _rows(first, step, n), _rows(first - shift, step, n)
    lhs = torch.cat([p[:, rows], p[:, rows]], dim=-2)
    rhs = torch.cat([g[:, src], p[:, src]], dim=-2)
    return torch.stack([lhs ^ a_next, rhs ^ b_next], dim=1)


# ``pack`` spreads each value over w int64 bit lanes; a (..., w, W, 32)
# tensor of more elements than this is made a block of words at a time
# (the long LM path's w = 64 planes of 47.6 M values would take 45 GB)
PACK_CHUNK = 1 << 26


def pack(v: torch.Tensor, w: int, shift: int = 0) -> torch.Tensor:
    """(..., E) values -> (..., w, W) int32 words, W = ceil(E/32): bit t of
    word (i, j) is bit ``shift + i`` of value 32j + t (tail bits zero).
    ``shift + w`` is at most 32 for int32 values and 64 for int64 ones."""
    e = v.shape[-1]
    n_words = (e + 31) // 32
    v = torch.nn.functional.pad(v.to(torch.int64), (0, n_words * 32 - e))
    grouped = v.reshape(v.shape[:-1] + (1, n_words, 32))
    planes = torch.arange(shift, shift + w, dtype=torch.int64,
                          device=v.device).reshape(w, 1, 1)
    lanes = torch.arange(32, dtype=torch.int64, device=v.device)
    step = max(1, PACK_CHUNK // max(1, 32 * w * math.prod(v.shape[:-1])))
    if step >= n_words:
        bits = (grouped >> planes) & 1                      # (..., w, W, 32)
        return (bits << lanes).sum(dim=-1).to(torch.int32)
    out = torch.empty(v.shape[:-1] + (w, n_words), dtype=torch.int32, device=v.device)
    for j in range(0, n_words, step):
        bits = (grouped[..., j:j + step, :] >> planes) & 1
        out[..., j:j + step] = (bits << lanes).sum(dim=-1)
    return out


def pack_ring(x: torch.Tensor, k: int, m: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 ring values (..., E) -> (..., k - m, W) words of bits m..k-1,
    XORed with ``mask`` (words of the same shape) where it is given."""
    words = pack(x, k - m, shift=m)
    return words if mask is None else words ^ mask


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., w, W) words -> (..., n) int32 values: value e is the sum over
    planes i of bit e of plane i, shifted to bit i (w <= 32)."""
    w = words.shape[-2]
    lanes = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> lanes) & 1  # (..., w, W, 32)
    bits = bits.reshape(words.shape[:-1] + (-1,))[..., :n]
    planes = torch.arange(w, dtype=torch.int64, device=words.device)
    return (bits << planes[:, None]).sum(dim=-2).to(torch.int32)


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


def ring_matmul_digits(x: torch.Tensor, w: torch.Tensor,
                       fold: int = FOLD_K) -> torch.Tensor:
    """The ring_matmul kernel's own arithmetic (``csrc/ring_matmul.cu``):
    x's 8 raw bytes u_i as unsigned digits, w's 5 balanced digits e_j
    (e_0..e_3 the bytes of w + 0x80808080 minus 128, e_4 its carry into bit
    32), one int32 sum per shift s = i + j < 8 over at most ``fold`` of K,
    recombined as sum_s acc_s << 8s mod 2^64.  Raises ``OverflowError``
    where a shift's sum leaves the int32 range, as the kernel's
    accumulators would."""
    m, k = x.shape
    n = w.shape[1]
    u = [(x >> (8 * i)) & 0xFF for i in range(8)]
    v = w.to(torch.int64) + 0x80808080
    e = [((v >> (8 * j)) & 0xFF) - 128 for j in range(4)] + [v >> 32]
    out = torch.zeros((m, n), dtype=torch.int64, device=x.device)
    for k0 in range(0, k, fold):
        ks = slice(k0, k0 + fold)
        for s in range(8):
            acc = sum(u[i][:, ks] @ e[s - i][ks] for i in range(max(0, s - 4), s + 1))
            if acc.numel() and (int(acc.min()) < -2 ** 31 or int(acc.max()) >= 2 ** 31):
                raise OverflowError(f"ring_matmul_digits: shift {s}'s sum over "
                                    f"{min(fold, k - k0)} of K leaves int32")
            out += acc << (8 * s)
    return out


def ring_matmul_ss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int64 [B, M, K] @ int64 [B, K, N] mod 2^64 -> int64 [B, M, N].

    Broadcast multiply and sum over K in chunks, as ``ring_matmul`` (int64
    products and sums wrap mod 2^64); works on any device."""
    b, m, k = x.shape
    n = y.shape[2]
    out = torch.zeros((b, m, n), dtype=torch.int64, device=x.device)
    chunk = max(1, (1 << 24) // max(1, b * m * n))
    for k0 in range(0, k, chunk):
        part = x[:, :, k0:k0 + chunk, None] * y[:, None, k0:k0 + chunk, :]
        out += part.sum(dim=2)
    return out


def ring_matmul_ss_digits(x: torch.Tensor, y: torch.Tensor,
                          chunk: int = SPLIT_K_SS) -> torch.Tensor:
    """The ring_matmul_ss kernel's own arithmetic (``csrc/ring_matmul_ss.cu``):
    both operands' 8 raw bytes as unsigned digits, and K split into chunks
    of at most ``chunk``, as the kernel's split-K work units; in each chunk
    one int32 sum per shift s = i + j < 8 (36 byte-plane products), whose
    64-bit partial sum_s acc_s << 8s adds into the output mod 2^64.  Raises
    ``OverflowError`` where a shift's sum over a chunk leaves the int32
    range, as the kernel's accumulators would."""
    k = x.shape[2]
    u = [(x >> (8 * i)) & 0xFF for i in range(8)]
    v = [(y >> (8 * j)) & 0xFF for j in range(8)]
    out = torch.zeros(x.shape[:2] + y.shape[2:], dtype=torch.int64, device=x.device)
    for k0 in range(0, k, chunk):
        ks = slice(k0, k0 + chunk)
        partial = torch.zeros_like(out)
        for s in range(8):
            acc = sum(u[i][:, :, ks] @ v[s - i][:, ks] for i in range(s + 1))
            if acc.numel() and int(acc.max()) >= 2 ** 31:
                raise OverflowError(f"ring_matmul_ss_digits: shift {s}'s sum over "
                                    f"{min(chunk, k - k0)} of K leaves int32")
            partial += acc << (8 * s)
        out += partial
    return out
