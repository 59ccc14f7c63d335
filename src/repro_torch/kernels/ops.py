"""Public wrappers of the port's CUDA kernels.

Dispatch: a wrapper given CPU tensors runs the kernel's plain PyTorch
version (``kernels/ref.py``); given CUDA tensors it checks them, launches
the hand-written kernel (``csrc/*.cu``, built by ``kernels/build.py``) on
PyTorch's current stream, and raises if the tensors or the launch are not
what the kernel takes.  There is no other path.

Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, so a run can show that the main path went through
the kernels (``reset_launches`` / ``launch_counts``).

Each kernel, the reference Pallas kernel it replaces, and its bound on
the card (design notes in the CUDA sources):

- ``beaver_and``: ``kernels/gmw_round.py:45`` ``beaver_and_pallas``;
  bytes, 24 per word (5 inputs, 1 output); 32 in the opening form, which
  reads the sent (d, e) and the peer's halves and opens them itself.
- ``ks_mask``: ``kernels/gmw_round.py:73`` ``ks_mask_pallas``; bytes, 40
  per (party, plane of w, word), written as the level's send buffer.  The
  dense adder runs it for its first level only.
- ``ks_combine``: ``kernels/gmw_round.py:105`` ``ks_combine_pallas``;
  bytes, 68 per (party, plane of w, word), 36 when only g' is asked for
  (the dense adder's last level).
- ``ks_step``: ``ks_combine_pallas`` of one dense level fused with
  ``ks_mask_pallas`` of the next; bytes, 96 per (party, plane of w, word),
  where the two passes and the stack between them moved 140.
- ``ks_level``: ``kernels/gmw_round.py:134`` ``ks_level_pallas``; bytes,
  20 per (party, level plane, word), in place on the adder's planes.
- ``cone_step``: ``beaver_and_pallas`` of one cone round fused with
  ``ks_level_pallas`` and the next cone level's masking (the reference's
  lhs/rhs stack, ``core/gmw.py:190-192``); bytes, every word the round
  must read or write once (``chip_smoke.cone_step_bytes``).
- ``ring_matmul``: ``kernels/ring_matmul.py:88`` ``ring_matmul_pallas``;
  max(bytes, 8 per x and output value and 4 per weight, over 3.35 TB/s;
  26 int8 digit-plane products, the fewest a byte-digit scheme needs,
  over the 1979 TOP/s int8 tensor cores; the kernel issues 30).
- ``ring_matmul_ss``: no Pallas kernel; the reference's jnp einsum of
  ``core/ring_linalg.py:72`` ``matmul_ring`` (secret x secret, mod 2^64);
  max(bytes, 8 per x, y and output value, over 3.35 TB/s; 36 u8 byte-plane
  products over the 1979 TOP/s int8 tensor cores).  Two forms: 64 x 64
  block tiles from M = 64 on, 16 x 8 warp tiles below (``ss_form``);
  ``ring_matmul_ss.large`` counts the large form's launches.
- ``pack`` and ``pack_ring``: ``kernels/bitpack.py:44`` ``pack_pallas``;
  bytes, each value read once (4 or 8 bytes) and 4 per word written;
  ``pack_ring``'s masked form (the A2B round's ``packed ^ mask``) also
  reads 4 per mask word.
- ``unpack``: ``kernels/bitpack.py:60`` ``unpack_pallas``; bytes, 4 per
  word read and 4 per value written.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Optional, Sequence

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "hb_beaver_and": ("gmw_round.cu", [_P, _I] * 4 + [_P] * 5 + [_I, _I, _P]),
    "hb_ks_mask": ("gmw_round.cu", [_P] * 5 + [_I] * 4 + [_P]),
    "hb_ks_combine": ("gmw_round.cu",
                      [_P, _I] * 4 + [_P] * 7 + [_I] * 3 + [_P]),
    "hb_ks_step": ("gmw_round.cu",
                   [_P, _P, _I, _P, _I] + [_P] * 8 + [_I] * 4 + [_P]),
    "hb_ks_level": ("gmw_round.cu", [_P, _P, _P] + [_I] * 7 + [_P]),
    "hb_cone_step": ("gmw_round.cu",
                     [_P, _P, _I, _P, _I] + [_P] * 9 + [_I] * 10 + [_P]),
    "hb_ring_matmul": ("ring_matmul.cu", [_P] * 3 + [_I] * 3 + [_P]),
    "hb_ring_matmul_ss": ("ring_matmul_ss.cu", [_P] * 3 + [_I] * 5 + [_P]),
    "hb_pack": ("bitpack.cu", [_P, _I, _I, _P, _I, _P]),
    "hb_pack_ring": ("bitpack.cu", [_P, _I, _I, _P, _I, _I, _P, _P]),
    "hb_unpack": ("bitpack.cu", [_P, _I, _I, _I, _I, _P, _P]),
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    source, argtypes = _SIGNATURES[name]
    fn = getattr(build.library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _check(name: str, tensors: Sequence[torch.Tensor], dtype: torch.dtype,
           contiguous: bool = True) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, the kernel runs on CUDA")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _party_rows(name: str, t: torch.Tensor) -> int:
    """Party stride of a tensor whose rows after the party dim are
    contiguous (a view into the received round buffer)."""
    expected, step = [], 1
    for size in reversed(t.shape[1:]):
        expected.insert(0, step)
        step *= size
    if list(t.stride()[1:]) != expected:
        raise ValueError(f"{name}: rows after the party dim must be contiguous")
    return t.stride(0)


_COUNT_LOCK = threading.Lock()


def _count(kernel, attr: str = "launches") -> None:
    """One launch of ``kernel`` counted (under a lock: the two parties of a
    deployment may run as threads of one process)."""
    with _COUNT_LOCK:
        setattr(kernel, attr, getattr(kernel, attr) + 1)


def _launch(name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _fn(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def beaver_and(d, e, a, b, c, sel, d_other=None, e_other=None):
    """Local Beaver-AND z = c ^ (d&b) ^ (e&a) ^ (sel&d&e) on (P, ..., W)
    int32 words of any leading shape; ``sel`` is one word per party.
    Plain form: d and e are the opened values, contiguous.  Opening form
    (``d_other`` and ``e_other`` given): d and e are this party's sent
    halves and d_other, e_other the peer's, all four views with any party
    stride; the kernel opens d ^ d_other and e ^ e_other itself."""
    opening = d_other is not None
    if (e_other is not None) != opening:
        raise ValueError("beaver_and: give both of d_other and e_other, or neither")
    if _on_cpu(d):
        if opening:
            return ref.beaver_and_open(d, e, a, b, c, sel, d_other, e_other)
        return ref.beaver_and(d, e, a, b, c, sel)
    name = "beaver_and"
    halves = [d, e] + ([d_other, e_other] if opening else [])
    _check(name, [a, b, c, sel], torch.int32)
    _check(name, halves, torch.int32, contiguous=not opening)
    n_parties = a.shape[0]
    for t in halves + [b, c]:
        if t.shape != a.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(a.shape)}")
    if sel.shape != (n_parties,):
        raise ValueError(f"{name}: sel must be ({n_parties},), got "
                         f"{tuple(sel.shape)}")
    out = torch.empty_like(a)
    per_party = a.numel() // n_parties if n_parties else 0
    if per_party:
        rows = [(t.data_ptr(), _party_rows(name, t)) for t in halves]
        peer = rows[2:] if opening else [(None, 0), (None, 0)]
        _launch("hb_beaver_and", *rows[0], *rows[1], *peer[0], *peer[1],
                a.data_ptr(), b.data_ptr(), c.data_ptr(), sel.data_ptr(),
                out.data_ptr(), n_parties, per_party)
        _count(beaver_and)
    return out


def ks_mask(g, p, a, b, shift: int):
    """Pre-exchange Kogge-Stone level: d = [p, p] ^ a and
    e = [g >> shift, p >> shift] ^ b (plane shifts with zero fill).
    g, p: (P, w, W); a, b: (P, 2w, W) int32 words.  Returns the level's
    send buffer, (P, 2, 2w, W): d then e per party, the payload of its
    exchange (the plain version's (d, e), stacked)."""
    if _on_cpu(g):
        return torch.stack(ref.ks_mask(g, p, a, b, shift), dim=1)
    _check("ks_mask", [g, p, a, b], torch.int32)
    n_parties, w, words = g.shape
    if p.shape != g.shape or a.shape != (n_parties, 2 * w, words) \
            or b.shape != a.shape:
        raise ValueError("ks_mask: expected g, p (P, w, W) and a, b (P, 2w, W)")
    send = torch.empty((n_parties, 2, 2 * w, words), dtype=torch.int32,
                       device=g.device)
    if g.numel():
        _launch("hb_ks_mask", g.data_ptr(), p.data_ptr(), a.data_ptr(),
                b.data_ptr(), send.data_ptr(), n_parties, w, words, int(shift))
        _count(ks_mask)
    return send


def _level_check(name: str, g, halves, triples, sel) -> None:
    """Shapes of a dense level's operands: g (P, w, W); every half and
    triple member (P, 2w, W); sel (P,)."""
    n_parties, w, words = g.shape
    full = (n_parties, 2 * w, words)
    for t in (*halves, *triples):
        if tuple(t.shape) != full:
            raise ValueError(f"{name}: expected {full}, got {tuple(t.shape)}")
    if sel.shape != (n_parties,):
        raise ValueError(f"{name}: sel must be ({n_parties},)")


def ks_combine(d, d_other, e, e_other, a, b, c, sel, g, need_p: bool = True):
    """Post-exchange Kogge-Stone level: open (d, e) with the peer's halves,
    Beaver-AND, then g' = g ^ z[:w] and p' = z[w:].  d, e, d_other and
    e_other may be views with any party stride (halves of the send buffer,
    of the received round buffer).  Returns (g', p'); with ``need_p``
    False, (g', None), and the kernel reads only the first w rows."""
    if _on_cpu(g):
        g_out, p_out = ref.ks_combine(d, d_other, e, e_other, a, b, c, sel, g)
        return g_out, p_out if need_p else None
    name = "ks_combine"
    _check(name, [a, b, c, sel, g], torch.int32)
    _check(name, [d, d_other, e, e_other], torch.int32, contiguous=False)
    _level_check(name, g, (d, d_other, e, e_other), (a, b, c), sel)
    n_parties, w, words = g.shape
    g_out = torch.empty_like(g)
    p_out = torch.empty_like(g) if need_p else None
    if g.numel():
        _launch("hb_ks_combine", d.data_ptr(), _party_rows(name, d),
                d_other.data_ptr(), _party_rows(name, d_other), e.data_ptr(),
                _party_rows(name, e), e_other.data_ptr(),
                _party_rows(name, e_other), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), sel.data_ptr(), g.data_ptr(), g_out.data_ptr(),
                None if p_out is None else p_out.data_ptr(), n_parties, w, words)
        _count(ks_combine)
    return g_out, p_out


def ks_step(sent, d_other, e_other, a, b, c, sel, g, a_next, b_next,
            shift: int):
    """A dense Kogge-Stone level's combine fused with the next level's
    mask: ``ks_combine`` of this level's sent (d, e) (``sent``, the
    (P, 2, 2w, W) payload the adder yielded), the peer's halves (views of
    the received round buffer, any party stride) and its triple (a, b,
    c), then ``ks_mask`` of the next level (triple a_next, b_next; plane
    ``shift``) on (g', p').  g (P, w, W) is updated in place to g'; p'
    is not kept.  Returns (g, send): send is a new (P, 2, 2w, W) buffer
    holding the next level's (d', e'), the payload of its exchange."""
    if _on_cpu(g):
        return ref.ks_step(sent, d_other, e_other, a, b, c, sel, g, a_next,
                           b_next, shift)
    name = "ks_step"
    _check(name, [sent, a, b, c, sel, g, a_next, b_next], torch.int32)
    _check(name, [d_other, e_other], torch.int32, contiguous=False)
    n_parties, w, words = g.shape
    if sent.shape != (n_parties, 2, 2 * w, words):
        raise ValueError(f"{name}: sent must be ({n_parties}, 2, {2 * w}, "
                         f"{words}), got {tuple(sent.shape)}")
    _level_check(name, g, (d_other, e_other), (a, b, c, a_next, b_next), sel)
    if not 1 <= w <= 64 or shift < 1:
        raise ValueError(f"{name}: w = {w} outside 1..64 or shift {shift} < 1")
    send = torch.empty_like(sent)
    if g.numel():
        _launch("hb_ks_step", sent.data_ptr(), d_other.data_ptr(),
                _party_rows(name, d_other), e_other.data_ptr(),
                _party_rows(name, e_other), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), sel.data_ptr(), g.data_ptr(), a_next.data_ptr(),
                b_next.data_ptr(), send.data_ptr(), n_parties, w, words,
                int(shift))
        _count(ks_step)
    return g, send


def ks_level(g, p, z, first: int, step: int):
    """Cone-adder level combine, in place on (P, planes, W) int32 words g
    and p: with n = z.shape[1] // 2 and the level's planes first,
    first + step, ..., g[:, rows] ^= z[:, :n] and p[:, rows] = z[:, n:].
    z is the level's (P, 2n, W) AND output; its rows after the party dim
    must be contiguous (any party stride).  Returns (g, p)."""
    if _on_cpu(g):
        return ref.ks_level(g, p, z, first, step)
    name = "ks_level"
    _check(name, [g, p], torch.int32)
    _check(name, [z], torch.int32, contiguous=False)
    if g.ndim != 3 or p.shape != g.shape or z.ndim != 3:
        raise ValueError(f"{name}: expected g, p of one (P, planes, W) shape "
                         f"and z (P, 2n, W), got {tuple(g.shape)}, "
                         f"{tuple(p.shape)}, {tuple(z.shape)}")
    n_parties, planes, n_words = g.shape
    n = z.shape[1] // 2
    if tuple(z.shape) != (n_parties, 2 * n, n_words):
        raise ValueError(f"{name}: z must be ({n_parties}, 2n, {n_words}), got "
                         f"{tuple(z.shape)}")
    if n and (first < 0 or step < 1 or first + step * (n - 1) >= planes):
        raise ValueError(f"{name}: rows {first}:{step}:x{n} outside {planes} planes")
    if n and n_words:
        _launch("hb_ks_level", g.data_ptr(), p.data_ptr(), z.data_ptr(),
                _party_rows(name, z), n_parties, planes, int(first), int(step),
                n, n_words)
        _count(ks_level)
    return g, p


def cone_step(sent, d_other, e_other, a, b, c, sel, g, p, level=None,
              nxt=None, a_next=None, b_next=None):
    """The MSB-cone adder's work between two exchanges, in one launch.

    Opens the round's sent (d, e) (``sent``, the (P, 2, R, W) payload the
    adder yielded) with the peer's halves (views of the received round
    buffer, any party stride), Beaver-ANDs with the round's triple (a, b,
    c: (P, R, W)), and updates g (P, w-1, W) and p (P, w, W) in place:
    with ``level`` None (the initial AND, R = w - 1) g = z; with ``level``
    = (first, step) (a cone level of n = R // 2 rows first + i step)
    g[rows] ^= z[:n] and p[rows] = z[n:].  With ``nxt`` = (first', step',
    shift') of the next non-empty cone level and its triple's a_next,
    b_next (P, 2n', W), returns its payload (P, 2, 2n', W):
    d' = [p[rows'], p[rows']] ^ a_next, e' = [g[rows' - shift'],
    p[rows' - shift']] ^ b_next.  With ``nxt`` None (the last round),
    returns the sign plane p[w-1] ^ g[w-2], (P, W)."""
    if _on_cpu(g):
        return ref.cone_step(sent, d_other, e_other, a, b, c, sel, g, p, level,
                             nxt, a_next, b_next)
    name = "cone_step"
    _check(name, [sent, a, b, c, sel, g, p], torch.int32)
    _check(name, [d_other, e_other], torch.int32, contiguous=False)
    if g.ndim != 3 or p.ndim != 3 or sent.ndim != 4:
        raise ValueError(f"{name}: expected g (P, w-1, W), p (P, w, W) and sent "
                         f"(P, 2, R, W)")
    n_parties, planes, n_words = g.shape
    w = planes + 1
    rows = sent.shape[2]
    if p.shape != (n_parties, w, n_words) or not 2 <= w <= 64:
        raise ValueError(f"{name}: g {tuple(g.shape)} and p {tuple(p.shape)} are "
                         f"not (P, w-1, W) and (P, w, W) with 2 <= w <= 64")
    if sent.shape != (n_parties, 2, rows, n_words):
        raise ValueError(f"{name}: sent must be ({n_parties}, 2, R, {n_words}), "
                         f"got {tuple(sent.shape)}")
    for t in (d_other, e_other, a, b, c):
        if tuple(t.shape) != (n_parties, rows, n_words):
            raise ValueError(f"{name}: expected {(n_parties, rows, n_words)}, got "
                             f"{tuple(t.shape)}")
    if sel.shape != (n_parties,):
        raise ValueError(f"{name}: sel must be ({n_parties},)")
    if level is None:
        first, step = -1, 0
        if rows != planes:
            raise ValueError(f"{name}: the initial AND covers {planes} planes, "
                             f"sent has {rows}")
    else:
        first, step = level
        n = rows // 2
        if rows % 2 or not n or first < 0 or step < 1 or step & (step - 1) \
                or first + step * (n - 1) >= planes:
            raise ValueError(f"{name}: level rows {first}:{step}:x{rows // 2} "
                             f"outside {planes} planes or step not a power of 2")
    if nxt is None:
        n_next, first_next, step_next, shift_next = 0, 0, 0, 0
        out = torch.empty((n_parties, n_words), dtype=torch.int32, device=g.device)
    else:
        first_next, step_next, shift_next = nxt
        _check(name, [a_next, b_next], torch.int32)
        n_next = a_next.shape[1] // 2 if a_next.ndim == 3 else 0
        for t in (a_next, b_next):
            if tuple(t.shape) != (n_parties, 2 * n_next, n_words) or not n_next:
                raise ValueError(f"{name}: a_next, b_next must be ({n_parties}, "
                                 f"2n', {n_words}), got {tuple(t.shape)}")
        if step_next < 1 or first_next - shift_next < 0 \
                or first_next + step_next * (n_next - 1) >= planes:
            raise ValueError(f"{name}: next rows {first_next}:{step_next}:"
                             f"x{n_next} - {shift_next} outside {planes} planes")
        out = torch.empty((n_parties, 2, 2 * n_next, n_words), dtype=torch.int32,
                          device=g.device)
    if n_words:
        _launch("hb_cone_step", sent.data_ptr(), d_other.data_ptr(),
                _party_rows(name, d_other), e_other.data_ptr(),
                _party_rows(name, e_other), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), sel.data_ptr(), g.data_ptr(), p.data_ptr(),
                a_next.data_ptr() if nxt is not None else None,
                b_next.data_ptr() if nxt is not None else None, out.data_ptr(),
                n_parties, w, n_words, rows, first, step, n_next, first_next,
                step_next, shift_next)
        _count(cone_step)
    return out


def _packed_shape(name: str, v: torch.Tensor, w: int):
    if v.ndim < 1:
        raise ValueError(f"{name}: expected (..., E) values")
    lead, n = tuple(v.shape[:-1]), v.shape[-1]
    return lead, n, lead + (w, (n + 31) // 32)


def pack(v: torch.Tensor, w: int) -> torch.Tensor:
    """(..., E) int32 values -> (..., w, ceil(E/32)) int32 words: bit t of
    word (i, j) is bit i of value 32j + t; tail bits zero; 1 <= w <= 32."""
    if _on_cpu(v):
        return ref.pack(v, w)
    _check("pack", [v], torch.int32)
    if not 1 <= w <= 32:
        raise ValueError(f"pack: w = {w} outside 1..32")
    lead, n, shape = _packed_shape("pack", v, w)
    out = torch.empty(shape, dtype=torch.int32, device=v.device)
    if out.numel():
        _launch("hb_pack", v.data_ptr(), math.prod(lead), n, out.data_ptr(), w)
        _count(pack)
    return out


def pack_ring(x: torch.Tensor, k: int, m: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., E) int64 ring values -> (..., k - m, ceil(E/32)) int32 words
    of bits m..k-1 (0 <= m < k <= 64): the reduced-ring A2B input, packed
    straight from the shares.  With ``mask`` (int32 words of the output's
    shape, contiguous) the words come out XORed with it, in the same
    launch: the A2B round's masked planes.  ``pack_ring.masked`` counts
    the launches of that form (they count in ``launches`` too)."""
    if not 0 <= m < k <= 64:
        raise ValueError(f"pack_ring: (k, m) = ({k}, {m}) outside 0 <= m < k <= 64")
    lead, n, shape = _packed_shape("pack_ring", x, k - m)
    if mask is not None:
        if tuple(mask.shape) != shape or mask.dtype != torch.int32 \
                or not mask.is_contiguous():
            raise ValueError(f"pack_ring: mask must be contiguous int32 {shape}, "
                             f"got {mask.dtype} {tuple(mask.shape)}")
    if _on_cpu(x):
        return ref.pack_ring(x, k, m, mask)
    _check("pack_ring", [x], torch.int64)
    if mask is not None:
        _check("pack_ring", [mask], torch.int32)
        if mask.device != x.device:
            raise ValueError(f"pack_ring: mask on {mask.device}, x on {x.device}")
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    if out.numel():
        _launch("hb_pack_ring", x.data_ptr(), math.prod(lead), n,
                out.data_ptr(), k, m, None if mask is None else mask.data_ptr())
        _count(pack_ring)
        if mask is not None:
            _count(pack_ring, "masked")
    return out


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., w, W) int32 words -> (..., n) int32 values, n <= 32 W: value e
    holds bit e of plane i at bit i (w <= 32)."""
    if _on_cpu(words):
        return ref.unpack(words, n)
    _check("unpack", [words], torch.int32)
    if words.ndim < 2 or not 1 <= words.shape[-2] <= 32 \
            or not 0 <= n <= 32 * words.shape[-1]:
        raise ValueError(f"unpack: {tuple(words.shape)} words cannot hold "
                         f"{n} values of at most 32 planes")
    lead = tuple(words.shape[:-2])
    w, n_words = words.shape[-2:]
    out = torch.empty(lead + (n,), dtype=torch.int32, device=words.device)
    if out.numel():
        _launch("hb_unpack", words.data_ptr(), math.prod(lead), w, n_words, n,
                out.data_ptr())
        _count(unpack)
    return out


def ring_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int64 ring [M, K] @ public int32 [K, N] mod 2^64 -> int64 [M, N].

    One kernel launch per call on the card; where the launch splits K over
    blocks it also zeroes the output first (a memset on the same stream),
    and the blocks add their partials into it."""
    if _on_cpu(x):
        return ref.ring_matmul(x, w)
    _check("ring_matmul", [x], torch.int64)
    _check("ring_matmul", [w], torch.int32)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"ring_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if (n + 63) // 64 > 65535 or (m + 31) // 32 >= 2 ** 31:
        raise ValueError(f"ring_matmul: [{m}, {n}] exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.int64, device=x.device)
    if m and n:
        if k == 0:
            return out.zero_()
        _launch("hb_ring_matmul", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                m, k, n)
        _count(ring_matmul)
    return out


# ring_matmul_ss's two forms (csrc/ring_matmul_ss.cu): the large form's
# 64 x 64 block tiles from this many rows on, the small form's 16 x 8 warp
# tiles below it
SS_LARGE_ROWS = 64
SS_FORMS = ("large", "small")


def ss_form(m: int) -> str:
    """The form ``ring_matmul_ss`` launches for [., m, .] @ [., ., .]."""
    return "large" if m >= SS_LARGE_ROWS else "small"


def ring_matmul_ss(x: torch.Tensor, y: torch.Tensor,
                   form: Optional[str] = None) -> torch.Tensor:
    """int64 ring [B, M, K] @ int64 ring [B, K, N] mod 2^64 -> int64
    [B, M, N]: every batch cell in one kernel launch.

    ``form`` ("large" or "small") overrides the kernel's form, which
    ``ss_form`` otherwise picks from M; both compute the same product.
    Where the launch splits K it also zeroes the output first (a memset on
    the same stream), and the work units add their partials into it."""
    if _on_cpu(x):
        return ref.ring_matmul_ss(x, y)
    _check("ring_matmul_ss", [x, y], torch.int64)
    if x.ndim != 3 or y.ndim != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[1]:
        raise ValueError(f"ring_matmul_ss: shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    b, m, k = x.shape
    n = y.shape[2]
    form = ss_form(m) if form is None else form
    if form not in SS_FORMS:
        raise ValueError(f"ring_matmul_ss: form {form!r}, not one of {SS_FORMS}")
    if form == "small" and \
            b * ((max(m, n) + 15) // 16) * ((min(m, n) + 7) // 8) // 4 >= 2 ** 31:
        raise ValueError(f"ring_matmul_ss: [{b}, {m}, {n}] exceeds the small form's grid")
    out = torch.empty((b, m, n), dtype=torch.int64, device=x.device)
    if b and m and n:
        if k == 0:
            return out.zero_()
        _launch("hb_ring_matmul_ss", x.data_ptr(), y.data_ptr(), out.data_ptr(),
                b, m, k, n, SS_FORMS.index(form))
        _count(ring_matmul_ss)
        if form == "large":
            _count(ring_matmul_ss, "large")
    return out


KERNELS = (beaver_and, ks_mask, ks_combine, ks_step, ks_level, cone_step,
           ring_matmul, ring_matmul_ss, pack, pack_ring, unpack)
for _k in KERNELS:
    _k.launches = 0
pack_ring.masked = 0
ring_matmul_ss.large = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    pack_ring.masked = 0
    ring_matmul_ss.large = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
