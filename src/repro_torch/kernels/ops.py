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
  bytes, 24 per word (5 inputs, 1 output).
- ``ks_mask``: ``kernels/gmw_round.py:73`` ``ks_mask_pallas``; bytes, 40
  per (party, plane of w, word).
- ``ks_combine``: ``kernels/gmw_round.py:105`` ``ks_combine_pallas``;
  bytes, 68 per (party, plane of w, word).
- ``ring_matmul``: ``kernels/ring_matmul.py:88`` ``ring_matmul_pallas``;
  operations, the int32 IMAD rate (no 64-bit multiplier on the card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "hb_beaver_and": ("gmw_round.cu", [_P] * 7 + [_I, _I, _P]),
    "hb_ks_mask": ("gmw_round.cu", [_P] * 6 + [_I] * 4 + [_P]),
    "hb_ks_combine": ("gmw_round.cu",
                      [_P, _P, _I, _P, _P, _I] + [_P] * 7 + [_I] * 3 + [_P]),
    "hb_ring_matmul": ("ring_matmul.cu", [_P] * 3 + [_I] * 3 + [_P]),
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


def _launch(name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _fn(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def beaver_and(d_open, e_open, a, b, c, sel):
    """Local Beaver-AND z = c ^ (d&b) ^ (e&a) ^ (sel&d&e) on (P, ..., W)
    int32 words of any leading shape; ``sel`` is one word per party."""
    if _on_cpu(d_open):
        return ref.beaver_and(d_open, e_open, a, b, c, sel)
    _check("beaver_and", [d_open, e_open, a, b, c, sel], torch.int32)
    n_parties = d_open.shape[0]
    for t in (e_open, a, b, c):
        if t.shape != d_open.shape:
            raise ValueError(f"beaver_and: shape {tuple(t.shape)} != "
                             f"{tuple(d_open.shape)}")
    if sel.shape != (n_parties,):
        raise ValueError(f"beaver_and: sel must be ({n_parties},), got "
                         f"{tuple(sel.shape)}")
    out = torch.empty_like(d_open)
    per_party = d_open.numel() // n_parties
    if per_party:
        _launch("hb_beaver_and", d_open.data_ptr(), e_open.data_ptr(),
                a.data_ptr(), b.data_ptr(), c.data_ptr(), sel.data_ptr(),
                out.data_ptr(), n_parties, per_party)
        beaver_and.launches += 1
    return out


def ks_mask(g, p, a, b, shift: int):
    """Pre-exchange Kogge-Stone level: d = [p, p] ^ a and
    e = [g >> shift, p >> shift] ^ b (plane shifts with zero fill).
    g, p: (P, w, W); a, b: (P, 2w, W) int32 words."""
    if _on_cpu(g):
        return ref.ks_mask(g, p, a, b, shift)
    _check("ks_mask", [g, p, a, b], torch.int32)
    n_parties, w, words = g.shape
    if p.shape != g.shape or a.shape != (n_parties, 2 * w, words) \
            or b.shape != a.shape:
        raise ValueError("ks_mask: expected g, p (P, w, W) and a, b (P, 2w, W)")
    d = torch.empty_like(a)
    e = torch.empty_like(a)
    if g.numel():
        _launch("hb_ks_mask", g.data_ptr(), p.data_ptr(), a.data_ptr(),
                b.data_ptr(), d.data_ptr(), e.data_ptr(), n_parties, w, words,
                int(shift))
        ks_mask.launches += 1
    return d, e


def ks_combine(d, d_other, e, e_other, a, b, c, sel, g):
    """Post-exchange Kogge-Stone level: open (d, e) with the peer's halves,
    Beaver-AND, then g' = g ^ z[:w] and p' = z[w:].  d_other and e_other
    may be views into the received round buffer (any party stride)."""
    if _on_cpu(g):
        return ref.ks_combine(d, d_other, e, e_other, a, b, c, sel, g)
    name = "ks_combine"
    _check(name, [d, e, a, b, c, sel, g], torch.int32)
    _check(name, [d_other, e_other], torch.int32, contiguous=False)
    n_parties, w, words = g.shape
    full = (n_parties, 2 * w, words)
    for t in (d, d_other, e, e_other, a, b, c):
        if tuple(t.shape) != full:
            raise ValueError(f"{name}: expected {full}, got {tuple(t.shape)}")
    if sel.shape != (n_parties,):
        raise ValueError(f"{name}: sel must be ({n_parties},)")
    g_out = torch.empty_like(g)
    p_out = torch.empty_like(g)
    if g.numel():
        _launch("hb_ks_combine", d.data_ptr(), d_other.data_ptr(),
                _party_rows(name, d_other), e.data_ptr(), e_other.data_ptr(),
                _party_rows(name, e_other), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), sel.data_ptr(), g.data_ptr(), g_out.data_ptr(),
                p_out.data_ptr(), n_parties, w, words)
        ks_combine.launches += 1
    return g_out, p_out


def ring_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int64 ring [M, K] @ public int32 [K, N] mod 2^64 -> int64 [M, N]."""
    if _on_cpu(x):
        return ref.ring_matmul(x, w)
    _check("ring_matmul", [x], torch.int64)
    _check("ring_matmul", [w], torch.int32)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"ring_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if (m + 63) // 64 > 65535:
        raise ValueError(f"ring_matmul: M = {m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.int64, device=x.device)
    if m and n:
        if k == 0:
            return out.zero_()
        _launch("hb_ring_matmul", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                m, k, n)
        ring_matmul.launches += 1
    return out


KERNELS = (beaver_and, ks_mask, ks_combine, ring_matmul)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
