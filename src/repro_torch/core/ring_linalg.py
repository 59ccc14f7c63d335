"""Linear algebra on Z/2^64: ring values by public int32 weights, and ring
values by ring values.

The reference contracts balanced 8-bit digit planes in a jnp einsum
because a TPU has no 64-bit integer matmul.  PyTorch has none on CUDA
either (cuBLAS has no int64 GEMM), so every conv and fc here goes through
the port's ``ring_matmul`` CUDA kernel (``kernels/ops.py``), which
contracts int8 digit planes on the tensor cores: x's 8 raw bytes against
w's 5 balanced digits, one int32 sum per shift, folded into 64 bits at
most every 16384 of K.  On CPU tensors the kernel's plain version runs.
Results are bit-identical to the reference's ``ring_linalg.matmul_pub``.

The secret-by-secret product ``matmul_ring`` (both operands full 64-bit
ring values, the local arithmetic a Beaver matmul reduces to) goes
through the ``ring_matmul_ss`` CUDA kernel, which contracts both
operands' 8 raw bytes on the tensor cores (36 plane products), every
batch cell in one launch; bit-identical to the reference's
``ring_linalg.matmul_ring`` at any K.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops


def matmul_pub(x: torch.Tensor, w_i32: torch.Tensor) -> torch.Tensor:
    """int64 ring [..., M, K] @ public int32 [K, N] mod 2^64.  Linear over
    shares: applied to each party's share it yields shares of x @ W.
    Leading dims (party, batch, ...) fold into M."""
    k = x.shape[-1]
    if w_i32.shape[0] != k:
        raise ValueError(f"matmul_pub: {tuple(x.shape)} @ {tuple(w_i32.shape)}")
    out = kops.ring_matmul(x.reshape(-1, k).contiguous(), w_i32.contiguous())
    return out.reshape(x.shape[:-1] + (w_i32.shape[1],))


def matmul_ring(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int64 ring [..., M, K] @ int64 ring [..., K, N] mod 2^64, the
    leading (batch) dims of x and y equal.  Not a protocol: the modular
    arithmetic that Beaver-triple matmul reduces to."""
    lead = tuple(x.shape[:-2])
    if x.ndim < 2 or tuple(y.shape[:-2]) != lead or y.shape[-2] != x.shape[-1]:
        raise ValueError(f"matmul_ring: {tuple(x.shape)} @ {tuple(y.shape)}")
    m, k, n = x.shape[-2], x.shape[-1], y.shape[-1]
    out = kops.ring_matmul_ss(x.reshape(-1, m, k).contiguous(),
                              y.reshape(-1, k, n).contiguous())
    return out.reshape(lead + (m, n))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """[..., C, H, W] -> [..., OH*OW, C*kh*kw] patch matrix (local op);
    columns are c-major, then (di, dj), matching w.reshape(cout, -1)."""
    if padding:
        x = torch.nn.functional.pad(x, (padding,) * 4)
    h, w = x.shape[-2], x.shape[-1]
    oh = (h - kh) // stride + 1
    ow = (w - kw) // stride + 1
    cols = []
    for di in range(kh):
        for dj in range(kw):
            sl = x[..., di:di + stride * oh:stride, dj:dj + stride * ow:stride]
            cols.append(sl.reshape(x.shape[:-2] + (oh * ow,)))
    stacked = torch.stack(cols, dim=-2)          # (..., C, kh*kw, OH*OW)
    moved = stacked.movedim(-1, -3)              # (..., OH*OW, C, kh*kw)
    return moved.reshape(moved.shape[:-2] + (moved.shape[-2] * moved.shape[-1],))


def conv2d_pub(x: torch.Tensor, w_i32: torch.Tensor, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """Ring [..., C, H, W] conv by public int32 [Cout, C, kh, kw]."""
    cout, cin, kh, kw = w_i32.shape
    h, w = x.shape[-2], x.shape[-1]
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    patches = im2col(x, kh, kw, stride, padding)       # (..., OH*OW, C*kh*kw)
    wmat = w_i32.reshape(cout, cin * kh * kw).T         # (C*kh*kw, Cout)
    out = matmul_pub(patches, wmat)                     # (..., OH*OW, Cout)
    return out.movedim(-1, -2).reshape(out.shape[:-2] + (cout, oh, ow))
