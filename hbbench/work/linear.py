"""The least work of the ring products Z/2^64 a call runs (frozen).

A product mod 2^64 as int8 tensor-core products: a public int32 weight
times a ring element needs 26 byte-plane products (x's 8 byte digits
against w's 4, only digit pairs i + j < 8 count: 8 + 7 + 6 + 5), a secret
by secret product 36 (both operands' 8 digits, i + j < 8).  Each plane
product is 2 operations a multiply-add.  Bytes: each input read once and
the output written once (int64 ring values, int32 weights).  A launch's
least time is the larger of its operations over the int8 peak and its
bytes over the memory peak.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from . import peaks

PUBLIC_PLANE_PRODUCTS = 26
SECRET_PLANE_PRODUCTS = 36

#: the program's linear kernels, by symbol in a profiler trace
KERNEL_PATTERN = r"(?<![A-Za-z_])ring_matmul(_ss)?_kernel"


def public_work(m: int, k: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of (M, K) ring @ (K, N) int32."""
    return (PUBLIC_PLANE_PRODUCTS * 2.0 * m * k * n,
            8.0 * m * k + 4.0 * k * n + 8.0 * m * n)


def secret_work(b: int, m: int, k: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of b products (M, K) ring @ (K, N) ring."""
    return (SECRET_PLANE_PRODUCTS * 2.0 * b * m * k * n,
            8.0 * b * (m * k + k * n + m * n))


def call_work(shapes: Iterable) -> Tuple[float, float]:
    """(int8 operations, least seconds) of a call's ring products:
    ``shapes`` holds ("public", (M, K, N), count) and ("secret", (B, M, K,
    N), count) entries."""
    total_ops, least_s = 0.0, 0.0
    for kind, shape, count in shapes:
        ops, nbytes = (public_work(*shape) if kind == "public"
                       else secret_work(*shape))
        total_ops += count * ops
        least_s += count * max(ops / peaks.INT8_OPS_PER_S,
                               nbytes / peaks.HBM_BYTES_PER_S)
    return total_ops, least_s
