"""Fixed-point error bounds for reduced-ring nonlinearity evaluation (twin
of the reference's ``nn/approx/bounds.py``).

- ``discard_margin(m)``: the worst-case |x_f| below which discarding the
  low m ring bits can flip a DReLU decision (monotone in m);
- ``magnitude_bound(k)``: Theorem 1's regime of a k-bit reduced ring,
  |x_f| < 2^(k - 1 - frac_bits);
- ``pwl_fixed_point_bound(spec)``: PWL interpolation error plus one LSB
  truncation per knot of the public combine.
"""
from __future__ import annotations

from ...core import fixed
from .pwl import PWLSpec, _gelu, _silu, pwl_max_error


def discard_margin(m: int, frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> float:
    """Worst-case |x_f| below which discarding the low ``m`` ring bits can
    flip a DReLU decision."""
    if m < 0:
        raise ValueError(f"negative discarded bits: {m}")
    return (2.0 ** m) / (2.0 ** frac_bits)


def magnitude_bound(k: int, frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> float:
    """Theorem-1 magnitude regime of a k-bit reduced ring."""
    return 2.0 ** (k - 1 - frac_bits)


def pwl_fixed_point_bound(spec: PWLSpec,
                          frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> float:
    """Worst-case |f_hat - f| of one fixed-point PWL activation inside the
    knot range: interpolation error + J truncation ulps from the combine."""
    fn = {"silu": _silu, "gelu": _gelu}[spec.name]
    return pwl_max_error(spec, fn, margin=0.0) + spec.n_knots * (2.0 ** -frac_bits)
