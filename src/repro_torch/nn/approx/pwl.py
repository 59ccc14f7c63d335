"""Reduced-ring piecewise-linear nonlinearities: GELU / SiLU as ReLU sums
(twin of the reference's ``nn/approx/pwl.py``).

A smooth activation f is lowered to the closed form

    f_hat(x) = c0 + sum_j a_j * ReLU(x - t_j)

over a fixed knot grid t_0 < ... < t_{J-1}: a_0 is the first segment's
slope, a_j the slope change at knot j, the right tail continues with
slope 1, and left of t_0 the value is c0 = f(t_0).

The J knot-shifted copies are stacked on a NEW LEADING axis and evaluated
in ONE ``relu_fn`` call, so under MPC the activation costs one
reduced-ring ReLU pass over J times the elements, and the plan's
per-group element counts price that truthfully.  The combine is public:
one ``mul_public`` by the coefficient vector plus ring adds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PWLSpec:
    """Closed-form ReLU decomposition of a scalar nonlinearity."""

    name: str
    knots: Tuple[float, ...]      # t_0 < ... < t_{J-1}
    coeffs: Tuple[float, ...]     # a_j, one per knot
    c0: float                     # constant left tail, = f(t_0)

    @property
    def n_knots(self) -> int:
        return len(self.knots)


def _silu(x: float) -> float:
    return x / (1.0 + math.exp(-x))


def _gelu(x: float) -> float:
    # tanh form, as the reference's (jax.nn.gelu(approximate=True))
    return 0.5 * x * (1.0 + math.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def pwl_spec(fn: Callable[[float], float], lo: float, hi: float, step: float,
             right_slope: float = 1.0, name: str = "") -> PWLSpec:
    """Interpolate ``fn`` on the uniform grid [lo, hi] with spacing
    ``step``: secant slopes between knots, ``right_slope`` beyond ``hi``,
    ``fn(lo)`` below ``lo``.  Deterministic (no fitting)."""
    n_seg = int(round((hi - lo) / step))
    assert abs(lo + n_seg * step - hi) < 1e-9, (lo, hi, step)
    knots = [lo + j * step for j in range(n_seg + 1)]
    vals = [fn(t) for t in knots]
    slopes = [(vals[j + 1] - vals[j]) / step for j in range(n_seg)]
    slopes.append(right_slope)
    coeffs = [slopes[0]] + [slopes[j] - slopes[j - 1] for j in range(1, n_seg + 1)]
    return PWLSpec(name=name, knots=tuple(knots), coeffs=tuple(coeffs), c0=vals[0])


def silu_spec(lo: float = -8.0, hi: float = 8.0, step: float = 0.5) -> PWLSpec:
    return pwl_spec(_silu, lo, hi, step, name="silu")


def gelu_spec(lo: float = -4.0, hi: float = 4.0, step: float = 0.25) -> PWLSpec:
    return pwl_spec(_gelu, lo, hi, step, name="gelu")


def spec_for(act: str) -> Optional[PWLSpec]:
    """The reduced-ring lowering of a config ``act`` name: None for
    ``relu`` (one relu_fn call already); raises for an activation with no
    MPC lowering."""
    if act == "relu":
        return None
    if act == "silu":
        return silu_spec()
    if act == "gelu":
        return gelu_spec()
    raise ValueError(f"no reduced-ring PWL lowering for activation {act!r}")


def eval_pwl(spec: PWLSpec, x) -> torch.Tensor:
    """Direct (hook-free) evaluation of the closed form: the oracle tests
    and error-bound sweeps compare against."""
    x = torch.as_tensor(x)
    y = torch.full(x.shape, spec.c0, dtype=x.dtype, device=x.device)
    for t, a in zip(spec.knots, spec.coeffs):
        y = y + a * torch.clamp(x - t, min=0.0)
    return y


def pwl_max_error(spec: PWLSpec, fn: Callable, n: int = 4001,
                  margin: float = 2.0) -> float:
    """Max |f_hat - f| on a dense grid spanning the knot range +- margin."""
    xs = np.linspace(spec.knots[0] - margin, spec.knots[-1] + margin, n)
    ref = np.asarray([fn(float(v)) for v in xs])
    got = eval_pwl(spec, torch.from_numpy(xs.astype(np.float32))).numpy()
    return float(np.max(np.abs(got - ref)))


def ensure_hooks(relu_fn):
    """A plaintext ``relu_fn`` with ``.matmul`` / ``.mul``: ``None`` means
    exact ReLU and plain torch products; a bare function gets plain torch
    product hooks on a wrapper (the caller's object is left as it is)."""
    base = (lambda v, g: torch.relu(v)) if relu_fn is None else relu_fn
    if hasattr(base, "matmul") and hasattr(base, "mul"):
        return base

    def wrapped(v, g):
        return base(v, g)

    wrapped.matmul = getattr(base, "matmul", torch.matmul)
    wrapped.mul = getattr(base, "mul", torch.mul)
    return wrapped


def apply_pwl(spec: PWLSpec, x: torch.Tensor, group: int, relu_fn) -> torch.Tensor:
    """Plaintext PWL activation through the ``relu_fn`` hook, in the MPC
    data flow: J knot-shifted copies stacked on a new leading axis, ONE
    relu_fn call, public linear combine."""
    shifted = torch.stack([x - t for t in spec.knots], dim=0)
    r = relu_fn(shifted, group)
    coeffs = torch.tensor(spec.coeffs, dtype=x.dtype, device=x.device).reshape(
        (spec.n_knots,) + (1,) * x.ndim)
    return spec.c0 + torch.sum(r * coeffs, dim=0)


def apply_pwl_mpc(spec: PWLSpec, hs: Sequence, group: int, relu_fn,
                  comm=None) -> List:
    """Secret-shared PWL activation over sibling MPCTensor streams: one
    ``relu_fn`` call evaluates every stream's J knot-shifted copies; the
    combine is local: one ``mul_public`` by the coefficients, J - 1 ring
    adds, one public constant add."""
    from ...core import mpc_tensor
    stacked = [mpc_tensor.stack([h.add_public(-t, comm) for t in spec.knots], axis=0)
               for h in hs]
    rs = relu_fn(stacked, group)
    outs = []
    for r in rs:
        coeffs = np.asarray(spec.coeffs, np.float32).reshape(
            (spec.n_knots,) + (1,) * (len(r.shape) - 1))
        w = r.mul_public(coeffs)
        acc = w[0]
        for j in range(1, spec.n_knots):
            acc = acc + w[j]
        outs.append(acc.add_public(spec.c0, comm))
    return outs
