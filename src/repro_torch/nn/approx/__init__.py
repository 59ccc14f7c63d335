"""Reduced-ring nonlinearity lowering for private transformer inference
(twin of the reference's ``nn/approx``).

- GELU / SiLU -> affine + reduced-ring ReLU sums (``pwl``): one relu_fn
  call per activation site, the J knot-shifted copies stacked on a new
  leading axis;
- softmax -> ReLU attention normalization (``attention``): ReLU on scaled
  scores times a public causal-mean multiplier; the two secret matmuls
  open through Beaver rounds fused across sibling streams;
- ``bounds``: the closed-form fixed-point error bounds.

The plaintext twins (``apply_pwl``, ``relu_attention``) make the same
``relu_fn`` / ``relu_fn.matmul`` / ``relu_fn.mul`` hook calls in the same
order as their MPC counterparts, so one trace prices the replay.
"""
from .attention import causal_norm, relu_attention, relu_attention_mpc
from .bounds import discard_margin, magnitude_bound, pwl_fixed_point_bound
from .pwl import (PWLSpec, apply_pwl, apply_pwl_mpc, ensure_hooks, eval_pwl,
                  gelu_spec, pwl_max_error, pwl_spec, silu_spec, spec_for)

__all__ = [
    "PWLSpec", "apply_pwl", "apply_pwl_mpc", "causal_norm", "discard_margin",
    "ensure_hooks", "eval_pwl", "gelu_spec", "magnitude_bound",
    "pwl_fixed_point_bound", "pwl_max_error", "pwl_spec", "relu_attention",
    "relu_attention_mpc", "silu_spec", "spec_for",
]
