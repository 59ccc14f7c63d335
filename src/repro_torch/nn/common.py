"""Shared neural-net primitives of the dense LM (twin of the pieces of the
reference's ``nn/common.py`` that the private LM needs), and the MPC
bridge ``mpc_relu_many``.

Functional style as in the reference: ``*_init`` builds param trees
(plain dicts of tensors) from an explicit ``torch.Generator`` on its
device, the apply functions are pure, and every apply function also runs
on ``meta`` tensors (the plan tracer's shape-only pass).
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, with_bias: bool = False):
    """{"w": N(0, 1/d_in) of shape (d_in, d_out)} (+ zero "b"), on the
    generator's device."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=gen.device) * (1.0 / math.sqrt(d_in))
    if with_bias:
        return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=gen.device)}
    return {"w": w}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = torch.einsum("...d,df->...f", x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, Dh); positions broadcastable to
    (..., S).  Tables in float32, as the reference."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      / half)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32):
    """Up, down (and gate) projections, drawn in the reference's key order."""
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype)["w"],
         "w_down": dense_init(gen, d_ff, d_model, dtype)["w"]}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)["w"]
    return p


# ---------------------------------------------------------------------------
# MPC bridge: round-shared ReLU over sibling secret-shared tensors
# ---------------------------------------------------------------------------

def mpc_relu_many(keys, tensors, hbs=None, comm=None, triples_list=None,
                  cone: bool = False, auto_batch: bool = True):
    """Apply GMW ReLU to sibling MPCTensors with shared protocol rounds
    (``core.mpc_tensor.relu_many``): every communication round across the
    sibling group is one coalesced exchange, so N parallel branches pay
    max-of-N rounds, and identical-(shape, k, m) branches auto-batch into
    one protocol stream per round.  ``keys`` is one PRNG key per tensor;
    ``hbs`` one HummingBird (k, m) per tensor (default the exact 64-bit
    ring)."""
    from ..core import mpc_tensor      # lazy: keep the plaintext pieces light
    return mpc_tensor.relu_many(keys, tensors, comm=comm, hbs=hbs,
                                triples_list=triples_list, cone=cone,
                                auto_batch=auto_batch)
