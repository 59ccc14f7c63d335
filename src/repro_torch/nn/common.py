"""Shared neural-net primitives of the plaintext model zoo (twin of the
reference's ``nn/common.py``), and the MPC bridge ``mpc_relu_many``.

Functional style as in the reference: ``*_init`` builds param trees
(plain dicts of tensors) from an explicit ``torch.Generator`` on its
device, the apply functions are pure, and ``dense`` and ``rope`` also
run on ``meta`` tensors (the plan tracer's shape-only pass).

Mixed dtypes promote as jnp does: a float32 activation times a bfloat16
weight is a float32 product (``einsum``), where ``torch.einsum`` itself
would refuse the pair.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..runtime import constraints


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, with_bias: bool = False):
    """{"w": N(0, 1/d_in) of shape (d_in, d_out)} (+ zero "b"), on the
    generator's device."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=gen.device) * (1.0 / math.sqrt(d_in))
    if with_bias:
        return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=gen.device)}
    return {"w": w}


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to one dtype, as jnp.einsum
    promotes them (float32 with bfloat16 gives float32)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in operands))
    return torch.einsum(equation, *(t.to(dt) for t in operands))


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = einsum("...d,df->...f", x, constraints.gathered(params["w"]))
    if "b" in params:
        y = y + params["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in float32, the normalised value cast back to ``x``'s
    dtype before the scale (which never promotes the activations)."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"].to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32):
    return {"table": torch.randn((vocab, d), generator=gen, dtype=dtype,
                                 device=gen.device) * 0.02}


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``params["table"]`` at ``ids``.  On DTensors a lookup in
    a vocab-split table is a masked partial sum; it is reduced here onto
    the batch split (and its gradient brought back to that split, which
    DTensor can turn into the masked form the lookup's backward takes)."""
    return constraints.grad_placed(constraints.shard(
        F.embedding(ids, constraints.gathered(params["table"])), "dp", None, None))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping (``cap`` 0: none)."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh form, not torch's default erf form
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"gelu": _gelu_tanh, "silu": F.silu, "relu": F.relu,
                "tanh": torch.tanh}


def activation(name: str):
    return _ACTIVATIONS[name]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, Dh); positions broadcastable to
    (..., S).  Tables in float32, as the reference."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = constraints.like(
        theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half),
        positions)
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


def mlp(params, x: torch.Tensor, act_name: str = "gelu") -> torch.Tensor:
    act = activation(act_name)
    w = {k: constraints.gathered(v) for k, v in params.items()}
    up = einsum("...d,df->...f", x, w["w_up"])
    if "w_gate" in w:
        h = act(einsum("...d,df->...f", x, w["w_gate"])) * up
    else:
        h = act(up)
    # Megatron TP: hidden sharded over model, contraction in w_down emits
    # the single per-block all-reduce
    h = constraints.shard(h, "dp", None, "tp")
    y = einsum("...f,fd->...d", h, w["w_down"])
    return constraints.shard(y, "dp", None, None)


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
