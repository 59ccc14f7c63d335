"""Top-k mixture-of-experts with capacity-bounded sort-based dispatch (twin
of the reference's ``nn/moe.py``).

Tokens are gathered into per-row (E, capacity, D) buffers and each expert
runs one batched product, so the compute is about top_k x tokens x FFN
(+ router).  Routing is per batch row (Switch-style, with dropping): an
assignment past its expert's capacity goes to the buffer's extra last row
``E * capacity``, which no expert reads.  On DTensors (the dry run) the
reference's sharding constraints apply, the routing's index tensors are
replicated DTensors and the scatters are out of place (DTensor has no
strategy for the in-place ones); on plain tensors the values are the
same.
"""
from __future__ import annotations

import torch

from ..runtime import constraints
from . import common


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             gated: bool = True, dtype=torch.float32):
    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) * scale

    p = {"router": common.dense_init(gen, d_model, n_experts, dtype),
         "w_up": normal((n_experts, d_model, d_ff), d_model ** -0.5),
         "w_down": normal((n_experts, d_ff, d_model), d_ff ** -0.5)}
    if gated:
        p["w_gate"] = normal((n_experts, d_model, d_ff), d_model ** -0.5)
    return p


def topk(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index (as ``jax.lax.top_k``; ``torch.topk`` promises no order
    among equal values)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _per_expert(h, w):
    """(B, E, C, I) x (E, I, O) -> (B, E, C, O), each expert its own
    weight.  On DTensors as one batched product between contiguous
    copies, each gradient made contiguous before a view's backward: the
    einsum's backward views strided gradients, which DTensor cannot."""
    if constraints.mesh_of(h) is None:
        return common.einsum("beci,eio->beco", h, w)
    b, e, c, i = h.shape
    w = constraints.gathered(w)
    h = constraints.grad_contiguous(h.to(torch.promote_types(h.dtype, w.dtype)))
    y = torch.bmm(h.transpose(0, 1).contiguous().reshape(e, b * c, i), w.to(h.dtype))
    y = constraints.grad_contiguous(y.reshape(e, b, c, w.shape[-1]))
    return y.transpose(0, 1).contiguous()


def moe(params, x: torch.Tensor, *, n_experts: int, top_k: int = 2,
        capacity_factor: float = 1.25, act_name: str = "silu") -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    k = top_k
    logits = common.dense(params["router"], x)                  # (B, S, E)
    weights = torch.softmax(logits.to(torch.float32), dim=-1)
    top_w, top_e = topk(weights, k)                            # (B, S, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    capacity = int(max(1, capacity_factor * k * s / n_experts))
    flat_e = top_e.reshape(b, s * k)                            # (B, T)
    flat_w = top_w.reshape(b, s * k).to(x.dtype)
    flat_tok = constraints.like(
        torch.arange(s, device=x.device).repeat_interleave(k).expand(b, -1), x)

    order = torch.argsort(flat_e, dim=-1, stable=True)          # per row
    sorted_e = torch.gather(flat_e, -1, order)
    # rank of each assignment within its expert group (per row)
    counts = constraints.like(torch.zeros((b, n_experts), dtype=torch.int64,
                                          device=x.device), x).scatter_add(
        1, flat_e, torch.ones_like(flat_e))
    first_idx = torch.cumsum(counts, dim=-1) - counts           # exclusive cumsum
    rank = (constraints.like(torch.arange(s * k, device=x.device), x)
            - torch.gather(first_idx, -1, sorted_e))
    slot = torch.where(rank < capacity, sorted_e * capacity + rank,
                       n_experts * capacity)

    # gather tokens into per-row (E*cap + 1, D) buffers (last row: dropped)
    src_tok = torch.gather(flat_tok, -1, order)                 # (B, T)
    gathered = torch.gather(x, 1, src_tok[..., None].expand(-1, -1, d))
    buf = constraints.like(torch.zeros((b, n_experts * capacity + 1, d), dtype=x.dtype,
                                       device=x.device), x)
    buf = buf.scatter(1, slot[..., None].expand(-1, -1, d), gathered)
    h = constraints.shard(buf[:, :-1].reshape(b, n_experts, capacity, d),
                          "dp", None, None, None)

    act = common.activation(act_name)
    up = _per_expert(h, params["w_up"])
    if "w_gate" in params:
        hidden = act(_per_expert(h, params["w_gate"])) * up
    else:
        hidden = act(up)
    hidden = constraints.shard(hidden, "dp", None, None, "tp")
    out_buf = _per_expert(hidden, params["w_down"])
    out_flat = torch.cat([out_buf.reshape(b, n_experts * capacity, d),
                          constraints.like(torch.zeros((b, 1, d), dtype=out_buf.dtype,
                                                       device=x.device), x)], dim=1)

    # scatter back with routing weights
    contrib = torch.gather(out_flat, 1, slot[..., None].expand(-1, -1, d))
    contrib = contrib * torch.gather(flat_w, -1, order)[..., None]
    rows = constraints.like(torch.arange(b, device=x.device)[:, None], x) * s + src_tok
    y = constraints.like(torch.zeros((b * s, d), dtype=x.dtype, device=x.device), x)
    y = y.index_add(0, rows.reshape(-1), contrib.reshape(b * s * k, d).to(x.dtype))
    return constraints.shard(y.reshape(b, s, d), "dp", None, None)


def moe_aux_loss(params, x: torch.Tensor, *, n_experts: int) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style)."""
    logits = common.dense(params["router"], x.reshape(-1, x.shape[-1]))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = torch.nn.functional.one_hot(top1, n_experts).to(torch.float32).mean(0)
    return n_experts * torch.sum(frac_tokens * probs.mean(0))
