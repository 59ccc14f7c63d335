"""Unified decoder LM covering the dense, MoE, SSM, hybrid and VLM families,
and its private inference (twin of the reference's ``models/lm.py``).

Weights are a params tree in the reference's layout (``layers`` leaves
stacked on a leading layer axis, projections [in, out]), so trees carry
across with ``params_from_jax``.  Layers run in a Python loop over that
axis (the reference's ``lax.scan``); gemma2's local/global alternation is
a per-layer window.  Hybrid (zamba2) splits the stack into
``attn_every``-sized segments with one *shared* attention block (one
param set) before each, so its KV cache exists for n_layers/attn_every
slots only.

Plaintext modes:
  apply        - full-sequence forward (training, under autograd, with the
                 config's remat policy per layer; serving without)
  prefill      - forward + KV/SSM cache construction (serving)
  decode_step  - one token with the cache updated in place (serving)

The cache keeps K/V in bfloat16 and the SSM states in float32, as the
reference's.  ``decode_step`` writes into the cache's tensors and returns
the same dict; clone the cache to keep the state before a step.

Private inference (dense family only, as the reference's): the MPC
lowering replaces every transformer nonlinearity with a reduced-ring
composition (``nn/approx``): SiLU/GELU become knot-stacked ReLU sums,
softmax becomes ReLU + a public causal-mean normalization, and rms/layer
norms become their static-scale approximation (x * scale: the
data-dependent rsqrt has no cheap GMW circuit).  ``mpc_reference`` is the
plaintext twin of ``_lm_mpc_forward``: it makes the same relu_fn /
.matmul / .mul hook calls in the same order, so ``trace()`` prices the
replay (ReLU groups: 2 per layer, the attention scores then the MLP
activation; Beaver opens: QK^T, A@V, gate*up per layer).  The input is the
*embedded* hidden states (B, S, d_model): the token lookup happens
client-side in the clear.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..api import Plan, register_mpc_forward, trace_plan
from ..configs.base import ArchConfig
from ..core import mpc_tensor
from ..device import Device, resolve as resolve_device
from ..nn import approx, attention, common, moe as moe_lib, rope_tables, ssm
from ..runtime import constraints

BIG_WINDOW = 1 << 30


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab rounded up to a multiple of 16, as the reference."""
    return -(-cfg.vocab // 16) * 16


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _norm_init(cfg: ArchConfig, d: int, device):
    """Norm params, float32 whatever the model's dtype (the reference's)."""
    return (common.layernorm_init(d, device=device) if cfg.norm == "layernorm"
            else common.rmsnorm_init(d, device=device))


def _norm(cfg: ArchConfig, p, x):
    return (common.layernorm(p, x) if cfg.norm == "layernorm"
            else common.rmsnorm(p, x))


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(
            f"MPC lowering covers the dense family only, not {cfg.family!r}")


def _stack(trees):
    """Stack a list of equal-structure param trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(tree, n: int) -> List[Any]:
    """The ``n`` per-layer trees of a stacked tree, one ``unbind`` per leaf
    (views): under autograd each leaf's gradient is one stack of the
    layers', where indexing would add a full-size zero-padded gradient
    per layer."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _set_layer(tree, i: int, new) -> None:
    """Copy ``new`` into layer ``i`` of the stacked ``tree``, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_layer(v, i, new[k])
        else:
            v[i] = new[k]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _attn_init(gen: torch.Generator, cfg: ArchConfig):
    return attention.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.qkv_bias, _dtype(cfg))


def _layer_init(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    dt, d = _dtype(cfg), cfg.d_model
    p: Dict[str, Any] = {"ln1": _norm_init(cfg, d, gen.device)}
    if cfg.family in ("dense", "vlm", "moe"):
        p["attn"] = _attn_init(gen, cfg)
        p["ln2"] = _norm_init(cfg, d, gen.device)
        if cfg.family == "moe":
            p["moe"] = moe_lib.moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                        cfg.gated_mlp, dt)
        else:
            p["mlp"] = common.mlp_init(gen, d, cfg.d_ff, cfg.gated_mlp, dt)
    elif cfg.family == "ssm":
        p["mamba"] = ssm.mamba1_init(gen, d, cfg.ssm_state, cfg.ssm_expand, dtype=dt)
    elif cfg.family == "hybrid":
        p["mamba"] = ssm.mamba2_init(gen, d, cfg.ssm_state, cfg.mamba2_head_dim,
                                     cfg.ssm_expand, dt)
    else:
        raise ValueError(cfg.family)
    return p


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random params in the reference's tree layout, drawn from
    ``generator`` on its device (the reference's init scales: N(0, 1/d_in)
    projections, zero biases, unit norm scales, N(0, 0.02^2) embeddings,
    the SSM and MoE layers' own).  The enc-dec family is ``models/encdec``'s."""
    dt, dev, d = _dtype(cfg), generator.device, cfg.d_model
    vocab = padded_vocab(cfg)
    params = {
        "embed": common.embed_init(generator, vocab, d, dt),
        "layers": _stack([_layer_init(generator, cfg) for _ in range(cfg.n_layers)]),
        "final_norm": _norm_init(cfg, d, dev),
        "lm_head": common.dense_init(generator, d, vocab, dt),
    }
    if cfg.family == "hybrid" and cfg.attn_every:
        params["shared_attn"] = {"ln": _norm_init(cfg, d, dev),
                                 "attn": _attn_init(generator, cfg)}
    return params


def params_from_jax(np_tree, device: Device = None) -> Dict[str, Any]:
    """The reference's ``lm.init`` (or ``encdec.init``) tree, as numpy
    arrays, -> the port's tree on ``device`` (default the GPU): same keys,
    stacked leaves still stacked on axis 0, same dtypes (bfloat16 leaves
    stay bfloat16)."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return leaf(tree)

    return walk(np_tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _layer_window(cfg: ArchConfig, idx: int) -> Optional[int]:
    """The attention window of layer ``idx`` (None: global).  gemma2's even
    layers are local; its odd ones get ``BIG_WINDOW``, as the reference's."""
    if cfg.local_global_period:
        return (cfg.sliding_window if idx % cfg.local_global_period == 0
                else BIG_WINDOW)
    return cfg.sliding_window or None


def _attn_kwargs(cfg: ArchConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                cap=cfg.attn_softcap, chunk_q=cfg.attn_chunk_q,
                chunk_k=cfg.attn_chunk_k)


def _decode_kwargs(cfg: ArchConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                cap=cfg.attn_softcap)


def _ffn(cfg: ArchConfig, p, h):
    """The MLP (or MoE) half of an attention block, residual added."""
    x = _norm(cfg, p["ln2"], h)
    if cfg.family == "moe":
        return h + moe_lib.moe(p["moe"], x, n_experts=cfg.n_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.moe_capacity_factor,
                               act_name=cfg.act)
    return h + common.mlp(p["mlp"], x, cfg.act)


def _attn_mlp_block(cfg: ArchConfig, p, h, idx: int):
    a = attention.attention(p["attn"], _norm(cfg, p["ln1"], h), **_attn_kwargs(cfg),
                            window=_layer_window(cfg, idx))
    return _ffn(cfg, p, h + a)


def _mamba_block(cfg: ArchConfig, p, h, return_state: bool = False):
    x = _norm(cfg, p["ln1"], h)
    if cfg.mamba_version == 1:
        out = ssm.mamba1(p["mamba"], x, n_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
                         return_state=return_state)
    else:
        out = ssm.mamba2(p["mamba"], x, n_state=cfg.ssm_state,
                         head_dim=cfg.mamba2_head_dim, chunk=cfg.ssm_chunk,
                         return_state=return_state)
    if return_state:
        return h + out[0], out[1]
    return h + out


def _mamba_decode(cfg: ArchConfig, p, h, state):
    x = _norm(cfg, p["ln1"], h)
    if cfg.mamba_version == 1:
        y, st = ssm.mamba1_decode(p["mamba"], x, state, n_state=cfg.ssm_state)
    else:
        y, st = ssm.mamba2_decode(p["mamba"], x, state, n_state=cfg.ssm_state,
                                  head_dim=cfg.mamba2_head_dim)
    return h + y, st


_REMAT = ("none", "full", "dots", "dots_all")


def _remat_policy(name: str):
    """The selective-checkpoint policy of ``cfg.remat`` (jax's checkpoint
    policies): "dots_all" saves every matmul's output (``dots_saveable``),
    "dots" only those of matmuls without batch dims
    (``dots_with_no_batch_dims_saveable``); the rest is recomputed.
    ``common.einsum`` reaches ``aten.bmm`` for projections and attention
    alike, a projection with a batch extent of 1 (its batch dims are the
    contraction's free dims), so "dots" tells them apart by that extent: a
    product whose only batch dims have extent 1 (a batch of one sequence
    with one KV head) counts as unbatched."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    unbatched = {aten.mm.default, aten.addmm.default}
    batched = {aten.bmm.default: 0, aten.baddbmm.default: 1}   # the batch1 arg

    def policy(ctx, op, *args, **kwargs):
        if op in unbatched or (op in batched and (
                name == "dots_all" or args[batched[op]].shape[0] == 1)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _maybe_remat(cfg: ArchConfig, fn: Callable) -> Callable:
    """``fn`` (one layer) under ``torch.utils.checkpoint`` as ``cfg.remat``
    says (the reference's ``jax.checkpoint`` policies): "full" saves only
    the layer's inputs, "dots" / "dots_all" also the matmul outputs their
    policy keeps.  "none", or no autograd, runs ``fn`` as it is."""
    if cfg.remat not in _REMAT:
        raise ValueError(f"remat {cfg.remat!r} is none of {_REMAT}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt

    kw: Dict[str, Any] = {"use_reentrant": False}
    if cfg.remat != "full":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _remat_policy(cfg.remat))
    return lambda *args: ckpt.checkpoint(fn, *args, **kw)


def _segments(cfg: ArchConfig):
    """The hybrid's (lo, hi) layer ranges, one per shared-attention slot."""
    per = cfg.attn_every
    return [(lo, min(lo + per, cfg.n_layers)) for lo in range(0, cfg.n_layers, per)]


def _logits(params, cfg: ArchConfig, h):
    h = _norm(cfg, params["final_norm"], h)
    return common.softcap(common.dense(params["lm_head"], h), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ArchConfig, tokens, frontend_embeds):
    h = common.embed(params["embed"], tokens)
    if cfg.frontend != "none":
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: a {cfg.frontend} arch needs its stub "
                             "frontend embeds")
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    # residual stream: batch over dp, replicated over model (Megatron TP)
    return constraints.shard(h, "dp", None, None)


def apply(params, tokens, cfg: ArchConfig, frontend_embeds=None):
    """tokens: (B, S_tok) -> logits (B, S_total, vocab)."""
    h = _embed_inputs(params, cfg, tokens, frontend_embeds)
    if cfg.family == "hybrid" and cfg.attn_every:
        h = _hybrid_forward(params, h, cfg)
    else:
        for l, p in enumerate(_layers(params["layers"], cfg.n_layers)):
            if cfg.family in ("dense", "moe", "vlm"):
                block = functools.partial(_attn_mlp_block, cfg, idx=l)
            else:
                block = functools.partial(_mamba_block, cfg)
            h = constraints.shard(_maybe_remat(cfg, block)(p, h), "dp", None, None)
    return _logits(params, cfg, h)


def _hybrid_forward(params, h, cfg: ArchConfig):
    """zamba2: the shared attention block before each segment of mamba2
    layers."""
    sa = params["shared_attn"]
    layers = _layers(params["layers"], cfg.n_layers)
    block = _maybe_remat(cfg, functools.partial(_mamba_block, cfg))
    for lo, hi in _segments(cfg):
        h = h + attention.attention(sa["attn"], _norm(cfg, sa["ln"], h),
                                    **_attn_kwargs(cfg))
        for l in range(lo, hi):
            h = block(layers[l], h)
    return h


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _stacked(tree, n: int):
    return {k: torch.stack([v] * n) for k, v in tree.items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device: Device = None):
    """The serving cache, zeroed: per layer (hybrid: per segment) K/V of
    ``max_len`` slots in bfloat16, per layer SSM state in float32."""
    device = resolve_device(device)
    kv = lambda n: _stacked(attention.init_kv_cache(
        batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim, torch.bfloat16,
        device), n)
    di = cfg.ssm_expand * cfg.d_model
    if cfg.family in ("dense", "moe", "vlm"):
        return {"kv": kv(cfg.n_layers)}
    if cfg.family == "ssm":
        return {"ssm": _stacked(ssm.mamba1_init_state(batch, di, cfg.ssm_state,
                                                      device), cfg.n_layers)}
    if cfg.family == "hybrid":
        return {"ssm": _stacked(ssm.mamba2_init_state(batch, di, cfg.ssm_state,
                                                      cfg.mamba2_head_dim, device),
                                cfg.n_layers),
                "kv": kv(len(_segments(cfg)))}
    raise ValueError(cfg.family)


def _init_cache_like(cfg: ArchConfig, batch: int, max_len: int, h):
    """``init_cache`` on ``h``'s device; for a DTensor ``h``, DTensors on
    its mesh placed by the cache rules (``runtime/sharding.cache_spec``),
    each rank's block made alone."""
    mesh = constraints.mesh_of(h)
    if mesh is None:
        return init_cache(cfg, batch, max_len, h.device)
    from ..runtime import sharding

    return sharding.cache_zeros(init_cache(cfg, batch, max_len, "meta"), cfg, mesh,
                                h.device)


def decode_step(params, token, cache, pos: int, cfg: ArchConfig):
    """token: (B, 1) ids; ``pos``: the token's position (an int).  Returns
    (logits (B, 1, vocab), cache), the cache updated in place."""
    h = common.embed(params["embed"], token)
    layers = params["layers"]
    if cfg.family in ("dense", "moe", "vlm"):
        for l in range(cfg.n_layers):
            p = _layer(layers, l)
            a, _ = attention.attention_decode(
                p["attn"], _norm(cfg, p["ln1"], h), _layer(cache["kv"], l), pos,
                **_decode_kwargs(cfg), window=_layer_window(cfg, l))
            h = _ffn(cfg, p, h + a)
    elif cfg.family == "ssm":
        for l in range(cfg.n_layers):
            h, st = _mamba_decode(cfg, _layer(layers, l), h, _layer(cache["ssm"], l))
            _set_layer(cache["ssm"], l, st)
    else:  # hybrid
        sa = params["shared_attn"]
        for seg, (lo, hi) in enumerate(_segments(cfg)):
            a, _ = attention.attention_decode(
                sa["attn"], _norm(cfg, sa["ln"], h), _layer(cache["kv"], seg), pos,
                **_decode_kwargs(cfg))
            h = h + a
            for l in range(lo, hi):
                h, st = _mamba_decode(cfg, _layer(layers, l), h,
                                      _layer(cache["ssm"], l))
                _set_layer(cache["ssm"], l, st)
    return _logits(params, cfg, h), cache


def _attend_prefill(cfg: ArchConfig, p_attn, x, window=None):
    """Prefill attention: (output, k, v) of the whole sequence."""
    b, s, _ = x.shape
    positions = constraints.like(torch.arange(s, device=x.device)[None, :], x)
    q, k, v = attention._project_qkv(p_attn, x, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, positions,
                                     cfg.rope_theta)
    o = attention.flash_attention(q, k, v, q_offset=0, chunk_q=cfg.attn_chunk_q,
                                  chunk_k=cfg.attn_chunk_k, window=window,
                                  cap=cfg.attn_softcap)
    a = common.dense(p_attn["wo"], constraints.grad_placed(
        o.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)))
    return a, k, v


def _fill_kv(kv, i: int, k, v) -> None:
    s = k.shape[1]
    kv["k"][i, :, :s] = k.to(torch.bfloat16)
    kv["v"][i, :, :s] = v.to(torch.bfloat16)


def prefill(params, tokens, cfg: ArchConfig, max_len: int, frontend_embeds=None):
    """Full-sequence forward that also fills the serving cache (K/V of the
    attention layers at positions ``[0, S)``, each SSM layer's final
    state).  Returns (last-position logits (B, 1, vocab), cache)."""
    h = _embed_inputs(params, cfg, tokens, frontend_embeds)
    b, s = h.shape[0], h.shape[1]
    if s > max_len:
        raise ValueError(f"prefill of {s} positions into a cache of {max_len}")
    cache = _init_cache_like(cfg, b, max_len, h)
    layers = params["layers"]
    if cfg.family in ("dense", "moe", "vlm"):
        for l in range(cfg.n_layers):
            p = _layer(layers, l)
            a, k, v = _attend_prefill(cfg, p["attn"], _norm(cfg, p["ln1"], h),
                                      _layer_window(cfg, l))
            _fill_kv(cache["kv"], l, k, v)
            h = _ffn(cfg, p, h + a)
    elif cfg.family == "ssm":
        for l in range(cfg.n_layers):
            h, st = _mamba_block(cfg, _layer(layers, l), h, return_state=True)
            _set_layer(cache["ssm"], l, st)
    else:  # hybrid
        sa = params["shared_attn"]
        for seg, (lo, hi) in enumerate(_segments(cfg)):
            a, k, v = _attend_prefill(cfg, sa["attn"], _norm(cfg, sa["ln"], h))
            _fill_kv(cache["kv"], seg, k, v)
            h = h + a
            for l in range(lo, hi):
                h, st = _mamba_block(cfg, _layer(layers, l), h, return_state=True)
                _set_layer(cache["ssm"], l, st)
    return _logits(params, cfg, h[:, -1:]), cache


# ---------------------------------------------------------------------------
# Plaintext twin of the MPC forward
# ---------------------------------------------------------------------------

def _static_norm_ref(p, x):
    y = x * p["scale"]
    return y + p["bias"] if "bias" in p else y


def mpc_reference(params, h: torch.Tensor, cfg: ArchConfig, relu_fn=None):
    """Plaintext reference of the MPC-approximated LM forward: h (B, S,
    d_model) embedded hidden states -> logits (B, S, vocab).  ``relu_fn``
    None evaluates with exact ReLU and plain torch products; a traced or
    reduced-ring relu_fn sees the replay's hook calls in order."""
    _dense_only(cfg)
    relu_fn = approx.ensure_hooks(relu_fn)
    spec = approx.spec_for(cfg.act)
    b, s, _ = h.shape
    dh = cfg.resolved_head_dim
    grp = cfg.n_heads // cfg.n_kv_heads
    positions = torch.arange(s, device=h.device)[None, :]
    for l in range(cfg.n_layers):
        p = _layer(params["layers"], l)
        x = _static_norm_ref(p["ln1"], h)
        q, k, v = attention._project_qkv(p["attn"], x, cfg.n_heads,
                                         cfg.n_kv_heads, dh, positions,
                                         cfg.rope_theta)
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        if grp > 1:
            k = torch.repeat_interleave(k, grp, dim=1)
            v = torch.repeat_interleave(v, grp, dim=1)
        o = approx.relu_attention(q, k, v, 2 * l, relu_fn)
        o = o.permute(0, 2, 1, 3).reshape(b, s, cfg.n_heads * dh)
        h = h + common.dense(p["attn"]["wo"], o)
        x = _static_norm_ref(p["ln2"], h)
        up = torch.einsum("...d,df->...f", x, p["mlp"]["w_up"])
        if "w_gate" in p["mlp"]:
            gate = torch.einsum("...d,df->...f", x, p["mlp"]["w_gate"])
            act = (relu_fn(gate, 2 * l + 1) if spec is None
                   else approx.apply_pwl(spec, gate, 2 * l + 1, relu_fn))
            mid = relu_fn.mul(act, up)
        else:
            mid = (relu_fn(up, 2 * l + 1) if spec is None
                   else approx.apply_pwl(spec, up, 2 * l + 1, relu_fn))
        h = h + torch.einsum("...f,fd->...d", mid, p["mlp"]["w_down"])
    h = _static_norm_ref(params["final_norm"], h)
    return torch.einsum("...d,df->...f", h, params["lm_head"]["w"])


# ---------------------------------------------------------------------------
# Secret-shared forward
# ---------------------------------------------------------------------------

def _static_norm_mpc(p, h, comm):
    y = h.mul_public(p["scale"])
    return y.add_public(p["bias"], comm) if "bias" in p else y


def _mpc_proj(x, wp, n_h: int, dh: int, comm):
    y = x.matmul_public(wp["w"])
    if "b" in wp:
        y = y.add_public(wp["b"], comm)
    return y.reshape(x.shape[0], x.shape[1], n_h, dh)


def _rope_mpc(t, s: int, theta: float):
    """RoPE on a secret (B, S, H, Dh) tensor: cos/sin are public per
    position, so the rotation is four mul_public and two ring combines.
    The float32 tables are the reference's bit for bit, built on the CPU
    and moved to the tensor's device (``nn/rope_tables.py``)."""
    half = t.shape[-1] // 2
    cos, sin = rope_tables.rope_tables(s, t.shape[-1], theta, t.device)  # (S, 1, half)
    x1, x2 = t[..., :half], t[..., half:]
    out1 = x1.mul_public(cos) - x2.mul_public(sin)
    out2 = x2.mul_public(cos) + x1.mul_public(sin)
    return mpc_tensor.concat([out1, out2], axis=-1)


def _lm_mpc_forward(params, hs, cfg: ArchConfig, relu_fn, comm):
    """Secret-shared LM forward over sibling MPCTensor streams (the
    ``register_mpc_forward`` contract): the MPC twin of ``mpc_reference``,
    hook call for hook call."""
    _dense_only(cfg)
    spec = approx.spec_for(cfg.act)
    dh = cfg.resolved_head_dim
    grp = cfg.n_heads // cfg.n_kv_heads
    for l in range(cfg.n_layers):
        p = _layer(params["layers"], l)
        qs, ks, vs = [], [], []
        for h in hs:
            s = h.shape[1]
            x = _static_norm_mpc(p["ln1"], h, comm)
            q = _mpc_proj(x, p["attn"]["wq"], cfg.n_heads, dh, comm)
            k = _mpc_proj(x, p["attn"]["wk"], cfg.n_kv_heads, dh, comm)
            v = _mpc_proj(x, p["attn"]["wv"], cfg.n_kv_heads, dh, comm)
            if cfg.rope_theta:
                q = _rope_mpc(q, s, cfg.rope_theta)
                k = _rope_mpc(k, s, cfg.rope_theta)
            q, k, v = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
            if grp > 1:
                k = k.repeat(grp, axis=1)
                v = v.repeat(grp, axis=1)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        os_ = approx.relu_attention_mpc(qs, ks, vs, 2 * l, relu_fn)
        outs = []
        for h, o in zip(hs, os_):
            b, s = h.shape[0], h.shape[1]
            o = o.transpose(0, 2, 1, 3).reshape(b, s, cfg.n_heads * dh)
            outs.append(h + o.matmul_public(p["attn"]["wo"]["w"]))
        hs = outs
        xs = [_static_norm_mpc(p["ln2"], h, comm) for h in hs]
        ups = [x.matmul_public(p["mlp"]["w_up"]) for x in xs]
        if "w_gate" in p["mlp"]:
            gates = [x.matmul_public(p["mlp"]["w_gate"]) for x in xs]
            acts = (relu_fn(gates, 2 * l + 1) if spec is None
                    else approx.apply_pwl_mpc(spec, gates, 2 * l + 1, relu_fn, comm))
            mids = relu_fn.mul(acts, ups)
        else:
            mids = (relu_fn(ups, 2 * l + 1) if spec is None
                    else approx.apply_pwl_mpc(spec, ups, 2 * l + 1, relu_fn, comm))
        hs = [h + m.matmul_public(p["mlp"]["w_down"]) for h, m in zip(hs, mids)]
    hs = [_static_norm_mpc(params["final_norm"], h, comm) for h in hs]
    return [h.matmul_public(params["lm_head"]["w"]) for h in hs]


def trace(params, cfg: ArchConfig, batch: int, seq: int, hb=None,
          name: str = "") -> Plan:
    """Shape-trace the MPC-approximated LM into a Plan (2 ReLU groups per
    layer, 3 Beaver opens per gated layer), on the ``meta`` device."""
    def afn(p, x, relu_fn=None):
        return mpc_reference(p, x, cfg, relu_fn=relu_fn)

    return trace_plan(afn, params, (batch, seq, cfg.d_model), hb=hb,
                      name=name or cfg.name)


register_mpc_forward(ArchConfig, _lm_mpc_forward)
