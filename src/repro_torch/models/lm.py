"""Private inference of the dense decoder LM (twin of the private-inference
part of the reference's ``models/lm.py``).

The MPC lowering replaces every transformer nonlinearity with a
reduced-ring composition (``nn/approx``): SiLU/GELU become knot-stacked
ReLU sums, softmax becomes ReLU + a public causal-mean normalization, and
rms/layer norms become their static-scale approximation (x * scale: the
data-dependent rsqrt has no cheap GMW circuit).  ``mpc_reference`` is the
plaintext twin of ``_lm_mpc_forward``: it makes the same relu_fn /
.matmul / .mul hook calls in the same order, so ``trace()`` prices the
replay (ReLU groups: 2 per layer, the attention scores then the MLP
activation; Beaver opens: QK^T, A@V, gate*up per layer).  The input is the
*embedded* hidden states (B, S, d_model): the token lookup happens
client-side in the clear.

Weights are a params tree in the reference's layout (``layers`` leaves
stacked on a leading layer axis, projections [in, out]), so trees carry
across with ``params_from_jax``.  Only the dense family is lowered; the
plaintext ``apply``/``prefill``/``decode_step``, flash attention, MoE and
SSM are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..api import Plan, register_mpc_forward, trace_plan
from ..configs.base import ArchConfig
from ..core import mpc_tensor
from ..device import Device, resolve as resolve_device
from ..nn import approx, attention, common, rope_tables


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab rounded up to a multiple of 16, as the reference."""
    return -(-cfg.vocab // 16) * 16


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _norm_init(cfg: ArchConfig, d: int, dtype, device):
    return (common.layernorm_init(d, dtype, device) if cfg.norm == "layernorm"
            else common.rmsnorm_init(d, dtype, device))


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(
            f"MPC lowering covers the dense family only, not {cfg.family!r} "
            "(other families: ROADMAP queue 1, item 11)")


def _stack(trees):
    """Stack a list of equal-structure param trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked params tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random params of a dense-family LM in the reference's tree layout,
    drawn from ``generator`` on its device (the reference's init scales:
    N(0, 1/d_in) projections, zero biases, unit norm scales, N(0, 0.02^2)
    embeddings).  Other families raise ``ValueError``."""
    _dense_only(cfg)
    dt, dev, d = _dtype(cfg), generator.device, cfg.d_model
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": _norm_init(cfg, d, dt, dev),
            "attn": attention.attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, cfg.qkv_bias, dt),
            "ln2": _norm_init(cfg, d, dt, dev),
            "mlp": common.mlp_init(generator, d, cfg.d_ff, cfg.gated_mlp, dt),
        })
    vocab = padded_vocab(cfg)
    return {
        "embed": {"table": torch.randn((vocab, d), generator=generator, dtype=dt,
                                       device=dev) * 0.02},
        "layers": _stack(layers),
        "final_norm": _norm_init(cfg, d, dt, dev),
        "lm_head": common.dense_init(generator, d, vocab, dt),
    }


def params_from_jax(np_tree, device: Device = None) -> Dict[str, Any]:
    """The reference's ``lm.init`` tree, as numpy arrays, -> the port's tree
    on ``device`` (default the GPU): same keys, ``layers`` leaves still
    stacked on axis 0, same dtypes (bfloat16 leaves stay bfloat16)."""
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
