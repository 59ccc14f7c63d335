"""Encoder-decoder transformer, the seamless-m4t backbone (twin of the
reference's ``models/encdec.py``).

The audio frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, d_model).  The decoder is a causal transformer with
cross-attention into the encoder memory; sinusoidal positions, no RoPE.
Weights are in the reference's tree layout (``enc_layers`` and
``dec_layers`` stacked on axis 0), carried across by
``lm.params_from_jax``.  The serving cache holds the decoder's self K/V
(written in place by ``decode_step``) and each layer's cross K/V of the
memory, all in bfloat16.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..device import Device, resolve as resolve_device
from ..nn import attention, common
from ..runtime import constraints, sharding
from .lm import (_dtype, _layer, _layers, _norm, _norm_init, _stack,
                 padded_vocab, params_from_jax)

__all__ = ["init", "encode", "apply", "init_cache", "prefill", "decode_step",
           "params_from_jax"]


def _sin_posenc(s: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    pe = torch.zeros((s, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)


def _enc_layer_init(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    d, dt = cfg.d_model, _dtype(cfg)
    return {
        "ln1": _norm_init(cfg, d, gen.device),
        "attn": attention.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, dtype=dt),
        "ln2": _norm_init(cfg, d, gen.device),
        "mlp": common.mlp_init(gen, d, cfg.d_ff, cfg.gated_mlp, dt),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    p = _enc_layer_init(gen, cfg)
    p["ln_x"] = _norm_init(cfg, cfg.d_model, gen.device)
    p["xattn"] = attention.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, dtype=_dtype(cfg))
    return p


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random params in the reference's layout, drawn from ``generator`` on
    its device."""
    dt, dev, vocab = _dtype(cfg), generator.device, padded_vocab(cfg)
    return {
        "embed": common.embed_init(generator, vocab, cfg.d_model, dt),
        "enc_layers": _stack([_enc_layer_init(generator, cfg)
                              for _ in range(cfg.n_enc_layers)]),
        "dec_layers": _stack([_dec_layer_init(generator, cfg)
                              for _ in range(cfg.n_layers)]),
        "enc_norm": _norm_init(cfg, cfg.d_model, dev),
        "final_norm": _norm_init(cfg, cfg.d_model, dev),
        "lm_head": common.dense_init(generator, cfg.d_model, vocab, dt),
    }


def _self_attn_full(cfg: ArchConfig, p, x, causal: bool):
    b, s, _ = x.shape
    q, k, v = attention._project_qkv(
        p, x, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
        constraints.like(torch.arange(s, device=x.device)[None, :], x), cfg.rope_theta)
    if causal:
        o = attention.flash_attention(q, k, v, q_offset=0, chunk_q=cfg.attn_chunk_q,
                                      chunk_k=cfg.attn_chunk_k)
    else:
        o = _bidir_attention(q, k, v)
    return common.dense(p["wo"], o.reshape(b, s, -1))


def _softmax_attend(q, k, v, n_kv: int):
    """Unmasked attention in float32.  q: (B, Sq, H, Dh); k, v: (B, Sk, K,
    Dh) -> (B, Sq, H, Dh) float32."""
    b, s, h, dh = q.shape
    qh = constraints.splittable(q, 2, n_kv).reshape(b, s, n_kv, h // n_kv, dh).to(
        torch.float32)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qh, k.to(torch.float32)) * dh ** -0.5
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(b, s, h, dh)


def _bidir_attention(q, k, v):
    return _softmax_attend(q, k, v, k.shape[2]).to(q.dtype)


def _cross_attn(cfg: ArchConfig, p, x, mem_k, mem_v):
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = constraints.splittable(common.dense(p["wq"], x), -1, cfg.n_heads).reshape(
        b, s, cfg.n_heads, dh)
    o = _softmax_attend(q, mem_k, mem_v, cfg.n_kv_heads)
    return common.dense(p["wo"], o.reshape(b, s, cfg.n_heads * dh).to(x.dtype))


def encode(params, src_embeds, cfg: ArchConfig):
    """src_embeds: (B, S_src, D) stub frame embeddings -> encoder memory."""
    h = src_embeds + constraints.like(_sin_posenc(
        src_embeds.shape[1], cfg.d_model, src_embeds.dtype, src_embeds.device),
        src_embeds)
    for p in _layers(params["enc_layers"], cfg.n_enc_layers):
        h = h + _self_attn_full(cfg, p["attn"], _norm(cfg, p["ln1"], h), causal=False)
        h = h + common.mlp(p["mlp"], _norm(cfg, p["ln2"], h), cfg.act)
    return _norm(cfg, params["enc_norm"], h)


def _memory_kv(params, memory, cfg: ArchConfig):
    """Every decoder layer's cross-attention K/V of the encoder memory,
    stacked: (L, B, S_src, K, Dh) each."""
    b, s, _ = memory.shape
    shape = (b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    ks, vs = [], []
    for p in _layers(params["dec_layers"], cfg.n_layers):
        xp = p["xattn"]
        ks.append(common.dense(xp["wk"], memory).reshape(shape))
        vs.append(common.dense(xp["wv"], memory).reshape(shape))
    return torch.stack(ks), torch.stack(vs)


def _dec_block(cfg: ArchConfig, p, h, self_attn, mem_k, mem_v):
    h = h + self_attn(_norm(cfg, p["ln1"], h))
    h = h + _cross_attn(cfg, p["xattn"], _norm(cfg, p["ln_x"], h), mem_k, mem_v)
    return h + common.mlp(p["mlp"], _norm(cfg, p["ln2"], h), cfg.act)


def apply(params, src_embeds, tgt_tokens, cfg: ArchConfig):
    """(B, S_src, D) embeds + (B, S_tgt) ids -> logits (B, S_tgt, vocab)."""
    memory = encode(params, src_embeds, cfg)
    mem_k, mem_v = _memory_kv(params, memory, cfg)
    h = common.embed(params["embed"], tgt_tokens)
    h = h + constraints.like(_sin_posenc(h.shape[1], cfg.d_model, h.dtype, h.device), h)
    for l, p in enumerate(_layers(params["dec_layers"], cfg.n_layers)):
        h = _dec_block(cfg, p, h,
                       lambda x, p=p: _self_attn_full(cfg, p["attn"], x, causal=True),
                       mem_k[l], mem_v[l])
    h = _norm(cfg, params["final_norm"], h)
    return common.dense(params["lm_head"], h)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, src_len: int,
               device: Device = None):
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    mem = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    zeros = lambda s: torch.zeros(s, dtype=torch.bfloat16, device=device)
    return {"self_kv": {"k": zeros(shape), "v": zeros(shape)},
            "mem_k": zeros(mem), "mem_v": zeros(mem)}


def _init_cache_like(cfg: ArchConfig, batch: int, max_len: int, src):
    """``init_cache`` on ``src``'s device; for a DTensor ``src``, DTensors on
    its mesh placed by the cache rules."""
    mesh = constraints.mesh_of(src)
    if mesh is None:
        return init_cache(cfg, batch, max_len, src.shape[1], src.device)
    return sharding.cache_zeros(init_cache(cfg, batch, max_len, src.shape[1], "meta"),
                                cfg, mesh, src.device)


def prefill(params, src_embeds, cfg: ArchConfig, batch: int, max_len: int):
    """Encode the source and build the decoder's cache (cross K/V, empty
    self K/V)."""
    memory = encode(params, src_embeds, cfg)
    mem_k, mem_v = _memory_kv(params, memory, cfg)
    cache = _init_cache_like(cfg, batch, max_len, src_embeds)
    cache["mem_k"] = mem_k.to(torch.bfloat16)
    cache["mem_v"] = mem_v.to(torch.bfloat16)
    return cache


def decode_step(params, token, cache, pos: int, cfg: ArchConfig):
    """token: (B, 1) ids at position ``pos`` -> (logits (B, 1, vocab),
    cache), the self K/V updated in place."""
    max_len = cache["self_kv"]["k"].shape[2]
    h = common.embed(params["embed"], token)
    pe = constraints.like(_sin_posenc(max_len, cfg.d_model, h.dtype, h.device), h)
    h = h + pe[attention.cache_slot(pos, max_len)][None]
    for l in range(cfg.n_layers):
        p = _layer(params["dec_layers"], l)

        def self_attn(x):
            return attention.attention_decode(
                p["attn"], x, _layer(cache["self_kv"], l), pos, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta)[0]

        h = _dec_block(cfg, p, h, self_attn, cache["mem_k"][l], cache["mem_v"][l])
    h = _norm(cfg, params["final_norm"], h)
    return common.dense(params["lm_head"], h), cache
