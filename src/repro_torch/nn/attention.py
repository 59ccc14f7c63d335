"""GQA attention with RoPE, sliding windows, logit softcap and KV caches
(twin of the reference's ``nn/attention.py``).

Training and prefill use the reference's flash-style chunked attention:
an unrolled loop over query chunks, an inner loop over key/value chunks
``0..i`` only (block-level causal skipping) and an online softmax in
float32.  Decode attends one new token against the whole cache, masked to
``cache[: pos + 1]`` (and the sliding window).  On DTensors the
reference's sharding constraints pin the chunks (``runtime/constraints``:
sequence-parallel attention over `model`, a context-parallel decode
cache), and the positions, masks and accumulator inits become replicated
DTensors; on plain tensors both are the identity.

The cache is written in place: ``attention_decode`` stores the new K/V at
``pos`` in the tensors of ``cache`` and returns the same dict (the
reference returns a new one).  A position outside the cache raises,
where the reference's ``dynamic_update_slice`` clamps it to the last
slot.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..device import Device, resolve as resolve_device
from ..runtime import constraints
from . import common

NEG_INF = -2.0e38


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, qkv_bias: bool = False, dtype=torch.float32):
    return {
        "wq": common.dense_init(gen, d_model, n_heads * head_dim, dtype,
                                with_bias=qkv_bias),
        "wk": common.dense_init(gen, d_model, n_kv * head_dim, dtype,
                                with_bias=qkv_bias),
        "wv": common.dense_init(gen, d_model, n_kv * head_dim, dtype,
                                with_bias=qkv_bias),
        "wo": common.dense_init(gen, n_heads * head_dim, d_model, dtype),
    }


def _project_qkv(params, x, n_heads: int, n_kv: int, head_dim: int,
                 positions, rope_theta: float):
    """x: (B, S, d) -> q (B, S, H, Dh), k and v (B, S, n_kv, Dh), RoPE on
    q and k when ``rope_theta``."""
    b, s, _ = x.shape
    proj = lambda w, n: constraints.splittable(common.dense(w, x), -1, n).reshape(
        b, s, n, head_dim)
    q = proj(params["wq"], n_heads)
    k = proj(params["wk"], n_kv)
    v = proj(params["wv"], n_kv)
    if rope_theta:
        q = common.rope(q, positions, rope_theta)
        k = common.rope(k, positions, rope_theta)
    return q, k, v


def _chunk_scores(q, k, scale: float, cap: float):
    """q: (B, Cq, K, G, Dh); k: (B, Ck, K, Dh) -> (B, K, G, Cq, Ck)."""
    s = torch.einsum("bqkgd,bckd->bkgqc", q, k) * scale
    return common.softcap(s, cap)


def flash_attention(q, k, v, *, q_offset: int, chunk_q: int, chunk_k: int,
                    window: Optional[int] = None, cap: float = 0.0) -> torch.Tensor:
    """Causal chunked attention.  q: (B, S, H, Dh); k, v: (B, S, K, Dh).

    Sequences that don't divide the chunk sizes are padded at the end;
    padded keys sit at positions past every real query, so the causal mask
    removes them, and padded query rows are sliced off the output.
    """
    b, s_real, h, dh = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scale = dh ** -0.5
    cq = min(chunk_q, s_real)
    ck = min(chunk_k, s_real)
    mult = cq * ck // math.gcd(cq, ck)
    pad = (-s_real) % mult
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    s = s_real + pad
    nq, nk = s // cq, s // ck
    qc = constraints.splittable(constraints.splittable(q, 1, nq), 2, n_kv).reshape(
        b, nq, cq, n_kv, g, dh)
    kc = constraints.splittable(k, 1, nk).reshape(b, nk, ck, n_kv, dh)
    vc = constraints.splittable(v, 1, nk).reshape(b, nk, ck, n_kv, dh)
    # sequence-parallel attention over `model`: each shard computes all
    # heads for a slice of the query chunk; k/v chunks are replicated over
    # model (the reference's constraints; the softmax stays local)
    kc = constraints.shard(kc, "dp", None, None, None, None)
    vc = constraints.shard(vc, "dp", None, None, None, None)
    dev = q.device
    out = []
    for iq in range(nq):            # block-level causal skipping
        q_i = constraints.shard(qc[:, iq].to(torch.float32), "dp", "tp", None, None, None)
        q_pos = q_offset + iq * cq + torch.arange(cq, device=dev)
        init = lambda shape, fill: constraints.like(
            torch.full(shape, fill, dtype=torch.float32, device=dev), q_i)
        m = constraints.shard(init((b, n_kv, g, cq), NEG_INF), "dp", None, None, "tp")
        l = constraints.shard(init((b, n_kv, g, cq), 0.0), "dp", None, None, "tp")
        acc = constraints.shard(init((b, n_kv, g, cq, dh), 0.0),
                                "dp", None, None, "tp", None)
        for jk in range(iq * cq // ck + 1):     # kv chunks visible to chunk iq
            k_pos = jk * ck + torch.arange(ck, device=dev)
            sc = _chunk_scores(q_i, kc[:, jk].to(torch.float32), scale, cap)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            sc = torch.where(constraints.like(mask, sc), sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, vc[:, jk].to(torch.float32))
            m = m_new
        o = acc / torch.clamp_min(l[..., None], 1e-30)
        out.append(constraints.grad_placed(o.permute(0, 3, 1, 2, 4).reshape(b, cq, h, dh)))
    return torch.cat(out, dim=1).to(q.dtype)[:, :s_real]


def attention(params, x, *, n_heads: int, n_kv: int, head_dim: int,
              positions=None, rope_theta: float = 10000.0,
              window: Optional[int] = None, cap: float = 0.0,
              chunk_q: int = 512, chunk_k: int = 1024) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill)."""
    b, s, _ = x.shape
    if positions is None:
        positions = constraints.like(torch.arange(s, device=x.device)[None, :], x)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions,
                           rope_theta)
    o = flash_attention(q, k, v, q_offset=0, chunk_q=chunk_q, chunk_k=chunk_k,
                        window=window, cap=cap)
    return common.dense(params["wo"],
                        constraints.grad_placed(o.reshape(b, s, n_heads * head_dim)))


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device: Device = None) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    return {"k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                             device=device)}


def cache_slot(pos: int, max_len: int) -> int:
    """``pos`` as a cache index; raises outside ``[0, max_len)``."""
    pos = int(pos)
    if not 0 <= pos < max_len:
        raise IndexError(f"position {pos} outside the cache's {max_len} slots")
    return pos


def _cache_constraint(t):
    """Context-parallel decode: batch over dp, the *sequence* over tp; with
    a batch too small for dp (long_500k, B = 1) the sequence over both."""
    if constraints.axis_divides("dp", t.shape[0]):
        return constraints.shard(t, "dp", "tp", None, None)
    return constraints.shard(t, None, ("dp", "tp"), None, None)


def _write_slot(cache_t, pos: int, new) -> None:
    """``cache_t[:, pos] = new``, in place.  On a DTensor cache (its
    sequence dim split over ranks) the rank whose block holds ``pos``
    writes it into its local block."""
    mesh = constraints.mesh_of(cache_t)
    if mesh is None:
        cache_t[:, pos] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    off, block = constraints.block_of(cache_t, 1)      # this rank's slots
    if not off <= pos < off + block:
        return
    # the slot's placements: the cache's, with the sequence dim dropped
    want = [Replicate() if p == Shard(1) else
            Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
            for p in cache_t.placements]
    cache_t.to_local()[:, pos - off] = new.redistribute(mesh, want).to_local()


def attention_decode(params, x, cache, pos: int, *, n_heads: int, n_kv: int,
                     head_dim: int, rope_theta: float = 10000.0,
                     window: Optional[int] = None, cap: float = 0.0):
    """One-token decode.  x: (B, 1, D); ``pos``: the current position.

    Writes the token's K/V into ``cache`` at ``pos`` (in place) and attends
    over ``cache[: pos + 1]`` by masking.  Returns (y, cache).
    """
    b = x.shape[0]
    s_max = cache["k"].shape[1]
    pos = cache_slot(pos, s_max)
    positions = constraints.like(torch.full((b, 1), pos, device=x.device), x)
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv, head_dim,
                                   positions, rope_theta)
    _write_slot(cache["k"], pos, k_new[:, 0].to(cache["k"].dtype))
    _write_slot(cache["v"], pos, v_new[:, 0].to(cache["v"].dtype))
    k_cache, v_cache = _cache_constraint(cache["k"]), _cache_constraint(cache["v"])
    g = n_heads // n_kv
    qh = constraints.splittable(q, 2, n_kv).reshape(b, 1, n_kv, g, head_dim).to(
        torch.float32)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qh,
                      k_cache.to(torch.float32)) * head_dim ** -0.5
    sc = common.softcap(sc, cap)
    kpos = torch.arange(s_max, device=x.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    p = torch.softmax(torch.where(constraints.like(mask, sc), sc, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.to(torch.float32))
    o = constraints.grad_placed(o.reshape(b, 1, n_heads * head_dim)).to(x.dtype)
    return common.dense(params["wo"], o), cache
