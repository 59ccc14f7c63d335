"""Selective state-space layers: Mamba1 (falcon-mamba) and Mamba2 (zamba2)
(twin of the reference's ``nn/ssm.py``).

Sequence mixing is a chunked scan: the sequence runs in chunks of
``chunk`` steps (the largest exact divisor of S up to ``chunk``), each an
in-chunk log-depth scan over (decay, increment) pairs with the
inter-chunk state carried across.  Decode is a single-step state update.

The in-chunk scan (``_scan``) is a Hillis-Steele doubling scan in torch
ops: ceil(log2(chunk)) steps over the chunk axis, for any chunk length.
It associates the float products and sums otherwise than XLA's
``associative_scan``, so the two agree to float32 rounding (about 1e-6
relative per step), not bit for bit.

State layouts:
  mamba1: h (B, d_inner, N),  conv cache (B, k-1, d_inner)
  mamba2: h (B, H, P, N),     conv cache (B, k-1, d_inner + 2N)

On DTensors (the dry run) the reference's sharding constraints apply (the
inner width over `model`) and the zero states are replicated DTensors;
on plain tensors both are the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import Device, resolve as resolve_device
from ..runtime import constraints
from . import common

_CONV_K = 4


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every h_t of h_t = a_t * h_{t-1} + b_t over axis 1, from h_{-1} = 0:
    the inclusive scan of the pairs (a_t, b_t) under (a1, b1), (a2, b2) ->
    (a2 a1, a2 b1 + b2).  ``a`` broadcasts against ``b``."""
    n = b.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < n:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _pick_chunk(s: int, chunk: int) -> int:
    """Largest chunk <= ``chunk`` that divides s (keeps the scan exact for
    any sequence length)."""
    for cs in range(min(chunk, s), 0, -1):
        if s % cs == 0:
            return cs
    return 1


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); b: (C,)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return y + b


def _conv_step(cache, x_new, w, b):
    """cache: (B, K-1, C); x_new: (B, C) -> (y, new_cache)."""
    full = torch.cat([cache, x_new.to(cache.dtype)[:, None]], dim=1)   # (B, K, C)
    y = common.einsum("bkc,kc->bc", full, w) + b
    return y, full[:, 1:]


def _chunks(s: int, chunk: int):
    cs = _pick_chunk(s, chunk)
    return [slice(i, i + cs) for i in range(0, s, cs)]


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba-7b): per-channel diagonal A, data-dependent dt/B/C
# ---------------------------------------------------------------------------

def mamba1_init(gen: torch.Generator, d_model: int, n_state: int, expand: int = 2,
                dt_rank: int = 0, dtype=torch.float32):
    di = expand * d_model
    dt_rank = dt_rank or max(1, d_model // 16)
    dev = gen.device
    a = torch.arange(1, n_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": common.dense_init(gen, d_model, 2 * di, dtype),
        "conv_w": torch.randn((_CONV_K, di), generator=gen, dtype=dtype, device=dev) * 0.1,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": common.dense_init(gen, di, dt_rank + 2 * n_state, dtype),
        "dt_proj": {"w": torch.randn((dt_rank, di), generator=gen, dtype=dtype,
                                     device=dev) * 0.1,
                    "b": torch.full((di,), -4.6, dtype=dtype, device=dev)},
        "a_log": torch.log(a.expand(di, n_state)).to(dtype),
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": common.dense_init(gen, di, d_model, dtype),
    }


def _mamba1_core(p, xc, dt_rank: int, n_state: int):
    """Shared projections: (decay, inc, c_t) of the conv'd input xc."""
    proj = common.dense(p["x_proj"], xc)
    dt_in, b_t, c_t = torch.split(proj, [dt_rank, n_state, n_state], dim=-1)
    dt = F.softplus(common.einsum("...r,rd->...d", dt_in, p["dt_proj"]["w"])
                    + p["dt_proj"]["b"])
    a = -torch.exp(p["a_log"].to(torch.float32))                   # (Di, N)
    decay = torch.exp(dt[..., None] * a)                           # (..., Di, N)
    inc = (dt * xc)[..., None] * b_t[..., None, :]                 # (..., Di, N)
    return decay, inc, c_t


def mamba1(p, x, *, n_state: int, chunk: int = 128, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) [, final decode state]."""
    b, s, _ = x.shape
    di = p["conv_w"].shape[1]
    dt_rank = p["x_proj"]["w"].shape[1] - 2 * n_state
    xz = constraints.shard(common.dense(p["in_proj"], x), "dp", None, "tp")  # d_inner TP
    xr, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xr, p["conv_w"], p["conv_b"]))
    h = constraints.shard(constraints.like(
        torch.zeros((b, di, n_state), dtype=torch.float32, device=x.device), x),
        "dp", "tp", None)
    ys = []
    for sl in _chunks(s, chunk):
        decay, inc, c_t = _mamba1_core(p, xc[:, sl].to(torch.float32), dt_rank,
                                       n_state)
        inc = constraints.shard(inc, "dp", None, "tp", None)
        inc[:, 0] += decay[:, 0] * h
        hs = _scan(decay, inc)
        ys.append(torch.einsum("bldn,bln->bld", hs, c_t.to(torch.float32)))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + xc * p["d_skip"]
    y = y * F.silu(z)
    out = common.dense(p["out_proj"], y)
    if return_state:
        return out, {"h": h, "conv": xr[:, -(_CONV_K - 1):].to(torch.float32)}
    return out


def mamba1_init_state(batch: int, d_inner: int, n_state: int,
                      device: Device = None):
    device = resolve_device(device)
    return {"h": torch.zeros((batch, d_inner, n_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, _CONV_K - 1, d_inner), dtype=torch.float32,
                                device=device)}


def mamba1_decode(p, x, state, *, n_state: int):
    """x: (B, 1, D) -> (y, new_state).  O(1) per token."""
    dt_rank = p["x_proj"]["w"].shape[1] - 2 * n_state
    xr, z = common.dense(p["in_proj"], x[:, 0]).chunk(2, dim=-1)
    xc, conv = _conv_step(state["conv"], xr, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)          # float32 (the conv cache's); cast back after the skip
    decay, inc, c_t = _mamba1_core(p, xc.to(torch.float32), dt_rank, n_state)
    # the state's own split (the cache's): batch over dp, d_inner over tp
    h = constraints.shard(decay * state["h"] + inc, "dp", "tp", None)
    y = torch.einsum("bdn,bn->bd", h, c_t.to(torch.float32))
    y = (y + xc * p["d_skip"].to(torch.float32)).to(x.dtype)
    y = y * F.silu(z)
    return common.dense(p["out_proj"], y)[:, None], {"h": h, "conv": conv}


# ---------------------------------------------------------------------------
# Mamba2 (zamba2): scalar decay per head, SSD-style heads
# ---------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, d_model: int, n_state: int,
                head_dim: int = 64, expand: int = 2, dtype=torch.float32):
    di = expand * d_model
    n_heads = di // head_dim
    dev = gen.device
    return {
        "in_proj": common.dense_init(gen, d_model, 2 * di + 2 * n_state + n_heads,
                                     dtype),
        "conv_w": torch.randn((_CONV_K, di + 2 * n_state), generator=gen,
                              dtype=dtype, device=dev) * 0.1,
        "conv_b": torch.zeros((di + 2 * n_state,), dtype=dtype, device=dev),
        "a_log": torch.zeros((n_heads,), dtype=dtype, device=dev),
        "dt_bias": torch.full((n_heads,), -4.6, dtype=dtype, device=dev),
        "d_skip": torch.ones((n_heads,), dtype=dtype, device=dev),
        "norm": common.rmsnorm_init(di, dtype, dev),
        "out_proj": common.dense_init(gen, di, d_model, dtype),
    }


def _mamba2_split(p, x, di: int, n_state: int):
    """in_proj, split into (z, xBC, dt_in)."""
    zxbcdt = common.dense(p["in_proj"], x)
    n_heads = zxbcdt.shape[-1] - 2 * di - 2 * n_state
    return torch.split(zxbcdt, [di, di + 2 * n_state, n_heads], dim=-1)


def mamba2(p, x, *, n_state: int, head_dim: int = 64, chunk: int = 64,
           return_state: bool = False):
    b, s, _ = x.shape
    di = p["out_proj"]["w"].shape[0]
    n_heads = di // head_dim
    z, xbc_raw, dt_in = _mamba2_split(p, x, di, n_state)
    z = constraints.shard(z, "dp", None, "tp")
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xr, b_t, c_t = torch.split(xbc, [di, n_state, n_state], dim=-1)
    xr = constraints.shard(xr, "dp", None, "tp")
    dt = F.softplus(dt_in + p["dt_bias"]).to(torch.float32)           # (B, S, H)
    a = -torch.exp(p["a_log"].to(torch.float32))                      # (H,)
    decay = torch.exp(dt * a)                                         # (B, S, H)
    xh = xr.reshape(b, s, n_heads, head_dim).to(torch.float32)
    inc = (dt[..., None] * xh)[..., None] * b_t[:, :, None, None, :]  # (B, S, H, P, N)
    h = constraints.shard(constraints.like(
        torch.zeros((b, n_heads, head_dim, n_state), dtype=torch.float32,
                    device=x.device), x), "dp", "tp", None, None)
    ys = []
    for sl in _chunks(s, chunk):
        dec_k = decay[:, sl]
        inc_k = constraints.shard(inc[:, sl].clone(), "dp", None, "tp", None, None)
        inc_k[:, 0] += dec_k[:, 0, :, None, None] * h
        hs = _scan(dec_k[..., None, None], inc_k)
        ys.append(torch.einsum("blhpn,bln->blhp", hs, c_t[:, sl].to(torch.float32)))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + xh * p["d_skip"][:, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = common.rmsnorm(p["norm"], y * F.silu(z))
    out = common.dense(p["out_proj"], y)
    if return_state:
        return out, {"h": h, "conv": xbc_raw[:, -(_CONV_K - 1):].to(torch.float32)}
    return out


def mamba2_init_state(batch: int, d_inner: int, n_state: int, head_dim: int = 64,
                      device: Device = None):
    device = resolve_device(device)
    n_heads = d_inner // head_dim
    return {"h": torch.zeros((batch, n_heads, head_dim, n_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_K - 1, d_inner + 2 * n_state),
                                dtype=torch.float32, device=device)}


def mamba2_decode(p, x, state, *, n_state: int, head_dim: int = 64):
    b = x.shape[0]
    di = p["out_proj"]["w"].shape[0]
    n_heads = di // head_dim
    z, xbc, dt_in = _mamba2_split(p, x[:, 0], di, n_state)
    xbc, conv = _conv_step(state["conv"], xbc, p["conv_w"], p["conv_b"])
    xr, b_t, c_t = torch.split(F.silu(xbc), [di, n_state, n_state], dim=-1)
    dt = F.softplus(dt_in + p["dt_bias"]).to(torch.float32)
    a = -torch.exp(p["a_log"].to(torch.float32))
    decay = torch.exp(dt * a)                                         # (B, H)
    xh = xr.reshape(b, n_heads, head_dim).to(torch.float32)
    inc = (dt[..., None] * xh)[..., None] * b_t[:, None, None, :]
    # the state's own split (the cache's): batch over dp, heads over tp
    h = constraints.shard(decay[..., None, None] * state["h"] + inc, "dp", "tp", None, None)
    y = torch.einsum("bhpn,bn->bhp", h, c_t.to(torch.float32))
    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(b, di).to(x.dtype)
    y = common.rmsnorm(p["norm"], y * F.silu(z))
    return common.dense(p["out_proj"], y)[:, None], {"h": h, "conv": conv}
