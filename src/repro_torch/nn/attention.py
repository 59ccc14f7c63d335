"""Attention projections of the dense LM (twin of ``attn_init`` and
``_project_qkv`` in the reference's ``nn/attention.py``).  The softmax
attention itself is not needed by the private LM, whose attention is the
ReLU attention of ``nn/approx``."""
from __future__ import annotations

import torch

from . import common


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
    q = common.dense(params["wq"], x).reshape(b, s, n_heads, head_dim)
    k = common.dense(params["wk"], x).reshape(b, s, n_kv, head_dim)
    v = common.dense(params["wv"], x).reshape(b, s, n_kv, head_dim)
    if rope_theta:
        q = common.rope(q, positions, rope_theta)
        k = common.rope(k, positions, rope_theta)
    return q, k, v
