"""Architecture config schema + the input-shape suite (a copy of the
reference's ``configs/base.py``: plain dataclasses, no jax)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    sliding_window: int = 0
    local_global_period: int = 0  # gemma2: alternate local/global attention
    n_experts: int = 0
    top_k: int = 0
    ssm_state: int = 0
    ssm_expand: int = 2
    mamba_version: int = 0
    mamba2_head_dim: int = 64
    attn_every: int = 0           # zamba2: shared attention block period
    n_enc_layers: int = 0         # enc-dec only
    frontend: str = "none"        # none | audio | vision (stub embeddings)
    n_frontend_tokens: int = 0
    sub_quadratic: bool = False   # eligible for long_500k
    norm: str = "rmsnorm"
    dtype: str = "bfloat16"
    # substrate knobs
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    ssm_chunk: int = 128
    moe_capacity_factor: float = 1.25
    train_microbatches: int = 1
    remat: str = "dots"           # none | dots | dots_all | full

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def has_attention(self) -> bool:
        return self.family not in ("ssm",)

    def param_count(self) -> int:
        """Total params (for roofline MODEL_FLOPS)."""
        d, v, l = self.d_model, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        emb = v * d * 2  # embed + head (untied)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            per_layer += attn if self.family != "hybrid" else 0
        if self.family in ("dense", "vlm", "encdec"):
            mult = 3 if self.gated_mlp else 2
            per_layer += mult * d * self.d_ff
        if self.family == "moe":
            mult = 3 if self.gated_mlp else 2
            per_layer += self.n_experts * mult * d * self.d_ff + d * self.n_experts
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            n = self.ssm_state
            if self.mamba_version == 1:
                dt_rank = max(1, d // 16)
                per_layer += d * 2 * di + di * (dt_rank + 2 * n) + dt_rank * di \
                    + di * n + 2 * di + di * d
            else:
                nh = di // self.mamba2_head_dim
                per_layer += d * (2 * di + 2 * n + nh) + di * d + di
        total = emb + l * per_layer
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            total += self.n_enc_layers * (attn + 2 * d * self.d_ff) + l * attn
        if self.family == "hybrid" and self.attn_every:
            hd2 = self.resolved_head_dim
            total += d * hd2 * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd2 * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, l = self.d_model, self.n_layers
        mult = 3 if self.gated_mlp else 2
        dense_ffn = l * self.n_experts * mult * d * self.d_ff
        active_ffn = l * self.top_k * mult * d * self.d_ff
        return self.param_count() - dense_ffn + active_ffn


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Which (architecture, shape) cells run, and why a cell is skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic"
    return True, ""


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    heads = 4
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=heads,
        n_kv_heads=max(1, heads // kv_ratio),
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        n_experts=min(cfg.n_experts, 4),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        mamba2_head_dim=16,
        sliding_window=16 if cfg.sliding_window else 0,
        attn_every=2 if cfg.attn_every else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
        attn_chunk_q=16,
        attn_chunk_k=16,
        ssm_chunk=16,
        dtype="float32",
        remat="none",
    )
