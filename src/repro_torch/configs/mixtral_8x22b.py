"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768, n_experts=8,
    top_k=2, act="silu", gated_mlp=True, sliding_window=4096,
    sub_quadratic=True,
)
