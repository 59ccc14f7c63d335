"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, 8 experts top-2.  [hf:xai-org/grok-1]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab=131072, n_experts=8,
    top_k=2, act="gelu", gated_mlp=True,
)
