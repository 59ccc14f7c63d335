"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; InternViT frontend is a stub providing precomputed patch
embeddings per the brief.  [arXiv:2404.16821]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, act="silu",
    gated_mlp=True, frontend="vision", n_frontend_tokens=256,
)
