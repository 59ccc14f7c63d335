"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, Mamba2 backbone (ssm_state=64) + shared attention blocks.
[arXiv:2411.15242]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, ssm_state=64,
    mamba_version=2, mamba2_head_dim=64, attn_every=6, sub_quadratic=True,
)
