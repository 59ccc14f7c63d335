"""falcon-mamba-7b [ssm]: 64L d_model=4096, attn-free Mamba1, ssm_state=16,
vocab=65024.  [arXiv:2410.05355]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024, ssm_state=16,
    ssm_expand=2, mamba_version=1, sub_quadratic=True,
)
