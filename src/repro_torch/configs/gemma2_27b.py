"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; local/global alternating attention, logit softcaps.
[arXiv:2408.00118]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense", n_layers=46, d_model=4608,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256000,
    act="gelu", gated_mlp=True, logit_softcap=30.0, attn_softcap=50.0,
    sliding_window=4096, local_global_period=2,
)
