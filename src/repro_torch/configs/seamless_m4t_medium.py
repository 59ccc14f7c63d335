"""seamless-m4t-medium [audio]: enc-dec, 12L d_model=1024 16H d_ff=4096
vocab=256206; audio frontend is a stub providing precomputed frame
embeddings per the brief.  [arXiv:2308.11596]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206, n_enc_layers=12,
    act="relu", gated_mlp=False, norm="layernorm", frontend="audio",
    rope_theta=0.0,
)
