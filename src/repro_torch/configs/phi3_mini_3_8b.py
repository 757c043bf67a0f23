"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from .base import ArchConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    head_dim=96, d_ff=8192, vocab=32064,
    rope_theta=10_000.0,
    source="arXiv:2404.14219",
)

def smoke():
    return smoke_variant(CONFIG)
