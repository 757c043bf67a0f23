"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""
from .base import ArchConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    head_dim=64, d_ff=8192, vocab=128256,
    rope_theta=500_000.0, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)

def smoke():
    return smoke_variant(CONFIG)
