"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import ArchConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    head_dim=128, d_ff=28672, vocab=32768,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

def smoke():
    return smoke_variant(CONFIG)
