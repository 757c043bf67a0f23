"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from .base import ArchConfig, MoEConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    head_dim=64, d_ff=512, vocab=49155,
    rope_theta=10_000.0, tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, n_shared=0, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

def smoke():
    return smoke_variant(CONFIG)
