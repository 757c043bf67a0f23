"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
experts [arXiv:2401.06066]."""
from .base import ArchConfig, MoEConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    head_dim=128, d_ff=1408, vocab=102400,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    source="arXiv:2401.06066",
)

def smoke():
    return smoke_variant(CONFIG)
