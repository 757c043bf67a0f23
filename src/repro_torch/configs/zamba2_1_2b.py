"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242]. Shared attention is sliding-window so the model stays
sub-quadratic for long_500k."""
from .base import ArchConfig, SSMConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    head_dim=64, d_ff=8192, vocab=32000,
    hybrid_attn_every=6,
    sliding_window=4096,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, chunk=256),
    source="arXiv:2411.15242",
)

def smoke():
    return smoke_variant(CONFIG)
