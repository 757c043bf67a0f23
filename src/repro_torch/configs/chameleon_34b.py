"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].
Image tokens are ordinary ids inside the 65536 vocab (early fusion); the
VQ-GAN tokenizer is the permitted stub. qk-norm per the paper."""
from .base import ArchConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=22016, vocab=65536,
    qk_norm=True, rope_theta=10_000.0,
    source="arXiv:2405.09818",
)

def smoke():
    return smoke_variant(CONFIG)
