"""whisper-small [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].
n_layers is the decoder depth; the encoder has the same depth."""
from .base import ArchConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    head_dim=64, d_ff=3072, vocab=51865,
    n_encoder_layers=12, encoder_frames=1500,
    rope_theta=10_000.0,
    source="arXiv:2212.04356",
)

def smoke():
    return smoke_variant(CONFIG)
