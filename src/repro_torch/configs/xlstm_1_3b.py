"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from .base import ArchConfig, SSMConfig, smoke_variant

CONFIG = ArchConfig(
    arch_id="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    head_dim=512, d_ff=0, vocab=50304,
    slstm_every=8,                      # 7x mLSTM + 1x sLSTM per group
    ssm=SSMConfig(kind="mlstm", chunk=256),
    source="arXiv:2405.04517",
)

def smoke():
    return smoke_variant(CONFIG)
