"""mamba2-2.7b [arXiv:2405.21060; unverified] — attention-free SSD."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    citation="arXiv:2405.21060",
)
