"""yi-6b [arXiv:2403.04652; hf] — llama-arch GQA kv=4."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11_008,
    vocab_size=64_000, mlp="swiglu",
    citation="arXiv:2403.04652",
)
