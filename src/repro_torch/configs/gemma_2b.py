"""gemma-2b [arXiv:2403.08295; hf] — dense, GeGLU, MQA (kv=1), head_dim=256."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16_384,
    vocab_size=256_000, head_dim=256, mlp="geglu", tie_embeddings=True,
    citation="arXiv:2403.08295",
)
