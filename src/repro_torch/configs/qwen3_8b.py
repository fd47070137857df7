"""qwen3-8b [hf:Qwen/Qwen3-8B; hf] — dense, qk_norm, GQA kv=8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12_288,
    vocab_size=151_936, mlp="swiglu", qk_norm=True,
    citation="hf:Qwen/Qwen3-8B",
)
