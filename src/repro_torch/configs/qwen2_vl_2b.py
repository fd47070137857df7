"""qwen2-vl-2b [arXiv:2409.12191; hf] — VLM backbone, M-RoPE; vision
frontend stubbed (input_specs feeds precomputed patch+text embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151_936, mlp="swiglu", rope="mrope", input_kind="embeddings",
    citation="arXiv:2409.12191",
)
