"""zamba2-2.7b [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention
block every 6 layers; shared block attends over a 4096 sliding window at
long-context decode (DESIGN.md §4 deviation note)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10_240,
    vocab_size=32_000, mlp="swiglu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6, attn_window=4096,
    citation="arXiv:2411.15242",
)
