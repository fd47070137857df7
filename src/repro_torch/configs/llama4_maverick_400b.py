"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
— MoE 128 experts top-1 + 1 shared expert, early fusion."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202_048, mlp="swiglu",
    n_experts=128, n_shared_experts=1, top_k=1,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
