"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained MoE: 2 shared +
64 routed experts, top-6.  (Deviation: DeepSeek's dense first layer is kept
MoE for scan homogeneity — DESIGN.md §4.)"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102_400, head_dim=128, mlp="swiglu",
    n_experts=64, n_shared_experts=2, top_k=6,
    citation="arXiv:2401.06066",
)
