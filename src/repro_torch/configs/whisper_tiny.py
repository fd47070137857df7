"""whisper-tiny [arXiv:2212.04356; unverified] — enc-dec audio backbone,
conv frontend stubbed (input_specs feeds precomputed frame embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51_865, mlp="gelu", norm="layernorm", rope="none",
    n_encoder_layers=4, encoder_seq=1500, input_kind="tokens",
    citation="arXiv:2212.04356",
)
