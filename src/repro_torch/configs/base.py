"""Architecture + shape configuration system.

Every assigned architecture gets one ``<id>.py`` exporting ``CONFIG`` (the
exact published spec) — tests run ``CONFIG.reduced()``.  ``SHAPES`` are the
four assigned input cells.  A copy, as data, of ``repro/configs/base.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # None -> d_model // n_heads
    mlp: str = "swiglu"          # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    qk_norm: bool = False
    rope: str = "default"        # default | mrope | learned | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Zamba2) ---
    attn_every: int = 0          # shared attention block applied every k layers
    attn_window: int = 0         # sliding window for the shared block (0 = full)
    # --- enc-dec (Whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0         # precomputed frame embeddings length
    # --- frontend stubs ---
    input_kind: str = "tokens"   # tokens | embeddings (vlm/audio stubs feed embeddings)
    # --- numerics ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family: tiny but structurally true."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(self.n_layers, 2 if self.attn_every == 0 else self.attn_every)),
            d_model=128,
            n_heads=max(2, min(self.n_heads, 4)),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32 if self.head_dim else None,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            attn_every=2 if self.attn_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}
