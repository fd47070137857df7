"""Input construction per (architecture x shape) cell (port of
``repro/launch/specs.py``).

``abstract=True`` returns tensors on the ``meta`` device with the keys,
shapes and dtypes of the reference's ``ShapeDtypeStruct`` stand-ins (the
multi-pod dry-run: shardable, nothing allocated).  ``abstract=False`` draws
small concrete batches from an explicit ``torch.Generator`` on its device,
for smoke tests and examples (the reference draws from ``jax.random``, which
has no PyTorch twin: only the distribution is the same).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import registry


def _float_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _arr(shape, dtype, abstract: bool, generator=None, kind: str = "normal", maxval=None):
    if abstract:
        return torch.empty(shape, dtype=dtype, device="meta")
    if generator is None:
        raise ValueError("abstract=False draws from a torch.Generator; pass generator=")
    if kind == "tokens":
        return torch.randint(0, maxval, shape, generator=generator, device=generator.device,
                             dtype=dtype)
    return (torch.randn(shape, generator=generator, device=generator.device) * 0.02).to(dtype)


def train_batch(cfg: ArchConfig, shape: ShapeSpec, *, abstract: bool = True,
                generator: torch.Generator | None = None) -> dict:
    """Batch tree for train_step (tokens/labels, embeds, frames per family)."""
    b, s = shape.global_batch, shape.seq_len
    vocab = cfg.vocab_size
    dt = _float_dtype(cfg)
    batch: dict = {}
    if cfg.family in ("audio", "encdec"):
        batch["frames"] = _arr((b, cfg.encoder_seq, cfg.d_model), dt, abstract, generator)
        batch["tokens"] = _arr((b, s), torch.int32, abstract, generator, "tokens", vocab)
        batch["labels"] = _arr((b, s), torch.int32, abstract, generator, "tokens", vocab)
        return batch
    if cfg.input_kind == "embeddings":  # vlm: precomputed patch+text embeddings
        batch["embeds"] = _arr((b, s, cfg.d_model), dt, abstract, generator)
    else:
        batch["tokens"] = _arr((b, s), torch.int32, abstract, generator, "tokens", vocab)
    batch["labels"] = _arr((b, s), torch.int32, abstract, generator, "tokens", vocab)
    return batch


def prefill_inputs(cfg: ArchConfig, shape: ShapeSpec, *, abstract: bool = True,
                   generator: torch.Generator | None = None) -> dict:
    b, s = shape.global_batch, shape.seq_len
    dt = _float_dtype(cfg)
    if cfg.family in ("audio", "encdec"):
        return {
            "frames": _arr((b, cfg.encoder_seq, cfg.d_model), dt, abstract, generator),
            "tokens": _arr((b, s), torch.int32, abstract, generator, "tokens", cfg.vocab_size),
        }
    if cfg.input_kind == "embeddings":
        return {"embeds": _arr((b, s, cfg.d_model), dt, abstract, generator)}
    return {"tokens": _arr((b, s), torch.int32, abstract, generator, "tokens", cfg.vocab_size)}


def decode_inputs(cfg: ArchConfig, shape: ShapeSpec, *, abstract: bool = True,
                  generator: torch.Generator | None = None) -> dict:
    """token + position + decode state (KV caches of seq_len / SSM states)."""
    b, s = shape.global_batch, shape.seq_len
    api = registry.get_api(cfg)
    dt = _float_dtype(cfg)
    if abstract:
        state = api.init_decode_state(cfg, b, s, dt, True)
        pos = torch.empty((), dtype=torch.int32, device="meta")
    else:
        if generator is None:
            raise ValueError("abstract=False draws from a torch.Generator; pass generator=")
        state = api.init_decode_state(cfg, b, s, dt, device=generator.device)
        pos = torch.tensor(s - 1, dtype=torch.int32, device=generator.device)
    token = _arr((b, 1), torch.int32, abstract, generator, "tokens", cfg.vocab_size)
    return {"state": state, "token": token, "pos": pos}
