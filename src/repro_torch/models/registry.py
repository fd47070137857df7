"""Family registry: one uniform API over the ported architectures.

    api = get_api(cfg)
    params = api.init(cfg, generator, device)
    loss   = api.loss(params, cfg, batch, bits=...)        # train / QAT
    logits, state = api.prefill(params_serve, cfg, tokens, ...)
    logits, state = api.decode_step(params_serve, cfg, state, token, pos)
    logits, state, burst_kv = api.decode_verify(params_serve, cfg, state, tokens, pos)
    scratch = api.init_prefill_scratch(cfg, seq, device=device)     # chunked prefill
    scratch = api.prefill_chunk(params_serve, cfg, scratch, tokens, offset)

Every family of the JAX registry is ported: dense, MoE and VLM (the
decoder), SSM (Mamba2), hybrid (Zamba2) and the encoder-decoder families.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import decoder, encdec, hybrid, mamba2
from .decoder import lm_loss_from_hidden


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    unstack: Callable
    prefill: Callable            # accepts lengths= (per-row valid prompt lengths)
    decode_step: Callable
    # (cfg, batch, seq, dtype, abstract, *, state_bits, block, paged, pool_blocks,
    #  device) -> decode state; abstract=True puts it on the meta device
    #  (the dry-run) and refuses a quantized one
    init_decode_state: Callable
    # speculative verify: (params, cfg, state, tokens (B, T), pos (B,)) ->
    # (logits (B, T, V), state, burst_kv); None where the state cannot rewind
    # a burst
    decode_verify: Callable | None = None
    # (params, cfg, batch, *, bits, impl) -> mean cross-entropy (train / QAT)
    loss: Callable | None = None
    # chunked prefill: (cfg, seq, dtype=None, *, device) -> per-layer fp K/V
    # scratch, and (params, cfg, scratch, tokens (1, C), offset, *, impl) ->
    # scratch; None where a family has no KV scratch
    init_prefill_scratch: Callable | None = None
    prefill_chunk: Callable | None = None


def _decoder_state(cfg, batch, seq, dtype=torch.bfloat16, abstract=False, *, state_bits=None,
                   block=None, paged=False, pool_blocks=None, device=None):
    if abstract:
        if state_bits is not None or paged:
            raise NotImplementedError("abstract quantized decode state")
        return decoder.abstract_cache(cfg, batch, seq, dtype)
    return decoder.init_cache(cfg, batch, seq, dtype, state_bits=state_bits, block=block,
                              paged=paged, pool_blocks=pool_blocks, device=device)


def _decoder_loss(params, cfg, batch, *, bits=None, impl="auto"):
    return decoder.lm_loss(params, cfg, batch.get("tokens"), batch["labels"], batch.get("embeds"),
                           bits=bits, impl=impl)


def _mamba_loss(params, cfg, batch, *, bits=None, impl="auto"):
    hidden = mamba2.forward(params, cfg, batch.get("tokens"), batch.get("embeds"), bits=bits,
                            impl=impl)
    return lm_loss_from_hidden(params, cfg, hidden, batch["labels"], bits=bits, impl=impl)


def _mamba_state(cfg, batch, seq, dtype=torch.bfloat16, abstract=False, *, state_bits=None,
                 block=None, paged=False, pool_blocks=None, device=None):
    del seq, dtype, block, pool_blocks
    if state_bits is not None or paged:
        raise ValueError("ssm family has no quantizable KV state")
    if abstract:
        return [mamba2.abstract_state(cfg, batch) for _ in range(cfg.n_layers)]
    return [mamba2.init_state(cfg, batch, device=device) for _ in range(cfg.n_layers)]


def _hybrid_loss(params, cfg, batch, *, bits=None, impl="auto"):
    hidden = hybrid.forward(params, cfg, batch.get("tokens"), batch.get("embeds"), bits=bits,
                            impl=impl)
    return lm_loss_from_hidden(params, cfg, hidden, batch["labels"], bits=bits, impl=impl)


def _hybrid_state(cfg, batch, seq, dtype=torch.bfloat16, abstract=False, *, state_bits=None,
                  block=None, paged=False, pool_blocks=None, device=None):
    del pool_blocks
    if paged:
        raise NotImplementedError(
            "paged KV cache covers the decoder families; the hybrid shared-"
            "attention caches stay dense (DESIGN.md §12)")
    return hybrid.init_decode_state(cfg, batch, seq, dtype, abstract, state_bits=state_bits,
                                    block=block, device=device)


def _encdec_state(cfg, batch, seq, dtype=torch.bfloat16, abstract=False, *, state_bits=None,
                  block=None, paged=False, pool_blocks=None, device=None):
    del block, pool_blocks
    if state_bits is not None or paged:
        raise ValueError("encdec serving has no engine-managed KV state")
    return encdec.init_cache(cfg, batch, seq, dtype, abstract, device=device)


_DECODER_API = ModelAPI(
    init=decoder.init,
    unstack=decoder.unstack_layers,
    prefill=decoder.prefill,
    decode_step=decoder.decode_step,
    init_decode_state=_decoder_state,
    decode_verify=decoder.decode_verify,
    loss=_decoder_loss,
    init_prefill_scratch=decoder.init_prefill_scratch,
    prefill_chunk=decoder.prefill_chunk,
)

# the recurrent state cannot rewind a burst (no decode_verify) nor split a
# prefill bitwise (no prefill_chunk: the engine recomputes the prefix)
_MAMBA_API = ModelAPI(
    init=mamba2.init,
    unstack=mamba2.unstack_layers,
    prefill=mamba2.prefill,
    decode_step=mamba2.decode_step,
    init_decode_state=_mamba_state,
    loss=_mamba_loss,
)

# the same refusals as the SSM family: the recurrent state cannot rewind a
# burst nor split a prefill bitwise (decode_verify and prefill_chunk None)
_HYBRID_API = ModelAPI(
    init=hybrid.init,
    unstack=hybrid.unstack_layers,
    prefill=hybrid.prefill,
    decode_step=hybrid.decode_step,
    init_decode_state=_hybrid_state,
    loss=_hybrid_loss,
)

# whisper serves through prefill(tokens, frames) / decode_step directly (the
# engine refuses the family): prefill takes the frames, not lengths
_ENCDEC_API = ModelAPI(
    init=encdec.init,
    unstack=encdec.unstack_layers,
    prefill=encdec.prefill,
    decode_step=encdec.decode_step,
    init_decode_state=_encdec_state,
    loss=encdec.loss,
)

_REGISTRY = {"dense": _DECODER_API, "moe": _DECODER_API, "vlm": _DECODER_API,
             "ssm": _MAMBA_API, "hybrid": _HYBRID_API, "encdec": _ENCDEC_API,
             "audio": _ENCDEC_API}


def get_api(cfg) -> ModelAPI:
    return _REGISTRY[cfg.family]
