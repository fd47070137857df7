"""Family registry: one uniform API over the ported architectures.

    api = get_api(cfg)
    params = api.init(cfg, generator, device)
    loss   = api.loss(params, cfg, batch, bits=...)        # train / QAT
    logits, state = api.prefill(params_serve, cfg, tokens, ...)
    logits, state = api.decode_step(params_serve, cfg, state, token, pos)
    logits, state, burst_kv = api.decode_verify(params_serve, cfg, state, tokens, pos)
    scratch = api.init_prefill_scratch(cfg, seq, device=device)     # chunked prefill
    scratch = api.prefill_chunk(params_serve, cfg, scratch, tokens, offset)

Only the dense family is ported; the others raise and name the ROADMAP
item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import decoder
from .decoder import lm_loss_from_hidden  # noqa: F401  (the JAX registry's name)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    unstack: Callable
    prefill: Callable            # accepts lengths= (per-row valid prompt lengths)
    decode_step: Callable
    # (cfg, batch, seq, dtype, *, state_bits, block, paged, pool_blocks, device)
    #   -> decode state
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


def _decoder_state(cfg, batch, seq, dtype=torch.bfloat16, *, state_bits=None, block=None,
                   paged=False, pool_blocks=None, device=None):
    return decoder.init_cache(cfg, batch, seq, dtype, state_bits=state_bits, block=block,
                              paged=paged, pool_blocks=pool_blocks, device=device)


def _decoder_loss(params, cfg, batch, *, bits=None, impl="auto"):
    return decoder.lm_loss(params, cfg, batch["tokens"], batch["labels"], bits=bits, impl=impl)


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

_NOT_PORTED = {
    "moe": "ROADMAP queue 1, 'Other model families' (models/moe.py)",
    "vlm": "ROADMAP queue 1, 'Other model families' (M-RoPE)",
    "ssm": "ROADMAP queue 1, 'Other model families' (models/mamba2.py)",
    "hybrid": "ROADMAP queue 1, 'Other model families' (models/hybrid.py)",
    "encdec": "ROADMAP queue 1, 'Other model families' (models/encdec.py)",
    "audio": "ROADMAP queue 1, 'Other model families' (models/encdec.py)",
}


def get_api(cfg) -> ModelAPI:
    if cfg.family == "dense":
        return _DECODER_API
    where = _NOT_PORTED.get(cfg.family, "ROADMAP queue 1")
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet: {where}")
