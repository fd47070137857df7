"""Family registry: one uniform API over the ported architectures.

    api = get_api(cfg)
    params = api.init(cfg, generator, device)
    logits, state = api.prefill(params_serve, cfg, tokens, ...)
    logits, state = api.decode_step(params_serve, cfg, state, token, pos)

Only the dense family is ported; the others raise and name the ROADMAP
item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import decoder


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    unstack: Callable
    prefill: Callable            # accepts lengths= (per-row valid prompt lengths)
    decode_step: Callable
    # (cfg, batch, seq, dtype, *, state_bits, block, device) -> decode state
    init_decode_state: Callable


def _decoder_state(cfg, batch, seq, dtype=torch.bfloat16, *, state_bits=None, block=None,
                   device=None):
    return decoder.init_cache(cfg, batch, seq, dtype, state_bits=state_bits, block=block,
                              device=device)


_DECODER_API = ModelAPI(
    init=decoder.init,
    unstack=decoder.unstack_layers,
    prefill=decoder.prefill,
    decode_step=decoder.decode_step,
    init_decode_state=_decoder_state,
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
