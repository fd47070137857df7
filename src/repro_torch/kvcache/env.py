"""KVQuantEnv: the calibration environment of the state-bitwidth search
(port of ``repro/kvcache/env.py``).

One calibration prefill captures the fp K/V every state entry sees; a
candidate state policy (a ``BitPolicy`` over the ``kind="state"`` registry
of ``kvcache/policy.py``) is scored by the logit divergence of ONE decode
step on the quantized state against the same step on the fp state.
Post-training: ``calibrate_and_qat`` does nothing.

Kept out of ``kvcache/__init__``: it imports the training stack
(``quant.env``), which the serving modules must not.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import BitPolicy
from repro_torch.quant.env import QuantEnvBase

from .cache import DEFAULT_BLOCK, insert_state_rows
from .policy import KV_FAMILIES, extract_kv_entries, resolve_state_bits, state_layer_infos


class KVQuantEnv(QuantEnvBase):
    """QuantEnv over the decode state of one served model.

    quality(policy) = -(mean |logits_quant - logits_fp| / mean |logits_fp|)
    of one decode step on the calibration prompts: 0 is a perfect state, and
    the budget's ``acc_t`` is minus the tolerated relative logit error.  The
    env runs on the device of ``serve_params``; ``steps`` counts the decode
    steps run on a quantized state.
    """

    def __init__(self, serve_params: dict, cfg, calib_tokens, *, slots: int, max_seq: int,
                 block: int = DEFAULT_BLOCK, cost_model=None, impl: str = "auto",
                 allocated_tokens: int | None = None):
        from repro_torch.cost import ShiftAddCostModel
        from repro_torch.models import registry

        if cfg.family not in KV_FAMILIES:
            raise ValueError(f"family {cfg.family!r} has no quantizable KV state")
        self.params = serve_params
        self.cfg = cfg
        self.block = block
        self.impl = impl
        self.cost_model = cost_model or ShiftAddCostModel()
        self.device = getattr(serve_params["embed"], "packed", serve_params["embed"]).device
        self.steps = 0
        self._api = registry.get_api(cfg)
        # allocated_tokens prices a paged pool's live blocks instead of the
        # dense (slots, max_seq) worst case; fidelity is still scored on a
        # dense cache, whose blocks hold the paged pool's bytes
        self._specs = state_layer_infos(cfg, slots, max_seq, allocated_tokens=allocated_tokens)

        with self._span("calibrate", prompts=len(calib_tokens)), torch.no_grad():
            toks = torch.as_tensor(np.asarray(calib_tokens), dtype=torch.long,
                                   device=self.device)
            bc, sc = toks.shape
            self._calib_batch, self._calib_len, self._max_seq = bc, sc, max_seq
            _, self._caches = self._api.prefill(serve_params, cfg, toks, impl=impl)
            self._capture = {}
            for nm, node in extract_kv_entries(self._caches):
                self._capture[f"{nm}.state.k"] = node["k"]
                self._capture[f"{nm}.state.v"] = node["v"]
            # the fp-state reference step replays the last calibration token
            # at the next position, as the engine's decode step does
            self._next_tok = toks[:, -1:]
            self._pos = torch.full((bc,), sc, dtype=torch.int32, device=self.device)
            self._fp_logits = self._decode_logits(None)
            self._fp_scale = float(torch.mean(torch.abs(self._fp_logits))) or 1.0

    # -- state construction --------------------------------------------------
    def _build_state(self, state_policy: BitPolicy | None):
        bc = self._calib_batch
        state = self._api.init_decode_state(
            self.cfg, bc, self._max_seq, torch.float32,
            state_bits=resolve_state_bits(state_policy, self.cfg), block=self.block,
            device=self.device)
        lens = torch.full((bc,), self._calib_len, dtype=torch.int32, device=self.device)
        return insert_state_rows(state, torch.arange(bc, device=self.device), self._caches,
                                 lens)

    @torch.no_grad()
    def _decode_logits(self, state_policy: BitPolicy | None) -> torch.Tensor:
        self.steps += state_policy is not None
        logits, _ = self._api.decode_step(self.params, self.cfg, self._build_state(state_policy),
                                          self._next_tok, self._pos, impl=self.impl)
        return logits[:, -1].to(torch.float32)

    # -- QuantEnv protocol ---------------------------------------------------
    def _weight(self, name: str):
        return self._capture[name]

    def evaluate(self, policy: BitPolicy) -> float:
        with self._span("evaluate"):
            lq = self._decode_logits(policy)
            return -float(torch.mean(torch.abs(lq - self._fp_logits))) / self._fp_scale

    def calibrate_and_qat(self, policy: BitPolicy, epochs: int) -> None:
        pass  # post-training: the packed state needs no retraining

    def fp_state_bytes(self) -> int:
        """fp32 cache bytes of the same geometry (the baseline the budget cuts)."""
        return int(sum(4 * np.prod(l.shape) for l in self._specs))
