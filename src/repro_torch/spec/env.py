"""DraftQuantEnv: the calibration environment of the draft-policy search
(port of ``repro/spec/env.py``).

The controller that allocated the deployed weight bitwidths searches the
draft policy too, for predicted acceptance: the one-step argmax agreement
of the draft re-packing with the deployed packing of the same weights over
calibration prompts (greedy self-speculation accepts a draft token iff it
equals the verify argmax), smoothed by a small relative-logit-divergence
term that orders policies within one agreement plateau.  The Budget bounds
the draft's weight cost.

Kept out of ``spec/__init__``: it imports the training stack
(``quant.env``), which the serving modules must not.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import BitPolicy
from repro_torch.quant import apply as apply_mod
from repro_torch.quant.env import QuantEnvBase

from .draft import build_draft_params

#: weight of the smooth divergence term next to the [0, 1] agreement rate
DIVERGENCE_WEIGHT = 0.05


class DraftQuantEnv(QuantEnvBase):
    """QuantEnv over draft re-packings of one deployed model.

    quality(policy) = argmax agreement - 0.05 * relative logit divergence of
    one decode step on the calibration prompts, the draft containers built
    from the DEPLOYED packed weights (dequantize, re-pack), as the engine
    builds them.  A perfect draft scores 1.0; ``Budget.acc_t`` is the least
    predicted first-token acceptance.  ``params`` is the train-layout float
    tree (statistics and registry), ``serve_params`` its unstacked form; the
    env runs on their device.  ``steps`` counts the decode steps run, each
    through every packed linear of the deployed or a draft tree.
    """

    def __init__(self, params: dict, serve_params: dict, cfg, deployed_policy, calib_tokens, *,
                 cost_model=None, impl: str = "auto"):
        from repro_torch.cost import ShiftAddCostModel
        from repro_torch.models import registry

        self.params = params
        self.cfg = cfg
        self.impl = impl
        self.steps = 0
        self.cost_model = cost_model or ShiftAddCostModel()
        self._specs = apply_mod.layer_specs(params, cfg)
        self._api = registry.get_api(cfg)
        if self._api.decode_verify is None:
            raise ValueError(f"family {cfg.family!r} cannot self-speculate "
                             f"(no burst-rewindable decode state)")
        self._deployed = apply_mod.quantize_for_serve(serve_params, deployed_policy, cfg)
        device = params["embed"].device

        # one calibration prefill with the deployed packing into an fp state
        # one position longer, then the reference step replaying the last token
        with self._span("calibrate", prompts=len(calib_tokens)), torch.no_grad():
            toks = torch.as_tensor(np.asarray(calib_tokens), dtype=torch.long, device=device)
            bc, sc = toks.shape
            _, caches = self._api.prefill(self._deployed, cfg, toks, impl=impl, logits=False)
            self._state = self._api.init_decode_state(cfg, bc, sc + 1, torch.float32,
                                                      device=device)
            for st, new in zip(self._state, caches):
                for side in ("k", "v"):
                    st[side][:, :sc] = new[side].to(st[side].dtype)
            self._next_tok = toks[:, -1:]
            self._pos = torch.full((bc,), sc, dtype=torch.int32, device=device)
            self._ref_logits = self._step_logits(self._deployed)
            self._ref_argmax = torch.argmax(self._ref_logits, dim=-1)
            self._scale = float(torch.mean(torch.abs(self._ref_logits))) or 1.0
            self._probe = None

    @torch.no_grad()
    def _step_logits(self, packed_params) -> torch.Tensor:
        # the step writes position sc of the fp state in place before reading
        # it, so every call sees the calibration rows and its own K/V there
        self.steps += 1
        logits, _ = self._api.decode_step(packed_params, self.cfg, self._state, self._next_tok,
                                          self._pos, impl=self.impl)
        return logits[:, -1].to(torch.float32)

    def _draft_logits(self, policy: BitPolicy) -> torch.Tensor:
        draft, _ = build_draft_params(self._deployed, policy, self.cfg, materialize=False)
        return self._step_logits(draft)

    def _agree(self, lq: torch.Tensor) -> torch.Tensor:
        return torch.mean((torch.argmax(lq, dim=-1) == self._ref_argmax).to(torch.float32))

    # -- QuantEnv protocol ---------------------------------------------------
    def _weight(self, name: str):
        return apply_mod.get_weight(self.params, name)

    def divergence(self, policy: BitPolicy) -> float:
        """Relative one-step logit divergence of the draft re-packing."""
        with self._span("evaluate"):
            lq = self._draft_logits(policy)
            return float(torch.mean(torch.abs(lq - self._ref_logits))) / self._scale

    def agreement(self, policy: BitPolicy) -> float:
        """One-step argmax agreement rate: the predicted greedy acceptance."""
        with self._span("evaluate"):
            return float(self._agree(self._draft_logits(policy)))

    def evaluate(self, policy: BitPolicy) -> float:
        with self._span("evaluate"):
            lq = self._draft_logits(policy)
            div = torch.mean(torch.abs(lq - self._ref_logits)) / self._scale
            return float(self._agree(lq) - DIVERGENCE_WEIGHT * div)

    def sensitivities(self, policy: BitPolicy) -> np.ndarray:
        """Per-layer probe divergence: ONE layer dropped to 4 bits, the rest
        at 8, measured once against the deployed packing and cached.

        The base class's weight statistics rank how much a layer's weight
        distribution distorts; drafting needs how much one layer's
        distortion moves the logits (the embedding is robust by statistics
        but critical for acceptance).
        """
        del policy  # the probe does not depend on the policy (measured at 4 bits)
        if self._probe is None:
            with self._span("probe", layers=len(self._specs)):
                self._probe = np.asarray([
                    self.divergence(BitPolicy.uniform(self._specs, 8).with_bits(s.name, 4))
                    for s in self._specs])
        return self._probe

    def calibrate_and_qat(self, policy: BitPolicy, epochs: int) -> None:
        pass  # post-training: the draft re-packing needs no retraining
