"""Roofline cost backend: price a BitPolicy's serving step in seconds and
joules (port of ``repro/cost/roofline.py``), on the port's H100 spec.

The per-layer container bytes that ``core/packing`` says the packed weights
occupy in HBM are priced through ``roofline``'s compute and memory terms.
Per serving step (default: decode, ``batch`` sequences, one token each):

  flops     = 2 * MACs(l) * batch                      per layer
  hbm bytes = container_bytes(l)                       weights stream once
            + batch * (K + N) * act_bytes              activations in/out
  compute_s = flops / peak ;  memory_s = bytes / hbm_bw
  latency_s = max(compute_s, memory_s)                 (roofline bound)
  energy    = bytes * pj_per_byte + flops * pj_per_flop    [joules]

Decode is memory-bound on weight container bytes, so a latency budget on this
backend pushes the search toward small containers (6 bits pack one a byte,
as 8 do), where the shift-add backend rewards small logical bits.
"""
from __future__ import annotations

from repro_torch.core import packing
from repro_torch.core.policy import BitPolicy
from repro_torch.roofline.model import H100_SXM, HwSpec, roofline_terms

from .base import CostReport, register_cost_model

#: order-of-magnitude HBM-class energy constants (per byte moved from HBM, per
#: bf16 FLOP), tied to no chip.  Absolute joules are indicative; relative
#: energy across policies, which a Budget constrains, follows bytes and FLOPs.
PJ_PER_HBM_BYTE = 15.0
PJ_PER_FLOP = 0.3


class RooflineCostModel:
    """Price a policy's serving step on the HBM/FLOPs roofline.

    ``batch``     sequences per decode step (rows of every GEMV);
    ``act_bytes`` bytes per activation element (2 = bf16);
    ``n_chips``   chips the step is sharded over (weights divide evenly).
    """

    name = "roofline"

    def __init__(self, hw: HwSpec = H100_SXM, *, batch: int = 1, act_bytes: int = 2,
                 n_chips: int = 1, pj_per_byte: float = PJ_PER_HBM_BYTE,
                 pj_per_flop: float = PJ_PER_FLOP):
        self.hw = hw
        self.batch = batch
        self.act_bytes = act_bytes
        self.n_chips = n_chips
        self.pj_per_byte = pj_per_byte
        self.pj_per_flop = pj_per_flop

    def _layer_bytes(self, shape: tuple[int, ...], bits: int) -> float:
        weight = packing.container_bytes(shape, bits)
        k, n = (shape[-2], shape[-1]) if len(shape) >= 2 else (shape[0], 1)
        return weight + self.batch * (k + n) * self.act_bytes

    def report(self, policy: BitPolicy) -> CostReport:
        flops = 0.0
        hbm_bytes = 0.0
        for l in policy.weight_layers():
            flops += 2.0 * l.macs * self.batch
            hbm_bytes += self._layer_bytes(l.shape, policy.bits[l.name])
        # decode-state layers: the packed KV container is re-read on every
        # decode step, so its bytes price into latency and energy as weight
        # bytes do; attention MACs ride the FLOPs term
        state_bytes = 0.0
        for l in policy.state_layers():
            flops += 2.0 * l.macs
            state_bytes += packing.container_bytes(l.shape, policy.bits[l.name])
        hbm_bytes += state_bytes
        terms = roofline_terms(flops / self.n_chips, hbm_bytes / self.n_chips,
                               0.0, self.n_chips, self.hw)
        energy_j = (hbm_bytes * self.pj_per_byte + flops * self.pj_per_flop) * 1e-12
        return CostReport(
            size_bytes=policy.model_size_bytes(),
            container_bytes=policy.container_bytes(),
            state_bytes=state_bytes,
            bops=policy.bops(),
            energy=energy_j,
            latency_s=terms.bound_s,
            backend=self.name,
            detail={"compute_s": terms.compute_s, "memory_s": terms.memory_s,
                    "hbm_bytes": hbm_bytes, "flops": flops})


register_cost_model("roofline", RooflineCostModel)
