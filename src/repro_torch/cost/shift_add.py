"""Shift-add MAC analytical PPA backend (paper §III-B, §VI-E, Table VI, Fig. 5;
port of ``repro/cost/shift_add.py``, pure numpy).

The paper evaluates SigmaQuant on a generic 8-bit x n-bit shift-add MAC
(TSMC 28 nm, 0.9 V, 600 MHz).  This is the *paper-fidelity* cost backend — it
reproduces Table VI areas exactly and fits the Fig. 5 energy/latency deltas.

Model:
  * latency: a naive n-bit shift-add multiply takes n cycles; trailing-zero
    skipping halves that on average  ->  cycles/MAC = max(1, B_w / 2).
    The 1-cycle INT8 MAC is the baseline (Fig. 5 normalization).
  * energy:  E(B_w) = alpha + beta * B_w per MAC, normalized to INT8 = 1.
    (alpha, beta) are fitted to the paper's reported uniform-quantization
    deltas: A8W2 -> -25.0%, A8W4 -> -13.8% vs INT8 (§VI-E, ResNet34), giving
    alpha = 0.638, beta = 0.056. Predicted A8W6 = -2.6%, A8W8 = +8.6%
    (paper: A8W8 "similar energy, 4.2x slower" — consistent).
  * area: Table VI, TSMC 28nm  um^2.

``CostReport`` units for this backend: ``energy`` and ``latency_s`` are
INT8-MAC-normalized ratios (the Fig. 5 axes), not joules/seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core.policy import BitPolicy

from .base import CostReport, register_cost_model

#: Table VI — MAC implementation areas (um^2, TSMC 28 nm)
AREA_UM2: Mapping[str, float] = {
    "fp32": 3218.3,
    "fp16": 3837.9,
    "bf16": 3501.9,
    "int8": 2103.4,
    "shift_add": 1635.4,
}

#: fitted energy model (per-MAC, INT8-normalized): E(b) = ALPHA + BETA * b
ENERGY_ALPHA = 0.638
ENERGY_BETA = 0.056

#: energy overhead of fp formats vs INT8 (§VI-E: "up to 5.5x / 4.0x / 3.6x")
FP_ENERGY_X = {"fp32": 5.5, "fp16": 4.0, "bf16": 3.6}


def area_saving_vs_int8() -> float:
    """Paper headline: shift-add saves 22.3% area over INT8."""
    return 1.0 - AREA_UM2["shift_add"] / AREA_UM2["int8"]


def mac_cycles(w_bits: int | np.ndarray) -> np.ndarray:
    """Cycles per MAC on the shift-add unit (trailing-zero skipping ~ n/2)."""
    return np.maximum(1.0, np.asarray(w_bits, dtype=np.float64) / 2.0)


def mac_energy(w_bits: int | np.ndarray) -> np.ndarray:
    """Energy per MAC, normalized to the 1-cycle INT8 MAC."""
    return ENERGY_ALPHA + ENERGY_BETA * np.asarray(w_bits, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class HardwareReport:
    """Whole-model PPA for one policy, INT8-MAC-normalized (Fig. 5 axes)."""

    energy: float   # relative to INT8 hardware running the same MACs
    latency: float  # relative cycle count
    area_um2: float
    model_size_mib: float
    bops: float

    def energy_saving(self) -> float:
        return 1.0 - self.energy

    def latency_overhead(self) -> float:
        return self.latency - 1.0


def evaluate_policy(policy: BitPolicy, impl: str = "shift_add") -> HardwareReport:
    """Price a mixed-precision model on the shift-add MAC (Fig. 5 points).

    INT8 baseline: every MAC costs 1 cycle / 1 energy unit on INT8 hardware.
    """
    macs = np.asarray([l.macs for l in policy.layers], dtype=np.float64)
    bits = policy.bit_vector().astype(np.float64)
    total_macs = float(macs.sum()) or 1.0
    if impl == "int8":
        energy = latency = 1.0
    elif impl == "shift_add":
        energy = float((macs * mac_energy(bits)).sum() / total_macs)
        latency = float((macs * mac_cycles(bits)).sum() / total_macs)
    elif impl in FP_ENERGY_X:
        energy = FP_ENERGY_X[impl]
        latency = 1.0
    else:
        raise ValueError(f"unknown MAC impl {impl!r}")
    return HardwareReport(
        energy=energy,
        latency=latency,
        area_um2=AREA_UM2["shift_add" if impl == "shift_add" else impl],
        model_size_mib=policy.model_size_mib(),
        bops=policy.bops(),
    )


def uniform_sweep(layers, act_bits: int = 8) -> dict[str, HardwareReport]:
    """A8W{2,4,6,8} uniform points (Fig. 5 light markers) on shift-add."""
    out = {}
    for b in (2, 4, 6, 8):
        pol = BitPolicy.uniform(layers, b, act_bits)
        out[f"A{act_bits}W{b}"] = evaluate_policy(pol, "shift_add")
    return out


class ShiftAddCostModel:
    """The paper's edge-accelerator backend behind the ``CostModel`` seam.

    energy / latency_s are INT8-MAC-normalized ratios; size / container /
    BOPs come straight from the policy's packing accountants, so budgets
    written against the old scalar ``resource()`` objectives price
    identically here.

    Decode-state layers (kind=="state") price into the separate
    ``state_bytes`` term; their MACs still ride the shift-add energy/latency
    ladder (an n-bit KV operand costs the MAC exactly what an n-bit weight
    does on this unit), while the weight metrics exclude them.
    """

    name = "shift_add"

    def __init__(self, impl: str = "shift_add"):
        if impl != "int8" and impl not in AREA_UM2:
            raise ValueError(f"unknown MAC impl {impl!r}")
        self.impl = impl

    def report(self, policy: BitPolicy) -> CostReport:
        rep = evaluate_policy(policy, self.impl)
        return CostReport(
            size_bytes=policy.model_size_bytes(),
            container_bytes=policy.container_bytes(),
            state_bytes=policy.state_bytes(),
            bops=rep.bops,
            energy=rep.energy,
            latency_s=rep.latency,
            backend=self.name,
            detail={"area_um2": rep.area_um2})


register_cost_model("shift_add", ShiftAddCostModel)
