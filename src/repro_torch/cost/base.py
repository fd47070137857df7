"""The CostModel seam: one interface, swappable hardware backends (port of
``repro/cost/base.py``).

SigmaQuant's differentiator (paper §I, §VI-E) is re-running the *same* cheap
two-phase search against a different hardware condition — memory size, energy
budget, latency requirement — by swapping the cost backend, not retraining a
hardware-baked loss (contrast Schaefer et al., arXiv:2206.07741).  This module
defines the vector every backend produces (``CostReport``) and the protocol
the allocator consumes (``CostModel``); the two shipped backends are

  * :class:`repro_torch.cost.shift_add.ShiftAddCostModel` — the paper-fidelity
    28 nm shift-add MAC PPA model (Table VI / Fig. 5 units);
  * :class:`repro_torch.cost.roofline.RooflineCostModel` — the serving
    model (HBM-bytes/FLOPs roofline over packed container bytes, seconds and
    joules), priced on the port's H100 spec.

``Budget`` items (core/policy.py) name metrics of this vector, so one search
can constrain any subset of memory/energy/latency/BOPs simultaneously.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Protocol, runtime_checkable

from repro_torch.core.policy import BitPolicy


@dataclasses.dataclass(frozen=True)
class CostReport:
    """One policy priced on one backend.

    Units are backend-defined and documented per backend: size/container are
    always bytes and BOPs always bit-operations; ``energy``/``latency_s`` are
    INT8-normalized ratios on the shift-add backend and joules/seconds on the
    roofline backend.  Budgets are stated in the backend's units.
    """

    size_bytes: float        # logical weight bytes (paper Tables II/III metric)
    container_bytes: float   # packed HBM bytes the serving path actually moves
    bops: float              # sum_l B_w(l) * B_a(l) * MACs(l)
    energy: float            # backend units (see class docstring)
    latency_s: float         # backend units (see class docstring)
    state_bytes: float = 0.0  # packed decode-state bytes (kind=="state" layers)
    backend: str = ""
    detail: Mapping[str, float] = dataclasses.field(default_factory=dict)

    @property
    def size_mib(self) -> float:
        return self.size_bytes / 2**20

    def as_costs(self) -> dict[str, float]:
        """The metric mapping Budget items index into (core/policy.COST_METRICS)."""
        return {
            "size_bytes": float(self.size_bytes),
            "size_mib": float(self.size_mib),
            "container_bytes": float(self.container_bytes),
            "state_bytes": float(self.state_bytes),
            "bops": float(self.bops),
            "energy": float(self.energy),
            "latency_s": float(self.latency_s),
        }


@runtime_checkable
class CostModel(Protocol):
    """What the allocator needs from a hardware backend."""

    name: str

    def report(self, policy: BitPolicy) -> CostReport:
        """Price a full per-layer bit assignment."""
        ...


_REGISTRY: dict[str, Callable[..., CostModel]] = {}


def register_cost_model(name: str, factory: Callable[..., CostModel]) -> None:
    _REGISTRY[name] = factory


def get_cost_model(name: str, **kwargs) -> CostModel:
    """Instantiate a backend by name ("shift_add", "roofline")."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown cost model {name!r} (have: {sorted(_REGISTRY)})")
    return _REGISTRY[name](**kwargs)


def available_cost_models() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
