"""Elastic mesh planning: shrink or grow the data axis when the device count
changes (a copy of ``repro/runtime/elastic.py``).

Policy (DESIGN.md §7): the model axis is load-bearing (TP shards must all be
present), so elasticity happens on the data/pod axes.  On failure of ``f``
hosts we re-plan to the largest feasible data axis, restore the latest
checkpoint (mesh-independent npz), and the stateless data pipeline re-slices
by the new (host_id, n_hosts) — no epoch bookkeeping to repair.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_devices: int, *, model: int = 16, pods: int = 1) -> MeshPlan:
    """Largest (pod, data, model) plan that fits ``n_devices`` healthy chips.

    The data axis absorbs the loss: data = floor(n / (model*pods)).  Raises
    if even one data row doesn't fit (model axis is not elastic).
    """
    if n_devices < model * pods:
        raise ValueError(f"{n_devices} devices cannot host model={model} x pods={pods}")
    data = n_devices // (model * pods)
    if pods > 1:
        return MeshPlan((pods, data, model), ("pod", "data", "model"))
    return MeshPlan((data, model), ("data", "model"))


def replan_after_failure(plan: MeshPlan, n_failed: int) -> MeshPlan:
    """Shrink the data axis after losing ``n_failed`` devices."""
    pods = plan.shape[0] if len(plan.shape) == 3 else 1
    model = plan.shape[-1]
    return plan_mesh(plan.n_devices - n_failed, model=model, pods=pods)


def batch_for_plan(global_batch: int, plan: MeshPlan) -> int:
    """Largest per-step batch <= global_batch divisible by the batch axes."""
    rows = plan.n_devices // plan.shape[-1]  # pod*data
    return (global_batch // rows) * rows
