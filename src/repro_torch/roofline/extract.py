"""Roofline inputs from a traced run (the port's twin of
``repro/roofline/extract.py``).

The reference reads ``cost_analysis()`` and parses collectives out of the
optimized HLO; the port reads the :class:`~repro_torch.roofline.hlo_cost.Trace`
that ``CostMode`` recorded.  Each collective counts its result bytes,
weighted on the wire by the reference's factors:

    all-gather          1      (each rank receives ~the full output once)
    all-reduce          2      (ring = reduce-scatter + all-gather)
    reduce-scatter      1
    all-to-all          1
    collective-permute  1
    broadcast           1

The totals are one device's (the trace is one rank's run).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from .hlo_cost import _WIRE_FACTOR, Trace, _nbytes, analyze


@dataclasses.dataclass
class CollectiveStats:
    by_kind_bytes: dict[str, float]
    by_kind_count: dict[str, int]

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.by_kind_bytes.get(k, 0.0) * _WIRE_FACTOR[k]
                   for k in self.by_kind_bytes)

    @property
    def total_raw_bytes(self) -> float:
        return sum(self.by_kind_bytes.values())


def collective_bytes(trace: Trace | list) -> CollectiveStats:
    """Sum the result bytes of every collective in a trace, by kind."""
    by_bytes: dict[str, float] = defaultdict(float)
    by_count: dict[str, int] = defaultdict(int)
    for rec in getattr(trace, "records", trace):
        kind = rec.get("coll")
        if kind:
            by_bytes[kind] += sum(_nbytes(t) for t in rec["out"])
            by_count[kind] += 1
    return CollectiveStats(dict(by_bytes), dict(by_count))


def cost_summary(trace: Trace) -> dict:
    """flops / bytes and per-device memory of a traced run.

    ``argument_bytes`` is what the caller stored in ``trace.meta`` (the local
    shards' bytes of the step's arguments); ``temp_bytes`` is the live peak
    that the recording mode saw of the tensors the step made, and
    ``peak_bytes`` their sum.  It leaves out the allocator's rounding and
    fragmentation, library workspaces and communication buffers.
    """
    cost = analyze(trace)
    out = {"flops": cost.flops, "bytes": cost.bytes}
    if "argument_bytes" in trace.meta:
        out["argument_bytes"] = float(trace.meta["argument_bytes"])
        out["temp_bytes"] = float(trace.peak_live_bytes)
        out["peak_bytes"] = out["argument_bytes"] + out["temp_bytes"]
    return out
