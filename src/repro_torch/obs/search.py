"""Search-side observability: the structured SearchReport and artifact
provenance (port of ``repro/obs/search.py``).

The controller (``core/controller.py``) builds one :class:`SearchReport` per
run — per-iteration history, per-layer final sigma/sensitivity/bits/
container bytes, phase timings — whether or not the tracer is on; its
``digest()`` hashes the decision content only and is the same in both
packages for the same decisions.  :func:`build_provenance` assembles the v6
``PolicyArtifact`` payload.  When the process tracer is on, the controller
and the envs add spans in :data:`PHASE_CAT` (run, phases, iterations) and
:data:`WORK_CAT` (env work: evaluate, QAT, pretrain, statistics), and
:func:`search_trace_report` attributes the traced wall time to the work
spans (``launch/search.py --trace``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from . import trace as trace_mod

#: trace category for structural search spans (run root / phases / iterations)
PHASE_CAT = "search.phase"
#: trace category for leaf work spans (env evaluate / QAT / stats / calib)
WORK_CAT = "search.work"
#: the Perfetto track (thread lane) every search-side event lands on
TRACK = "search"


@dataclasses.dataclass
class IterationRecord:
    """One controller iteration: the measured point and what was decided."""

    phase: int                 # 0 init, 1 clustering, 2 KL refinement
    step: int
    acc: float
    zone: str
    note: str
    bits: dict                 # layer -> candidate bits at this iteration
    costs: dict                # metric -> value (the measured cost vector)
    violations: dict           # metric -> normalized overshoot (0 = ok)
    wall_s: float = 0.0        # iteration wall time (excluded from digest)
    env_s: dict = dataclasses.field(default_factory=dict)  # env call -> s


@dataclasses.dataclass
class LayerRecord:
    """Final per-layer allocation: the sigma/KL signal and what it bought."""

    name: str
    kind: str
    bits: int
    sigma: float
    sensitivity: float
    container_bytes: int
    cost_share: float          # container_bytes / sum over the registry


@dataclasses.dataclass
class SearchReport:
    """Everything one controller run decided and why, structured.

    ``digest()`` hashes the decision content only (iterations without wall
    times, final layers, outcome) — two identical searches produce identical
    digests even though their wall clocks differ.
    """

    phase_name: str            # "weight" | "state" | "draft" | ...
    success: bool
    abandoned: bool
    acc: float
    costs: dict
    iterations: list
    layers: list
    phase_timings: dict = dataclasses.field(default_factory=dict)
    total_s: float = 0.0
    env_s: float = 0.0

    def iteration_counts(self) -> dict:
        out: dict[str, int] = {}
        for it in self.iterations:
            key = f"phase{it.phase}"
            out[key] = out.get(key, 0) + 1
        return out

    def _digest_doc(self) -> dict:
        return {
            "phase_name": self.phase_name,
            "success": bool(self.success),
            "abandoned": bool(self.abandoned),
            "acc": self.acc,
            "costs": self.costs,
            "iterations": [
                {"phase": it.phase, "step": it.step, "acc": it.acc,
                 "zone": it.zone, "note": it.note, "bits": it.bits,
                 "costs": it.costs, "violations": it.violations}
                for it in self.iterations],
            "layers": [dataclasses.asdict(l) for l in self.layers],
        }

    def digest(self) -> str:
        blob = json.dumps(self._digest_doc(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Artifact provenance (PolicyArtifact v6)
# ---------------------------------------------------------------------------

def phase_provenance(report: SearchReport) -> dict:
    """The compact per-phase provenance record a v6 artifact carries."""
    return {
        "iterations": len(report.iterations),
        "iteration_counts": report.iteration_counts(),
        "wall_s": round(report.total_s, 3),
        "env_s": round(report.env_s, 3),
        "success": bool(report.success),
        "abandoned": bool(report.abandoned),
        "acc": report.acc,
        "costs": dict(report.costs),
        "digest": report.digest(),
        "history": [
            {"phase": it.phase, "step": it.step, "acc": it.acc,
             "zone": it.zone, "note": it.note,
             "violations": {k: v for k, v in it.violations.items() if v > 0}}
            for it in report.iterations],
        "layers": [dataclasses.asdict(l) for l in report.layers],
    }


def build_provenance(*, backend: str, reports: dict, seed=None,
                     limits=None, config=None) -> dict:
    """Assemble the v6 ``PolicyArtifact.provenance`` payload.

    ``reports`` maps phase name ("weight" / "state" / "draft") to that
    phase's :class:`SearchReport`; the digest inside each phase record is
    what the determinism tests compare.
    """
    return {
        "schema": 1,
        "backend": backend,
        "seed": seed,
        "limits": dict(limits or {}),
        "config": dict(config or {}),
        "phases": {name: phase_provenance(rep)
                   for name, rep in reports.items() if rep is not None},
    }


def work_span(name: str, **args):
    """A leaf search-work span (``env/<name>``, :data:`WORK_CAT`) on the
    process-wide tracer — the shared no-op when tracing is off.  The env
    base class and the launchers both route through here so every unit of
    attributable search work lands in the same category/track."""
    tr = trace_mod.get_tracer()
    if not tr.enabled:
        return trace_mod.NOOP_SPAN
    return tr.span("env/" + name, cat=WORK_CAT, track=TRACK,
                   args=args or None)


# ---------------------------------------------------------------------------
# Trace-based wall-time attribution
# ---------------------------------------------------------------------------

def _merged(intervals) -> list:
    """Sorted, overlap-merged [start, end] intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _intersect_len(a: list, b: list) -> float:
    """Total overlap length of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def search_trace_report(events=None) -> dict:
    """Attribute traced search wall time to named work spans.

    ``total_s`` is the union of the root windows (PHASE_CAT spans named
    ``search/...``); ``attributed_s`` is the union of WORK_CAT spans
    clipped to those windows — overlap-safe, so nested env spans (a draft
    sensitivity probe calling divergence, say) never double-count.  With no
    root span recorded the work union itself is the denominator.
    """
    if events is None:
        events = trace_mod.get_tracer().events()
    roots, work = [], []
    by_name: dict[str, dict] = {}
    for ph, name, cat, track, ts, dur, args in events:
        if ph != "X":
            continue
        if cat == PHASE_CAT and name.startswith("search/"):
            roots.append((ts, ts + dur))
        elif cat == WORK_CAT:
            work.append((ts, ts + dur))
            d = by_name.setdefault(name, {"count": 0, "total_s": 0.0})
            d["count"] += 1
            d["total_s"] += dur
    mwork = _merged(work)
    mroots = _merged(roots) if roots else mwork
    total = sum(e - s for s, e in mroots)
    attributed = _intersect_len(mwork, mroots)
    return {
        "total_s": total,
        "attributed_s": attributed,
        "attributed_fraction": (attributed / total) if total > 0 else 0.0,
        "spans": dict(sorted(by_name.items(),
                             key=lambda kv: -kv[1]["total_s"])),
    }
