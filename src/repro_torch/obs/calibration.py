"""Cost-model calibration: predicted vs measured cost vectors (a copy of
``repro/obs/calibration.py``).

The controller optimizes against a ``CostModel``'s *predictions*; the serve
engine deploys the result and can *measure* some of the same metrics —
packed weight container bytes from the param tree, decode-state bytes from
the cache accountants, step latency from the ``phase/*`` histograms.  The
ratio measured/predicted per metric is the calibration signal: 1.0 means
the proxy the search trusted matches deployment, a stable offset (e.g.
per-block scale overhead on ``state_bytes``) is a model-fidelity gap worth
folding back into the backend.

Pure functions over plain mappings — the engine passes its own
measurements in, so this module imports nothing from the serve stack.
"""
from __future__ import annotations

from typing import Mapping

#: cost metrics deployment can measure (artifact report keys, DESIGN.md §10)
CALIBRATED_METRICS = ("container_bytes", "state_bytes", "latency_s")


def calibration_ratios(predicted: Mapping, measured: Mapping, *,
                       metrics=None) -> dict:
    """Per-metric ``{predicted, measured, ratio}`` for every metric present
    in both vectors (ratio = measured / predicted)."""
    out = {}
    for m in (metrics or CALIBRATED_METRICS):
        if m not in predicted or m not in measured:
            continue
        p, v = float(predicted[m]), float(measured[m])
        if p <= 0:
            continue
        out[m] = {"predicted": p, "measured": v, "ratio": v / p}
    return out


def max_ratio_error(calibration: Mapping, *, metrics=None) -> float:
    """Worst |ratio - 1| across the calibrated metrics — the scalar a
    benchmark headline can gate on (lower is better, 0 = perfect model)."""
    errs = [abs(rec["ratio"] - 1.0) for m, rec in calibration.items()
            if metrics is None or m in metrics]
    return max(errs, default=0.0)


def attach_calibration(artifact, calibration: Mapping) -> None:
    """Record measured ratios in ``artifact.meta["calibration"]``.

    Rides the free-form ``meta`` (no artifact-version implications): a
    re-saved artifact then lets ``launch/report.py`` render the calibration
    table offline, with no engine or re-search required.
    """
    artifact.meta["calibration"] = {m: dict(rec)
                                    for m, rec in calibration.items()}


def render_calibration_table(calibration: Mapping) -> str:
    """The calibration section as a markdown table."""
    lines = ["| metric | predicted | measured | ratio |",
             "|---|---:|---:|---:|"]
    for m, rec in calibration.items():
        lines.append(f"| {m} | {rec['predicted']:g} | {rec['measured']:g} "
                     f"| {rec['ratio']:.3f} |")
    return "\n".join(lines)
