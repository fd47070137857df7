"""The benchmark's arithmetic on samples: tails, rates and busy time."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) over all ``values``, linear between
    the two nearest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    if seconds <= 0:
        raise ValueError("a rate over an empty window")
    return count / seconds


def union(intervals) -> list[tuple[float, float]]:
    """Merge ``(start, end)`` intervals: overlapping ones count once."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` covered by at least one interval."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of ``[lo, hi]``: where no interval runs."""
    out, t = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
