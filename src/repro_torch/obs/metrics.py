"""Counters, gauges, and fixed-bucket histograms (a copy of ``repro/obs/metrics.py``).

Prometheus-shaped but in-process and allocation-light: a
:class:`Histogram` is a fixed edge ladder plus integer bucket counts, so
``observe`` is one bisect + three adds and percentile queries interpolate
inside the bucket that crosses the target rank (clamped to the observed
min/max, so a single sample reports itself exactly).

The :class:`MetricsRegistry` is the engine-facing surface: get-or-create
by name, ``snapshot()`` for a serializable view.  ``ServeEngine`` keeps
one registry for its TTFT and inter-token histograms.
"""
from __future__ import annotations

import math
from bisect import bisect_right


def exp_buckets(lo: float = 1e-6, hi: float = 10.0,
                factor: float = 2.0) -> tuple[float, ...]:
    """Geometric bucket edges covering [lo, hi] — the default time ladder
    (1µs .. 10s at factor 2 is 24 edges)."""
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * factor)
    return tuple(edges)


DEFAULT_TIME_BUCKETS = exp_buckets()


class Counter:
    """Monotonically increasing value (floats allowed: byte/second totals)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        self.value += n


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with interpolated percentile summaries."""

    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets=None):
        self.edges = tuple(sorted(buckets)) if buckets else DEFAULT_TIME_BUCKETS
        if not self.edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.clear()

    def clear(self) -> None:
        # counts[i] = observations in (edges[i-1], edges[i]]; counts[-1] is
        # the +inf overflow bucket
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        self.counts[bisect_right(self.edges, x)] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile (p in [0, 100]) by linear
        interpolation inside the bucket crossing the target rank; exact at
        the observed min/max ends."""
        if self.count == 0:
            return 0.0
        target = p / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else min(self.min, self.edges[0])
                hi = self.edges[i] if i < len(self.edges) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations into this histogram (in place).

        Requires an identical edge ladder — bucket counts add exactly, so
        percentiles over the merged data are what a single histogram
        observing both streams would report.  Lets benchmark runs and
        chaos-matrix legs aggregate percentile data across engines/runs.
        """
        if self.edges != other.edges:
            raise ValueError(
                f"cannot merge histograms with different bucket edges "
                f"({len(self.edges)} vs {len(other.edges)} edges)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def state(self) -> dict:
        """Full serializable state (edges + counts + sum/count/min/max) —
        enough to reconstruct and merge across processes, unlike the
        percentile-only ``summary()`` view."""
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None}

    @classmethod
    def from_state(cls, d: dict) -> "Histogram":
        h = cls(d["edges"])
        h.counts = list(d["counts"])
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = d["min"] if d.get("min") is not None else math.inf
        h.max = d["max"] if d.get("max") is not None else -math.inf
        return h

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0,
                    "min": 0.0, "max": 0.0}
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99), "min": self.min, "max": self.max}


class MetricsRegistry:
    """Name -> metric, get-or-create, with a serializable snapshot view."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(*args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram, buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self) -> None:
        """Zero every registered metric in place (histograms clear, counters
        and gauges return to 0) while keeping the objects alive, so callers
        holding metric references keep observing into the same instances.
        The warm-up exclusion knob: call after the warm turns so first-call
        set-up stops skewing latency percentiles."""
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                m.clear()
            else:
                m.value = 0.0

    def items(self, prefix: str = ""):
        return sorted((k, v) for k, v in self._metrics.items()
                      if k.startswith(prefix))

    def snapshot(self) -> dict:
        out = {}
        for name, m in self.items():
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out
