"""The device trace of a traced run: ``torch.profiler`` over a run of loop
turns, read back from its Chrome trace.

Only CUDA activity is recorded (kernels, copies, sets and the runtime calls
that launch them), not the CPU operators, so that the host's own time is
disturbed as little as it can be.  Timestamps are put on the host's
``time.perf_counter`` clock through two device synchronizations made at
known host times, at the start and at the end.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

#: trace categories that are work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: runtime and driver calls that launch work on the device
LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch", "cuLaunch")


@dataclasses.dataclass
class DeviceTrace:
    """What a traced span of turns ran on the device, on the perf_counter clock."""
    ops: list[tuple[str, float, float]]        # (name, start_s, end_s)
    launches: int                              # launch calls made by the host
    t0: float                                  # the traced span, perf_counter seconds
    t1: float
    aligned: bool                              # whether op times share the host clock


class Capture:
    """Start and stop the profiler between loop turns; ``read()`` afterwards."""

    def __init__(self, out_dir: Path):
        self.out_dir = Path(out_dir)
        self._prof = None
        self.t0 = self.t1 = None
        self.mark0 = self.mark1 = None

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0, self.mark0 = _synced_mark(torch)

    def stop(self) -> None:
        import torch

        self.t1, self.mark1 = _synced_mark(torch)
        self._prof.__exit__(None, None, None)

    @property
    def running(self) -> bool:
        return self._prof is not None and self.t1 is None

    def read(self) -> DeviceTrace:
        """The trace as ``DeviceTrace``; the Chrome trace is written under
        ``out_dir`` and removed once read."""
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"trace.{os.getpid()}.json"
        try:
            self._prof.export_chrome_trace(str(path))
            doc = json.loads(path.read_text())
        finally:
            path.unlink(missing_ok=True)
        return parse(doc, self.t0, self.t1, (self.mark0, self.mark1))


def _synced_mark(torch) -> tuple[float, float]:
    """A device synchronization at a known host time: (time after it, its midpoint).
    Its ``cudaDeviceSynchronize`` call in the trace ties the trace's clock to
    ``time.perf_counter``."""
    a = time.perf_counter()
    torch.cuda.synchronize()
    b = time.perf_counter()
    return b, 0.5 * (a + b)


def parse(doc: dict, t0: float, t1: float, marks=None) -> DeviceTrace:
    """Device ops and launch calls of a Chrome trace, in ``[t0, t1]`` on the
    host clock.  ``marks``: the host midpoints of the first and last
    ``cudaDeviceSynchronize`` of the trace; without them (or without such
    calls in the trace) the ops keep their own clock, shifted so that the
    first starts at ``t0``, and ``aligned`` is False."""
    ops, launches, raw, syncs = [], 0, [], []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        if cat in DEVICE_CATS:
            s = float(ev["ts"]) * 1e-6
            raw.append((name, s, s + float(ev.get("dur", 0.0)) * 1e-6))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if any(k in name for k in LAUNCH_NAMES):
                launches += 1
            elif name == "cudaDeviceSynchronize":
                syncs.append((float(ev["ts"]) + 0.5 * float(ev.get("dur", 0.0))) * 1e-6)
    aligned = bool(marks) and len(syncs) >= 2
    if aligned:
        shift = 0.5 * ((marks[0] - min(syncs)) + (marks[1] - max(syncs)))
    elif raw:
        shift = t0 - min(s for _, s, _ in raw)
    else:
        shift = 0.0
    ops = [(n, max(s + shift, t0), min(e + shift, t1)) for n, s, e in raw
           if e + shift > t0 and s + shift < t1]
    return DeviceTrace(ops=ops, launches=launches, t0=t0, t1=t1, aligned=aligned)
