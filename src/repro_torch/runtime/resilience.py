"""Fault-tolerance primitives: failure injection, stragglers, step timing (a
copy of ``repro/runtime/resilience.py``).

On a real fleet the failure signal comes from the runtime (NCCL timeout,
host heartbeat loss); offline ``FailureInjector`` schedules faults at chosen
steps and the serve engine's own fault handling reacts to them.
"""
from __future__ import annotations

import collections
import dataclasses
import time


class SimulatedFailure(RuntimeError):
    """Stands in for a node crash / link flap in offline tests."""


#: serve-path fault sites the ServeEngine consults via ``fires`` (the chaos
#: harness drives these; DESIGN.md §14):
#:   pool_exhaustion    admission sees a full block pool -> shed/backpressure
#:   nan_logit          one active slot's decode logits go non-finite
#:   nan_logit_draft    the speculative draft's logits go non-finite (the
#:                      engine must fall back to the verify path, not fail)
#:   append_failure     the paged append bookkeeping for one slot dies
#:   artifact_mismatch  deploy-time artifact verification sees wrong bits
SERVE_FAULT_SITES = ("pool_exhaustion", "nan_logit", "nan_logit_draft",
                     "append_failure", "artifact_mismatch")


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault scheduler.

    Two interfaces share one injector:

    * the original train-loop contract — ``check(step, site)`` raises
      ``SimulatedFailure`` once per step listed in ``fail_at`` when ``site``
      matches ``kind`` — is unchanged;
    * serve-path faults ride in ``schedule``, a ``{site: (step, ...)}``
      mapping over ``SERVE_FAULT_SITES``; the engine polls ``fires(site,
      step)`` (consume-once, non-raising) at the matching hook and reacts
      with its OWN fault handling — that reaction path is what the chaos
      harness asserts on.
    """

    fail_at: tuple[int, ...] = ()
    kind: str = "step"           # step | save  (where the fault fires)
    schedule: dict[str, tuple[int, ...]] | None = None

    def __post_init__(self):
        self._pending = set(self.fail_at)
        self._sched = {site: set(steps)
                       for site, steps in (self.schedule or {}).items()}
        self.fired: list[tuple[str, int]] = []   # consumed (site, step) log

    def check(self, step: int, site: str = "step") -> None:
        if site == self.kind and step in self._pending:
            self._pending.discard(step)
            raise SimulatedFailure(f"injected failure at {site} step {step}")

    def fires(self, site: str, step: int) -> bool:
        """Consume-once poll: True exactly once per scheduled (site, step)."""
        pending = self._sched.get(site)
        if pending and step in pending:
            pending.discard(step)
            self.fired.append((site, step))
            return True
        return False

    @property
    def exhausted(self) -> bool:
        """Every scheduled fault (both interfaces) has been consumed."""
        return not self._pending and not any(self._sched.values())


class StragglerMonitor:
    """Per-step wall-time tracker with k-of-median flagging.

    A step slower than ``threshold``x the rolling median is flagged; the
    caller decides the mitigation (re-shard, evict host, re-dispatch).  The
    median over a deque is robust to the compile-step outlier at step 0.
    """

    def __init__(self, window: int = 32, threshold: float = 3.0, warmup: int = 3):
        self.durations: collections.deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.warmup = warmup
        self.flagged: list[tuple[int, float, float]] = []  # (step, dt, median)

    def observe(self, step: int, dt: float) -> bool:
        med = self.median()
        is_straggler = (len(self.durations) >= self.warmup and med > 0
                        and dt > self.threshold * med)
        if is_straggler:
            self.flagged.append((step, dt, med))
        else:
            self.durations.append(dt)  # flagged steps don't poison the median
        return is_straggler

    def median(self) -> float:
        if not self.durations:
            return 0.0
        s = sorted(self.durations)
        return s[len(s) // 2]


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.t0
        return False
