"""The production train loop: checkpoint/restart, stragglers, failure retry
(port of ``repro/runtime/loop.py``).

One code path serves the driver (``launch/train.py``) and the offline
fault-injection tests: the loop survives ``SimulatedFailure`` (and, in
deployment, runtime errors) by restoring the latest checkpoint and replaying;
the stateless data pipeline makes the replay repeat the clean run bit for bit
where the step itself is deterministic.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from repro_torch.checkpoint.store import CheckpointStore
from .resilience import FailureInjector, SimulatedFailure, StepTimer, StragglerMonitor

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    total_steps: int
    save_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    log_every: int = 10


class TrainLoop:
    """step_fn(state, batch) -> (state, metrics); state is one tree (nested
    dicts, lists and tuples of tensors and numbers), which the step may
    update in place: a save copies it before the next step runs."""

    def __init__(self, step_fn: Callable, init_state: Any,
                 batch_fn: Callable[[int], Any], store: CheckpointStore,
                 cfg: LoopConfig, *, injector: FailureInjector | None = None,
                 monitor: StragglerMonitor | None = None,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.step_fn = step_fn
        self.state = init_state
        self.batch_fn = batch_fn
        self.store = store
        self.cfg = cfg
        self.injector = injector
        self.monitor = monitor or StragglerMonitor()
        self.on_straggler = on_straggler
        self.restarts = 0
        self.history: list[dict] = []

    # -- checkpoint glue ------------------------------------------------------
    def _resume(self) -> int:
        latest = self.store.latest()
        if latest is None:
            return 0
        self.state, extra = self.store.restore_latest(self.state)
        log.info("resumed from step %d", latest)
        return int(extra.get("next_step", latest))

    def _save(self, step: int) -> None:
        if self.injector:
            self.injector.check(step, "save")
        self.store.save_async(step, self.state, extra={"next_step": step + 1})

    # -- main -----------------------------------------------------------------
    def run(self) -> Any:
        step = self._resume()
        while step < self.cfg.total_steps:
            try:
                step = self._run_from(step)
            except SimulatedFailure as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                log.warning("failure at step %d (%s) — restart %d", step, e, self.restarts)
                self.store.wait()
                step = self._resume()
        self.store.wait()
        return self.state

    def _run_from(self, step: int) -> int:
        while step < self.cfg.total_steps:
            if self.injector:
                self.injector.check(step, "step")
            batch = self.batch_fn(step)
            with StepTimer() as t:
                self.state, metrics = self.step_fn(self.state, batch)
            if self.monitor.observe(step, t.dt) and self.on_straggler:
                self.on_straggler(step, t.dt)
            if step % self.cfg.log_every == 0:
                self.history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
            step += 1
            if step % self.cfg.save_every == 0 or step == self.cfg.total_steps:
                self._save(step - 1)
        return step
