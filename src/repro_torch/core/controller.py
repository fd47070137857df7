"""The SigmaQuant two-phase controller (paper Algorithm 1, Figs. 2-3; port of
``repro/core/controller.py``, numpy and the search observability only).

The controller is model-agnostic: it talks to the network through a small
``QuantEnv`` interface (evaluate / calibrate+QAT / statistics) so the same
algorithm drives the paper-faithful CNN run, the LM QAT runs, and unit tests
with synthetic environments.

It searches under a multi-constraint ``Budget`` (any subset of
memory/energy/latency/BOPs, priced by the env's injected ``CostModel``) or a
legacy single-constraint ``Targets``; every decision operates on the
budget-violation vector: the most-violated constraint drives the Fig. 2 zone
direction, and Phase 2 early-stops only when *all* strict budget items hold.

Phase 1 — adaptive clustering (§IV-B): size-penalized k-means over layer
sigmas, clusters mapped (low sigma -> low bits) onto the bit-set, with the
whole mapping shifted by the Fig. 2 zone direction; lambda grows 0.1/iter
until at least one boundary enters its buffer.

Phase 2 — KL refinement (§IV-C): per round, bump ``m`` layers by +/-2 bits
chosen by the sigma+normalized-KL sensitivity score, recalibrate + short QAT,
early-stop/revert on stagnation, finish when every strict constraint holds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Protocol

import numpy as np

from repro_torch.obs import search as obs_search
from repro_torch.obs import trace as obs_trace

from . import clustering, packing
from .policy import Budget, BitPolicy, LayerInfo, Targets, Zone, classify_zone

__all__ = ["ControllerConfig", "QuantEnv", "SigmaQuantResult", "SigmaQuantController", "TraceEntry"]


class QuantEnv(Protocol):
    """What the controller needs from a quantizable model."""

    def layer_infos(self) -> tuple[LayerInfo, ...]: ...

    def sigmas(self) -> np.ndarray:
        """Per-layer weight standard deviations (current float weights)."""

    def sensitivities(self, policy: BitPolicy) -> np.ndarray:
        """Per-layer sensitivity scores (sigma + normalized KL) at the policy's bits."""

    def evaluate(self, policy: BitPolicy) -> float:
        """Quantized-model quality, higher is better (top-1 acc, or mapped -loss)."""

    def calibrate_and_qat(self, policy: BitPolicy, epochs: int) -> None:
        """Recalibrate ranges and run a short QAT cycle under ``policy``."""

    def resource(self, policy: BitPolicy) -> float:
        """Legacy scalar objective: model size (MiB) or BOPs."""

    # Envs with an injected CostModel additionally expose
    #   costs(policy) -> Mapping[str, float]   (CostReport.as_costs())
    # which multi-constraint Budgets price against; the controller falls back
    # to {"resource": resource(policy)} when absent (synthetic test envs).


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    bit_set: tuple[int, ...] = (2, 4, 6, 8)
    k: int = 4
    lam0: float = 0.1
    lam_step: float = 0.1
    phase1_max_iters: int = 3      # paper: 1-3 rounds
    phase2_max_iters: int = 40     # paper: 5-40 refinement rounds
    layers_per_round: int = 2      # paper: m = 2
    bit_step: int = 2              # paper: +/- 2 bits within {2,4,6,8}
    phase1_qat_epochs: int = 4
    phase2_qat_epochs: int = 2
    stagnation_patience: int = 5   # §IV-C.4 early stopping / reversion
    tabu_rounds: int = 4           # freeze a layer after a rejected move
    size_aware_rank: bool = False  # beyond-paper: rank decreases by sens/bytes
    objective: str = "size"        # "size" (MiB) or "bops"


@dataclasses.dataclass
class TraceEntry:
    phase: int
    step: int
    acc: float
    resource: float                # primary budget metric (back-compat scalar)
    zone: str
    bits: dict[str, int]
    note: str = ""
    costs: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SigmaQuantResult:
    policy: BitPolicy
    acc: float
    resource: float                # primary budget metric at the final policy
    success: bool
    abandoned: bool
    trace: list[TraceEntry]
    phase1_policy: BitPolicy | None = None
    phase1_acc: float = float("nan")
    phase1_resource: float = float("nan")
    costs: dict[str, float] = dataclasses.field(default_factory=dict)
    budget: Budget | None = None
    search_report: "obs_search.SearchReport | None" = None


class SigmaQuantController:
    def __init__(self, env: QuantEnv, targets: Targets | Budget,
                 config: ControllerConfig | None = None,
                 log: Callable[[str], None] | None = None,
                 phase: str = "search"):
        self.env = env
        self.targets = targets
        self.budget = targets.to_budget() if isinstance(targets, Targets) else targets
        self.cfg = config or ControllerConfig()
        self._log = log or (lambda s: None)
        #: the search-phase name ("weight" / "state" / "draft") — prefixes
        #: every trace span/counter and names the SearchReport (DESIGN.md §18)
        self.phase = phase
        self._tracer = obs_trace.get_tracer()

    # -- helpers -------------------------------------------------------------
    def _timed(self, name, fn, *args):
        """Time one env call for the SearchReport (tracer-independent; the
        env implementations emit their own WORK_CAT spans when tracing)."""
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        self._env_s += dt
        self._pending_env[name] = self._pending_env.get(name, 0.0) + dt
        return out

    def _measure(self, policy) -> tuple[float, dict[str, float]]:
        acc = self._timed("evaluate", self.env.evaluate, policy)
        costs_fn = getattr(self.env, "costs", None)
        costs = dict(self._timed("costs", costs_fn, policy)) \
            if costs_fn is not None else {}
        if "resource" not in costs:
            costs["resource"] = float(self.env.resource(policy))
        return acc, costs

    def _primary(self, costs: Mapping[str, float]) -> float:
        return float(costs[self.budget.primary_metric])

    def _record(self, trace, phase, step, acc, costs, policy, note=""):
        zone = classify_zone(acc, costs, self.budget).value
        res = self._primary(costs)
        trace.append(TraceEntry(phase, step, acc, res, zone, dict(policy.bits),
                                note, dict(costs)))
        viol = self.budget.violations(costs)
        now = time.perf_counter()
        self._iters.append(obs_search.IterationRecord(
            phase=phase, step=step, acc=float(acc), zone=zone, note=note,
            bits={k: int(v) for k, v in policy.bits.items()},
            costs={k: float(v) for k, v in costs.items()},
            violations={k: float(v) for k, v in viol.items()},
            wall_s=now - self._iter_t0,
            env_s={k: round(v, 6) for k, v in self._pending_env.items()}))
        worst_m, worst_v = self.budget.worst(costs)
        if self._tracer.enabled:
            self._tracer.complete(
                f"{self.phase}/p{phase}.{step}", ts=self._iter_t0,
                dur=now - self._iter_t0, cat=obs_search.PHASE_CAT,
                track=obs_search.TRACK,
                args={"phase": phase, "step": step, "zone": zone,
                      "acc": float(acc), "note": note, "worst": worst_m,
                      "bits": {k: int(v) for k, v in policy.bits.items()}})
            self._tracer.counter(f"{self.phase}/acc", float(acc))
            for m, v in viol.items():
                self._tracer.counter(f"{self.phase}/violation/{m}", float(v))
        self._iter_t0 = now
        self._pending_env = {}
        extra = f" worst={worst_m}+{worst_v:.1%}" if worst_v > 0 else ""
        self._log(f"[phase{phase} step{step}] acc={acc:.4f} res={res:.4g} "
                  f"zone={zone}{extra} {note}")

    def _close_phase(self, name: str, t0: float, iterations: int) -> None:
        self._phase_marks[name] = (t0, time.perf_counter() - t0, iterations)

    def _finish_report(self, policy, acc, costs, success,
                       abandoned) -> obs_search.SearchReport:
        """Per-layer final records + timings -> the run's SearchReport."""
        sens = np.asarray(
            self._timed("sensitivities", self.env.sensitivities, policy),
            dtype=np.float64)
        sig = np.asarray(self._timed("sigmas", self.env.sigmas),
                         dtype=np.float64)
        def _cont(l) -> int:
            try:
                return packing.container_bytes(l.shape, policy.bits[l.name])
            except ValueError:  # off-ladder bits (synthetic envs): logical
                return int(packing.logical_bytes(l.shape, policy.bits[l.name]))

        conts = [_cont(l) for l in policy.layers]
        total_c = float(sum(conts)) or 1.0
        layers = [obs_search.LayerRecord(
            name=l.name, kind=l.kind, bits=int(policy.bits[l.name]),
            sigma=float(sig[i]), sensitivity=float(sens[i]),
            container_bytes=int(conts[i]), cost_share=conts[i] / total_c)
            for i, l in enumerate(policy.layers)]
        total_s = time.perf_counter() - self._t_run
        timings = {name: {"wall_s": round(dur, 6), "iterations": n}
                   for name, (t0, dur, n) in self._phase_marks.items()}
        report = obs_search.SearchReport(
            phase_name=self.phase, success=bool(success),
            abandoned=bool(abandoned), acc=float(acc),
            costs={k: float(v) for k, v in costs.items()},
            iterations=self._iters, layers=layers, phase_timings=timings,
            total_s=total_s, env_s=self._env_s)
        if self._tracer.enabled:
            for name, (t0, dur, n) in self._phase_marks.items():
                self._tracer.complete(
                    f"{self.phase}/{name}", ts=t0, dur=dur,
                    cat=obs_search.PHASE_CAT, track=obs_search.TRACK,
                    args={"iterations": n})
            self._tracer.instant(
                f"{self.phase}/layer_sensitivities", cat=obs_search.PHASE_CAT,
                track=obs_search.TRACK,
                args={l.name: {"sigma": l.sigma, "sensitivity": l.sensitivity,
                               "bits": l.bits} for l in layers})
            self._tracer.complete(
                f"search/{self.phase}", ts=self._t_run, dur=total_s,
                cat=obs_search.PHASE_CAT, track=obs_search.TRACK,
                args={"success": bool(success), "abandoned": bool(abandoned),
                      "iterations": len(self._iters),
                      "digest": report.digest()})
        return report

    def _result(self, policy, acc, costs, success, abandoned, trace, *,
                phase1=None) -> SigmaQuantResult:
        p1_policy, p1_acc, p1_costs = phase1 or (None, float("nan"), None)
        report = self._finish_report(policy, acc, costs, success, abandoned)
        return SigmaQuantResult(
            policy, acc, self._primary(costs), success, abandoned, trace,
            p1_policy, p1_acc,
            self._primary(p1_costs) if p1_costs is not None else float("nan"),
            dict(costs), self.budget, report)

    # -- phases ---------------------------------------------------------------
    def run(self) -> SigmaQuantResult:
        cfg, b = self.cfg, self.budget
        # SearchReport accumulation state (DESIGN.md §18): per-iteration
        # records, env-call timings, and phase windows build up as the
        # search runs and land on ``SigmaQuantResult.search_report``
        self._t_run = self._iter_t0 = time.perf_counter()
        self._env_s = 0.0
        self._pending_env: dict[str, float] = {}
        self._iters: list[obs_search.IterationRecord] = []
        self._phase_marks: dict[str, tuple[float, float, int]] = {}
        layers = self.env.layer_infos()
        trace: list[TraceEntry] = []

        # Alg. 1 lines 1-3: start from uniform 8-bit
        policy = BitPolicy.uniform(layers, max(cfg.bit_set))
        acc, costs = self._measure(policy)
        self._record(trace, 0, 0, acc, costs, policy, "init uniform-8bit")

        # ---- Phase 1: adaptive clustering (lines 4-20) ----
        lam, i = cfg.lam0, 0
        p1_t0 = time.perf_counter()
        while (not b.acc_ok(acc, buffered=True)) and (not b.res_ok(costs, buffered=True)) \
                and i < cfg.phase1_max_iters:
            i += 1
            sig = self._timed("sigmas", self.env.sigmas)
            labels, _ = clustering.adaptive_kmeans(sig, cfg.k, lam)
            zone = classify_zone(acc, costs, b)
            if zone is Zone.ABANDON:
                self._record(trace, 1, i, acc, costs, policy, "abandon zone")
                self._close_phase("phase1", p1_t0, i)
                return self._result(policy, acc, costs, False, True, trace)
            # the most-violated constraint drives the direction; every cost
            # metric is monotone in bits, so over-budget always means "down"
            shift = 1 if zone is Zone.BIT_INCREASE else (-1 if zone is Zone.BIT_DECREASE else 0)
            bits_arr = clustering.assign_bits_to_clusters(labels, cfg.bit_set, shift=shift)
            policy = BitPolicy.from_bits(layers, {l.name: int(bt) for l, bt in zip(layers, bits_arr)},
                                         policy.act_bits)
            self._timed("qat", self.env.calibrate_and_qat, policy,
                        cfg.phase1_qat_epochs)
            acc, costs = self._measure(policy)
            self._record(trace, 1, i, acc, costs, policy, f"lambda={lam:.2f} shift={shift:+d}")
            if b.acc_ok(acc, buffered=True) or b.res_ok(costs, buffered=True):
                break
            lam += cfg.lam_step
        self._close_phase("phase1", p1_t0, i)

        if (not b.acc_ok(acc, buffered=True)) and (not b.res_ok(costs, buffered=True)):
            # lines 18-20: give up — infeasible
            self._record(trace, 1, i, acc, costs, policy, "infeasible — abandoned")
            return self._result(policy, acc, costs, False, True, trace)

        phase1 = (policy, acc, costs)

        # ---- Phase 2: iterative KL refinement (lines 21-31) ----
        best = (policy, acc, costs)
        stagnant, j = 0, 0
        tabu: dict[str, int] = {}  # layer -> round until which it is frozen
        lo, hi = min(cfg.bit_set), max(cfg.bit_set)
        sizes = np.asarray([l.n_params for l in layers], dtype=np.float64)
        p2_t0 = time.perf_counter()

        def done(acc_, costs_):
            # early-stop only when accuracy AND all *strict* budgets hold
            return b.acc_ok(acc_) and b.res_ok(costs_, strict_only=True)

        while j < cfg.phase2_max_iters and not done(acc, costs):
            j += 1
            sens = np.asarray(
                self._timed("sensitivities", self.env.sensitivities, policy),
                dtype=np.float64)
            bits_vec = policy.bit_vector()
            names = [l.name for l in layers]
            free = [k for k in range(len(names)) if tabu.get(names[k], 0) < j]
            if not b.acc_ok(acc):
                # raise bits on the most sensitive layers not already at max
                cand = [k for k in sorted(free, key=lambda k: -sens[k]) if bits_vec[k] < hi]
                delta = +cfg.bit_step
            else:
                # shrink the least harmful layers not already at min
                if cfg.size_aware_rank:
                    rank_key = sens / np.maximum(sizes, 1.0)  # sensitivity per byte saved
                else:
                    rank_key = sens
                cand = [k for k in sorted(free, key=lambda k: rank_key[k]) if bits_vec[k] > lo]
                delta = -cfg.bit_step
            chosen = cand[: cfg.layers_per_round]
            if not chosen:  # nowhere to move — bit ladder / tabu exhausted
                self._record(trace, 2, j, acc, costs, policy, "no movable layers")
                break
            prev = (policy, acc, costs)
            policy = policy.bumped([names[k] for k in chosen], delta)
            move = f"{delta:+d}b on {[names[k] for k in chosen]}"
            self._timed("qat", self.env.calibrate_and_qat, policy,
                        cfg.phase2_qat_epochs)
            acc, costs = self._measure(policy)

            # §IV-C.4 revert-on-failure: a move that worsens the total
            # constraint violation is rejected and its layers are tabu for a
            # few rounds (prevents increase/decrease oscillation).
            if b.badness(acc, costs) > b.badness(prev[1], prev[2]) + 1e-12:
                self._record(trace, 2, j, acc, costs, policy, move + " — rejected")
                for k in chosen:
                    tabu[names[k]] = j + cfg.tabu_rounds
                policy, acc, costs = prev
                stagnant += 1
            else:
                self._record(trace, 2, j, acc, costs, policy, move)
                if self._better(acc, costs, best[1], best[2]):
                    best = (policy, acc, costs)
                    stagnant = 0
                else:
                    stagnant += 1
            if stagnant >= cfg.stagnation_patience:
                policy, acc, costs = best
                self._record(trace, 2, j, acc, costs, policy, "stagnated — reverted to best")
                break

        self._close_phase("phase2", p2_t0, j)
        success = done(acc, costs)
        if not success and self._better(best[1], best[2], acc, costs):
            policy, acc, costs = best
        return self._result(policy, acc, costs, success, False, trace, phase1=phase1)

    def _better(self, acc_a, costs_a, acc_b, costs_b) -> bool:
        """Lexicographic-ish ordering: constraint violation first, then slack."""
        ba, bb = self.budget.badness(acc_a, costs_a), self.budget.badness(acc_b, costs_b)
        if abs(ba - bb) > 1e-12:
            return ba < bb
        # tie-break: smaller primary resource wins, then higher accuracy
        res_a, res_b = self._primary(costs_a), self._primary(costs_b)
        if abs(res_a - res_b) > 1e-12:
            return res_a < res_b
        return acc_a > acc_b
