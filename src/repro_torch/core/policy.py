"""Bitwidth policies, layer registries and policy artifacts (the data types of
``repro/core/policy.py``).

A ``BitPolicy`` maps quantizable-layer names to weight bits, plus a global
activation bitwidth.  A ``PolicyArtifact`` is the versioned hand-off from a
search to a deployment: the weight policy, its ``Budget``, an optional
decode-state policy, paged-pool geometry, a speculative draft policy,
kernel configs and provenance, pinned to the layer registry they were
searched on.  Their JSON forms are the JAX package's, so a policy or an
artifact moves between the two packages unchanged, with an equal
``registry_hash``.  ``Zone`` and ``classify_zone`` are the search's
decision zones (paper Fig. 2).
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Iterable, Mapping

import numpy as np

from . import packing


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """Static description of one quantizable layer.

    ``kind == "state"`` marks a decode-state surface (a KV cache tensor):
    it is priced by ``state_bytes`` and left out of the weight metrics.
    """

    name: str
    shape: tuple[int, ...]
    macs: int
    kind: str = "dense"  # dense | embedding | conv | expert | state

    @property
    def n_params(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class BitPolicy:
    """Ordered per-layer weight bits + global activation bits."""

    layers: tuple[LayerInfo, ...]
    bits: dict[str, int]
    act_bits: int = 8

    @classmethod
    def uniform(cls, layers: Iterable[LayerInfo], w_bits: int, act_bits: int = 8) -> "BitPolicy":
        layers = tuple(layers)
        return cls(layers, {l.name: int(w_bits) for l in layers}, act_bits)

    @classmethod
    def from_bits(cls, layers: Iterable[LayerInfo], bits: Mapping[str, int],
                  act_bits: int = 8) -> "BitPolicy":
        layers = tuple(layers)
        missing = [l.name for l in layers if l.name not in bits]
        if missing:
            raise KeyError(f"policy missing layers: {missing[:5]}")
        return cls(layers, {l.name: int(bits[l.name]) for l in layers}, act_bits)

    # -- mutation (functional) ----------------------------------------------
    def with_bits(self, name: str, bits: int) -> "BitPolicy":
        packing.check_bits(bits)
        new = dict(self.bits)
        new[name] = bits
        return BitPolicy(self.layers, new, self.act_bits)

    def bumped(self, names: Iterable[str], delta: int) -> "BitPolicy":
        """+/- delta bits on the named layers, clamped to the valid bit-set."""
        new = dict(self.bits)
        lo, hi = min(packing.VALID_BITS), max(packing.VALID_BITS)
        for n in names:
            new[n] = int(np.clip(new[n] + delta, lo, hi))
        return BitPolicy(self.layers, new, self.act_bits)

    def weight_layers(self) -> tuple[LayerInfo, ...]:
        return tuple(l for l in self.layers if l.kind != "state")

    def state_layers(self) -> tuple[LayerInfo, ...]:
        return tuple(l for l in self.layers if l.kind == "state")

    def model_size_bytes(self) -> float:
        """Paper-metric weight bytes: parameters times bits / 8."""
        return sum(l.n_params * self.bits[l.name] / 8.0 for l in self.weight_layers())

    def model_size_mib(self) -> float:
        return self.model_size_bytes() / 2**20

    def container_bytes(self) -> int:
        return sum(packing.container_bytes(l.shape, self.bits[l.name])
                   for l in self.weight_layers())

    def state_bytes(self) -> int:
        """Packed container bytes of the decode state (int lanes only, no scales)."""
        return sum(packing.container_bytes(l.shape, self.bits[l.name])
                   for l in self.state_layers())

    def bops(self) -> float:
        return float(sum(self.bits[l.name] * self.act_bits * l.macs
                         for l in self.weight_layers()))

    def bit_vector(self) -> np.ndarray:
        return np.asarray([self.bits[l.name] for l in self.layers], dtype=np.int64)

    def mean_bits(self) -> float:
        sizes = np.asarray([l.n_params for l in self.layers], dtype=np.float64)
        return float((self.bit_vector() * sizes).sum() / sizes.sum())

    def to_json(self) -> str:
        return json.dumps(
            {
                "act_bits": self.act_bits,
                "bits": self.bits,
                "layers": [dataclasses.asdict(l) for l in self.layers],
            },
            indent=2,
            default=lambda o: list(o) if isinstance(o, tuple) else o,
        )

    @classmethod
    def from_json(cls, s: str) -> "BitPolicy":
        d = json.loads(s)
        layers = tuple(
            LayerInfo(x["name"], tuple(x["shape"]), int(x["macs"]), x.get("kind", "dense"))
            for x in d["layers"]
        )
        return cls(layers, {k: int(v) for k, v in d["bits"].items()}, int(d["act_bits"]))


# ---------------------------------------------------------------------------
# decision zones (paper Fig. 2) and budgets
# ---------------------------------------------------------------------------


class Zone(enum.Enum):
    TARGET = "target"              # both constraints met
    BIT_INCREASE = "bit_increase"  # accuracy low, size comfortably under budget
    BIT_DECREASE = "bit_decrease"  # accuracy fine, size over budget
    ITERATION = "iteration"        # exactly one constraint inside its buffer
    TRANSITION = "transition"      # between phase-1 zones; keep current trend
    ABANDON = "abandon"            # both hopeless (far outside buffers)


#: cost-metric names a Budget may constrain
COST_METRICS = ("size_mib", "size_bytes", "container_bytes", "state_bytes",
                "bops", "energy", "latency_s", "resource")


@dataclasses.dataclass(frozen=True)
class BudgetItem:
    """One upper-bound resource constraint: ``costs[metric] <= limit``.

    ``buffer`` is a fraction of the limit; ``strict`` items gate the search's
    early stop, non-strict ones only steer.
    """

    metric: str
    limit: float
    buffer: float = 0.05
    strict: bool = True

    def value(self, costs: Mapping[str, float]) -> float:
        if self.metric not in costs:
            raise KeyError(f"cost report has no metric {self.metric!r} "
                           f"(available: {sorted(costs)})")
        return float(costs[self.metric])

    def ok(self, costs: Mapping[str, float], *, buffered: bool = False) -> bool:
        slack = self.buffer * self.limit if buffered else 0.0
        return self.value(costs) <= self.limit + slack

    def violation(self, costs: Mapping[str, float]) -> float:
        """Normalized overshoot: max(0, (value - limit) / limit)."""
        return max(0.0, (self.value(costs) - self.limit) / max(abs(self.limit), 1e-9))


@dataclasses.dataclass(frozen=True)
class Budget:
    """Accuracy >= ``acc_t`` and every resource item under its limit."""

    acc_t: float
    items: tuple[BudgetItem, ...]
    acc_buffer: float = 0.01
    abandon_factor: float = 4.0

    def __post_init__(self):
        if not self.items:
            raise ValueError("Budget needs at least one resource constraint")

    @classmethod
    def of(cls, acc_t: float, *, acc_buffer: float = 0.01, buffer: float = 0.05,
           abandon_factor: float = 4.0, **limits: float) -> "Budget":
        """Budget from metric=limit kwargs, e.g. ``Budget.of(0.9, size_mib=4)``."""
        items = []
        for metric, limit in limits.items():
            if metric not in COST_METRICS:
                raise ValueError(f"unknown cost metric {metric!r} (valid: {COST_METRICS})")
            items.append(BudgetItem(metric, float(limit), buffer))
        return cls(acc_t, tuple(items), acc_buffer, abandon_factor)

    def acc_ok(self, acc: float, *, buffered: bool = False) -> bool:
        slack = self.acc_buffer if buffered else 0.0
        return acc >= self.acc_t - slack

    def res_ok(self, costs: Mapping[str, float], *, buffered: bool = False,
               strict_only: bool = False) -> bool:
        items = self.strict_items if strict_only else self.items
        return all(it.ok(costs, buffered=buffered) for it in items)

    @property
    def strict_items(self) -> tuple[BudgetItem, ...]:
        return tuple(it for it in self.items if it.strict)

    @property
    def primary_metric(self) -> str:
        return self.items[0].metric

    def violations(self, costs: Mapping[str, float]) -> dict[str, float]:
        """Normalized violation per constraint (0 = satisfied)."""
        return {it.metric: it.violation(costs) for it in self.items}

    def worst(self, costs: Mapping[str, float]) -> tuple[str, float]:
        """The most-violated constraint."""
        v = self.violations(costs)
        metric = max(v, key=v.get)
        return metric, v[metric]

    def badness(self, acc: float, costs: Mapping[str, float]) -> float:
        """Total normalized constraint violation; 0 inside the target zone."""
        return max(0.0, self.acc_t - acc) + sum(it.violation(costs) for it in self.items)

    def to_dict(self) -> dict:
        return {"acc_t": self.acc_t, "acc_buffer": self.acc_buffer,
                "abandon_factor": self.abandon_factor,
                "items": [dataclasses.asdict(it) for it in self.items]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Budget":
        items = tuple(BudgetItem(x["metric"], float(x["limit"]),
                                 float(x.get("buffer", 0.05)), bool(x.get("strict", True)))
                      for x in d["items"])
        return cls(float(d["acc_t"]), items, float(d.get("acc_buffer", 0.01)),
                   float(d.get("abandon_factor", 4.0)))


@dataclasses.dataclass(frozen=True)
class Targets:
    """The single-constraint case: accuracy >= ``acc_t``, resource <= ``res_t``."""

    acc_t: float
    res_t: float
    acc_buffer: float = 0.01
    res_buffer: float = 0.05
    abandon_factor: float = 4.0

    def acc_ok(self, acc: float, *, buffered: bool = False) -> bool:
        slack = self.acc_buffer if buffered else 0.0
        return acc >= self.acc_t - slack

    def res_ok(self, res: float, *, buffered: bool = False) -> bool:
        slack = self.res_buffer * self.res_t if buffered else 0.0
        return res <= self.res_t + slack

    def to_budget(self, metric: str = "resource") -> Budget:
        return Budget(self.acc_t, (BudgetItem(metric, self.res_t, self.res_buffer),),
                      self.acc_buffer, self.abandon_factor)


def _as_budget_costs(res, t) -> tuple[Budget, dict[str, float]]:
    """Normalize (res, targets) to (Budget, cost mapping)."""
    if isinstance(t, Targets):
        budget = t.to_budget()
        if isinstance(res, Mapping):
            if "resource" not in res:
                raise KeyError(
                    "classify_zone with Targets needs a scalar res or a "
                    f"mapping containing 'resource' (got {sorted(res)})")
            costs = dict(res)
        else:
            costs = {"resource": float(res)}
        return budget, costs
    costs = dict(res) if isinstance(res, Mapping) else {t.primary_metric: float(res)}
    return t, costs


def classify_zone(acc: float, res, t: "Targets | Budget") -> Zone:
    """Fig. 2 decision zones from the (accuracy, cost-vector) point.

    ``res`` is a scalar (single constraint) or a metric -> value mapping; the
    most-violated constraint stands in for "the" resource axis, so with one
    constraint this is the paper's 2-D diagram.

    TARGET       accuracy and every constraint strictly hold.
    ABANDON      accuracy and the worst constraint both far beyond buffers.
    BIT_INCREASE accuracy clearly low while every cost is strictly in budget.
    BIT_DECREASE some cost clearly over while accuracy strictly satisfied.
    ITERATION    exactly one side inside its buffer (phase-2 territory).
    TRANSITION   everything else (keep the current phase-1 trend).
    """
    budget, costs = _as_budget_costs(res, t)
    acc_strict = budget.acc_ok(acc)
    acc_buf = budget.acc_ok(acc, buffered=True)
    res_strict = budget.res_ok(costs)
    res_buf = budget.res_ok(costs, buffered=True)
    if acc_strict and res_strict:
        return Zone.TARGET
    far_acc = acc < budget.acc_t - budget.abandon_factor * max(budget.acc_buffer, 1e-9)
    far_res = any(it.violation(costs) > budget.abandon_factor * max(it.buffer, 1e-9)
                  for it in budget.items)
    if far_acc and far_res:
        return Zone.ABANDON
    if not acc_buf and res_strict:
        return Zone.BIT_INCREASE
    if acc_strict and not res_buf:
        return Zone.BIT_DECREASE
    if acc_buf != res_buf:
        return Zone.ITERATION
    return Zone.TRANSITION


# ---------------------------------------------------------------------------
# policy artifacts
# ---------------------------------------------------------------------------

#: the artifact JSON layout this package writes
ARTIFACT_VERSION = 6

#: versions it reads: v1 has no state policy, v1-v2 no pool geometry, v1-v3 no
#: draft policy, v1-v4 no kernel configs, v1-v5 no provenance (all load as
#: None / 0)
READABLE_ARTIFACT_VERSIONS = (1, 2, 3, 4, 5, 6)


def validate_provenance(prov) -> None:
    """Check the v6 ``provenance`` record's load-bearing shape (on build and on
    load), naming the offending field: a mapping of phase name -> record with
    a non-negative int ``iterations`` and a non-empty string ``digest``."""
    if not isinstance(prov, Mapping):
        raise ValueError("provenance must be a mapping")
    phases = prov.get("phases")
    if phases is None:
        raise ValueError("invalid provenance field 'provenance.phases': "
                         "required mapping of phase name -> record is missing")
    if not isinstance(phases, Mapping):
        raise ValueError("invalid provenance field 'provenance.phases': "
                         "must be a mapping of phase name -> record")
    for name, rec in phases.items():
        where = f"provenance.phases.{name}"
        if not isinstance(rec, Mapping):
            raise ValueError(f"invalid provenance field '{where}': must be a mapping")
        iters = rec.get("iterations")
        if isinstance(iters, bool) or not isinstance(iters, int) or iters < 0:
            raise ValueError(f"invalid provenance field '{where}.iterations': "
                             f"must be a non-negative int (got {iters!r})")
        digest = rec.get("digest")
        if not isinstance(digest, str) or not digest:
            raise ValueError(f"invalid provenance field '{where}.digest': "
                             f"must be a non-empty string (got {digest!r})")


def layer_registry_hash(layers: Iterable[LayerInfo]) -> str:
    """Stable hash of a layer registry over the ordered (name, shape, kind);
    MACs are left out (they depend on the reference batch)."""
    canon = [(l.name, list(l.shape), l.kind) for l in layers]
    blob = json.dumps(canon, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass
class PolicyArtifact:
    """Everything a deployment needs from one search.

    policy         the per-layer weight bitwidths
    registry_hash  ``layer_registry_hash`` of the model the search saw
    budget         the constraints the search ran under (None: hand-made)
    report         the cost vector at the final policy (metric -> value)
    backend        the cost model that priced it
    state_policy   per-layer K/V decode-state bitwidths (v2; None: fp state),
                   with ``state_registry_hash`` over the state surface
    pool           paged-pool geometry ``{"block", "num_blocks"}`` (v3; None:
                   the dense per-slot containers)
    draft_policy   self-speculative draft bitwidths over the same weight
                   registry (v4; None: no speculation); ``draft_k`` tokens
                   drafted per verify step (> 0 iff a draft policy is set)
    kernel_configs autotuned decode-step kernel configs (v5,
                   ``kernels/autotune.py``); the engine validates them
                   against its cache geometry and replays them
    provenance     how the search arrived at the policy (v6), validated on
                   build and on load
    meta           free-form notes
    """

    policy: BitPolicy
    registry_hash: str
    backend: str = ""
    report: dict = dataclasses.field(default_factory=dict)
    budget: Budget | None = None
    state_policy: BitPolicy | None = None
    state_registry_hash: str = ""
    pool: dict | None = None
    draft_policy: BitPolicy | None = None
    draft_k: int = 0
    kernel_configs: list | None = None
    provenance: dict | None = None
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = ARTIFACT_VERSION

    @classmethod
    def build(cls, policy: BitPolicy, *, backend: str = "", report: Mapping | None = None,
              budget: Budget | None = None, state_policy: BitPolicy | None = None,
              pool: Mapping | None = None, draft_policy: BitPolicy | None = None,
              draft_k: int = 0, kernel_configs: list | None = None,
              provenance: Mapping | None = None,
              meta: Mapping | None = None) -> "PolicyArtifact":
        if pool is not None:
            if state_policy is None:
                raise ValueError("pool geometry needs a state_policy (the "
                                 "pool stores packed state only)")
            missing = {"block", "num_blocks"} - set(pool)
            if missing:
                raise ValueError(f"pool geometry missing keys: {sorted(missing)}")
        if (draft_policy is not None) != (draft_k > 0):
            raise ValueError("draft_policy and draft_k > 0 go together "
                             f"(got draft_k={draft_k}, draft_policy="
                             f"{'set' if draft_policy is not None else 'None'})")
        if draft_policy is not None and (layer_registry_hash(draft_policy.layers)
                                         != layer_registry_hash(policy.layers)):
            raise ValueError("draft_policy must cover the same weight "
                             "registry as the deployed policy")
        if kernel_configs is not None:
            for e in kernel_configs:
                if not isinstance(e, Mapping) or {"key", "config"} - set(e):
                    raise ValueError("each kernel_configs entry needs 'key' and 'config' "
                                     f"(got {e!r})")
        if provenance is not None:
            validate_provenance(provenance)
        return cls(policy=policy, registry_hash=layer_registry_hash(policy.layers),
                   backend=backend, report=dict(report or {}), budget=budget,
                   state_policy=state_policy,
                   state_registry_hash=(layer_registry_hash(state_policy.layers)
                                        if state_policy is not None else ""),
                   pool=dict(pool) if pool is not None else None,
                   draft_policy=draft_policy, draft_k=int(draft_k),
                   kernel_configs=list(kernel_configs) if kernel_configs is not None else None,
                   provenance=dict(provenance) if provenance is not None else None,
                   meta=dict(meta or {}))

    def verify_layers(self, layers: Iterable[LayerInfo]) -> None:
        """Refuse to apply this artifact to a different layer registry."""
        got = layer_registry_hash(layers)
        if got != self.registry_hash:
            raise ValueError(f"policy artifact layer-registry hash mismatch: artifact was "
                             f"searched on {self.registry_hash}, model exposes {got}")

    def verify_state_layers(self, layers: Iterable[LayerInfo]) -> None:
        """Refuse to apply the state policy to a different state surface."""
        if self.state_policy is None:
            raise ValueError("artifact carries no state policy")
        got = layer_registry_hash(layers)
        if got != self.state_registry_hash:
            raise ValueError(f"policy artifact state-registry hash mismatch: artifact was "
                             f"searched on {self.state_registry_hash}, model exposes {got}")

    def to_json(self) -> str:
        def policy_json(p):
            return json.loads(p.to_json()) if p is not None else None

        return json.dumps(
            {
                "artifact_version": self.version,
                "registry_hash": self.registry_hash,
                "backend": self.backend,
                "report": self.report,
                "budget": self.budget.to_dict() if self.budget else None,
                "state_policy": policy_json(self.state_policy),
                "state_registry_hash": self.state_registry_hash,
                "pool": self.pool,
                "draft_policy": policy_json(self.draft_policy),
                "draft_k": self.draft_k,
                "kernel_configs": self.kernel_configs,
                "provenance": self.provenance,
                "meta": self.meta,
                "policy": json.loads(self.policy.to_json()),
            },
            indent=2)

    @classmethod
    def from_json(cls, s: str) -> "PolicyArtifact":
        d = json.loads(s)
        version = int(d.get("artifact_version", -1))
        if version not in READABLE_ARTIFACT_VERSIONS:
            raise ValueError(f"unsupported policy-artifact version {version} "
                             f"(this build reads {READABLE_ARTIFACT_VERSIONS})")

        def policy_of(key):
            return BitPolicy.from_json(json.dumps(d[key])) if d.get(key) else None

        provenance = d.get("provenance")
        if provenance is not None:
            validate_provenance(provenance)
        return cls(
            policy=BitPolicy.from_json(json.dumps(d["policy"])),
            registry_hash=d["registry_hash"],
            backend=d.get("backend", ""),
            report=dict(d.get("report") or {}),
            budget=Budget.from_dict(d["budget"]) if d.get("budget") else None,
            state_policy=policy_of("state_policy"),
            state_registry_hash=d.get("state_registry_hash", ""),
            pool=dict(d["pool"]) if d.get("pool") else None,
            draft_policy=policy_of("draft_policy"),
            draft_k=int(d.get("draft_k", 0)),
            kernel_configs=list(d["kernel_configs"]) if d.get("kernel_configs") else None,
            provenance=dict(provenance) if provenance is not None else None,
            meta=dict(d.get("meta") or {}),
            version=version)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "PolicyArtifact":
        with open(path) as f:
            return cls.from_json(f.read())
