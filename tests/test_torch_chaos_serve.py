"""Port parity of the serve path's graceful degradation (the twin of
``tests/test_chaos_serve.py``): fault injection, NaN quarantine, the shed
ladder, priority preemption and resume, and the mid-chunk fault sites.

Reduced gemma-2b from the JAX package's seed-0 weights, bridged through
numpy.  Each case drives the port's engine (plain versions on the CPU) and
the JAX engine (``qimpl="xla"``) with the same requests and the same
``FailureInjector`` schedule, and holds the port to the JAX engine: equal
streams, terminal states, preemption counts and counters.  On top, the
reference test's own laws are checked against the port's fault-free run:
untouched survivors bitwise equal, casualties a prefix, preempted requests
their full budget with ``resume_tokens`` equal to the fault-free prefix, and
the pool drained (``debug_invariants`` ran after every turn).

Every engine here passes ``SHED``, a ``ShedPolicy`` whose straggler shed
cannot fire: that shed reads the host clock, so it could lower K on one
engine and not on its twin.  K shedding is token-exact under greedy decode,
but it moves the paged reservations and so the turn at which a waiting
request is admitted or preempted.

Where the copy-on-write ledger difference (the port charges a split with
``_cow_payer``, the JAX engine does not: ROADMAP.md section 3) could
move a preemption or a shed to another turn, a case is held against the
port's own fault-free run instead of the JAX engine.  These are the cases
whose prompts share a write block: ``test_donor_fails_before_its_sharers_split``
(the JAX engine's invariant checker fails on every copy-on-write split, and
its ledger keeps the split a failed donor's sharers no longer need).  The six
chaos configs' prompts share no block (no occupancy matches), so their
ledgers agree and every other case is held against the JAX engine.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.models import registry as jregistry
from repro.runtime.resilience import SERVE_FAULT_SITES as J_SITES
from repro.runtime.resilience import FailureInjector as JFailureInjector
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.lifecycle import ShedPolicy as JShedPolicy
from repro_torch.configs import gemma_2b
from repro_torch.convert import params_from_numpy
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.resilience import SERVE_FAULT_SITES, FailureInjector
from repro_torch.serve import (LifecycleError, Request, RequestState, ServeEngine,
                               ShedPolicy, spec_ladder)
from repro_torch.serve.lifecycle import TERMINAL_STATES, RequestLifecycle

torch.set_num_threads(2)

SEEDS = [int(s) for s in os.environ.get("CHAOS_SEEDS", "0").split(",")]

MAX_NEW = 8
PROMPTS = {
    0: [5, 6, 7, 8],
    1: [5, 6, 7, 9, 4],       # shares a prefix with 0 (no whole block: no CoW)
    2: [9] * 11,
    3: [2, 3],
    4: [5, 6, 7, 8, 1, 2],
}

CONFIGS = {
    "fp-dense": {},
    "quant-dense": {"state_bits": 8},
    "paged": {"state_bits": 4, "paged": True, "pool_blocks": 10},
    "paged-spec": {"state_bits": 4, "paged": True, "pool_blocks": 12,
                   "speculate": 2, "draft_policy": 4},
    "paged-chunked": {"state_bits": 4, "paged": True, "pool_blocks": 10,
                      "prefill_chunk": 3},
    # chunked prefill together with speculation
    "paged-spec-chunked": {"state_bits": 4, "paged": True, "pool_blocks": 12,
                           "speculate": 2, "draft_policy": 4, "prefill_chunk": 3},
}

#: the straggler shed reads the host clock: off, so twin engines stay twins
SHED = ShedPolicy(straggler_sheds_spec=False)
JSHED = JShedPolicy(straggler_sheds_spec=False)


@pytest.fixture(scope="module")
def setup():
    cfg = jgemma.CONFIG.reduced()
    api = jregistry.get_api(cfg)
    sp = api.unstack(api.init(cfg, jax.random.key(0)), cfg)
    tsp = params_from_numpy(jax.tree.map(np.asarray, sp), device="cpu")
    return cfg, sp, gemma_2b.CONFIG.reduced(), tsp


def _engine(setup, config_key, **extra):
    _, _, tcfg, tsp = setup
    kw = dict(max_slots=3, max_seq=64, prefill_pad=8, shed=SHED, device="cpu")
    kw.update(CONFIGS[config_key])
    kw.update(extra)
    return ServeEngine(tcfg, tsp, **kw)


def _jengine(setup, config_key, **extra):
    cfg, sp, _, _ = setup
    kw = dict(max_slots=3, max_seq=64, prefill_pad=8, qimpl="xla", shed=JSHED)
    kw.update(CONFIGS[config_key])
    kw.update(extra)
    return JServeEngine(cfg, sp, **kw)


def _requests(req=Request, priorities=None, uids=PROMPTS):
    priorities = priorities or {}
    return [req(uid=u, prompt=PROMPTS[u], max_new_tokens=MAX_NEW, priority=priorities.get(u, 0))
            for u in uids]


def _reference(setup, config_key, **extra):
    """The port's fault-free streams for the whole workload."""
    return _engine(setup, config_key, **extra).run(_requests())


def _assert_clean(eng):
    assert all(s.free for s in eng.slots)
    if eng.paged:
        assert eng.pool.allocated == 0, "leaked blocks"
        assert eng.pool.reserved == 0, "live reservations after drain"
    eng.check_invariants()


def _fates(eng):
    return {u: (lc.state.value, lc.preemptions, list(lc.resume_tokens))
            for u, lc in eng.lifecycles.items()}


COUNTERS = ("completed", "failed", "cancelled", "timed_out", "preemptions", "nan_quarantined",
            "nan_draft_fallbacks", "decode_steps", "spec_steps", "spec_proposed",
            "spec_accepted", "prefill_tokens", "prefill_chunks")


def _twins(eng, out, jeng, jout):
    """The port against the JAX engine on the same workload and schedule."""
    assert out == jout
    assert _fates(eng) == _fates(jeng)
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert ([(e["action"], e["step"], e["k"]) for e in st["shed_events"]]
            == [(e["action"], e["step"], e["k"]) for e in jst["shed_events"]])
    assert st["health"]["shed_tier"] == jst["health"]["shed_tier"]


def _both(setup, config_key, schedule=None, requests=None, hook=None, **extra):
    """Run the port and the JAX engine on one workload and one schedule."""
    runs = []
    for make, req, inj in ((_engine, Request, FailureInjector),
                           (_jengine, JRequest, JFailureInjector)):
        injector = inj(schedule=schedule) if schedule else None
        eng = make(setup, config_key, fault_injector=injector, debug_invariants=True, **extra)
        out = eng.run(requests(req) if requests else _requests(req), step_hook=hook)
        if injector is not None:
            assert injector.exhausted
        runs.append((eng, out))
    (eng, out), (jeng, jout) = runs
    _twins(eng, out, jeng, jout)
    return eng, out


# ---------------------------------------------------------------------------
# the randomized harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config_key", sorted(CONFIGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_matrix(setup, config_key, seed):
    ref = _reference(setup, config_key)
    rng = np.random.default_rng(0xC0FFEE + seed)
    spec = "speculate" in CONFIGS[config_key]
    paged = CONFIGS[config_key].get("paged", False)

    schedule = {"nan_logit": tuple(int(s) for s in rng.choice(20, size=1, replace=False))}
    if spec:
        schedule["nan_logit_draft"] = (int(rng.integers(1, 10)),)
    if paged:
        schedule["pool_exhaustion"] = tuple(int(s) for s in rng.choice(4, size=1))
        schedule["append_failure"] = (int(rng.integers(2, 14)),)
    cancel_uid = int(rng.integers(0, len(PROMPTS)))
    cancel_step = int(rng.integers(1, 12))

    def hook(engine, step):
        if step == cancel_step:
            engine.cancel(cancel_uid)

    runs = []
    for make, req, inj in ((_engine, Request, FailureInjector),
                           (_jengine, JRequest, JFailureInjector)):
        injector = inj(schedule=schedule)
        eng = make(setup, config_key, fault_injector=injector, debug_invariants=True)
        runs.append((eng, eng.run(_requests(req, priorities={4: 1}), step_hook=hook)))
    (eng, out), (jeng, jout) = runs
    _twins(eng, out, jeng, jout)

    assert set(out) == set(PROMPTS)
    for uid in PROMPTS:
        lc = eng.lifecycles[uid]
        assert lc.state in TERMINAL_STATES
        assert out[uid] == lc.tokens
        if lc.state is RequestState.DONE and lc.preemptions == 0:
            assert out[uid] == ref[uid], (uid, lc.state, lc.diagnostic)
        elif lc.preemptions == 0:
            assert out[uid] == ref[uid][: len(out[uid])], (uid, lc.diagnostic)
        else:
            if lc.state is RequestState.DONE:
                assert len(out[uid]) == MAX_NEW
            assert out[uid][: len(lc.resume_tokens)] == lc.resume_tokens
            assert lc.resume_tokens == ref[uid][: len(lc.resume_tokens)]
    _assert_clean(eng)


# ---------------------------------------------------------------------------
# port-only cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_same", [2, 3])
def test_donor_fails_before_its_sharers_split(setup, n_same):
    """Identical prompts share their donor's blocks, the write block too; an
    append failure fails the donor (slot 0) in the very turn they were
    admitted, before their first append splits the block.  A sole sharer no
    longer needs its split; of two, the first splits and the other is left
    the sole holder.  Either way the unneeded reservation is released, the
    ledger holds after every turn, and the sharers' streams equal the
    fault-free run.  Held against the port's own run: the JAX engine's checker
    fails on any copy-on-write split (the copy-on-write ledger difference)."""
    same = [3] * 20
    reqs = [Request(uid=u, prompt=same, max_new_tokens=MAX_NEW) for u in range(n_same)]
    ref = _engine(setup, "paged", pool_blocks=12).run(list(reqs))
    inj = FailureInjector(schedule={"append_failure": (0,)})
    eng = _engine(setup, "paged", pool_blocks=12, fault_injector=inj, debug_invariants=True)
    out = eng.run(list(reqs))
    assert inj.exhausted and eng.pool.shared_maps >= 2 * (n_same - 1)
    assert eng.lifecycles[0].state is RequestState.FAILED and out[0] == []
    assert eng.pool.cow_copies == n_same - 2
    for u in range(1, n_same):
        assert eng.lifecycles[u].state is RequestState.DONE and out[u] == ref[u]
    _assert_clean(eng)


def test_straggler_sheds_speculation_to_one_not_below(setup):
    """A monitor that flags every dispatch sheds one tier a turn, K 4 -> 2 -> 1,
    and never turns speculation off; greedy streams stay the fault-free ones."""
    from repro_torch.runtime.resilience import StragglerMonitor

    ref = _reference(setup, "paged-spec")
    eng = _engine(setup, "paged-spec", speculate=4, shed=ShedPolicy(), debug_invariants=True)
    eng._straggler = StragglerMonitor(warmup=1, threshold=0.0)
    out = eng.run(_requests())
    assert out == ref
    sheds = [e["k"] for e in eng.stats()["shed_events"] if e["action"] == "straggler_shed"]
    # the first two flags step 4 -> 2 -> 1; a pressure-free turn may restore
    # K 2 and the next flag sheds it again, never to 0
    assert sheds[:2] == [2, 1] and min(sheds) == 1
    assert eng.stats()["health"]["straggler_flagged"] >= 2
    _assert_clean(eng)


def test_nan_flags_ride_the_token_transfer(setup, monkeypatch):
    """The per-slot flags come back in the tokens' own copy: one ``.cpu()`` a
    step, with or without an injector, plain and speculative."""
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **kw: calls.append(t.shape)
                        or real(t, *a, **kw))
    for key, schedule in (("quant-dense", {"nan_logit": (2,)}), ("quant-dense", None),
                          ("paged-spec", {"nan_logit_draft": (1,), "nan_logit": (3,)})):
        calls.clear()
        inj = FailureInjector(schedule=schedule) if schedule else None
        eng = _engine(setup, key, fault_injector=inj)
        eng.run(_requests())
        assert len(calls) == eng.stats()["decode_steps"], key
        k = eng.speculate
        assert all(s == ((3, k + 4) if k else (3, 2)) for s in calls), calls
        if schedule and "nan_logit" in schedule:
            assert eng.stats()["nan_quarantined"] == 1


# ---------------------------------------------------------------------------
# the lifecycle state machine and the fault sites (host-side units)
# ---------------------------------------------------------------------------


class TestLifecycleMachine:
    def test_happy_path(self):
        lc = RequestLifecycle(uid=0, enqueued_t=0.0)
        for s, t in [(RequestState.PREFILL, 1.0), (RequestState.DECODE, 2.0),
                     (RequestState.DONE, 3.0)]:
            lc.transition(s, t)
        assert lc.terminal and lc.finished_t == 3.0 and lc.admitted_t == 1.0
        assert [s for s, _ in lc.history] == ["prefill", "decode", "done"]

    def test_illegal_transition_raises(self):
        with pytest.raises(LifecycleError, match="illegal transition"):
            RequestLifecycle(uid=0).transition(RequestState.DONE, 0.0)

    def test_terminal_states_absorb(self):
        lc = RequestLifecycle(uid=0)
        lc.transition(RequestState.CANCELLED, 0.0)
        for s in RequestState:
            with pytest.raises(LifecycleError, match="already finalized"):
                lc.transition(s, 1.0)

    def test_preemption_round_trip(self):
        lc = RequestLifecycle(uid=0)
        for s, t in [(RequestState.PREFILL, 0.0), (RequestState.DECODE, 1.0),
                     (RequestState.QUEUED, 2.0), (RequestState.PREFILL, 3.0),
                     (RequestState.DECODE, 4.0), (RequestState.DONE, 5.0)]:
            lc.transition(s, t)
        assert lc.terminal

    def test_expiry_budgets(self):
        lc = RequestLifecycle(uid=0, enqueued_t=0.0, deadline_s=10.0, ttft_budget_s=2.0)
        assert lc.expired(1.0) is None
        assert lc.expired(3.0) == "ttft"
        lc.first_token_t = 1.5
        assert lc.expired(3.0) is None
        assert lc.expired(11.0) == "deadline"
        lc.transition(RequestState.TIMED_OUT, 11.0)
        assert lc.expired(12.0) is None

    def test_spec_ladder(self):
        assert spec_ladder(4) == [4, 2, 1, 0]
        assert spec_ladder(3) == [3, 1, 0]
        assert spec_ladder(1) == [1, 0]
        assert spec_ladder(0) == [0]

    def test_serve_fault_sites_frozen(self):
        assert set(SERVE_FAULT_SITES) == {
            "pool_exhaustion", "nan_logit", "nan_logit_draft", "append_failure",
            "artifact_mismatch"}
        assert SERVE_FAULT_SITES == J_SITES


@pytest.mark.parametrize("seed", range(3))
def test_failure_injector_matches_jax(seed):
    """Both injectors consume the same random schedule the same way."""
    rng = np.random.default_rng(seed)
    schedule = {s: tuple(int(x) for x in rng.choice(12, size=2, replace=False))
                for s in SERVE_FAULT_SITES}
    t, j = FailureInjector(schedule=schedule), JFailureInjector(schedule=schedule)
    for step in range(14):
        for site in SERVE_FAULT_SITES:
            assert t.fires(site, step) == j.fires(site, step)
            assert t.fires(site, step) is False          # consume-once
    assert t.fired == j.fired and t.exhausted and j.exhausted
    t2, j2 = FailureInjector(fail_at=(2,)), JFailureInjector(fail_at=(2,))
    for inj in (t2, j2):
        inj.check(1)
        with pytest.raises(RuntimeError, match="injected failure at step step 2"):
            inj.check(2)
        inj.check(2)


# ---------------------------------------------------------------------------
# tracing never perturbs the serve path
# ---------------------------------------------------------------------------


def test_traced_run_is_bitwise_identical(setup):
    """Enabling the tracer changes no token: the speculative paged config,
    traced, equals its untraced run, with every invariant swept."""
    ref = _reference(setup, "paged-spec")
    obs_trace.enable()
    try:
        eng = _engine(setup, "paged-spec", debug_invariants=True)
        out = eng.run(_requests())
    finally:
        obs_trace.disable()
    assert out == ref
    tr = obs_trace.get_tracer()
    assert any(e[1] == "step" for e in tr.events())
    assert any(e[3].startswith("req/") for e in tr.events())
    obs_trace.validate_chrome_trace(tr.chrome_trace())
    tr.clear()
    _assert_clean(eng)
