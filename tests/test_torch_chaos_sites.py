"""Port parity of the serve path's fault sites, one at a time (the second half
of the twin of ``tests/test_chaos_serve.py``; ``tests/test_torch_chaos_serve.py``
holds the randomized matrix, the tracing and the lifecycle units, and the
setup, the configs and the comparison this file shares;
``tests/test_torch_chaos_preempt.py`` preemption, the mid-chunk sites and
per-request admission).

Each case drives the port's engine and the JAX engine with the same requests
and the same ``FailureInjector`` schedule (``_both``): equal streams,
terminal states, preemption counts, counters and shed events, and then the
reference test's own laws against the port's fault-free run.  The prompts
share no block, so the copy-on-write ledger difference moves nothing here.
Every engine passes a ``ShedPolicy`` whose straggler shed cannot fire (it reads
the host clock, so it could shed K on one twin and not the other).
"""
import pytest
import torch

from repro_torch.runtime.resilience import FailureInjector
from repro_torch.serve import LifecycleError, Request, RequestState, ServeEngine
from test_torch_chaos_serve import (MAX_NEW, PROMPTS, _assert_clean, _both, _engine,  # noqa: F401
                                    _reference, setup)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# deterministic fault-site tests
# ---------------------------------------------------------------------------


def test_nan_quarantines_only_the_victim(setup):
    ref = _reference(setup, "quant-dense")
    eng, out = _both(setup, "quant-dense", {"nan_logit": (2,)})
    failed = [u for u, lc in eng.lifecycles.items() if lc.state is RequestState.FAILED]
    assert len(failed) == 1
    assert "non-finite logits" in eng.lifecycles[failed[0]].diagnostic
    for uid in PROMPTS:
        if uid not in failed:
            assert eng.lifecycles[uid].state is RequestState.DONE
            assert out[uid] == ref[uid]
    st = eng.stats()
    assert st["nan_quarantined"] == 1 and st["failed"] == 1


def test_draft_nan_falls_back_not_fails(setup):
    """A poisoned draft fails nothing: the round falls back to the verify
    token for that slot, so the workload equals the fault-free run."""
    ref = _reference(setup, "paged-spec")
    eng, out = _both(setup, "paged-spec", {"nan_logit_draft": (1,)})
    assert out == ref
    st = eng.stats()
    assert st["nan_draft_fallbacks"] >= 1
    assert st["failed"] == 0 and st["nan_quarantined"] == 0
    assert all(lc.state is RequestState.DONE for lc in eng.lifecycles.values())
    _assert_clean(eng)


def test_injected_pool_exhaustion_sheds_speculation_exactly(setup):
    ref = _reference(setup, "paged-spec")
    eng, out = _both(setup, "paged-spec", {"pool_exhaustion": (0,)})
    assert out == ref                     # K shedding is token-exact under greedy
    events = eng.stats()["shed_events"]
    assert any(e["action"] == "spec_shed" for e in events)
    assert any(e["action"] == "restore" for e in events)
    assert eng.stats()["health"]["shed_tier"] == 0 == eng.stats()["shed_tier"]
    assert eng.stats()["speculate_live_k"] == 2
    _assert_clean(eng)


def test_append_failure_quarantines_one_request(setup):
    ref = _reference(setup, "paged")
    eng, out = _both(setup, "paged", {"append_failure": (3,)})
    failed = [u for u, lc in eng.lifecycles.items() if lc.state is RequestState.FAILED]
    assert len(failed) == 1
    assert "append bookkeeping" in eng.lifecycles[failed[0]].diagnostic
    for uid in PROMPTS:
        if uid not in failed:
            assert out[uid] == ref[uid]
    _assert_clean(eng)


def test_artifact_mismatch_fault_refuses_start(setup):
    from repro_torch.core.policy import BitPolicy, PolicyArtifact
    from repro_torch.models import decoder as tdecoder
    from repro_torch.quant import apply as qapply

    _, _, cfg, tsp = setup
    params = tdecoder.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    policy = BitPolicy.uniform(qapply.layer_specs(params, cfg), 8)
    artifact = PolicyArtifact.build(policy, backend="shift_add")
    qp = qapply.quantize_for_serve(tsp, policy, cfg)
    # the artifact is served fine without the fault
    ServeEngine(cfg, qp, max_slots=2, max_seq=64, artifact=artifact, device="cpu")
    inj = FailureInjector(schedule={"artifact_mismatch": (0,)})
    with pytest.raises(ValueError, match="disagree with the policy artifact"):
        ServeEngine(cfg, qp, max_slots=2, max_seq=64, artifact=artifact,
                    fault_injector=inj, device="cpu")
    assert inj.exhausted


def test_cancel_deadline_and_ttft_paths(setup):
    ref = _reference(setup, "fp-dense")

    def reqs(req):
        return [req(uid=0, prompt=PROMPTS[0], max_new_tokens=MAX_NEW),
                req(uid=1, prompt=PROMPTS[1], max_new_tokens=MAX_NEW),
                # an already blown end-to-end budget: reaped before admission
                req(uid=2, prompt=PROMPTS[2], max_new_tokens=MAX_NEW, deadline_s=0.0),
                # generous budgets: must not fire
                req(uid=3, prompt=PROMPTS[3], max_new_tokens=MAX_NEW, deadline_s=3600.0,
                    ttft_budget_s=3600.0)]

    def hook(engine, step):
        if step == 3:
            engine.cancel(1)
            engine.cancel(999)           # an unknown uid: a no-op, never an error

    eng, out = _both(setup, "fp-dense", requests=reqs, hook=hook)
    lcs = eng.lifecycles
    assert lcs[0].state is RequestState.DONE and out[0] == ref[0]
    assert lcs[1].state is RequestState.CANCELLED
    assert out[1] == ref[1][: len(out[1])] and len(out[1]) < MAX_NEW
    assert lcs[2].state is RequestState.TIMED_OUT and out[2] == []
    assert "deadline" in lcs[2].diagnostic
    assert lcs[3].state is RequestState.DONE and out[3] == ref[3]
    assert lcs[0].ttft() is not None and lcs[0].ttlt() >= lcs[0].ttft()
    assert lcs[2].ttft() is None
    st = eng.stats()
    assert st["cancelled"] == 1 and st["timed_out"] == 1 and st["completed"] == 2


def test_submit_rejects_live_duplicate_uid(setup):
    eng = _engine(setup, "fp-dense")
    eng.submit(Request(uid=7, prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(LifecycleError, match="already live"):
        eng.submit(Request(uid=7, prompt=[3, 4], max_new_tokens=2))
    eng.run()
    assert eng.lifecycles[7].state is RequestState.DONE
    eng.submit(Request(uid=7, prompt=[1, 2], max_new_tokens=2))   # a terminal uid
    eng.run()
    assert eng.lifecycles[7].state is RequestState.DONE
