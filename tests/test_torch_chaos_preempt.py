"""Port parity of the serve path's priority preemption, of the fault sites
between two prefill chunks, and of per-request admission (the third part of
the twin of
``tests/test_chaos_serve.py``: ``tests/test_torch_chaos_serve.py`` holds the
setup, the configs and the comparison, ``tests/test_torch_chaos_sites.py``
the other fault sites).

As there, each case runs the port's engine and the JAX engine on one
workload (``_both``, or the two engines in turn with one step hook) and
holds them equal, then checks the reference test's laws against the port's
fault-free run.  The prompts share no block, so the copy-on-write ledger
difference moves no preemption here; the straggler shed is off in every
engine.  The ``batch_admission=False`` cases are the twins of
``tests/test_serve_engine.py::test_batched_admission_matches_sequential``.
"""
import pytest
import torch

from repro.serve import Request as JRequest
from repro_torch.serve import Request, RequestState, ServeEngine
from test_torch_chaos_serve import (MAX_NEW, PROMPTS, _assert_clean, _both, _engine,  # noqa: F401
                                    _jengine, _reference, _requests, _twins, setup)

torch.set_num_threads(2)


def test_priority_preemption_snapshots_and_resumes(setup):
    """Slot pressure and a strictly higher-priority waiter preempt the
    lowest-priority resident; the victim requeues, replays its prefix and
    finishes its full budget."""
    ref = _reference(setup, "paged")

    def hook_for(req):
        hi = req(uid=4, prompt=PROMPTS[4], max_new_tokens=MAX_NEW, priority=5)

        def hook(engine, step):
            if step == 2 and 4 not in engine.lifecycles:
                engine.submit(hi)
        return hook

    runs = []
    for make, req in ((_engine, Request), (_jengine, JRequest)):
        eng = make(setup, "paged", debug_invariants=True)
        runs.append((eng, eng.run(_requests(req, uids=range(3)), step_hook=hook_for(req))))
    (eng, out), (jeng, jout) = runs
    _twins(eng, out, jeng, jout)
    st = eng.stats()
    assert st["preemptions"] >= 1
    assert any(e["action"] == "preempt" for e in st["shed_events"])
    victims = [u for u, lc in eng.lifecycles.items() if lc.preemptions > 0]
    assert victims and 4 not in victims
    assert eng.lifecycles[4].state is RequestState.DONE
    assert out[4] == ref[4]
    for u in victims:
        lc = eng.lifecycles[u]
        assert lc.state is RequestState.DONE and len(out[u]) == MAX_NEW
        assert out[u][: len(lc.resume_tokens)] == lc.resume_tokens
        assert lc.resume_tokens == ref[u][: len(lc.resume_tokens)]
    _assert_clean(eng)


def test_equal_priorities_never_preempt(setup):
    eng, out = _both(setup, "paged")        # 5 equal-priority requests, 3 slots
    assert eng.stats()["preemptions"] == 0
    assert all(lc.state is RequestState.DONE for lc in eng.lifecycles.values())
    assert out == _reference(setup, "paged")
    _assert_clean(eng)


# ---------------------------------------------------------------------------
# mid-chunk fault sites: every PREFILL edge is valid between two chunks
# ---------------------------------------------------------------------------


def _mid_chunk(engine, uid):
    lc = engine.lifecycles.get(uid)
    return (lc is not None and lc.state.value == "prefill"
            and 0 < lc.prefill_progress < len(PROMPTS[uid]) - 1)


@pytest.fixture(scope="module")
def chunked_ref(setup):
    """Chunk-free reference for the paged-chunked config (same geometry)."""
    return _reference(setup, "paged-chunked", prefill_chunk=None)


def test_cancel_mid_chunk_frees_exactly_once(setup, chunked_ref):
    hit = set()                                       # the engines that cancelled

    def hook(engine, step):
        if id(engine) not in hit and _mid_chunk(engine, 2):
            hit.add(id(engine))
            engine.cancel(2)

    eng, out = _both(setup, "paged-chunked", hook=hook)
    assert len(hit) == 2, "uid 2 (11-token prompt) never observed mid-chunk"
    assert eng.lifecycles[2].state is RequestState.CANCELLED and out[2] == []
    for uid in PROMPTS:
        if uid != 2:
            assert out[uid] == chunked_ref[uid]
            assert eng.lifecycles[uid].state is RequestState.DONE
    assert eng.stats()["cancelled"] == 1
    _assert_clean(eng)


def test_deadline_mid_chunk_reaps_the_prefilling_slot(setup, chunked_ref):
    hit = set()

    def hook(engine, step):
        if id(engine) not in hit and _mid_chunk(engine, 2):
            hit.add(id(engine))
            engine.lifecycles[2].deadline_s = 1e-9     # expire between two chunks

    eng, out = _both(setup, "paged-chunked", hook=hook)
    assert len(hit) == 2
    lc = eng.lifecycles[2]
    assert lc.state is RequestState.TIMED_OUT and out[2] == []
    assert "deadline" in lc.diagnostic
    for uid in PROMPTS:
        if uid != 2:
            assert out[uid] == chunked_ref[uid]
    assert eng.stats()["timed_out"] == 1
    _assert_clean(eng)


def test_preempt_mid_chunk_restarts_prefill(setup, chunked_ref):
    def hook_for(req):
        hi = req(uid=4, prompt=PROMPTS[4], max_new_tokens=MAX_NEW, priority=5)

        def hook(engine, step):
            if 4 not in engine.lifecycles and any(_mid_chunk(engine, u) for u in PROMPTS):
                engine.submit(hi)
        return hook

    runs = []
    for make, req in ((_engine, Request), (_jengine, JRequest)):
        eng = make(setup, "paged-chunked", debug_invariants=True)
        runs.append((eng, eng.run(_requests(req, uids=range(3)), step_hook=hook_for(req))))
    (eng, out), (jeng, jout) = runs
    _twins(eng, out, jeng, jout)
    assert eng.stats()["preemptions"] >= 1
    victims = [u for u, lc in eng.lifecycles.items() if lc.preemptions > 0]
    assert victims and 4 not in victims
    assert out[4] == chunked_ref[4]
    for u in victims:
        lc = eng.lifecycles[u]
        assert lc.state is RequestState.DONE and len(out[u]) == MAX_NEW
        assert out[u][: len(lc.resume_tokens)] == lc.resume_tokens
        if not lc.resume_tokens:
            assert out[u] == chunked_ref[u]
    _assert_clean(eng)


def test_pool_exhaustion_between_chunks_requeues(setup):
    """A pool that fits two long chunked residents but not three serializes
    the third: requeued, not corrupted, while resident prefills keep chunking."""
    def long_reqs(req):
        return [req(uid=u, prompt=[u + 1] * 11, max_new_tokens=MAX_NEW) for u in range(3)]

    ref = _engine(setup, "paged-chunked", prefill_chunk=None, pool_blocks=4).run(
        long_reqs(Request))
    resident_high = []

    def hook(engine, step):
        if isinstance(engine, ServeEngine):
            resident_high.append(sum(not s.free for s in engine.slots))

    eng, out = _both(setup, "paged-chunked", requests=long_reqs, hook=hook, pool_blocks=4)
    assert max(resident_high) == 2
    assert all(eng.lifecycles[u].state is RequestState.DONE for u in range(3))
    assert out == ref
    _assert_clean(eng)


# ---------------------------------------------------------------------------
# per-request admission (batch_admission=False)
# ---------------------------------------------------------------------------

ADMIT_PROMPTS = [[5, 6, 7, 8], [1, 2, 9, 4, 7, 3], [9] * 11, [2], [3, 1, 4, 1, 5]]


@pytest.mark.parametrize("config_key", ["fp-dense", "quant-dense", "paged"])
def test_batched_admission_matches_sequential(setup, config_key):
    """One padded prefill for every free slot emits the same tokens as one
    prefill a request, in the port and in the JAX engine."""
    def reqs(req):
        return [req(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(ADMIT_PROMPTS)]

    kw = dict(max_slots=4, pool_blocks=12) if config_key == "paged" else dict(max_slots=4)
    batched = _engine(setup, config_key, **kw)
    out_b = batched.run(reqs(Request))
    eng = _engine(setup, config_key, batch_admission=False, debug_invariants=True, **kw)
    out_s = eng.run(reqs(Request))
    assert out_b == out_s
    jeng = _jengine(setup, config_key, batch_admission=False, **kw)
    assert jeng.run(reqs(JRequest)) == out_s
    # one prefill call a request with a head against fewer batched ones
    assert eng.stats()["admissions"] == sum(len(p) > 1 for p in ADMIT_PROMPTS)
    assert batched.stats()["admissions"] < eng.stats()["admissions"]
    assert eng.stats()["prefill_tokens"] == jeng.stats()["prefill_tokens"]
    _assert_clean(eng)
