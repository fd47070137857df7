"""Port parity of chunked-prefill continuous batching, the request lifecycle
and streaming: the twin of ``tests/test_scheduler.py`` for the decoder family.

Splitting a prompt's prefill into ``C``-token chunks interleaved with decode
turns changes scheduling only: every request's stream equals the port's
whole-prompt engine's and the JAX chunked engine's (``qimpl="xla"``, on the
same weights), across fp / quantized-dense / paged caches and chunk sizes
1, prime and >= the longest prompt, and the planner's ``SchedRecord``s equal
the JAX planner's turn by turn.  The budget invariants are asserted on
``engine._scheduler.records``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.models import registry as jregistry
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve_cli
from repro_torch.serve import (ChunkScheduler, LifecycleError, Request, RequestLifecycle,
                               RequestState, SchedulerConfig, ServeEngine)

torch.set_num_threads(2)

MAX_NEW = 8
# variable lengths: a shared prefix (paged CoW), a length-1 prompt (no
# prefill work at all) and a long prompt (several chunks at small C)
PROMPTS = {
    0: [9] * 11,
    1: [2, 3, 4],
    2: [5, 6, 7, 8, 1, 2, 3],
    3: [7],
    4: [5, 6, 7, 9, 4],
    5: list(range(1, 32)),
}

CONFIGS = {
    "fp": {},
    "quant-dense": {"state_bits": 8},
    "paged": {"state_bits": 4, "paged": True, "pool_blocks": 24},
}

CHUNKS = (1, 3, 7, 64)  # minimum, prime, prime, >= longest prompt

ENGINE_KW = dict(max_slots=2, max_seq=64, prefill_pad=8, debug_invariants=True)


@pytest.fixture(scope="module")
def models():
    jcfg = jgemma.CONFIG.reduced()
    api = jregistry.get_api(jcfg)
    jsp = api.unstack(api.init(jcfg, jax.random.key(0)), jcfg)
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    tsp = params_from_numpy(jax.tree.map(np.asarray, jsp), device="cpu")
    return jcfg, jsp, tcfg, tsp


def _engine(tcfg, tsp, config_key, **extra):
    return ServeEngine(tcfg, tsp, **ENGINE_KW, **CONFIGS[config_key], **extra, device="cpu")


def _requests(cls=Request):
    return [cls(uid=u, prompt=list(p), max_new_tokens=MAX_NEW) for u, p in PROMPTS.items()]


_REF: dict = {}


def _reference(tcfg, tsp, config_key):
    """The port's whole-prompt (chunk-free) streams, cached per config."""
    if config_key not in _REF:
        _REF[config_key] = _engine(tcfg, tsp, config_key).run(_requests())
    return _REF[config_key]


_JAX: dict = {}


def _jax_chunked(jcfg, jsp, config_key, chunk):
    """The JAX chunked engine's streams and ``SchedRecord``s, cached."""
    key = (config_key, chunk)
    if key not in _JAX:
        eng = JServeEngine(jcfg, jsp, qimpl="xla", prefill_chunk=chunk, **ENGINE_KW,
                           **CONFIGS[config_key])
        _JAX[key] = eng.run(_requests(JRequest)), _records(eng)
    return _JAX[key]


def _records(eng):
    return [dataclasses.asdict(r) for r in eng._scheduler.records]


def _assert_budget_invariants(eng):
    recs = eng._scheduler.records
    assert recs, "scheduler never planned a turn"
    budget = eng._scheduler.cfg.step_token_budget
    for r in recs:
        # the per-step token budget is a hard ceiling
        assert r.decode_tokens + r.chunk_tokens + r.finish_tokens <= budget, r
        # decode is never displaced: chunks only spend the leftover
        assert r.chunk_tokens <= budget - r.decode_tokens, r
    # every turn with a prefill backlog and leftover quota made progress
    stalled = [r for r in recs
               if r.n_prefilling and not r.chunk_tokens
               and budget - r.decode_tokens >= eng.prefill_chunk + 1]
    assert not stalled, stalled
    st = eng.stats()["scheduler"]
    assert st["max_step_tokens"] <= st["step_token_budget"]
    assert st["chunk_tokens"] == sum(r.chunk_tokens for r in recs)


# ---------------------------------------------------------------------------
# token identity: chunked == whole-prompt == the JAX chunked engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("config_key", sorted(CONFIGS))
def test_chunked_streams_identical(models, config_key, chunk):
    jcfg, jsp, tcfg, tsp = models
    ref = _reference(tcfg, tsp, config_key)
    eng = _engine(tcfg, tsp, config_key, prefill_chunk=chunk)
    out = eng.run(_requests())
    assert out == ref
    want, want_records = _jax_chunked(jcfg, jsp, config_key, chunk)
    assert out == want
    # the planner's turn-by-turn accounting equals the JAX planner's
    assert _records(eng) == want_records
    _assert_budget_invariants(eng)
    assert eng.stats()["prefill_chunks"] > 0
    for uid, p in PROMPTS.items():
        lc = eng.lifecycles[uid]
        assert lc.state is RequestState.DONE
        if len(p) > 1:
            assert lc.prefill_progress == len(p) - 1
    assert all(s.free for s in eng.slots)
    eng.check_invariants()
    if eng.paged:
        assert eng.pool.allocated == 0 and eng.pool.reserved == 0


def test_tight_budget_still_identical(models):
    """The floor budget (max_slots + C) forces at most one chunk per turn
    while both slots decode.  Still identical."""
    _, _, tcfg, tsp = models
    ref = _reference(tcfg, tsp, "quant-dense")
    eng = _engine(tcfg, tsp, "quant-dense", prefill_chunk=3, step_token_budget=2 + 3)
    out = eng.run(_requests())
    assert out == ref
    _assert_budget_invariants(eng)


# ---------------------------------------------------------------------------
# scheduler unit behaviour (host logic, the same cases as the JAX package's)
# ---------------------------------------------------------------------------


class TestChunkScheduler:
    def test_config_validation(self):
        with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
            SchedulerConfig(0, 10).validate(2)
        with pytest.raises(ValueError, match="starve forever"):
            SchedulerConfig(8, 9).validate(2)
        SchedulerConfig(8, 10).validate(2)

    def test_engine_rejects_budget_without_chunking(self, models):
        _, _, tcfg, tsp = models
        with pytest.raises(ValueError, match="prefill_chunk"):
            _engine(tcfg, tsp, "fp", step_token_budget=32)

    def test_decode_charged_first(self):
        sched = ChunkScheduler(SchedulerConfig(4, 6), max_slots=2)
        assert sched.plan(0, n_decode=6, prefilling=[(0, 10)]) == []
        assert sched.plan(1, n_decode=1, prefilling=[(0, 10)]) == [(0, 4)]
        r = sched.records[-1]
        assert (r.decode_tokens, r.chunk_tokens, r.finish_tokens) == (1, 4, 0)

    def test_final_chunk_charged_plus_one(self):
        sched = ChunkScheduler(SchedulerConfig(4, 6), max_slots=2)
        assert sched.plan(0, n_decode=2, prefilling=[(0, 4)]) == []
        assert sched.plan(1, n_decode=1, prefilling=[(0, 4)]) == [(0, 4)]
        assert sched.records[-1].finish_tokens == 1

    def test_round_robin_rotates(self):
        sched = ChunkScheduler(SchedulerConfig(4, 6), max_slots=2)
        first = sched.plan(0, 0, [(0, 100), (1, 100)])[0][0]
        second = sched.plan(1, 0, [(0, 100), (1, 100)])[0][0]
        assert {first, second} == {0, 1}

    def test_all_or_nothing_chunks(self):
        sched = ChunkScheduler(SchedulerConfig(4, 6), max_slots=2)
        assert sched.plan(0, n_decode=3, prefilling=[(0, 100)]) == []


# ---------------------------------------------------------------------------
# streaming, TTFT and the lifecycle
# ---------------------------------------------------------------------------


def test_streaming_callback_and_poll(models):
    _, _, tcfg, tsp = models
    ref = _reference(tcfg, tsp, "fp")
    eng = _engine(tcfg, tsp, "fp", prefill_chunk=3)
    streamed = {}
    for r in _requests():
        eng.submit(r, on_token=lambda uid, tok: streamed.setdefault(uid, []).append(tok))
    polled = {}

    def hook(engine, step):
        for uid, tok in engine.poll():  # a mid-run drain from a step hook
            polled.setdefault(uid, []).append(tok)

    out = eng.run(step_hook=hook)
    for uid, tok in eng.poll():  # the post-run drain picks up the tail
        polled.setdefault(uid, []).append(tok)
    assert streamed == ref and polled == ref and out == ref
    assert not list(eng.poll())  # the ring drains exactly once


def test_ttft_is_first_committed_token_not_first_chunk(models):
    """A chunked prompt makes prefill progress for several turns before any
    token commits: the lifecycle shows progress > 0 with no first token yet."""
    _, _, tcfg, tsp = models
    eng = _engine(tcfg, tsp, "fp", prefill_chunk=2)
    seen_mid_prefill = []

    def hook(engine, step):
        lc = engine.lifecycles.get(0)
        if lc is not None and lc.first_token_t is None:
            seen_mid_prefill.append(lc.prefill_progress)

    out = eng.run([Request(uid=0, prompt=list(PROMPTS[5]), max_new_tokens=MAX_NEW)],
                  step_hook=hook)
    assert len(out[0]) == MAX_NEW
    lc = eng.lifecycles[0]
    assert lc.ttft() is not None and lc.ttlt() >= lc.ttft()
    assert any(0 < p < len(PROMPTS[5]) - 1 for p in seen_mid_prefill)
    st = eng.stats()
    assert st["latency"]["ttft_s"]["count"] == 1
    assert st["latency"]["itl_s"]["count"] == MAX_NEW - 1


def test_lifecycle_edges_and_double_finalize():
    lc = RequestLifecycle(uid=7)
    with pytest.raises(LifecycleError, match="illegal transition"):
        lc.transition(RequestState.DECODE, 0.0)           # QUEUED -> DECODE skips PREFILL
    lc.transition(RequestState.PREFILL, 1.0)
    lc.transition(RequestState.QUEUED, 2.0)               # admission rejected
    lc.transition(RequestState.PREFILL, 3.0)
    lc.transition(RequestState.DECODE, 4.0)
    lc.transition(RequestState.DONE, 5.0)
    with pytest.raises(LifecycleError, match="already finalized"):
        lc.transition(RequestState.CANCELLED, 6.0)
    assert [s for s, _ in lc.history] == ["prefill", "queued", "prefill", "decode", "done"]


@pytest.mark.parametrize("config_key", ("quant-dense", "paged"))
def test_cancel_before_admission_mid_chunk_and_mid_decode(models, config_key):
    """Three cancellations: a queued request (uid 4 behind two slots), one
    mid-chunked-prefill (uid 5, 31 tokens at C=2) and one mid-decode (uid 0).
    The rest finish with the whole-prompt streams; the block and reservation
    accounting returns to empty under the invariant checker."""
    _, _, tcfg, tsp = models
    ref = _reference(tcfg, tsp, config_key)
    eng = _engine(tcfg, tsp, config_key, prefill_chunk=2)
    seen = {}

    def hook(engine, step):
        if 4 in {r.uid for r in engine._queue} and "queued" not in seen:
            engine.cancel(4)
            seen["queued"] = step
        lc5 = engine.lifecycles.get(5)
        if (lc5 is not None and lc5.state is RequestState.PREFILL
                and 0 < lc5.prefill_progress and "chunk" not in seen):
            engine.cancel(5)
            seen["chunk"] = lc5.prefill_progress
        lc0 = engine.lifecycles.get(0)
        if lc0 is not None and lc0.state is RequestState.DECODE and "decode" not in seen:
            slot = next(s for s in engine.slots if s.req is not None and s.req.uid == 0)
            if slot.generated:
                engine.cancel(0)
                seen["decode"] = len(slot.generated)

    reqs = _requests()
    order = [reqs[i] for i in (0, 5, 1, 2, 3, 4)]
    out = eng.run(order, step_hook=hook)
    assert set(seen) == {"queued", "chunk", "decode"}, seen
    states = {uid: eng.lifecycles[uid].state for uid in PROMPTS}
    assert states[4] is RequestState.CANCELLED and out[4] == []
    assert states[5] is RequestState.CANCELLED and out[5] == []
    assert states[0] is RequestState.CANCELLED
    assert 0 < len(out[0]) < MAX_NEW and out[0] == ref[0][:len(out[0])]
    for uid in (1, 2, 3):
        assert states[uid] is RequestState.DONE and out[uid] == ref[uid]
    assert "while queued" in eng.lifecycles[4].diagnostic
    st = eng.stats()
    assert st["cancelled"] == 3 and st["completed"] == 3
    assert all(s.free for s in eng.slots) and not eng._scratch
    if eng.paged:
        assert eng.pool.allocated == 0 and eng.pool.reserved == 0 and not eng._reserved
    eng.check_invariants()
    eng.cancel(1)                       # cancelling a terminal request is a no-op
    assert eng.run() == {} and eng.lifecycles[1].state is RequestState.DONE


def test_deadline_expires_queued_and_resident(models):
    """A zero TTFT budget expires at the first reap, before any admission
    (uid 0, queued); a deadline cut to zero once uid 5 holds a slot expires
    it resident at that turn's reap.  The others finish unchanged and the
    pool ends empty."""
    _, _, tcfg, tsp = models
    ref = _reference(tcfg, tsp, "paged")
    eng = _engine(tcfg, tsp, "paged", prefill_chunk=3)
    reqs = _requests()
    reqs[0].ttft_budget_s = 0.0
    cut = []

    def hook(engine, step):
        lc = engine.lifecycles[5]
        resident = any(s.req is not None and s.req.uid == 5 for s in engine.slots)
        if resident and not lc.terminal and not cut:
            lc.deadline_s = 0.0
            cut.append(lc.state)

    out = eng.run([reqs[i] for i in (5, 0, 1, 2, 3, 4)], step_hook=hook)
    assert cut == [RequestState.PREFILL]         # uid 5 expires mid-chunked-prefill
    for uid in (0, 5):
        assert eng.lifecycles[uid].state is RequestState.TIMED_OUT and out[uid] == []
    assert eng.lifecycles[0].diagnostic == "ttft budget exceeded while queued"
    assert eng.lifecycles[5].diagnostic == "deadline budget exceeded mid-decode"
    for uid in (1, 2, 3, 4):
        assert out[uid] == ref[uid]
    assert eng.stats()["timed_out"] == 2 and eng.stats()["completed"] == 4
    assert eng.pool.allocated == 0 and eng.pool.reserved == 0
    eng.submit(Request(uid=9, prompt=[1, 2]))
    with pytest.raises(LifecycleError, match="already live"):
        eng.submit(Request(uid=9, prompt=[1, 2]))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

CLI = ["--arch", "gemma-2b", "--reduced", "--requests", "6", "--max-new", "6", "--wbits",
       "mixed", "--device", "cpu"]


def _req_lines(capsys, argv):
    assert tserve_cli.main(argv) == 0
    return [line for line in capsys.readouterr().out.splitlines() if "req " in line]


def test_cli_chunked_prints_the_same_streams(capsys):
    plain = _req_lines(capsys, CLI)
    chunked = _req_lines(capsys, CLI + ["--prefill-chunk", "4", "--token-budget", "12"])
    assert plain and chunked == plain


def test_cli_budget_without_chunk_is_refused():
    with pytest.raises(ValueError, match="step_token_budget has no meaning without "
                                         "prefill_chunk"):
        tserve_cli.main(CLI + ["--token-budget", "12"])
