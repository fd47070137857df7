"""Port parity of the serve-path observability (the twin of ``tests/test_obs.py``):
the tracer's no-op fast path, span nesting and the Chrome/Perfetto export,
the histograms, the engine's metrics-backed ``stats()`` view with its
calibration ratios, the per-request lifecycle spans of every terminal state,
the step-phase attribution and the tracing-overhead guard.

The tracer and metrics cases feed the same events and samples to the port's
classes and the JAX package's and compare what they give back: the exported
trace document key for key, the percentiles and summaries to rel 1e-12.  The
engine cases run the port's engine on reduced gemma-2b (plain versions on
the CPU) beside the JAX engine where a count can be compared.
``test_kernel_config_replay_traced`` runs the port's autotuner ("torch"
candidates) and checks the same span names on the ``kernel`` track, and the
engine's ``kernel_config_replayed`` instants when it installs a table.
"""
import json
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.models import registry as jregistry
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.lifecycle import ShedPolicy as JShedPolicy
from repro_torch.configs import gemma_2b
from repro_torch.convert import params_from_numpy
from repro_torch.obs import calibration as obs_calibration
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import NOOP_SPAN, Tracer, validate_chrome_trace
from repro_torch.runtime.resilience import FailureInjector
from repro_torch.serve import Request, RequestState, ServeEngine, ShedPolicy

torch.set_num_threads(2)

#: the straggler shed reads the host clock: off where two engines are compared
SHED = ShedPolicy(straggler_sheds_spec=False)


@pytest.fixture(autouse=True)
def _clean_global_tracer():
    """Never leak an enabled process-wide tracer into other tests."""
    yield
    obs_trace.disable()
    obs_trace.get_tracer().clear()


@pytest.fixture(scope="module")
def setup():
    cfg = jgemma.CONFIG.reduced()
    api = jregistry.get_api(cfg)
    sp = api.unstack(api.init(cfg, jax.random.key(0)), cfg)
    return cfg, sp, gemma_2b.CONFIG.reduced(), params_from_numpy(
        jax.tree.map(np.asarray, sp), device="cpu")


def _engine(setup, params=None, **kw):
    base = dict(max_slots=2, max_seq=64, prefill_pad=8, device="cpu")
    base.update(kw)
    return ServeEngine(setup[2], setup[3] if params is None else params, **base)


def _requests(n=3, max_new=6, req=Request, **kw):
    return [req(uid=i, prompt=[3 + i + j for j in range(4 + i)], max_new_tokens=max_new, **kw)
            for i in range(n)]


def _events_on(tracer, track):
    return [e for e in tracer.events() if e[3] == track]


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_disabled_tracer_is_noop_singleton():
    t = Tracer()
    assert not t.enabled
    s1 = t.span("a", args={"x": 1})
    s2 = t.span("b")
    assert s1 is NOOP_SPAN and s2 is NOOP_SPAN
    with s1:
        s1.annotate(ignored=True)
    t.instant("nope")
    t.counter("nope", 1.0)
    t.complete("nope", ts=0.0, dur=1.0)
    assert t.events() == []


def test_span_records_and_reenables_cleanly():
    t = Tracer()
    t.enable()
    with t.span("outer", cat="phase", args={"k": 1}):
        with t.span("inner"):
            pass
    t.disable()
    with t.span("after-disable"):
        pass
    evs = t.events()
    assert [e[1] for e in evs] == ["inner", "outer"]
    outer, inner = evs[1], evs[0]
    assert outer[4] <= inner[4]
    assert inner[4] + inner[5] <= outer[4] + outer[5] + 1e-9


def test_span_feeds_histogram():
    t = Tracer()
    t.enable()
    h = obs_metrics.Histogram()
    with t.span("timed", hist=h):
        pass
    assert h.count == 1 and h.sum > 0


def test_chrome_trace_schema_and_tracks():
    t = Tracer()
    t.enable()
    with t.span("phase_a", cat="phase", track="engine"):
        t.instant("marker", track="req/7", args={"uid": 7})
    t.counter("queue_depth", 3)
    doc = t.chrome_trace()
    validate_chrome_trace(doc)
    jtrace.validate_chrome_trace(doc)           # the reference's schema accepts it
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"phase_a", "marker", "queue_depth", "process_name", "thread_name"} <= names
    lanes = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert {"engine", "req/7", "counters"} <= lanes
    assert all(e.get("ts", 0) >= 0 for e in doc["traceEvents"])


def _feed(t):
    """One event sequence with explicit timestamps, over four tracks."""
    t.enable()
    t._t0 = 100.0
    t.complete("step", ts=100.5, dur=0.25, cat="step", track="engine", args={"step": 0})
    t.complete("dispatch", ts=100.55, dur=0.1, cat="phase", track="engine")
    t.instant("submit", cat="request", track="req/3", args={"uid": 3, "priority": 2},
              ts=100.25)
    t.counter("queue_depth", 4, ts=100.8)
    t.instant("shed:spec_shed", cat="degradation", track="engine",
              args={"action": "spec_shed", "k": 1}, ts=100.9)
    t.complete("decode", ts=100.3, dur=1.5, cat="request", track="req/3", args={"uid": 3})
    t.instant("done", cat="request", track="req/3", args={"uid": 3}, ts=101.8)
    t.counter("active_slots", 1, track="counters", ts=101.9)
    t.instant("nan_quarantine", cat="anomaly", track="req/5", args={"uid": 5}, ts=102.0)


def test_chrome_trace_document_equals_the_references():
    """The same event sequence gives the same document: keys, the
    track-to-tid mapping, phases, rebased microsecond timestamps."""
    t, j = Tracer(), jtrace.Tracer()
    _feed(t)
    _feed(j)
    doc, jdoc = t.chrome_trace(), j.chrome_trace()
    assert doc == jdoc
    assert json.dumps(doc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    assert t.chrome_trace(pid=3, process_name="x") == j.chrome_trace(pid=3, process_name="x")


def test_validate_rejects_malformed_docs():
    with pytest.raises(ValueError):
        validate_chrome_trace({"nope": []})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "tid": 1,
                                                "ts": 0.0}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "?", "name": "a", "pid": 0, "tid": 1,
                                                "ts": 0.0}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "i", "name": "a", "pid": 0, "tid": 1,
                                                "ts": -1.0}]})


def test_save_roundtrip(tmp_path):
    t = Tracer()
    t.enable()
    with t.span("x"):
        pass
    path = tmp_path / "trace.json"
    doc = t.save(str(path))
    assert json.loads(path.read_text()) == doc


def test_clear_and_now():
    t = Tracer()
    t.enable()
    t.instant("a")
    before = t.now()
    t.clear()
    assert t.events() == [] and t._t0 >= before and t.now() >= t._t0


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_counter_and_gauge():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("done")
    c.inc()
    c.inc(2.5)
    assert reg.counter("done") is c and c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(7)
    assert g.value == 7.0
    with pytest.raises(TypeError):
        reg.gauge("done")


@pytest.mark.parametrize("seed", range(3))
def test_histogram_matches_the_references(seed):
    """Percentiles, summaries, merges and state round trips equal the JAX
    package's on the same samples."""
    rng = np.random.default_rng(seed)
    buckets = sorted(float(x) for x in rng.uniform(0, 100, 12))
    vals = rng.uniform(-5, 120, 300)
    hs = [obs_metrics.Histogram(buckets=buckets), jmetrics.Histogram(buckets=buckets)]
    hd = [obs_metrics.Histogram(), jmetrics.Histogram()]
    for v in vals:
        for h in (*hs, *hd):
            h.observe(float(v) / (1 if h in hs else 1e3))
    for a, b in (hs, hd):
        assert a.counts == b.counts and a.count == b.count
        for p in (0, 1, 50, 90, 99, 100):
            assert a.percentile(p) == pytest.approx(b.percentile(p), rel=1e-12)
        assert a.summary() == pytest.approx(b.summary(), rel=1e-12)
        assert a.state() == b.state()
    a = obs_metrics.Histogram.from_state(hs[0].state())
    a.merge(hs[0])
    b = jmetrics.Histogram.from_state(hs[1].state())
    b.merge(hs[1])
    assert a.counts == b.counts and a.summary() == pytest.approx(b.summary(), rel=1e-12)


def test_histogram_percentiles_uniform():
    h = obs_metrics.Histogram(buckets=[float(x) for x in range(0, 1001, 10)])
    vals = np.arange(1, 1001, dtype=float)
    for v in vals:
        h.observe(v)
    for p in (50, 90, 99):
        assert abs(h.percentile(p) - float(np.percentile(vals, p))) <= 15.0
    assert h.min == 1.0 and h.max == 1000.0
    assert h.summary()["count"] == 1000


def test_histogram_single_sample_empty_and_overflow():
    h = obs_metrics.Histogram()
    h.observe(0.003)
    for p in (0, 50, 100):
        assert h.percentile(p) == pytest.approx(0.003)
    h = obs_metrics.Histogram(buckets=[1.0, 2.0])
    assert h.percentile(50) == 0.0 and h.summary()["count"] == 0
    h.observe(50.0)
    assert h.percentile(99) == pytest.approx(50.0)


def test_histogram_merge_rejects_mismatched_edges():
    a = obs_metrics.Histogram(buckets=[1.0, 2.0])
    with pytest.raises(ValueError, match="different bucket edges"):
        a.merge(obs_metrics.Histogram(buckets=[1.0, 2.0, 3.0]))


def test_registry_reset_keeps_instances():
    reg = obs_metrics.MetricsRegistry()
    c, g = reg.counter("done"), reg.gauge("depth")
    h = reg.histogram("lat", buckets=[1.0, 2.0])
    c.inc(3)
    g.set(7)
    h.observe(1.5)
    reg.reset()
    assert reg.counter("done") is c and c.value == 0.0
    assert g.value == 0.0 and h.count == 0 and h.sum == 0.0
    h.observe(0.5)
    assert h.count == 1 and reg.snapshot()["lat"]["count"] == 1


def test_calibration_module_matches_the_references():
    from repro.obs import calibration as jcal

    pred = {"container_bytes": 1000.0, "state_bytes": 64.0, "latency_s": 0.0, "x": 3.0}
    meas = {"container_bytes": 1000.0, "state_bytes": 80.0, "latency_s": 0.1, "x": 6.0}
    cal = obs_calibration.calibration_ratios(pred, meas)
    assert cal == jcal.calibration_ratios(pred, meas)
    assert set(cal) == {"container_bytes", "state_bytes"}          # latency 0 is skipped
    assert obs_calibration.max_ratio_error(cal) == pytest.approx(0.25)
    assert (obs_calibration.render_calibration_table(cal)
            == jcal.render_calibration_table(cal))
    assert obs_calibration.CALIBRATED_METRICS == jcal.CALIBRATED_METRICS


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------


def test_stats_view_is_metrics_backed(setup):
    eng = _engine(setup, shed=SHED)
    out = eng.run(_requests())
    st = eng.stats()
    for key in ("prefill_tokens", "decode_steps", "loop_turns", "completed", "failed",
                "cancelled", "timed_out", "wall_s", "shed_events", "health", "preemptions",
                "nan_quarantined", "nan_draft_fallbacks", "shed_tier", "speculate_live_k"):
        assert key in st, key
    assert st["completed"] == 3 == len(out)
    assert st["loop_turns"] >= st["decode_steps"] > 0
    assert st["wall_s"] > 0
    assert st["decode_steps"] == int(eng.metrics.counter("decode_steps").value)
    h = eng.metrics.histogram("step_time_s")
    assert h.count == st["loop_turns"]
    assert st["health"]["step_time_median_s"] == pytest.approx(h.percentile(50))
    assert eng.metrics.histogram("ttft_s").count == 3
    assert st["latency"]["ttft_s"]["count"] == 3
    # the same counts as the JAX engine on the same workload
    jeng = JServeEngine(setup[0], setup[1], max_slots=2, max_seq=64, prefill_pad=8,
                        qimpl="xla", shed=JShedPolicy(straggler_sheds_spec=False))
    assert jeng.run(_requests(req=JRequest)) == out
    jst = jeng.stats()
    for key in ("prefill_tokens", "decode_steps", "loop_turns", "completed"):
        assert st[key] == jst[key], key
    assert set(st["health"]) == set(jst["health"])


def test_stats_calibration_ratios(setup):
    """``stats()["calibration"]``: the packed-tree bytes agree exactly with the
    cost model's prediction, and the traced latency ratio appears only once
    the phase histograms hold samples."""
    from repro_torch.core.policy import BitPolicy, PolicyArtifact
    from repro_torch.cost.shift_add import ShiftAddCostModel
    from repro_torch.models import decoder as tdecoder
    from repro_torch.quant import apply as qapply

    cfg, tsp = setup[2], setup[3]
    params = tdecoder.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = qapply.layer_specs(params, cfg)
    rng = np.random.default_rng(1)
    policy = BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8])) for s in specs})
    report = ShiftAddCostModel().report(policy).as_costs()
    artifact = PolicyArtifact.build(policy, backend="shift_add", report=report)
    qp = qapply.quantize_for_serve(tsp, artifact, cfg)
    eng = _engine(setup, qp, artifact=artifact)
    assert eng.weight_container_bytes() == policy.container_bytes()
    eng.run(_requests(n=1, max_new=3))
    cal = eng.stats()["calibration"]
    assert cal["container_bytes"]["ratio"] == pytest.approx(1.0)
    assert "state_bytes" not in cal and "latency_s" not in cal
    obs_trace.enable()
    eng.run(_requests(n=1, max_new=3))
    obs_trace.disable()
    cal = eng.stats()["calibration"]
    assert "latency_s" in cal and cal["latency_s"]["measured"] > 0
    costs = eng.measured_costs()
    assert costs["latency_s"] == pytest.approx(
        eng.metrics.get("phase/dispatch").mean + eng.metrics.get("phase/device_sync").mean)


def test_stats_without_report_has_no_calibration(setup):
    eng = _engine(setup)
    eng.run(_requests(n=1, max_new=2))
    assert "calibration" not in eng.stats()
    assert set(eng.measured_costs()) == {"container_bytes"}   # fp weights and cache


def test_trace_report_attributes_step_time(setup):
    eng = _engine(setup)
    eng.run(_requests())
    obs_trace.enable()
    eng.run(_requests(n=2))
    obs_trace.disable()
    rep = eng.trace_report()
    assert rep["steps"] > 0
    assert set(rep["phases"]) <= {"hook", "reap", "admission", "prep", "dispatch",
                                  "device_sync", "commit", "bookkeeping"}
    assert "dispatch" in rep["phases"] and "device_sync" in rep["phases"]
    assert rep["attributed_fraction"] >= 0.90, rep
    assert rep["unattributed_fraction"] <= 0.10
    fracs = [p["fraction_of_step"] for p in rep["phases"].values()]
    assert abs(sum(fracs) - rep["attributed_fraction"]) < 1e-6


def test_trace_report_notes_untraced_engine(setup):
    eng = _engine(setup)
    eng.run(_requests(n=1))
    rep = eng.trace_report()
    assert rep["steps"] == 0 and "note" in rep


def test_lifecycle_spans_done(setup):
    eng = _engine(setup)
    obs_trace.enable()
    eng.run(_requests(n=1))
    evs = _events_on(obs_trace.get_tracer(), "req/0")
    names = [e[1] for e in evs]
    assert "submit" in names and "first_token" in names
    assert [e[1] for e in evs if e[0] == "X"] == ["queued", "prefill", "decode"]
    assert names[-1] == "done"


def test_lifecycle_spans_failed(setup):
    inj = FailureInjector(schedule={"nan_logit": (1,)})
    eng = _engine(setup, state_bits=8, fault_injector=inj)
    obs_trace.enable()
    eng.run(_requests(n=1))
    assert eng.lifecycles[0].state is RequestState.FAILED
    names = [e[1] for e in _events_on(obs_trace.get_tracer(), "req/0")]
    assert "nan_quarantine" in names and names[-1] == "failed"


def test_lifecycle_spans_cancelled(setup):
    eng = _engine(setup)

    def hook(engine, step):
        engine.cancel(0)

    obs_trace.enable()
    eng.run(_requests(n=1, max_new=32), step_hook=hook)
    assert eng.lifecycles[0].state is RequestState.CANCELLED
    names = [e[1] for e in _events_on(obs_trace.get_tracer(), "req/0")]
    assert names[-1] == "cancelled"


def test_lifecycle_spans_timed_out(setup):
    eng = _engine(setup)
    obs_trace.enable()
    eng.run([Request(uid=0, prompt=[3, 4, 5], max_new_tokens=4, deadline_s=0.0)])
    assert eng.lifecycles[0].state is RequestState.TIMED_OUT
    evs = _events_on(obs_trace.get_tracer(), "req/0")
    assert [e[1] for e in evs if e[0] == "X"] == ["queued"]
    assert [e[1] for e in evs][-1] == "timed_out"


def test_lifecycle_spans_preempted_requeue(setup):
    eng = _engine(setup, max_slots=1)
    fired = []

    def hook(engine, step):
        if step == 3 and not fired:
            fired.append(step)
            engine.submit(Request(uid=100, prompt=[9, 9, 9], max_new_tokens=4, priority=2))

    obs_trace.enable()
    out = eng.run(_requests(n=1, max_new=24), step_hook=hook)
    assert eng.lifecycles[0].state is RequestState.DONE
    assert eng.lifecycles[0].preemptions == 1
    assert len(out[0]) == 24
    evs = _events_on(obs_trace.get_tracer(), "req/0")
    names = [e[1] for e in evs]
    assert "requeued" in names
    spans = [e[1] for e in evs if e[0] == "X"]
    assert spans.count("decode") == 2 and spans.count("prefill") == 2
    assert names[-1] == "done"


def test_kernel_config_replay_traced(setup):
    from repro_torch.core.policy import BitPolicy, PolicyArtifact
    from repro_torch.kernels import autotune
    from repro_torch.kvcache import state_layer_infos
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply

    cfg = setup[2]
    obs_trace.enable()
    key = autotune.KernelKey(family="decode_step", k_bits=4, v_bits=4, heads=cfg.n_kv_heads,
                             head_dim=cfg.resolved_head_dim, block=16, impl="torch")
    entry = autotune.autotune_key(key, batch=2, blocks=4, repeats=1)
    tr = obs_trace.get_tracer()
    names = [e[1] for e in _events_on(tr, "kernel")]
    assert "autotune_candidate" in names and "autotune_winner" in names
    assert names.count("autotune_compile") == names.count("autotune_candidate") == 4
    # the engine replays the table and says so on the same track
    specs = qapply.layer_specs(decoder.init(cfg, torch.Generator().manual_seed(0),
                                            device="cpu"), cfg)
    art = PolicyArtifact.build(
        BitPolicy.uniform(specs, 8),
        state_policy=BitPolicy.uniform(state_layer_infos(cfg, 2, 64), 4),
        kernel_configs=[entry])
    tr.clear()
    try:
        _engine(setup, params=qapply.quantize_for_serve(setup[3], art, cfg), artifact=art)
        replayed = [e for e in _events_on(tr, "kernel") if e[1] == "kernel_config_replayed"]
    finally:
        autotune.set_active_configs(None)
    assert len(replayed) == 1


def test_tracing_overhead_bounded(setup):
    """Tracing stays cheap: 3x plus slack, so a noisy box never flakes while a
    pathological per-span cost still fails."""
    eng = _engine(setup)
    eng.run(_requests(n=2, max_new=8))

    def timed(traced):
        (obs_trace.enable if traced else obs_trace.disable)()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            eng.run(_requests(n=2, max_new=8))
            best = min(best, time.perf_counter() - t0)
        return best

    untraced = timed(False)
    traced = timed(True)
    obs_trace.disable()
    assert traced <= untraced * 3 + 0.05, (traced, untraced)


def test_serve_cli_trace_export(tmp_path, capsys):
    """``launch.serve --trace OUT.json`` saves a valid Chrome trace with the
    engine's step phases and request tracks, and prints the phase table."""
    from repro_torch.launch import serve

    path = tmp_path / "out.json"
    assert serve.main(["--reduced", "--requests", "2", "--max-new", "3", "--trace", str(path),
                       "--device", "cpu"]) == 0
    doc = json.loads(path.read_text())
    validate_chrome_trace(doc)
    jtrace.validate_chrome_trace(doc)
    lanes = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert {"engine", "req/0", "req/1"} <= lanes
    out = capsys.readouterr().out
    assert "step phases over" in out and "dispatch" in out
    assert not obs_trace.is_enabled()
