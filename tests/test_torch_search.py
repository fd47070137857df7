"""Port parity of the SigmaQuant policy search, on the CPU.

The port's controller gives the JAX controller's trace, final policy and
``SearchReport.digest()`` on synthetic envs (the content is decisions, so
no tolerance).  One AdamW and one SGD step over a tree with stacked
``(L, d)`` leaves agree within rel 1e-6.  On reduced gemma-2b (f32) with
the JAX package's weights: the QAT loss within rel 1e-5 and each gradient
leaf within rel 1e-4 (the ``_rel`` of ``tests/test_kernel_parity.py``),
eight ``LMQuantEnv`` QAT steps within rel 1e-4 each when both envs start
every step from the same params and moments (run freely, the two drift
apart: see ``test_free_running_qat_drift_is_recorded``), and
``search_policy`` on shared batches gives the JAX search's per-step bit
trace and final policy; a microbatched step accumulates as the JAX one.  The command line writes an artifact both packages
load and the port serves (with the state phase, a pool and a draft too),
and refuses to run without a card unless asked.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.quant.env as jenv
from repro import configs as jconfigs
from repro.configs.base import ShapeSpec as JShape
from repro.core import policy as jpol
from repro.core.controller import ControllerConfig as JCC
from repro.core.controller import SigmaQuantController as JController
from repro.data import pipeline as jpipe
from repro.launch import search as jsearch
from repro.models import decoder as jdec
from repro.models import registry as jreg
from repro.quant import apply as japply
from repro.train import optimizer as jopt
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeSpec as TShape
from repro_torch.convert import params_from_numpy, to_tensor
from repro_torch.core import policy as tpol
from repro_torch.core.controller import ControllerConfig as TCC
from repro_torch.core.controller import SigmaQuantController as TController
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import search as tsearch
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as treg
from repro_torch.obs import search as tobs_search
from repro_torch.obs import trace as ttrace
from repro_torch.quant import apply as tapply
from repro_torch.quant.env import LMQuantEnv as TEnv
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig as TTrainConfig
from repro_torch.train.train_step import make_train_step as tmake_train_step
from repro_torch.train.train_step import value_and_grad
from test_core_controller import SyntheticEnv, make_layers

torch.set_num_threads(2)

SEQ, BATCH = 16, 4


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _np_batch(step: int, vocab: int = 512) -> dict:
    """The batch both packages' envs see at ``step`` (numpy, seeded by step)."""
    s = np.random.default_rng([7, step % 2**31]).integers(0, vocab, (BATCH, SEQ + 1))
    return {"tokens": s[:, :-1].astype(np.int32), "labels": s[:, 1:].astype(np.int32)}


@pytest.fixture
def shared_batches(monkeypatch):
    """JAX env batches from ``_np_batch`` (nothing in the JAX package changes)."""
    monkeypatch.setattr(jenv, "global_batch", lambda task, cfg, shape, step: {
        k: jnp.asarray(v) for k, v in _np_batch(step).items()})
    return lambda task, cfg, shape, step: _np_batch(step)


def _model(seed: int):
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdec.init(jcfg, jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _mixed(specs, seed: int):
    rng = np.random.default_rng(seed)
    tp = tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8])) for s in specs})
    return tp, jpol.BitPolicy.from_json(tp.to_json())


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


def _synthetic_pair(seed: int):
    jl = make_layers(12, seed=seed)
    tl = tuple(tpol.LayerInfo(l.name, l.shape, l.macs, l.kind) for l in jl)
    return SyntheticEnv(jl, seed=seed), SyntheticEnv(tl, seed=seed)


def _targets(kind: str, env: SyntheticEnv):
    full8 = jpol.BitPolicy.uniform(env.layers_, 8).model_size_mib()
    if kind == "feasible":
        t = env.feasible_targets()
    elif kind == "tight":
        t = jpol.Targets(acc_t=0.70, res_t=0.6 * full8)
    else:
        t = jpol.Targets(acc_t=0.99, res_t=0.05, acc_buffer=0.001, res_buffer=0.001)
    return t, tpol.Targets(t.acc_t, t.res_t, t.acc_buffer, t.res_buffer, t.abandon_factor)


@pytest.mark.parametrize("kind", ("feasible", "tight", "abandon"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_controller_decisions_and_digest_equal_jax(kind, seed):
    jenv_, tenv_ = _synthetic_pair(seed)
    jt, tt = _targets(kind, jenv_)
    cfg = dict(phase2_max_iters=12, phase1_qat_epochs=1, phase2_qat_epochs=1)
    jr = JController(jenv_, jt, JCC(**cfg), phase="weight").run()
    tr = TController(tenv_, tt, TCC(**cfg), phase="weight").run()
    assert [(e.phase, e.step, e.acc, e.resource, e.zone, e.bits, e.note) for e in jr.trace] == \
        [(e.phase, e.step, e.acc, e.resource, e.zone, e.bits, e.note) for e in tr.trace]
    assert jr.policy.bits == tr.policy.bits
    assert (jr.success, jr.abandoned) == (tr.success, tr.abandoned)
    assert jr.search_report.digest() == tr.search_report.digest()


def test_traced_controller_records_spans_and_keeps_its_decisions():
    """With the process tracer on, the controller adds its phase and
    iteration spans and counters, and the env's work spans; the decisions
    (and so the digest) are the untraced run's."""
    _, plain_env = _synthetic_pair(1)
    _, traced_env = _synthetic_pair(1)
    _, tt = _targets("tight", plain_env)
    cfg = TCC(phase2_max_iters=8, phase1_qat_epochs=1, phase2_qat_epochs=1)
    plain = TController(plain_env, tt, cfg, phase="weight").run()
    tracer = ttrace.enable()
    try:
        traced = TController(traced_env, tt, cfg, phase="weight").run()
        with tobs_search.work_span("sigmas", n=1):
            pass
        events = tracer.events()
    finally:
        ttrace.disable()
    assert traced.search_report.digest() == plain.search_report.digest()
    names = {e[1] for e in events}
    assert {"search/weight", "weight/phase2", "weight/acc", "env/sigmas"} <= names
    assert any(n.startswith("weight/p2.") for n in names)
    assert tobs_search.work_span("sigmas") is ttrace.NOOP_SPAN


# ---------------------------------------------------------------------------
# trace attribution and controller tracing (twins of tests/test_search_obs.py)
# ---------------------------------------------------------------------------


def _ev(pkg, name, cat, ts, dur):
    return ("X", name, getattr(pkg, cat), pkg.TRACK, ts, dur, None)


TRACE_CASES = {
    "work_clipped_to_root_union": lambda m: [
        _ev(m, "search/run", "PHASE_CAT", 0.0, 10.0), _ev(m, "env/a", "WORK_CAT", 1.0, 2.0),
        _ev(m, "env/b", "WORK_CAT", 2.0, 3.0), _ev(m, "env/c", "WORK_CAT", 20.0, 5.0)],
    "no_root_uses_work_union": lambda m: [
        _ev(m, "env/a", "WORK_CAT", 1.0, 4.0), _ev(m, "env/b", "WORK_CAT", 20.0, 5.0)],
    "non_search_categories_ignored": lambda m: [
        _ev(m, "search/run", "PHASE_CAT", 0.0, 10.0), _ev(m, "weight/p2.1", "PHASE_CAT", 0.0, 9.0),
        ("X", "decode", "engine.phase", "engine", 0.0, 8.0, None),
        ("i", "marker", m.WORK_CAT, m.TRACK, 1.0, 0.0, None)],
    "empty": lambda m: [],
}
TRACE_WANT = {"work_clipped_to_root_union": (10.0, 4.0, 0.4),
              "no_root_uses_work_union": (9.0, 9.0, 1.0),
              "non_search_categories_ignored": (10.0, 0.0, 0.0), "empty": (0.0, 0.0, 0.0)}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_search_trace_report_equals_jax(case):
    from repro.obs import search as jobs_search

    got = tobs_search.search_trace_report(TRACE_CASES[case](tobs_search))
    assert got == jobs_search.search_trace_report(TRACE_CASES[case](jobs_search))
    total, attributed, frac = TRACE_WANT[case]
    assert (got["total_s"], got["attributed_s"]) == pytest.approx((total, attributed))
    assert got["attributed_fraction"] == pytest.approx(frac)
    if case == "work_clipped_to_root_union":
        assert got["spans"]["env/a"] == {"count": 1, "total_s": 2.0}


class TracedSyntheticEnv(SyntheticEnv):
    """SyntheticEnv emitting the port's work spans with a real (tiny) duration."""

    NAP = 0.002

    def _napping(name):
        def call(self, *a, **kw):
            with tobs_search.work_span(name):
                time.sleep(self.NAP)
                return getattr(SyntheticEnv, name)(self, *a, **kw)
        return call

    sigmas = _napping("sigmas")
    sensitivities = _napping("sensitivities")
    evaluate = _napping("evaluate")
    calibrate_and_qat = _napping("calibrate_and_qat")


def _traced_run(seed: int = 0):
    layers = tuple(tpol.LayerInfo(l.name, l.shape, l.macs, l.kind) for l in make_layers(12, seed))
    env = TracedSyntheticEnv(layers, seed=seed)
    t = env.feasible_targets()
    targets = tpol.Targets(t.acc_t, t.res_t, t.acc_buffer, t.res_buffer, t.abandon_factor)
    return TController(env, targets, TCC(phase2_max_iters=40), phase="weight").run()


def test_traced_search_attributes_env_time_and_keeps_its_digest():
    untraced = _traced_run(5)
    tracer = ttrace.enable()
    try:
        res = _traced_run(5)
        rep = tobs_search.search_trace_report()
        evs = tracer.events()
        doc = tracer.chrome_trace()
    finally:
        ttrace.disable()
        tracer.clear()
    assert res.search_report.digest() == untraced.search_report.digest()
    names = {e[1] for e in evs if e[0] == "X"}
    assert {"search/weight", "env/evaluate", "env/sigmas", "env/sensitivities",
            "env/calibrate_and_qat"} <= names
    it = next(e for e in evs if e[0] == "X" and e[1].startswith("weight/p0."))
    assert it[2] == tobs_search.PHASE_CAT and set(it[6]) >= {"zone", "acc", "bits", "worst"}
    root = next(e for e in evs if e[1] == "search/weight")
    assert root[6]["digest"] == res.search_report.digest()
    assert rep["attributed_fraction"] > 0.5, rep
    assert rep["spans"]["env/evaluate"]["count"] >= 2
    ttrace.validate_chrome_trace(doc)


# ---------------------------------------------------------------------------
# optimizer, QAT loss and steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ("adamw", "sgd"))
def test_optimizer_steps_match_jax(name):
    rng = np.random.default_rng(5)
    tree = {"embed": rng.standard_normal((11, 6)), "final_norm": rng.standard_normal(6),
            "layers": {"ln1": 1 + 0.1 * rng.standard_normal((3, 6)),
                       "w": rng.standard_normal((3, 6, 5))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
                          tree) for _ in range(3)]
    jcfg = jopt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2, decay_steps=5,
                                grad_clip=0.5)
    tcfg = topt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2, decay_steps=5,
                                grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jopt.init(jcfg, jp)
    tp = params_from_numpy(tree, device="cpu")
    tst = topt.init(tcfg, tp)
    for g in grads:
        jp, jst, jm = jopt.apply(jcfg, jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst, tm = topt.apply(tcfg, [to_tensor(x, device="cpu") for x in jax.tree.leaves(g)],
                                 tst, tp)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
        for a, b in zip(jax.tree.leaves(jp), topt.leaves(tp)):
            assert _rel(b, a) <= 1e-6
        for key in ("m", "v") if name == "adamw" else ("m",):
            for a, b in zip(jax.tree.leaves(jst[key]), tst[key]):
                assert _rel(b, a) <= 1e-6
    # the stacked (L, d) norm scales decay (ndim >= 2), the 1-D final norm does not
    assert tst["step"] == 3 == int(jst["step"])


def test_qat_loss_and_gradients_match_jax():
    jcfg, tcfg, jp, tp = _model(3)
    tpolicy, jpolicy = _mixed(tapply.layer_specs(tp, tcfg), 1)
    batch = _np_batch(0)
    jb = japply.bits_for_scan(jpolicy, jp, jcfg)
    tb = tapply.bits_for_scan(tpolicy, tp, tcfg)
    assert jax.tree.map(lambda a: np.asarray(a).tolist(), jb) == tb
    jl, jg = jax.value_and_grad(lambda p: jreg.get_api(jcfg).loss(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, bits=jb))(jp)
    tl, tg = value_and_grad(lambda p, b, bits: treg.get_api(tcfg).loss(p, tcfg, b, bits=bits),
                            tp, {k: torch.as_tensor(v).long() for k, v in batch.items()}, tb)
    assert _rel(tl, jl) <= 1e-5
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        assert b.shape == a.shape and _rel(b, a) <= 1e-4


def test_microbatched_train_step_matches_jax():
    """Two microbatches: the loss and gradients accumulate in f32 and are
    scaled by 1/2 before one AdamW update; params within rel 1e-4."""
    jcfg, tcfg, jp, tp = _model(5)
    tpolicy, jpolicy = _mixed(tapply.layer_specs(tp, tcfg), 3)
    batch = _np_batch(1)
    jstep = jmake_train_step(jcfg, JTrainConfig(microbatches=2), lambda p, b, bits: jreg.get_api(
        jcfg).loss(p, jcfg, b, bits=bits))
    tstep = tmake_train_step(tcfg, TTrainConfig(microbatches=2), lambda p, b, bits: treg.get_api(
        tcfg).loss(p, tcfg, b, bits=bits))
    jp2, _, jm = jstep(jp, jopt.init(jopt.OptimizerConfig(), jp),
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       japply.bits_for_scan(jpolicy, jp, jcfg))
    tp2, _, tm = tstep(tp, topt.init(topt.OptimizerConfig(), tp),
                       {k: torch.as_tensor(v).long() for k, v in batch.items()},
                       tapply.bits_for_scan(tpolicy, tp, tcfg))
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-4
    for a, b in zip(jax.tree.leaves(jp2), topt.leaves(tp2)):
        assert _rel(b, a) <= 1e-4


def _envs(seed: int, batches):
    jcfg, tcfg, jp, tp = _model(seed)
    je = jenv.LMQuantEnv(jp, jcfg, JShape("s", "train", SEQ, BATCH), qat_steps_per_epoch=1)
    te = TEnv(tp, tcfg, TShape("s", "train", SEQ, BATCH), qat_steps_per_epoch=1,
              batches=batches)
    return je, te


def _hand_over(je, te) -> None:
    """Carry the JAX env's params and moments into the port's env."""
    for dst, src in zip(topt.leaves(te.params), jax.tree.leaves(je.params)):
        dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    for key in ("m", "v"):
        for dst, src in zip(te._opt_state[key], jax.tree.leaves(je._opt_state[key])):
            dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    assert te._opt_state["step"] == int(je._opt_state["step"])


def test_qat_steps_match_jax_from_shared_state(shared_batches):
    je, te = _envs(0, shared_batches)
    tpolicy, jpolicy = _mixed(te.layer_infos(), 1)
    assert [l.name for l in te.layer_infos()] == [l.name for l in je.layer_infos()]
    for _ in range(8):
        _hand_over(je, te)
        je.calibrate_and_qat(jpolicy, 1)
        te.calibrate_and_qat(tpolicy, 1)
        for a, b in zip(jax.tree.leaves(je.params), topt.leaves(te.params)):
            assert _rel(b, a) <= 1e-4
    assert te.train_steps == 8
    assert _rel(te.evaluate(tpolicy), je.evaluate(jpolicy)) <= 1e-5


def test_free_running_qat_drift_is_recorded(shared_batches):
    """Eight QAT steps without the hand-over: one step agrees at rel 1.0e-5;
    then Adam turns rounding noise in near-zero gradients (|g| near eps) into
    parameter moves of a fraction of the learning rate, and a moved weight
    that crosses a rounding boundary of a 2- or 4-bit grid changes the next
    forward pass by a whole step.  Measured (the same on 1 and 8 CPU
    threads): rel 1.0e-5 after steps 1 and 2, then 7.9e-4, 1.2e-3, 4.6e-3,
    9.3e-3, 1.7e-2 and 2.8e-2 after step 8 (ROADMAP queue 3).  Limits: 1e-4
    for the first two steps, and 5e-2 for every step (the step-8 reading
    with room).  The decisions the search takes on such runs are held in
    ``test_search_policy_matches_jax``."""
    je, te = _envs(0, shared_batches)
    tpolicy, jpolicy = _mixed(te.layer_infos(), 1)
    drift = []
    for _ in range(8):
        je.calibrate_and_qat(jpolicy, 1)
        te.calibrate_and_qat(tpolicy, 1)
        drift.append(max(_rel(b, a) for a, b in
                         zip(jax.tree.leaves(je.params), topt.leaves(te.params))))
    assert max(drift[:2]) <= 1e-4
    assert max(drift) <= 5e-2, drift


# ---------------------------------------------------------------------------
# the search and its command line
# ---------------------------------------------------------------------------


def test_search_policy_matches_jax(shared_batches):
    je, te = _envs(0, shared_batches)
    je.qat_steps_per_epoch = te.qat_steps_per_epoch = 4
    cc = dict(phase2_max_iters=3, phase1_qat_epochs=1, phase2_qat_epochs=1)
    runs = []
    for env, mod, CC in ((je, jsearch, JCC), (te, tsearch, TCC)):
        env.pretrain(4)
        fl = env.float_loss()
        budget = mod.budget_from_limits(-(fl + 0.1), {"size_mib": 0.25})
        runs.append((fl,) + mod.search_policy(env, budget, config=CC(**cc), seed=0))
    (jfl, ja, jr), (tfl, ta, tr) = runs
    assert _rel(tfl, jfl) <= 1e-5
    jtrace = [(e.phase, e.step, e.bits, e.note) for e in jr.trace]
    ttrace = [(e.phase, e.step, e.bits, e.note) for e in tr.trace]
    if jtrace != ttrace:
        # a parted decision must sit at a near-tie of the measured quality gap
        i = next(i for i, (a, b) in enumerate(zip(jtrace, ttrace)) if a != b)
        gap = max(abs(a.acc - b.acc) for a, b in zip(jr.trace[:i], tr.trace[:i]))
        pytest.fail(f"search parted at trace entry {i}: {jtrace[i]} vs {ttrace[i]}; "
                    f"quality gap before it {gap:.3g}")
    assert jr.policy.bits == tr.policy.bits
    assert (jr.success, jr.abandoned) == (tr.success, tr.abandoned)
    for a, b in zip(jr.trace, tr.trace):
        assert a.zone == b.zone and a.costs == b.costs
    assert ta.policy.to_json() == ja.policy.to_json()
    assert ta.registry_hash == ja.registry_hash
    assert ta.provenance["config"] == ja.provenance["config"]


def test_search_cli_writes_an_artifact_both_packages_load_and_the_port_serves(tmp_path, capsys):
    out = tmp_path / "policy.json"
    rc = tsearch.main(["--arch", "gemma-2b", "--reduced", "--limit", "size_mib=0.25",
                       "--pretrain-steps", "4", "--phase2-iters", "2", "--device", "cpu",
                       "--out", str(out)])
    assert rc in (0, 1)
    art = tpol.PolicyArtifact.load(str(out))
    jart = jpol.PolicyArtifact.load(str(out))
    assert art.version == 6 and art.provenance["phases"]["weight"]["digest"]
    assert jart.policy.bits == art.policy.bits and jart.registry_hash == art.registry_hash
    assert json.loads(art.to_json()) == json.loads(jart.to_json())
    cfg = tconfigs.get_config("gemma-2b").reduced()
    specs = tapply.layer_specs(treg.get_api(cfg).init(cfg, torch.Generator().manual_seed(0),
                                                      device="cpu"), cfg)
    art.verify_layers(specs)
    capsys.readouterr()
    assert tserve.main(["--arch", "gemma-2b", "--reduced", "--policy", str(out), "--requests",
                        "2", "--max-new", "3", "--device", "cpu"]) == 0
    assert "artifact" in capsys.readouterr().out


def test_search_cli_with_state_pool_and_draft_writes_a_v6_artifact_the_port_serves(
        tmp_path, capsys):
    out = tmp_path / "policy.json"
    rc = tsearch.main(["--arch", "gemma-2b", "--reduced", "--limit", "size_mib=0.25",
                       "--limit", "state_bytes=28000", "--paged", "--draft",
                       "--pretrain-steps", "4", "--phase2-iters", "2", "--device", "cpu",
                       "--out", str(out)])
    assert rc in (0, 1)
    printed = capsys.readouterr().out
    assert "state budget: state_bytes<=28000" in printed and "paged pool:" in printed
    art = tpol.PolicyArtifact.load(str(out))
    jart = jpol.PolicyArtifact.load(str(out))
    assert json.loads(art.to_json()) == json.loads(jart.to_json())
    assert art.version == 6 and art.state_policy is not None and art.pool["block"] == 16
    assert set(art.provenance["phases"]) == {"weight", "state", "draft"}
    assert art.report["state_bytes"] <= 28000 * 1.08
    # the draft rides the artifact only where strictly cheaper; on this run it does
    assert art.draft_policy is not None and art.draft_k == 3 and art.meta["draft_success"]
    assert art.report["draft_size_mib"] < art.report["size_mib"]
    assert art.meta["draft_pool_headroom_blocks"] == 4    # 4 slots x ceil(3 / 16)
    assert tserve.main(["--arch", "gemma-2b", "--reduced", "--policy", str(out), "--requests",
                        "2", "--max-new", "4", "--device", "cpu"]) == 0
    assert "speculation:" in capsys.readouterr().out


def test_search_cli_roofline_trace_and_checkpoint_load_in_both_packages(tmp_path, capsys):
    """``--backend roofline --decode-batch 4 --trace --ckpt``: the artifact
    prices on the H100 roofline, the trace validates in both packages, and
    the checkpoint (params and artifact) restores in both."""
    from repro.checkpoint import store as jck
    from repro.cost.roofline import RooflineCostModel as JRoofline
    from repro.obs import trace as jtrace
    from repro.roofline.model import HwSpec as JHwSpec
    from repro_torch.checkpoint import store as tck
    from repro_torch.cost import RooflineCostModel

    out, trace, ckpt = tmp_path / "policy.json", tmp_path / "trace.json", tmp_path / "ck"
    cfg = tconfigs.get_config("gemma-2b").reduced()
    spec_params = treg.get_api(cfg).init(cfg, torch.Generator().manual_seed(0), device="cpu")
    lat8 = RooflineCostModel(batch=4).report(tpol.BitPolicy.uniform(
        tapply.layer_specs(spec_params, cfg), 8)).latency_s
    rc = tsearch.main(["--arch", "gemma-2b", "--reduced", "--backend", "roofline",
                       "--decode-batch", "4", "--limit", f"latency_s={0.8 * lat8!r}",
                       "--pretrain-steps", "4", "--phase2-iters", "2", "--device", "cpu",
                       "--out", str(out), "--trace", str(trace), "--ckpt", str(ckpt)])
    assert rc in (0, 1)
    printed = capsys.readouterr().out
    assert f"search trace -> {trace}" in printed and "attributed to env work" in printed
    assert not ttrace.is_enabled()
    art = tpol.PolicyArtifact.load(str(out))
    assert art.backend == "roofline" and art.meta["backend"] == "roofline"
    want = RooflineCostModel(batch=4).report(art.policy).as_costs()
    assert {k: art.report[k] for k in want} == want
    h100 = JHwSpec("h100_sxm", 989e12, 3.35e12, 450e9)
    jart = jpol.PolicyArtifact.load(str(out))
    assert JRoofline(h100, batch=4).report(jart.policy).as_costs() == want
    doc = json.loads(trace.read_text())
    ttrace.validate_chrome_trace(doc)
    jtrace.validate_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"search/main", "search/weight", "env/model_init"} <= names
    # the checkpoint: step = the pretraining steps, the artifact, the float loss
    assert tck.list_steps(str(ckpt)) == [4]
    assert tck.load_policy_artifact(str(ckpt)).to_json() == art.to_json()
    assert jck.load_policy_artifact(str(ckpt)).to_json() == jart.to_json()
    tparams, extra = tck.restore(str(ckpt), spec_params)
    assert extra["float_loss"] > 0
    jlike = jdec.init(jconfigs.get_config("gemma-2b").reduced(), jax.random.key(0))
    jparams, jextra = jck.restore(str(ckpt), jlike)
    assert jextra == extra
    for a, b in zip(topt.leaves(tparams), jax.tree.leaves(jparams)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_search_cli_without_device_raises_when_no_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.main(["--reduced", "--limit", "size_mib=0.25", "--out",
                      str(tmp_path / "p.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.main(["--reduced", "--limit", "size_mib=0.25", "--limit", "state_bytes=1e4",
                      "--paged", "--draft", "--out", str(tmp_path / "p.json")])
    # the roofline backend, the trace and the checkpoint change nothing of that
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.main(["--reduced", "--backend", "roofline", "--decode-batch", "4", "--limit",
                      "latency_s=1e-7", "--trace", str(tmp_path / "t.json"), "--ckpt",
                      str(tmp_path / "ck"), "--out", str(tmp_path / "p.json")])
    assert not ttrace.is_enabled()
    assert not (tmp_path / "t.json").exists() and not (tmp_path / "ck").exists()


def test_token_task_matches_the_reference_process():
    tt, jt = tpipe.TokenTask(512), jpipe.TokenTask(512)
    assert _rel(tt.entropy_floor(), jt.entropy_floor()) <= 1e-6
    cfg = tconfigs.get_config("gemma-2b").reduced()
    shape = TShape("s", "train", 32, 8)
    a, b = tpipe.global_batch(tt, cfg, shape, 3), tpipe.global_batch(tt, cfg, shape, 3)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"][:, :-1],
                                                                 a["tokens"][:, 1:])
    assert not torch.equal(a["tokens"], tpipe.global_batch(tt, cfg, shape, 4)["tokens"])
    assert a["tokens"].shape == (8, 32) and 0 <= int(a["tokens"].min())
    assert int(a["tokens"].max()) < 512
    # the bigram permutation carries 1 - noise of the transitions
    perm = tt._perm()
    follows = (perm[a["tokens"][:, :-1]] == a["tokens"][:, 1:]).float().mean()
    assert 0.6 <= float(follows) <= 0.9


def test_weight_access_and_vectors_match_jax():
    jcfg, tcfg, jp, tp = _model(4)
    specs = tapply.layer_specs(tp, tcfg)
    jspecs = japply.layer_specs(jp, jcfg)
    for s in specs:
        assert np.array_equal(tapply.get_weight(tp, s.name).numpy(),
                              np.asarray(japply.get_weight(jp, s.name)))
    np.testing.assert_allclose(tapply.sigma_vector(tp, specs), japply.sigma_vector(jp, jspecs),
                               rtol=1e-6)
    tpolicy, jpolicy = _mixed(specs, 2)
    np.testing.assert_allclose(tapply.kl_vector(tp, specs, tpolicy),
                               japply.kl_vector(jp, jspecs, jpolicy), rtol=1e-5)
