"""Port parity of the state-bitwidth search (``kvcache/env.KVQuantEnv``,
``launch/search.state_controller_config`` and ``search_policy``'s state
phase and pool), on the CPU: the twin of ``tests/test_kvcache.py::
TestStateSearch``.

Both envs run reduced gemma-2b in f32 from the JAX package's weights
(``convert.params_from_numpy``) on the same calibration prompts; the JAX
env's decode step runs ``qimpl="xla"``.  Tolerances: ``evaluate`` (a
relative mean logit error) within 1e-5 absolute, ``sigmas`` rel 1e-5 and
``sensitivities`` rel 1e-4 (statistics of the captured fp K/V, which agree
at rel 1e-6); costs, controller decisions, state bits and pool geometry
exact.
"""
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
from repro.kvcache.env import KVQuantEnv as JKV
from repro.launch import search as jsearch
from repro.models import registry as jreg
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeSpec as TShape
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core.controller import ControllerConfig as TCC
from repro_torch.core.controller import SigmaQuantController as TController
from repro_torch.kvcache.policy import extract_kv_entries
from repro_torch.kvcache.env import KVQuantEnv as TKV
from repro_torch.launch import search as tsearch
from repro_torch.models import registry as treg
from repro_torch.quant.env import LMQuantEnv as TLM

torch.set_num_threads(2)

SLOTS, MAX_SEQ = 4, 64


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jreg.get_api(jcfg).init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def calib(model):
    return np.random.default_rng(0).integers(1, model[0].vocab_size, (4, 16))


def _kv_pair(model, calib, **kw):
    jcfg, tcfg, jp, tp = model
    je = JKV(jreg.get_api(jcfg).unstack(jp, jcfg), jcfg, calib, slots=SLOTS, max_seq=MAX_SEQ,
             qimpl="xla", **kw)
    te = TKV(treg.get_api(tcfg).unstack(tp, tcfg), tcfg, calib, slots=SLOTS, max_seq=MAX_SEQ,
             **kw)
    return je, te


@pytest.fixture(scope="module")
def kv_envs(model, calib):
    return _kv_pair(model, calib)


def _j(policy):
    return jpol.BitPolicy.from_json(policy.to_json())


def _mixed(specs, seed: int):
    rng = np.random.default_rng(seed)
    return tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8]))
                                            for s in specs})


def test_extract_kv_entries_over_every_state_form(model):
    _, tcfg, _, _ = model
    api = treg.get_api(tcfg)
    bits = [(8, 4)] * tcfg.n_layers
    for state in (api.init_decode_state(tcfg, 2, 32, torch.float32, device="cpu"),
                  api.init_decode_state(tcfg, 2, 32, state_bits=bits, device="cpu"),
                  api.init_decode_state(tcfg, 2, 32, state_bits=bits, paged=True,
                                        device="cpu")):
        entries = extract_kv_entries(state)
        assert [n for n, _ in entries] == [f"layer{i:03d}" for i in range(tcfg.n_layers)]
        assert all(node is st for (_, node), st in zip(entries, state))
    # the hybrid's state: its shared attention's caches, one entry an application
    fp, q = {"k": torch.zeros(1), "v": torch.zeros(1)}, state[0]
    assert extract_kv_entries({"attn": [fp, q], "mamba": []}) == [
        ("shared_attn.app000", fp), ("shared_attn.app001", q)]


def test_evaluate_equals_jax_and_orders_with_bits(kv_envs):
    je, te = kv_envs
    assert [l.name for l in te.layer_infos()] == [l.name for l in je.layer_infos()]
    qual = []
    for b in (8, 4, 2):
        u = tpol.BitPolicy.uniform(te.layer_infos(), b)
        t, j = te.evaluate(u), je.evaluate(_j(u))
        assert abs(t - j) <= 1e-5, (b, t, j)
        qual.append(t)
    assert qual[0] > qual[1] > qual[2]
    assert qual[0] > -0.05                      # an 8-bit state is near exact
    mixed = _mixed(te.layer_infos(), 0)
    assert abs(te.evaluate(mixed) - je.evaluate(_j(mixed))) <= 1e-5


def test_statistics_vectors_equal_jax(kv_envs):
    je, te = kv_envs
    np.testing.assert_allclose(te.sigmas(), je.sigmas(), rtol=1e-5)
    for b in (4, 2):
        u = tpol.BitPolicy.uniform(te.layer_infos(), b)
        np.testing.assert_allclose(te.sensitivities(u), je.sensitivities(_j(u)), rtol=1e-4)
    assert (te.sigmas() > 0).all()


def test_state_bytes_with_and_without_allocated_tokens(model, calib, kv_envs):
    je, te = kv_envs
    cfg = model[1]
    assert te.fp_state_bytes() == je.fp_state_bytes() == \
        4 * 2 * cfg.n_layers * SLOTS * MAX_SEQ * cfg.n_kv_heads * cfg.resolved_head_dim
    pje, pte = _kv_pair(model, calib, allocated_tokens=128)
    assert pte.fp_state_bytes() == pje.fp_state_bytes() == te.fp_state_bytes() // 2
    for env_t, env_j in ((te, je), (pte, pje)):
        for policy in (tpol.BitPolicy.uniform(env_t.layer_infos(), 8),
                       _mixed(env_t.layer_infos(), 1)):
            assert env_t.costs(policy) == env_j.costs(_j(policy))
    assert pte.costs(tpol.BitPolicy.uniform(pte.layer_infos(), 8))["state_bytes"] * 2 == \
        te.costs(tpol.BitPolicy.uniform(te.layer_infos(), 8))["state_bytes"]


def test_state_controller_takes_the_jax_decisions(kv_envs):
    je, te = kv_envs
    n = len(te.layer_infos())
    assert tsearch.state_controller_config(n) == \
        TCC(**vars(jsearch.state_controller_config(n)))
    ref = te.costs(tpol.BitPolicy.uniform(te.layer_infos(), 8))["state_bytes"]
    tb = tpol.Budget.of(-0.25, acc_buffer=0.05, buffer=0.08, state_bytes=0.75 * ref)
    jb = jpol.Budget.of(-0.25, acc_buffer=0.05, buffer=0.08, state_bytes=0.75 * ref)
    tr = TController(te, tb, tsearch.state_controller_config(n), phase="state").run()
    jr = JController(je, jb, jsearch.state_controller_config(n), phase="state").run()
    assert [(e.phase, e.step, e.bits, e.note, e.zone) for e in tr.trace] == \
        [(e.phase, e.step, e.bits, e.note, e.zone) for e in jr.trace]
    for a, b in zip(jr.trace, tr.trace):
        assert abs(a.acc - b.acc) <= 1e-5 and a.costs == b.costs
    assert tr.policy.bits == jr.policy.bits and len(set(tr.policy.bits.values())) >= 2
    assert tr.costs["state_bytes"] <= 0.75 * ref * 1.08 + 1e-9
    assert len(tr.trace) >= 3, [e.note for e in tr.trace]


def test_search_policy_with_a_pool_equals_jax(model, calib, monkeypatch):
    """The weight phase (no QAT, two refinement rounds) then the state phase
    over a paged pool of 16-position blocks at 128 allocated tokens."""
    jcfg, tcfg, jp, tp = model
    batch = lambda step: np.random.default_rng([9, step]).integers(0, 512, (2, 17))  # noqa: E731
    monkeypatch.setattr(jenv, "global_batch", lambda task, cfg, shape, step: {
        "tokens": jnp.asarray(batch(step)[:, :-1]), "labels": jnp.asarray(batch(step)[:, 1:])})
    lm_j = jenv.LMQuantEnv(jp, jcfg, JShape("s", "train", 16, 2))
    lm_t = TLM(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), tcfg,
               TShape("s", "train", 16, 2),
               batches=lambda task, cfg, shape, step: {"tokens": batch(step)[:, :-1],
                                                       "labels": batch(step)[:, 1:]})
    kj, kt = _kv_pair(model, calib, allocated_tokens=128)
    n = len(kt.layer_infos())
    limit = 0.8 * kt.costs(tpol.BitPolicy.uniform(kt.layer_infos(), 8))["state_bytes"]
    cc = dict(phase2_max_iters=2, phase1_qat_epochs=0, phase2_qat_epochs=0)
    out = {}
    for key, mod, lm, kv, pol, CC in (("jax", jsearch, lm_j, kj, jpol, JCC),
                                      ("port", tsearch, lm_t, kt, tpol, TCC)):
        fl = lm.float_loss()
        out[key] = mod.search_policy(
            lm, mod.budget_from_limits(-(fl + 0.1), {"size_mib": 0.25}), config=CC(**cc),
            state_env=kv, pool={"block": 16}, seed=0,
            state_budget=pol.Budget.of(-0.15, acc_buffer=0.05, buffer=0.08, state_bytes=limit),
            state_config=mod.state_controller_config(n))
    (ja, jr), (ta, tr) = out["jax"], out["port"]
    assert tr.policy.bits == jr.policy.bits
    assert ta.state_policy.bits == ja.state_policy.bits
    assert ta.pool == ja.pool and ta.pool["block"] == 16 and ta.pool["num_blocks"] >= 1
    assert ta.report["state_bytes"] == ja.report["state_bytes"] <= limit * 1.08
    assert ta.meta["fp_state_bytes"] == ja.meta["fp_state_bytes"]
    assert ta.meta["state_success"] == ja.meta["state_success"]
    tp_, jp_ = ta.provenance["phases"], ja.provenance["phases"]
    assert set(tp_) == set(jp_) == {"weight", "state"}
    for ph in ("weight", "state"):
        assert [(h["step"], h["zone"], h["note"]) for h in tp_[ph]["history"]] == \
            [(h["step"], h["zone"], h["note"]) for h in jp_[ph]["history"]]


def test_state_phase_calibrates_on_a_copy_the_weight_phase_does_not_move(model, monkeypatch):
    """The weight phase's QAT updates the LM env's params in place; the
    state env built by the search (before that phase, as the reference
    builds it) keeps the weights it calibrated on, so its scores do not move."""
    _, tcfg, jp, _ = model
    batch = np.random.default_rng(3).integers(0, 512, (2, 17))
    lm = TLM(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), tcfg,
             TShape("s", "train", 16, 2), qat_steps_per_epoch=2,
             batches=lambda task, cfg, shape, step: {"tokens": batch[:, :-1],
                                                     "labels": batch[:, 1:]})
    args = tsearch.build_parser().parse_args(["--reduced", "--limit", "size_mib=1",
                                              "--kv-max-seq", "32"])
    kv, _, _, _ = tsearch._state_phase(args, 1e5, tcfg, treg.get_api(tcfg), lm, None,
                                       lambda m: None)
    u4 = tpol.BitPolicy.uniform(kv.layer_infos(), 4)
    before = kv.evaluate(u4)
    lm.calibrate_and_qat(tpol.BitPolicy.uniform(lm.layer_infos(), 4), 1)
    assert kv.evaluate(u4) == before and kv.steps == 2
