"""Port parity of the draft-policy search (``spec/env.DraftQuantEnv``,
``launch/search.search_draft_policy`` and ``attach_draft``), on the CPU: the
twin of ``tests/test_spec_decode.py::test_draft_env_proxy_orders_with_bits``
and ``tests/test_policy_artifact.py``'s ``attach_draft`` case.

Both envs run reduced gemma-2b in f32 from the JAX package's weights
(``convert.params_from_numpy``), deployed at uniform 8 bits, on the same
calibration prompts; the JAX env runs ``qimpl="xla"``.  Tolerances: the
relative divergence and ``evaluate`` within 1e-5 absolute, the argmax
agreement and the controller's decisions exact, the probe vector rel 1e-4
(each entry a divergence of order 1e-2).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import policy as jpol
from repro.launch import search as jsearch
from repro.models import registry as jreg
from repro.spec.env import DraftQuantEnv as JDraft
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.launch import search as tsearch
from repro_torch.models import registry as treg
from repro_torch.quant import apply as tapply
from repro_torch.spec.env import DIVERGENCE_WEIGHT, DraftQuantEnv as TDraft

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jreg.get_api(jcfg).init(jcfg, jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def calib(model):
    return np.random.default_rng(0).integers(1, model[0].vocab_size, (2, 8))


@pytest.fixture(scope="module")
def envs(model, calib):
    jcfg, tcfg, jp, tp = model
    deployed = tpol.BitPolicy.uniform(tapply.layer_specs(tp, tcfg), 8)
    je = JDraft(jp, jreg.get_api(jcfg).unstack(jp, jcfg), jcfg, _j(deployed), calib,
                qimpl="xla")
    te = TDraft(tp, treg.get_api(tcfg).unstack(tp, tcfg), tcfg, deployed, calib)
    return je, te


def _j(policy):
    return jpol.BitPolicy.from_json(policy.to_json())


def test_proxy_orders_with_bits_and_equals_jax(envs):
    """An 8-bit draft of an 8-bit deployment is perfect (agreement 1,
    divergence 0, quality 1.0); lower bits score lower, as in the JAX env."""
    je, te = envs
    specs = te.layer_infos()
    assert [l.name for l in specs] == [l.name for l in je.layer_infos()]
    u8 = tpol.BitPolicy.uniform(specs, 8)
    assert te.divergence(u8) == pytest.approx(0.0, abs=1e-6)
    assert te.agreement(u8) == 1.0
    assert te.evaluate(u8) == pytest.approx(1.0, abs=1e-6)
    rng = np.random.default_rng(4)
    mixed = tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6])) for s in specs})
    for policy in (tpol.BitPolicy.uniform(specs, 4), tpol.BitPolicy.uniform(specs, 2), mixed):
        div, agree, ev = te.divergence(policy), te.agreement(policy), te.evaluate(policy)
        assert abs(div - je.divergence(_j(policy))) <= 1e-5
        assert agree == je.agreement(_j(policy))
        assert abs(ev - je.evaluate(_j(policy))) <= 1e-5
        assert ev == pytest.approx(agree - DIVERGENCE_WEIGHT * div, abs=1e-6)
    assert te.evaluate(tpol.BitPolicy.uniform(specs, 2)) < te.evaluate(u8)


def test_probe_vector_equals_jax(envs):
    je, te = envs
    u8 = tpol.BitPolicy.uniform(te.layer_infos(), 8)
    probe = te.sensitivities(u8)
    assert probe.shape == (len(te.layer_infos()),) and (probe >= 0).all() and probe.max() > 0
    np.testing.assert_allclose(probe, je.sensitivities(_j(u8)), rtol=1e-4, atol=1e-7)
    assert te.sensitivities(tpol.BitPolicy.uniform(te.layer_infos(), 2)) is probe   # cached


def test_search_draft_policy_takes_the_jax_decisions(model, calib):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(2)
    specs = tapply.layer_specs(tp, tcfg)
    deployed = tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([6, 8])) for s in specs})
    kw = dict(metric="size_mib", calib=calib, draft_frac=0.7, draft_accept=0.5)
    tr, tenv, tcost = tsearch.search_draft_policy(tp, tcfg, deployed, **kw)
    jr, jenv_, jcost = jsearch.search_draft_policy(jp, jcfg, _j(deployed), qimpl="xla", **kw)
    assert tcost == jcost
    assert [(e.phase, e.step, e.bits, e.note, e.zone) for e in tr.trace] == \
        [(e.phase, e.step, e.bits, e.note, e.zone) for e in jr.trace]
    for a, b in zip(jr.trace, tr.trace):
        assert abs(a.acc - b.acc) <= 1e-5 and a.costs == b.costs
    assert tr.policy.bits == jr.policy.bits
    assert (tr.success, tr.abandoned) == (jr.success, jr.abandoned)
    # the ladder lies strictly below the deployed maximum
    assert max(tr.policy.bits.values()) < 8 and len(tr.trace) >= 2
    assert tenv.costs(tr.policy)["size_mib"] < tcost


def _layers(pol):
    return (pol.LayerInfo("blk0.w", (64, 32), macs=2048, kind="dense"),
            pol.LayerInfo("blk1.w", (32, 32), macs=1024, kind="dense"),
            pol.LayerInfo("embed", (256, 64), macs=64, kind="embedding"))


def test_attach_draft_grows_a_pooled_artifact_as_jax():
    arts = {}
    for key, pol, mod in (("jax", jpol, jsearch), ("port", tpol, tsearch)):
        layers = _layers(pol)
        policy = pol.BitPolicy.from_bits(layers, {"blk0.w": 4, "blk1.w": 2, "embed": 8})
        art = pol.PolicyArtifact.build(policy, backend="shift_add", meta={"arch": "toy"})
        draft = pol.BitPolicy.uniform(layers, 4)
        plain = mod.attach_draft(art, draft, 3)
        assert plain.draft_k == 3 and plain.pool is None
        assert art.draft_policy is None                      # the input stays untouched
        pooled = pol.PolicyArtifact.build(policy, state_policy=policy,
                                          pool={"block": 16, "num_blocks": 10})
        out = mod.attach_draft(pooled, draft, 3, slots=4)
        # burst scratch: slots * ceil(K / block) more blocks, recorded in meta
        assert out.pool["num_blocks"] == 10 + 4 and pooled.pool["num_blocks"] == 10
        assert out.meta["draft_pool_headroom_blocks"] == 4
        assert mod.attach_draft(pooled, draft, 17, slots=3).pool["num_blocks"] == 10 + 6
        with pytest.raises(ValueError, match="slot count"):
            mod.attach_draft(pooled, draft, 3)
        arts[key] = out
    assert arts["port"].to_json() == arts["jax"].to_json()


def test_draft_search_config_can_be_bounded(model, calib):
    """``config=`` replaces the default controller budget (the reference's
    parameter): the run stops within its iterations and bit set."""
    _, tcfg, _, tp = model
    specs = tapply.layer_specs(tp, tcfg)
    cc = dataclasses.replace(tsearch.state_controller_config(len(specs)), phase2_max_iters=2,
                             bit_set=(2, 4, 6))
    res, _, _ = tsearch.search_draft_policy(tp, tcfg, tpol.BitPolicy.uniform(specs, 8),
                                            metric="size_mib", calib=calib, config=cc)
    assert sum(1 for e in res.trace if e.phase == 2) <= 2
    assert set(res.policy.bits.values()) <= {2, 4, 6}
