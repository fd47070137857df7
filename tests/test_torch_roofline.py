"""Port parity of the roofline model and the roofline cost backend, on the CPU.

The port prices against its H100 spec (``roofline.H100_SXM``); handed a
``HwSpec`` of the JAX package's TPU values, its ``CostReport`` equals the JAX
backend's field for field, ``detail`` included, on reduced gemma-2b's weight
registry under mixed policies (with decode-state layers too).  The arithmetic is the same float operations in the same order,
so the tolerance is none.  The twins of ``tests/test_cost_models.py``'s
roofline cases run on the port's default spec.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.core import policy as jpol
from repro.cost import RooflineCostModel as JRoofline
from repro.kvcache import state_layer_infos as jstate_layers
from repro.models import decoder as jdec
from repro.quant import apply as japply
from repro.roofline import model as jroof
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.cost import RooflineCostModel, available_cost_models, get_cost_model
from repro_torch.kvcache import state_layer_infos as tstate_layers
from repro_torch.quant import apply as tapply
from repro_torch.roofline import H100_SXM, HwSpec, active_params, model_flops, roofline_terms

#: the JAX package's TPU spec, built here: the port has no TPU constant
TPU = HwSpec(name=jroof.TPU_V5E.name, peak_flops=jroof.TPU_V5E.peak_flops,
             hbm_bw=jroof.TPU_V5E.hbm_bw, ici_bw=jroof.TPU_V5E.ici_bw)


def small_layers(pkg):
    return (pkg.LayerInfo("a", (256, 128), macs=256 * 128),
            pkg.LayerInfo("b", (128, 128), macs=128 * 128),
            pkg.LayerInfo("c", (128, 64), macs=128 * 64))


def test_h100_spec_is_the_data_sheet():
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.ici_bw) == (989e12, 3.35e12, 450e9)
    assert get_cost_model("roofline").hw is H100_SXM


def test_terms_equal_jax_on_tpu_values():
    args = (197e12 * 0.010, 819e9 * 0.002, 50e9 * 0.001, 256)
    t, j = roofline_terms(*args, hw=TPU), jroof.roofline_terms(*args)
    for f in ("compute_s", "memory_s", "collective_s", "flops", "hbm_bytes", "coll_bytes",
              "n_chips", "dominant", "bound_s"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dominant == "compute" and t.bound_s == pytest.approx(0.010)


def test_fraction_of_roofline_divides_by_its_own_spec():
    """The reference divides by ``TPU_V5E.peak_flops`` whatever spec priced the
    terms; the port by the spec it was given.  On TPU values the two agree;
    on the H100 spec the port peaks at 1 where the reference would not."""
    t, j = roofline_terms(197e12, 0.0, 0.0, 4, hw=TPU), jroof.roofline_terms(197e12, 0.0, 0.0, 4)
    assert t.fraction_of_roofline(4 * 197e12) == j.fraction_of_roofline(4 * 197e12) == 1.0
    h = roofline_terms(989e12, 0.0, 0.0, 4)
    assert h.fraction_of_roofline(4 * 989e12) == pytest.approx(1.0)
    jh = jroof.roofline_terms(989e12, 0.0, 0.0, 4, hw=jroof.HwSpec("h100", 989e12, 3.35e12,
                                                                    450e9))
    assert jh.fraction_of_roofline(4 * 989e12) == pytest.approx(989 / 197)
    assert roofline_terms(0.0, 0.0, 0.0, 1).fraction_of_roofline(1.0) == 0.0


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_MODULES))
def test_active_params_and_model_flops_equal_jax(arch):
    tc, jc = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert active_params(tc) == jroof.active_params(jc)
    for name in TSHAPES:
        for train in (True, False):
            assert model_flops(tc, TSHAPES[name], train=train) == \
                jroof.model_flops(jc, JSHAPES[name], train=train)


# ---------------------------------------------------------------------------
# the cost backend: twins of tests/test_cost_models.py's roofline cases
# ---------------------------------------------------------------------------


def test_prices_container_bytes_not_logical():
    layers = small_layers(tpol)
    r6 = RooflineCostModel().report(tpol.BitPolicy.uniform(layers, 6))
    r8 = RooflineCostModel().report(tpol.BitPolicy.uniform(layers, 8))
    # 6 bits pack one a byte: the same container and latency, a smaller logical size
    assert r6.container_bytes == r8.container_bytes
    assert r6.latency_s == r8.latency_s
    assert r6.size_bytes < r8.size_bytes


def test_latency_is_roofline_bound_and_monotone():
    layers = small_layers(tpol)
    rep = RooflineCostModel().report(tpol.BitPolicy.uniform(layers, 8))
    assert rep.latency_s == max(rep.detail["compute_s"], rep.detail["memory_s"])
    r2 = RooflineCostModel().report(tpol.BitPolicy.uniform(layers, 2))
    assert r2.latency_s < rep.latency_s          # decode is memory-bound
    assert r2.energy < rep.energy


def test_batch_and_chips_scaling():
    p = tpol.BitPolicy.uniform(small_layers(tpol), 4)
    r1 = RooflineCostModel(batch=1).report(p)
    r8 = RooflineCostModel(batch=8).report(p)
    assert r8.detail["flops"] == pytest.approx(8 * r1.detail["flops"])
    assert RooflineCostModel(n_chips=4).report(p).latency_s == pytest.approx(r1.latency_s / 4)


def test_registry_lookup():
    assert set(available_cost_models()) >= {"shift_add", "roofline"}
    assert get_cost_model("roofline", batch=2).batch == 2
    with pytest.raises(KeyError):
        get_cost_model("napkin")


# ---------------------------------------------------------------------------
# field for field against the JAX backend on TPU values
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma_specs():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdec.init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    js, ts = japply.layer_specs(jp, jcfg), tapply.layer_specs(tp, tcfg)
    assert [dataclasses.astuple(l) for l in js] == [dataclasses.astuple(l) for l in ts]
    return (jcfg, js), (tcfg, ts)


def _pair(ts, js, bits):
    return tpol.BitPolicy.from_bits(ts, bits), jpol.BitPolicy.from_bits(js, bits)


def _assert_reports_equal(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", [{}, {"batch": 4}, {"batch": 8, "act_bytes": 4, "n_chips": 2}],
                         ids=["decode", "batch4", "batch8-f32-2chips"])
def test_report_equals_jax_on_reduced_gemma(gemma_specs, seed, kw):
    (_, js), (_, ts) = gemma_specs
    rng = np.random.default_rng(seed)
    bits = {l.name: int(rng.choice([2, 4, 6, 8])) for l in ts}
    tp, jp = _pair(ts, js, bits)
    _assert_reports_equal(RooflineCostModel(TPU, **kw).report(tp), JRoofline(**kw).report(jp))
    # on the H100 spec only the two time terms (and latency) move
    h, j = RooflineCostModel(**kw).report(tp), JRoofline(**kw).report(jp)
    assert (h.size_bytes, h.container_bytes, h.bops, h.energy) == \
        (j.size_bytes, j.container_bytes, j.bops, j.energy)
    assert h.detail["memory_s"] == j.detail["hbm_bytes"] / kw.get("n_chips", 1) / 3.35e12


@pytest.mark.parametrize("seed", range(2))
def test_report_with_state_layers_equals_jax(gemma_specs, seed):
    (jcfg, js), (tcfg, ts) = gemma_specs
    tl = tuple(ts) + tuple(tstate_layers(tcfg, 4, 64))
    jl = tuple(js) + tuple(jstate_layers(jcfg, 4, 64))
    rng = np.random.default_rng(100 + seed)
    bits = {l.name: int(rng.choice([2, 4, 6, 8])) for l in tl}
    tp, jp = _pair(tl, jl, bits)
    t, j = RooflineCostModel(TPU, batch=4).report(tp), JRoofline(batch=4).report(jp)
    assert t.state_bytes > 0
    _assert_reports_equal(t, j)
    assert t.as_costs() == j.as_costs()
