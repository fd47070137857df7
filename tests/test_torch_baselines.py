"""Port parity of the baseline allocators and of activation calibration, on
the CPU.

``uniform_policy``, ``bop_greedy_policy`` and ``hawq_proxy_policy`` pick the
JAX package's policies bit for bit from the same registry and inputs.
``hutchinson_layer_traces`` draws its Rademacher vectors from a
``torch.Generator`` (the JAX draws have no torch twin), so it is held where
the draw cannot matter: on losses whose Hessian is diagonal, ``v^T H v`` is
the trace for every Rademacher ``v``, and both packages give the same traces
up to f32 rounding of the sum (rel 1e-6).  Neither loss crosses fake-quant
(``jax.jvp`` cannot differentiate the STE's ``custom_vjp``).  Off the
diagonal the port's estimate equals ``v^T H v`` over its own draws, computed
from the Hessian written out (rel 1e-5).

``quant.calibration`` gives ``jnp.percentile``'s ranges bit for bit, above
``torch.quantile``'s 2^24-element limit too, and ``fake_quant_act`` the JAX
package's values bit for bit; the twins of ``tests/test_quant_apply.py``'s
calibration cases run on the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import baselines as jbase
from repro.core import policy as jpol
from repro.models import decoder as jdec
from repro.quant import apply as japply
from repro.quant import calibration as jcal
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import keystr
from repro_torch.convert import params_from_numpy
from repro_torch.core import baselines as tbase
from repro_torch.core import policy as tpol
from repro_torch.models import registry as treg
from repro_torch.quant import apply as tapply
from repro_torch.quant import calibration as tcal

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def gemma():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdec.init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp, japply.layer_specs(jp, jcfg), tapply.layer_specs(tp, tcfg)


def _layers(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    shapes = [(int(rng.integers(8, 400)), int(rng.integers(8, 400))) for _ in range(n)]
    macs = [int(s[0] * s[1] * rng.integers(1, 9)) for s in shapes]
    mk = lambda pkg: tuple(pkg.LayerInfo(f"layer{i:02d}", s, m)
                           for i, (s, m) in enumerate(zip(shapes, macs)))
    return mk(tpol), mk(jpol)


# ---------------------------------------------------------------------------
# allocators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w_bits", (2, 4, 6, 8))
def test_uniform_policy_equals_jax(gemma, w_bits):
    *_, js, ts = gemma
    t, j = tbase.uniform_policy(ts, w_bits, 6), jbase.uniform_policy(js, w_bits, 6)
    assert t.bits == j.bits and t.act_bits == j.act_bits == 6
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("frac", (1.0, 0.7, 0.45, 0.2, 0.0))
@pytest.mark.parametrize("seed", range(3))
def test_bop_greedy_picks_the_jax_policy(seed, frac):
    tl, jl = _layers(seed)
    budget = frac * jpol.BitPolicy.uniform(jl, 8).bops()
    t, j = tbase.bop_greedy_policy(tl, budget), jbase.bop_greedy_policy(jl, budget)
    assert t.bits == j.bits and t.bops() == j.bops()


def test_bop_greedy_on_gemma_registry(gemma):
    *_, js, ts = gemma
    budget = 0.5 * tpol.BitPolicy.uniform(ts, 8).bops()
    t, j = tbase.bop_greedy_policy(ts, budget), jbase.bop_greedy_policy(js, budget)
    assert t.bits == j.bits and t.bops() <= budget


@pytest.mark.parametrize("frac", (1.1, 0.8, 0.5, 0.3))
@pytest.mark.parametrize("seed", range(3))
def test_hawq_proxy_picks_the_jax_policy(seed, frac):
    tl, jl = _layers(seed)
    rng = np.random.default_rng(50 + seed)
    traces = {l.name: float(v) for l, v in zip(tl, rng.standard_normal(len(tl)) * 10)}
    budget = frac * jpol.BitPolicy.uniform(jl, 8).model_size_mib()
    t = tbase.hawq_proxy_policy(tl, traces, budget)
    j = jbase.hawq_proxy_policy(jl, traces, budget)
    assert t.bits == j.bits


# ---------------------------------------------------------------------------
# Hutchinson traces
# ---------------------------------------------------------------------------


def _diag_problem(seed: int):
    """A tree of leaves ``w`` and the coefficients of the loss
    sum_i c_i * w_i^2 / 2 + d_i * w_i, whose Hessian is diag(c)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (6, 4), "layers": {"wq": (2, 4, 4), "ln": (2, 4)}, "head": [(3,), (4, 2)]}
    w = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    c = jax.tree.map(lambda a: rng.uniform(0.1, 3.0, a.shape).astype(np.float32), w)
    d = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), w)
    return w, c, d


def test_leaf_paths_are_the_jax_flattening_order(gemma):
    _, _, jp, tp, _, _ = gemma
    jkeys = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [keystr(p) for p in tbase.leaf_paths(tp)] == jkeys


@pytest.mark.parametrize("n_samples", (1, 3))
@pytest.mark.parametrize("seed", range(3))
def test_traces_equal_jax_on_a_diagonal_hessian(seed, n_samples):
    w, c, d = _diag_problem(seed)
    jflat = jax.tree_util.tree_flatten_with_path(w)[0]
    names = {f"l{i}": p for i, (p, _) in enumerate(jflat)}

    def jloss(p):
        return sum(jnp.sum(ci * x * x / 2 + di * x) for x, ci, di in
                   zip(jax.tree.leaves(p), jax.tree.leaves(c), jax.tree.leaves(d)))

    tw, tc, td = (jax.tree.map(torch.from_numpy, t) for t in (w, c, d))

    def tloss(p):
        from repro_torch.train.optimizer import leaves
        return sum(torch.sum(ci * x * x / 2 + di * x) for x, ci, di in
                   zip(leaves(p), leaves(tc), leaves(td)))

    tpaths = dict(zip([keystr(p) for p in tbase.leaf_paths(tw)], tbase.leaf_paths(tw)))
    tnames = {n: tpaths[jax.tree_util.keystr(p)] for n, p in names.items()}
    jt = jbase.hutchinson_layer_traces(jloss, jax.tree.map(jnp.asarray, w), names,
                                       jax.random.key(seed), n_samples)
    tt = tbase.hutchinson_layer_traces(tloss, tw, tnames, torch.Generator().manual_seed(seed),
                                       n_samples)
    assert set(tt) == set(jt)
    for i in range(len(jflat)):
        exact = float(np.sum(jax.tree.leaves(c)[i], dtype=np.float64))
        assert tt[f"l{i}"] == pytest.approx(jt[f"l{i}"], rel=1e-6)
        assert tt[f"l{i}"] == pytest.approx(exact, rel=1e-6)


def test_traces_off_the_diagonal_are_v_h_v_over_the_draws():
    """A loss with a full Hessian per leaf and a term that couples two
    leaves: the estimate is the mean of ``v_l^T (H v)_l`` over the
    generator's draws, H written out."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    hess = torch.from_numpy(a @ a.T)                       # the Hessian of x^T H x / 2
    params = {"x": torch.from_numpy(rng.standard_normal(6).astype(np.float32)),
              "y": [torch.from_numpy(rng.standard_normal(6).astype(np.float32))]}

    def loss(p):
        x, y = p["x"], p["y"][0]
        return x @ hess @ x / 2 + (y @ hess @ y) ** 2 / 8 + x @ y

    n = 4
    got = tbase.hutchinson_layer_traces(loss, params, {"x": ("x",), "y": ("y", 0)},
                                        torch.Generator().manual_seed(9), n)
    gen = torch.Generator().manual_seed(9)
    want = {"x": 0.0, "y": 0.0}
    y = params["y"][0]
    q = y @ hess @ y
    hyy = (hess * q + 2 * torch.outer(hess @ y, hess @ y)) / 2   # Hessian of q^2 / 8
    for _ in range(n):
        vx, vy = (torch.where(torch.rand(6, generator=gen) < 0.5, 1.0, -1.0) for _ in range(2))
        # the x @ y term couples the leaves: (H v)_x holds v_y, (H v)_y holds v_x
        want["x"] += float(vx @ hess @ vx + vx @ vy) / n
        want["y"] += float(vy @ hyy @ vy + vy @ vx) / n
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5)


def test_traces_of_a_float_lm_loss_and_the_hawq_policy(gemma):
    """On reduced gemma-2b's float loss: finite traces for every quantizable
    weight, and the policy both packages pick from them."""
    _, tcfg, _, tp, js, ts = gemma
    api = treg.get_api(tcfg)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 9)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    paths = {l.name: p for l, p in zip(ts, _spec_paths(tp, ts))}
    traces = tbase.hutchinson_layer_traces(lambda p: api.loss(p, tcfg, batch), tp, paths,
                                           torch.Generator().manual_seed(0), 2)
    assert set(traces) == {l.name for l in ts}
    assert all(np.isfinite(v) for v in traces.values())
    budget = 0.6 * tpol.BitPolicy.uniform(ts, 8).model_size_mib()
    t, j = tbase.hawq_proxy_policy(ts, traces, budget), jbase.hawq_proxy_policy(js, traces,
                                                                                  budget)
    assert t.bits == j.bits and t.model_size_mib() <= budget


def _spec_paths(params, specs):
    """Each spec's leaf path: its stacked leaf for a per-layer entry."""
    out = []
    by_leaf = {"/".join(map(str, p)): p for p in tbase.leaf_paths(params)}
    for s in specs:
        parts = s.name.split(".")
        key = "embed" if parts[0] == "embed" else "layers/" + "/".join(parts[1:])
        out.append(by_leaf[key])
    return out


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _bits_equal(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().view(np.uint32), np.asarray(j).view(np.uint32))


@pytest.mark.parametrize("percentile", (99.9, 99.0, 97.3, 50.0, 100.0))
@pytest.mark.parametrize("seed", range(6))
def test_observe_is_jnp_percentile_bit_for_bit(seed, percentile):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(int(rng.integers(1, 30000))) * rng.uniform(0.1, 10)).astype(
        np.float32)
    if seed % 2:
        x = x.astype(np.float16).astype(np.float32)       # many ties
    t, j = tcal.observe(torch.from_numpy(x), percentile), jcal.observe(jnp.asarray(x), percentile)
    assert _bits_equal(t.lo, j.lo) and _bits_equal(t.hi, j.hi)


def test_observe_above_torch_quantiles_limit_is_bit_for_bit():
    """2^24 + 3 values: ``torch.quantile`` refuses them, and f32(n) rounds."""
    x = np.random.default_rng(1).standard_normal(2**24 + 3).astype(np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.from_numpy(x[:2**24 + 1]), 0.5)
    t, j = tcal.observe(torch.from_numpy(x)), jcal.observe(jnp.asarray(x))
    assert _bits_equal(t.lo, j.lo) and _bits_equal(t.hi, j.hi)


def test_observe_bf16_and_nan_as_jax():
    x = np.random.default_rng(2).standard_normal((16, 33)).astype(np.float32)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    jb = jnp.asarray(x).astype(jnp.bfloat16)
    t, j = tcal.observe(tb), jcal.observe(jb)
    assert _bits_equal(t.lo, j.lo) and _bits_equal(t.hi, j.hi)
    x[3, 4] = np.nan
    t, j = tcal.observe(torch.from_numpy(x)), jcal.observe(jnp.asarray(x))
    assert np.isnan(t.lo.item()) and np.isnan(t.hi.item())
    assert np.isnan(float(j.lo)) and np.isnan(float(j.hi))


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("seed", range(3))
def test_calibrate_and_fake_quant_act_equal_jax(seed, bits):
    rng = np.random.default_rng(10 + seed)
    xs = [(rng.standard_normal(700) * s + o).astype(np.float32) for s, o in ((1, 0), (3, 1))]
    t = tcal.calibrate(torch.from_numpy(x) for x in xs)
    j = jcal.calibrate(jnp.asarray(x) for x in xs)
    assert _bits_equal(t.lo, j.lo) and _bits_equal(t.hi, j.hi)
    for x in xs:
        assert _bits_equal(tcal.fake_quant_act(torch.from_numpy(x), t, bits),
                           jcal.fake_quant_act(jnp.asarray(x), j, bits))


def test_empty_calibration_stream_raises():
    with pytest.raises(ValueError, match="empty"):
        tcal.calibrate([])


class TestCalibration:
    """Twins of ``tests/test_quant_apply.py``'s calibration cases."""

    def test_percentile_clips_outliers(self):
        x = torch.cat([torch.ones(10000), torch.tensor([1e6])])
        assert float(tcal.observe(x, 99.9).hi) < 1e3

    def test_ranges_merge(self):
        a = tcal.observe(torch.tensor([-1.0, 2.0] * 600))
        b = tcal.observe(torch.tensor([-3.0, 0.5] * 600))
        m = a.merge(b)
        assert float(m.lo) <= -2.9 and float(m.hi) >= 1.9

    @pytest.mark.parametrize("bits", (2, 4, 8))
    @pytest.mark.parametrize("seed", (0, 17, 50))
    def test_fake_quant_error_bounded_by_step(self, bits, seed):
        x = torch.randn(512, generator=torch.Generator().manual_seed(seed))
        r = tcal.calibrate([x])
        y = tcal.fake_quant_act(x, r, bits)
        step = (float(r.hi) - float(r.lo)) / (2 ** bits - 1)
        inside = (x >= float(r.lo)) & (x <= float(r.hi))
        assert float((y - x).abs()[inside].max()) <= step / 2 + 1e-6

    def test_more_bits_less_error(self):
        x = torch.randn(4096, generator=torch.Generator().manual_seed(7))
        r = tcal.calibrate([x])
        errs = [float(((tcal.fake_quant_act(x, r, b) - x) ** 2).mean()) for b in (2, 4, 8)]
        assert errs[0] > errs[1] > errs[2]


def test_actrange_is_a_dataclass_of_scalars():
    r = tcal.observe(torch.arange(10.0))
    assert dataclasses.fields(r)[0].name == "lo" and r.lo.shape == () and r.hi.shape == ()
