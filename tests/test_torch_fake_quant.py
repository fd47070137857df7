"""Port parity of QAT fake-quant and the search's statistics, on the CPU.

The port's plain fake-quant forward and its straight-through gradient equal
the JAX package's bit for bit (``fake_quant_ref`` and the Pallas body in
interpret mode; ``jax.grad`` through the custom VJP), NaN positions compared
as NaN.  Sigma, histograms, KL and sensitivities agree on the same weights:
histograms exactly; sigma and the sensitivity score within rel 1e-6 (the
reductions sum in another order); the KL terms within rel 1e-5, because
XLA's f32 log is an ulp off the correctly rounded value on about 14 % of
inputs and a high-bit KL sums p * (log p - log q) over log differences near
1e-2, where an ulp of the log is about 5e-5 of a term (4.0e-6 measured over
48 weight draws).  Clustering, shift-add costs and decision zones are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclust
from repro.core import policy as jpol
from repro.core import quantizer as jq
from repro.core import stats as jstats
from repro.cost import shift_add as jshift
from repro.kernels.fake_quant import ops as jops
from repro_torch import kernels
from repro_torch.convert import to_tensor
from repro_torch.core import clustering as tclust
from repro_torch.core import policy as tpol
from repro_torch.core import quantizer as tq
from repro_torch.core import stats as tstats
from repro_torch.cost import get_cost_model
from repro_torch.cost import shift_add as tshift
from repro_torch.kernels.fake_quant import ops as tops
from repro_torch.kernels.fake_quant.kernel import fake_quant_cuda, fake_quant_ste_bwd_cuda
from repro_torch.kernels.fake_quant.ref import fake_quant_ste_bwd_ref

torch.set_num_threads(2)

BITS = (2, 4, 6, 8, 32)
SHAPES = ((37, 53), (5, 129), (64, 96))
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _weights(k, n, dt, seed):
    """Seeded weights with an all-zero column and a few exact ties."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 1] = 0.0
    w[0, 2] = -w[1, 2]
    wj = jnp.asarray(w).astype(dt)
    return wj, to_tensor(np.asarray(wj), device="cpu")


def _same(t: torch.Tensor, a) -> bool:
    """Bit for bit, with NaN positions compared as NaN (payloads differ by platform)."""
    a = np.asarray(a)
    t = t.contiguous()
    bits = (torch.int16 if t.dtype is torch.bfloat16 else torch.int32)
    tn, an = torch.isnan(t.float()).numpy(), np.isnan(a.astype(np.float32))
    if not (tn == an).all():
        return False
    tv = t.view(bits).numpy()
    av = a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)
    return bool((tv[~tn] == av[~an]).all())


def test_qmax_is_the_reference_f32_value():
    for b in range(1, 33):
        assert tq.qmax(b) == float(np.float32(jq.qmax(b))), b
        assert tq.qmax(float(b)) == float(np.float32(jax.jit(jq.qmax)(jnp.float32(b)))), b
    assert [tq.qmax(b) for b in (2, 4, 6, 8)] == [1.0, 7.0, 31.0, 127.0]
    # exp2 lowers to exp(f32(ln 2) * x): the reference's 32-bit grid is 2^31 - 896
    assert tq.qmax(32) == 2.0 ** 31 - 896


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_bitwise_equals_jax(bits, k, n, dtype):
    jdt, _ = DTYPES[dtype]
    wj, wt = _weights(k, n, jdt, seed=k * 7 + n + bits)
    want = jops.fake_quant(wj, bits, impl="xla")
    assert _same(tops.fake_quant(wt, bits, impl="torch"), want)
    assert _same(tops.fake_quant(wt, bits), jops.fake_quant(wj, bits, impl="interpret"))
    # the tied head's route: a transposed view, one scale per storage row
    st = wt.T.contiguous()
    got = tops.fake_quant(st.T, bits)
    assert not got.is_contiguous() and _same(got, want)
    wscale = tq.weight_scale(wt, bits)
    assert _same(wscale, jq.weight_scale(wj, bits, channel_axis=-1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", BITS)
def test_ste_gradient_bitwise_equals_jax(bits, dtype):
    jdt, tdt = DTYPES[dtype]
    k, n = 37, 53
    wj, wt = _weights(k, n, jdt, seed=bits)
    rng = np.random.default_rng(100 + bits)
    c = rng.standard_normal((k, n)).astype(np.float32)
    c[3, :] = np.inf                    # +-inf upstream gradient, inside and outside the clip
    c[4, :] = -np.inf
    c[:, 1] *= -1.0                     # the zero column: signs of zero
    cj = jnp.asarray(c).astype(jdt)
    ct = to_tensor(np.asarray(cj), device="cpu")
    gj = jax.grad(lambda w: jnp.sum(jops.fake_quant_ste(w, bits, "xla").astype(jnp.float32)
                                    * cj.astype(jnp.float32)))(wj)
    for route in ("plain", "transposed"):
        w = wt.clone().requires_grad_() if route == "plain" else \
            wt.T.contiguous().requires_grad_()
        out = tops.fake_quant_ste(w if route == "plain" else w.T, bits, "auto")
        out.backward(ct)
        got = w.grad if route == "plain" else w.grad.T
        assert got.dtype == tdt and _same(got, gj), route
    # at max scaling the mask clips almost nothing: hold the backward at half
    # the scale, where half the weights lie outside and inf * 0 gives NaN
    scale_j = jq.weight_scale(wj, bits, channel_axis=-1) * 0.5
    inside = (jnp.abs(wj) <= jq.qmax(bits) * scale_j).astype(wj.dtype)
    want = jops._bwd("xla", inside, cj)[0]
    got = fake_quant_ste_bwd_ref(wt, to_tensor(np.asarray(scale_j), device="cpu"), bits, ct)
    assert _same(got, want)
    assert np.isnan(np.asarray(want, np.float32)).any() and not np.asarray(inside).all()


def test_ste_passes_no_gradient_to_bits_and_counts_plain_calls():
    w = torch.randn(9, 11, requires_grad=True)
    kernels.reset_counts()
    tops.fake_quant_ste(w, 4).sum().backward()
    assert kernels.PLAIN_CALLS["fake_quant"] == 1
    assert kernels.PLAIN_CALLS["fake_quant_ste_bwd"] == 1
    assert kernels.LAUNCHES["fake_quant"] == 0 == kernels.LAUNCHES["fake_quant_ste_bwd"]
    with torch.no_grad():
        tops.fake_quant_ste(w, 4)
    assert kernels.PLAIN_CALLS["fake_quant_ste_bwd"] == 1


def test_cuda_impl_is_refused_on_cpu_tensors():
    w = torch.randn(8, 8)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tops.fake_quant(w, 4, impl="cuda")
    scale = tq.weight_scale(w, 4)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fake_quant_cuda(w, scale, 4.0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fake_quant_ste_bwd_cuda(w, scale, 4.0, w)


# ---------------------------------------------------------------------------
# statistics, clustering, costs, zones
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    a, b = np.float64(a), np.float64(b)
    return float(abs(a - b) / max(abs(b), 1e-30))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", (2, 4, 6, 8))
def test_stats_match_jax(bits, dtype):
    jdt, _ = DTYPES[dtype]
    wj, wt = _weights(61, 47, jdt, seed=3 * bits)
    assert _rel(tstats.layer_sigma(wt), jstats.layer_sigma(wj)) <= 1e-6
    w32 = wt.float()
    amax = w32.abs().max()
    for x in (w32, tq.quantize_dequantize(w32, bits)):
        xj = jnp.asarray(x.numpy())
        got = tstats._histogram(x, -amax, amax, 256).numpy()
        want = np.asarray(jstats._histogram(xj, -jnp.asarray(amax.numpy()),
                                            jnp.asarray(amax.numpy()), 256))
        assert (got == want).all()
    assert _same(tq.quantize_dequantize(w32, bits),
                 jq.quantize_dequantize(jnp.asarray(w32.numpy()), bits))
    for name, tol in (("quantization_kl", 1e-5), ("normalized_kl", 1e-5),
                      ("sensitivity_score", 1e-6)):
        got = float(getattr(tstats, name)(wt, bits))
        want = float(getattr(jstats, name)(wj, bits))
        assert _rel(got, want) <= tol, (name, got, want)
    ws = [wt, wt * 2, wt[:, :13]]
    wjs = [wj, wj * 2, wj[:, :13]]
    np.testing.assert_allclose(tstats.sigma_vector(ws), jstats.sigma_vector(wjs), rtol=1e-6)
    np.testing.assert_allclose(tstats.sensitivity_vector(ws, [bits, 2, 8]),
                               jstats.sensitivity_vector(wjs, [bits, 2, 8]), rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_clustering_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0.02, 0.003, 9), rng.normal(0.08, 0.01, 7),
                        rng.uniform(0.001, 0.2, 5)])
    for lam in (0.0, 0.1, 0.5):
        lt, ct = tclust.adaptive_kmeans(x, 4, lam)
        lj, cj = jclust.adaptive_kmeans(x, 4, lam)
        assert (lt == lj).all() and (ct == cj).all()
        assert tclust.kmeans_objective(x, lt, 4, lam) == jclust.kmeans_objective(x, lj, 4, lam)
        for shift in (-1, 0, 1):
            assert (tclust.assign_bits_to_clusters(lt, shift=shift)
                    == jclust.assign_bits_to_clusters(lj, shift=shift)).all()


def _policies(seed):
    rng = np.random.default_rng(seed)
    layers = [(f"layer{i:03d}.w", (int(rng.integers(3, 300)), int(rng.integers(3, 300))),
               "dense") for i in range(9)] + [("embed", (512, 64), "embedding")]
    tl = tuple(tpol.LayerInfo(n, s, s[0] * s[1], k) for n, s, k in layers)
    jl = tuple(jpol.LayerInfo(n, s, s[0] * s[1], k) for n, s, k in layers)
    bits = {n: int(rng.choice([2, 4, 6, 8])) for n, _, _ in layers}
    return tpol.BitPolicy.from_bits(tl, bits), jpol.BitPolicy.from_bits(jl, bits)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("impl", ("shift_add", "int8", "bf16"))
def test_shift_add_costs_equal_jax(seed, impl):
    tp, jp = _policies(seed)
    assert tshift.ShiftAddCostModel(impl).report(tp).as_costs() == \
        jshift.ShiftAddCostModel(impl).report(jp).as_costs()
    assert tp.bops() == jp.bops()
    assert tp.bumped(["embed", "layer001.w"], -2).bits == jp.bumped(["embed", "layer001.w"],
                                                                     -2).bits
    assert get_cost_model("shift_add").report(tp).as_costs() == \
        jshift.ShiftAddCostModel().report(jp).as_costs()


def test_roofline_backend_is_refused_with_its_reason():
    """The roofline backend has its H100 spec now and is no longer refused; an
    unknown backend is, with the names the registry has."""
    from repro_torch.cost.roofline import RooflineCostModel
    from repro_torch.roofline import H100_SXM

    cm = get_cost_model("roofline")
    assert isinstance(cm, RooflineCostModel) and cm.hw is H100_SXM
    with pytest.raises(KeyError, match="roofline"):
        get_cost_model("napkin")


def test_classify_zone_equals_jax():
    rng = np.random.default_rng(0)
    budgets = [({"size_mib": 1.0}, -5.0), ({"size_mib": 1.0, "bops": 2e6}, -5.0)]
    for limits, acc_t in budgets:
        tb = tpol.Budget.of(acc_t, acc_buffer=0.03, buffer=0.08, **limits)
        jb = jpol.Budget.of(acc_t, acc_buffer=0.03, buffer=0.08, **limits)
        for _ in range(400):
            acc = acc_t + float(rng.uniform(-0.3, 0.1))
            costs = {m: lim * float(rng.uniform(0.5, 1.6)) for m, lim in limits.items()}
            assert tpol.classify_zone(acc, costs, tb).value == \
                jpol.classify_zone(acc, costs, jb).value
    tt, jt = tpol.Targets(0.75, 10.0), jpol.Targets(0.75, 10.0)
    for acc in np.linspace(0.5, 0.9, 17):
        for res in np.linspace(5, 80, 16):
            assert tpol.classify_zone(acc, res, tt).value == jpol.classify_zone(acc, res, jt).value
