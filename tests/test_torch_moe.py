"""Port parity of the MoE layer and its expert matmuls on CPU tensors.

Reduced deepseek-moe-16b (8 experts, top-2, one shared expert) and reduced
llama4 (top-1): the same numpy-seeded inputs and the JAX package's
parameters (carried across with ``convert.params_from_numpy``) go through
``repro.models.moe`` (``qimpl="xla"``) and ``repro_torch.models.moe``.  f32
outputs agree to rel 1e-5 (summation order only), in three routing regimes:
4 tokens (nothing dropped), 64 near-identical tokens (capacity drops
assignments) and a zero router (every probability ties, so the top-k are
experts 0..k-1).  The stacked ``qt_matmul`` is held against the JAX
package's vmapped one ("xla" and "interpret"), the expert launch plans
against the 2-D plans, and packing, layer specs, the draft containers and
the roofline against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.cost.roofline import RooflineCostModel as JRoofline
from repro.kernels.quant_matmul import ops as jmm_ops
from repro.models import decoder as jdecoder
from repro.models import moe as jmoe
from repro.quant import apply as japply
from repro.quant.tensor import quantize_tensor as jquantize
from repro.roofline import model as jroof
from repro.spec.draft import build_draft_params as jbuild_draft
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.cost.roofline import RooflineCostModel
from repro_torch.kernels.quant_gemv import kernel as gk
from repro_torch.kernels.quant_matmul import kernel as mk
from repro_torch.kernels.quant_matmul import ops as mm_ops
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.models import moe as tmoe
from repro_torch.quant import apply as tapply
from repro_torch.quant.tensor import QuantizedTensor, quantize_tensor
from repro_torch.roofline import model as troof
from repro_torch.spec.draft import build_draft_params

torch.set_num_threads(2)

ARCHS = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jconfigs.get_config(request.param).reduced()
    tcfg = tconfigs.get_config(request.param).reduced()
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg,
                jp=jmoe.moe_init(jax.random.key(1), jcfg, jnp.float32))


@pytest.mark.parametrize("n", (1, 3, 4, 12, 64, 96, 1000, 10_240))
def test_capacity_equals_the_reference(n):
    for name in ARCHS:
        jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
        for j, t in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
            assert tmoe.capacity(n, t) == jmoe.capacity(n, j)
    assert tmoe._round_up(n, 8) == jmoe._round_up(n, 8)


def _inputs(regime: str, d: int):
    rng = np.random.default_rng(len(regime))
    if regime == "t4":
        return rng.standard_normal((1, 4, d)).astype(np.float32)
    # near-identical tokens: the router sends them to the same experts, so
    # capacity drops assignments; the zero router sends every token to 0..k-1
    common = rng.standard_normal((1, 1, d)).astype(np.float32)
    return common + 0.1 * rng.standard_normal((4, 16, d)).astype(np.float32)


def _weights(jp, kind: str):
    p = dict(jp)
    if kind.startswith("packed"):
        p.update({n: jquantize(jp[n], int(kind[-1])) for n in EXPERT_KEYS})
    return p


QAT_BITS = {"w_gate": 4.0, "w_up": 6.0, "w_down": 2.0,
            "shared": {"w_gate": 4.0, "w_up": 8.0, "w_down": 2.0}}


@pytest.mark.parametrize("kind", ("float", "packed2", "packed4", "packed6", "packed8", "qat"))
@pytest.mark.parametrize("regime", ("t4", "t64", "zero_router"))
def test_moe_mlp_matches_jax(arch, regime, kind):
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    jp = _weights(arch["jp"], kind)
    if regime == "zero_router":
        jp["router"] = jnp.zeros_like(jp["router"])
    tp = _to_port(jp)
    if kind.startswith("packed"):
        assert isinstance(tp["w_gate"], QuantizedTensor) and tp["w_gate"].packed.ndim == 3
    x = _inputs(regime, jcfg.d_model)
    b, s, _ = x.shape
    bits = QAT_BITS if kind == "qat" else None
    if bits is not None and "shared" not in jp:
        bits = {k: v for k, v in bits.items() if k != "shared"}
    want = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg, qimpl="xla",
                        bits=None if bits is None else jax.tree.map(jnp.asarray, bits))
    kernels.reset_counts()
    got = tmoe.moe_mlp(tp, torch.from_numpy(x), tcfg, bits=bits)
    assert got.shape == (b, s, jcfg.d_model) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    if kind.startswith("packed"):
        name = "quant_gemv_experts" if tmoe.capacity(b * s, tcfg) <= 8 else "quant_matmul_experts"
        assert kernels.PLAIN_CALLS[name] == 3           # one call a linear, all experts
    # the routing regime is what the case says
    _, _, eidx = tmoe._route(tp, torch.from_numpy(x).reshape(b * s, -1), tcfg)
    c = tmoe.capacity(b * s, tcfg)
    drops = int((~tmoe.dispatch(eidx, tcfg.n_experts, c)[4]).sum())
    if regime == "t4":
        assert drops == 0
    else:
        assert drops > 0
    if regime == "zero_router":
        assert (eidx == torch.arange(tcfg.top_k)).all()


def test_aux_load_balance_loss_matches_jax(arch):
    x = _inputs("t64", arch["jcfg"].d_model)
    want = jmoe.aux_load_balance_loss(arch["jp"], jnp.asarray(x), arch["jcfg"])
    got = tmoe.aux_load_balance_loss(_to_port(arch["jp"]), torch.from_numpy(x), arch["tcfg"])
    assert _rel(got.numpy(), want) <= 1e-5


E, D, F_ = 4, 64, 96


@pytest.mark.parametrize("impl", ("xla", "interpret"))
@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("c", (8, 16))
def test_stacked_qt_matmul_matches_jax(c, bits, impl):
    """The expert matmul (E, C, d) x (E, d, f) and back (E, C, f) x (E, f, d):
    C 8 takes the GEMV's plain version, C 16 the GEMM's, one call for all E."""
    rng = np.random.default_rng(bits * 10 + c)
    for k, n in ((D, F_), (F_, D)):
        w = rng.standard_normal((E, k, n)).astype(np.float32) / k ** 0.5
        jqt = jquantize(jnp.asarray(w), bits)
        qt = _to_port(jqt)
        assert tuple(qt.scale.shape) == (1, 1, n)
        x = rng.standard_normal((E, c, k)).astype(np.float32)
        want = jmm_ops.qt_matmul(jnp.asarray(x), jqt, impl=impl)
        kernels.reset_counts()
        got = mm_ops.qt_matmul(torch.from_numpy(x), qt)
        assert got.shape == (E, c, n)
        assert _rel(got.numpy(), want) <= 1e-5
        name = "quant_gemv_experts" if c <= gk.GEMV_MAX_M else "quant_matmul_experts"
        assert kernels.PLAIN_CALLS[name] == 1 and sum(kernels.PLAIN_CALLS.values()) == 1
        # each expert is exactly the 2-D plain version on its slice
        for e in range(E):
            one = mm_ops.quant_matmul(torch.from_numpy(x[e]), qt.packed[e], qt.scale[0], bits, k)
            assert torch.equal(got[e], one)
    bad = torch.zeros((E + 1, c, D))
    with pytest.raises(ValueError, match="leading dims"):
        mm_ops.qt_matmul(bad, qt)
    with pytest.raises(ValueError, match="leading dims"):
        jmm_ops.qt_matmul(jnp.zeros((E + 1, c, D)), jqt, impl=impl)


@pytest.mark.parametrize("impl", ("xla", "interpret"))
@pytest.mark.parametrize("bits", (2, 4, 6, 8))
def test_routed_buffer_through_stacked_qt_matmul(bits, impl):
    """A decode step's capacity buffer as ``moe_mlp`` builds it: reduced
    deepseek-moe-16b's router sends 4 tokens to their top-2 of 8 experts,
    ``dispatch`` writes them into ``(E, 8, d)`` and the experts that hold no
    token stay zero; ``w_down`` takes an h zero on the same rows.  The JAX
    package's vmapped ``qt_matmul`` and the port's plain one agree within
    rel 1e-5, and the empty experts' outputs are exactly zero in both."""
    cfg = tconfigs.get_config("deepseek-moe-16b").reduced()
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(bits)
    xf = torch.from_numpy(rng.standard_normal((4, d), dtype=np.float32))
    router = torch.from_numpy(rng.standard_normal((d, e), dtype=np.float32))
    c = tmoe.capacity(4, cfg)
    _, _, eidx = tmoe._route({"router": router}, xf, cfg)
    _, e_s, t_s, pos, keep = tmoe.dispatch(eidx, e, c)
    slot = torch.where(keep, e_s * c + pos, e * c)
    h_rows = torch.from_numpy(rng.standard_normal((len(slot), f), dtype=np.float32))
    for k, n, rows in ((d, f, xf[t_s]), (f, d, h_rows)):
        buf = torch.zeros((e * c + 1, k))
        buf[slot] = rows
        x = buf[:e * c].view(e, c, k).numpy()
        empty = ~x.reshape(e, -1).any(-1)
        assert c == 8 and empty.any() and not empty.all()
        jqt = jquantize(jnp.asarray(rng.standard_normal((e, k, n), dtype=np.float32)
                                    / k ** 0.5), bits)
        want = np.asarray(jmm_ops.qt_matmul(jnp.asarray(x), jqt, impl=impl))
        kernels.reset_counts()
        got = mm_ops.qt_matmul(torch.from_numpy(x), _to_port(jqt)).numpy()
        assert kernels.PLAIN_CALLS["quant_gemv_experts"] == 1
        assert not got[empty].any() and not want[empty].any()
        assert _rel(got[~empty], want[~empty]) <= 1e-5


def test_per_expert_scales_and_arrays():
    """A scale per expert, ``(E, 1, N)``, and ``qt_matmul_arrays`` on a 2-D
    weight against the JAX package's."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((E, D, F_)).astype(np.float32)
    qts = [quantize_tensor(torch.from_numpy(w[e]), 4) for e in range(E)]
    packed = torch.stack([q.packed for q in qts])
    scale = torch.stack([q.scale for q in qts])                         # (E, 1, N)
    stack = QuantizedTensor(packed=packed, scale=scale, bits=4, shape=(E, D, F_))
    x = rng.standard_normal((E, 8, D)).astype(np.float32)
    got = mm_ops.qt_matmul(torch.from_numpy(x), stack)
    for e in range(E):
        assert torch.equal(got[e], mm_ops.qt_matmul(torch.from_numpy(x[e]), qts[e]))
    want = jmm_ops.qt_matmul_arrays(jnp.asarray(x[0]), jnp.asarray(qts[0].packed.numpy()),
                                    jnp.asarray(qts[0].scale.numpy()), 4, D, impl="xla")
    arr = mm_ops.qt_matmul_arrays(torch.from_numpy(x[0]), qts[0].packed, qts[0].scale, 4, D)
    assert _rel(arr.numpy(), want) <= 1e-6


#: deepseek-moe-16b's expert linears (N, K) and the reduced config's
EXPERT_LINEARS = {"w_gu": (1408, 2048), "w_down": (2048, 1408), "reduced_gu": (256, 128),
                  "reduced_down": (128, 256)}


@pytest.mark.parametrize("name", sorted(EXPERT_LINEARS))
def test_expert_plans_keep_the_2d_splits(name):
    """The stack's split and K ranges are the 2-D plan's (so an expert's
    outputs are the 2-D launch's); its tiles are its own: the 2-D rule's
    CTA count over all the experts, N's tiles cut evenly over those blocks
    (deepseek-moe-16b's w_gate at 64 experts: 6 + 5 tiles, not 8 + 3)."""
    n, k = EXPERT_LINEARS[name]
    n_tiles = -(-n // gk.CHANNELS)
    for e in (1, 8, 64):
        for c in range(1, gk.GEMV_MAX_M + 1):
            p, flat = gk.plan(c, n, k, e), gk.plan(c, n, k)
            assert p.splits == flat.splits == gk.split_of(k) and p.experts == e
            assert p.k_ranges() == flat.k_ranges()
            if e == 1:
                assert p.tiles == gk.tiles_of(n, p.splits)
                continue
            blocks = -(-n_tiles // gk.tiles_of(n, p.splits, e))
            assert p.grid == (p.splits, blocks) and p.tiles == gk.expert_tiles(n, k, e)
            assert p.tiles == -(-n_tiles // blocks) <= gk.tiles_of(n, p.splits, e)
    if name == "w_gu":
        assert gk.plan(8, n, k, 64).tiles == 6 and gk.plan(8, n, k, 64).grid == (8, 2)
    if name == "w_down":
        assert gk.plan(8, n, k, 64).tiles == 8 and gk.plan(8, n, k, 64).grid == (6, 2)
    for e in (1, 8, 64):
        for c in (16, 128, 1280):
            for dt in (torch.bfloat16, torch.float32):
                p, flat = mk.plan(c, n, k, dt, e), mk.plan(c, n, k, dt)
                assert p.splits == flat.splits == mk.split_of(n, k)
                assert p.k_ranges() == flat.k_ranges() and p.wgs == flat.wgs
                assert p.cluster in (1, p.splits) and (p.cluster > 1 or p.splits == 1
                                                       or p.nt <= mk.FOLD_MAX_TOKENS)
                gx, gy, gz = p.grid
                assert gy == e * -(-c // p.nt) <= 65535 and gz == p.cluster
                # a cluster while the experts' tiles alone leave SMs idle
                if p.splits > 1 and p.units // p.cluster < mk.SMS:
                    assert p.cluster == p.splits


@pytest.fixture(scope="module")
def deepseek():
    jcfg = jconfigs.get_config("deepseek-moe-16b").reduced()
    tcfg = tconfigs.get_config("deepseek-moe-16b").reduced()
    jp = jdecoder.init(jcfg, jax.random.key(2))
    tp = _to_port(jp)
    specs = tapply.layer_specs(tp, tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, specs=specs,
                policy=dryrun_policy(specs, "mixed"))


def _same_trees(tree, jtree):
    jflat = dict(tapply._walk(_to_port(jtree)))
    flat = dict(tapply._walk(tree))
    assert flat.keys() == jflat.keys()
    for path, leaf in flat.items():
        ref = jflat[path]
        if isinstance(leaf, QuantizedTensor):
            assert leaf.bits == ref.bits and leaf.shape == tuple(ref.shape), path
            assert torch.equal(leaf.packed, ref.packed), path
            assert torch.equal(leaf.scale, ref.scale), path
        else:
            assert torch.equal(leaf, ref), path


def _copy_dicts(tree):
    return {k: _copy_dicts(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def test_layer_specs_match_jax(deepseek):
    jspecs = japply.layer_specs(deepseek["jp"], deepseek["jcfg"])
    assert [(s.name, s.shape, s.macs, s.kind) for s in deepseek["specs"]] == [
        (s.name, tuple(s.shape), s.macs, s.kind) for s in jspecs]
    experts = [s for s in deepseek["specs"] if s.kind == "expert"]
    cfg = deepseek["tcfg"]
    assert len(experts) == 3 * cfg.n_layers
    assert all(s.macs == cfg.top_k * s.shape[1] * s.shape[2] for s in experts)


@pytest.mark.parametrize("fuse", (False, True))
def test_quantize_for_serve_stacks_match_jax(deepseek, fuse):
    """The stacked experts pack to (E, N, kp) with one scale per channel over
    the stack, byte for byte; fusion joins the shared MLP's gate and up and
    leaves the stacks alone."""
    jcfg, tcfg = deepseek["jcfg"], deepseek["tcfg"]
    jpol = JBitPolicy.from_json(deepseek["policy"].to_json())
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(deepseek["jp"], jcfg), jpol, jcfg)
    tserve = tapply.quantize_for_serve(tdecoder.unstack_layers(deepseek["tp"], tcfg),
                                       deepseek["policy"], tcfg)
    if fuse:
        jserve, tserve = japply.fuse_projections(jserve), tapply.fuse_projections(tserve)
        mlp = tserve["layers"][1]["mlp"]
        assert "w_gu" in mlp["shared"] and "w_gate" in mlp and mlp["w_gate"].packed.ndim == 3
    _same_trees(tserve, jserve)
    if not fuse:
        # the consuming, leaf-by-leaf packing gives the same tree and empties its input
        nested = _copy_dicts(deepseek["tp"])
        _same_trees(tapply.pack_for_serve(nested, deepseek["policy"], tcfg), jserve)
        assert nested == {}
    qt = tserve["layers"][1]["mlp"]["w_down"]
    assert tuple(qt.packed.shape) == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff // 2)
    assert tuple(qt.scale.shape) == (1, 1, tcfg.d_model)
    assert tapply.packed_policy_bits(tserve) == japply.packed_policy_bits(jserve)


def test_draft_containers_of_the_stacks_match_jax(deepseek):
    jcfg, tcfg = deepseek["jcfg"], deepseek["tcfg"]
    jpol = JBitPolicy.from_json(deepseek["policy"].to_json())
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(deepseek["jp"], jcfg), jpol, jcfg)
    tserve = _to_port(jserve)
    draft, bits = build_draft_params(tserve, 4, tcfg, materialize=False)
    jdraft, jbits = jbuild_draft(jserve, 4, jcfg, materialize=False)
    assert bits == jbits
    _same_trees(draft, jdraft)
    assert draft["layers"][0]["mlp"]["w_up"].packed.ndim == 3
    assert tdecoder.unstack_layers(deepseek["tp"], tcfg)["layers"][0]["mlp"]["router"].dtype == (
        torch.float32)


def test_roofline_counts_active_experts(deepseek):
    for name in ARCHS:
        assert troof.active_params(tconfigs.get_config(name)) == jroof.active_params(
            jconfigs.get_config(name))
    jspecs = japply.layer_specs(deepseek["jp"], deepseek["jcfg"])
    jpol = JBitPolicy.from_json(deepseek["policy"].to_json())
    # the JAX package priced on the port's H100 spec
    jh100 = jroof.HwSpec(troof.H100_SXM.name, troof.H100_SXM.peak_flops, troof.H100_SXM.hbm_bw,
                         troof.H100_SXM.ici_bw)
    for batch in (1, 4):
        got = RooflineCostModel(batch=batch).report(deepseek["policy"])
        want = JRoofline(jh100, batch=batch).report(jpol)
        assert got.latency_s == pytest.approx(want.latency_s, rel=1e-12)
        assert got.detail["flops"] == want.detail["flops"]
    assert len(jspecs) == len(deepseek["specs"])
    uniform = BitPolicy.uniform(deepseek["specs"], 4)
    rep = RooflineCostModel(batch=1).report(uniform)
    experts = [s for s in deepseek["specs"] if s.kind == "expert"]
    # every expert's packed bytes stream, only top-k of them compute
    assert rep.detail["flops"] == 2.0 * sum(s.macs for s in uniform.weight_layers())
    assert sum(s.macs for s in experts) == sum(
        deepseek["tcfg"].top_k * s.shape[1] * s.shape[2] for s in experts)
