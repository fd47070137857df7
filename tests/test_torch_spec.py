"""Port parity of self-speculative decoding: the dense append and attention
plain versions, the burst snapshot/restore/commit, acceptance, the draft
containers, ``decode_verify`` and the speculative engine.

The same seeded numpy inputs go through the JAX package (``"xla"``, and
``"interpret"`` for the Pallas bodies) and the port on CPU tensors.  Cache
bytes are compared exactly (scales at rel 1e-6 against ``"interpret"``, whose
jitted division is a reciprocal multiply, ROADMAP queue 3); paged pools at
blocks 1..P-1 (block 0 is the trash block).  Float outputs agree to rel
1e-5 (summation order only).  Greedy streams and speculation counters equal
the JAX speculative engine's and the port's non-speculative streams.
Stochastic acceptance is held by distribution: the two packages' RNGs share
no stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.core.policy import PolicyArtifact as JArtifact
from repro.kernels.quant_kv import ops as jkv_ops
from repro.kvcache import cache as jcache
from repro.kvcache import paged as jpaged
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.lifecycle import ShedPolicy as JShedPolicy
from repro.serve.sampling import filtered_logits as jfiltered_logits
from repro.spec import loop as jloop
from repro.spec.draft import build_draft_params as jbuild_draft
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy, PolicyArtifact
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import paged as tpaged
from repro_torch.kvcache import state_layer_infos
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.quant import apply as tapply
from repro_torch.quant.tensor import QuantizedTensor
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.lifecycle import ShedPolicy
from repro_torch.serve.sampling import filtered_logits, sample
from repro_torch.spec import loop as tloop
from repro_torch.spec.draft import build_draft_params

torch.set_num_threads(2)

FIELDS = ("k_packed", "k_scale", "v_packed", "v_scale")


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _same_layer(tl, jl, *, rows=slice(None), scale_rtol=0.0):
    for name in FIELDS:
        got, want = getattr(tl, name)[rows].numpy(), np.asarray(getattr(jl, name))[rows]
        if name.endswith("packed") or not scale_rtol:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=scale_rtol, atol=0, err_msg=name)


def _raises_alike(jfn, tfn):
    with pytest.raises(Exception) as jerr:
        jfn()
    with pytest.raises(Exception) as terr:
        tfn()
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


# -- the dense append and attention, plain versions -----------------------------

B, S, H, HQ, HD, BLOCK = 3, 32, 2, 4, 16, 8
LENS = np.asarray([5, 13, 29], np.int32)      # slot 2's burst reaches the cache end


def _dense(k_bits, v_bits, rng):
    k = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    jl = jcache.insert_rows(jcache.init_kv_layer(B, S, H, HD, k_bits=k_bits, v_bits=v_bits,
                                                 block=BLOCK),
                            jnp.arange(B), jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENS))
    tl = tcache.insert_rows(tcache.init_kv_layer(B, S, H, HD, k_bits=k_bits, v_bits=v_bits,
                                                 block=BLOCK, device="cpu"),
                            torch.arange(B), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(LENS))
    return tl, jl


def _kv(rng, t=1, b=B):
    return (rng.normal(size=(b, t, H, HD)).astype(np.float32) * 1.5,
            rng.normal(size=(b, t, H, HD)).astype(np.float32))


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("impl", ("xla", "interpret"))
def test_dense_masked_append_and_attention_plain_match_jax(bits, impl):
    """Rows 5 and 4's plain versions: a masked append (slot 1 keeps its bytes)
    and then the attention, against the JAX package's append-then-select."""
    rng = np.random.default_rng(bits * 7 + len(impl))
    tl, jl = _dense(bits, 8 if bits == 2 else bits // 2 * 2, rng)
    kn, vn = _kv(rng)
    mask = np.asarray([True, False, True])
    before = {name: getattr(tl, name)[1].clone() for name in FIELDS}
    kernels.reset_counts()
    jl = jloop._masked_append(jl, jnp.asarray(LENS), jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(mask), impl)
    # the port's dense masked row is position -1, which the append skips
    kv_ops.quant_kv_append(tl, torch.where(torch.from_numpy(mask), torch.from_numpy(LENS), -1),
                           torch.from_numpy(kn), torch.from_numpy(vn))
    _same_layer(tl, jl, scale_rtol=1e-6 if impl == "interpret" else 0.0)
    for name in FIELDS:
        assert torch.equal(getattr(tl, name)[1], before[name]), name
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    valid = np.arange(S)[None, :] <= LENS[:, None]
    want = jkv_ops.quant_kv_attention(jnp.asarray(q), jl, jnp.asarray(valid), impl=impl)
    got = kv_ops.quant_kv_attention(torch.from_numpy(q), tl, torch.from_numpy(valid))
    assert _rel(got.numpy(), want) <= 1e-5
    assert kernels.PLAIN_CALLS["quant_kv_append"] == kernels.PLAIN_CALLS["quant_kv_attention"] == 1
    assert sum(kernels.LAUNCHES.values()) == 0


# -- burst snapshot / restore / commit -------------------------------------------

NPOOL = 16


def _paged(k_bits, v_bits, rng):
    """Four slots over shuffled blocks of a 16-block pool: slots 0 and 1 share
    their first two blocks, slot 2 is idle (its row all -1)."""
    ids = iter((rng.permutation(NPOOL) + 1).tolist())
    nb = 64 // BLOCK
    table = np.full((4, nb), -1, np.int32)
    table[0, :4] = [next(ids) for _ in range(4)]
    table[1, :2] = table[0, :2]
    table[1, 2:4] = [next(ids) for _ in range(2)]
    table[3, :3] = [next(ids) for _ in range(3)]
    rows = np.full((4, 3), -1, np.int32)
    rows[0], rows[1, 2], rows[3] = table[0, :3], table[1, 2], table[3, :3]
    k = rng.normal(size=(4, 24, H, HD)).astype(np.float32)
    v = rng.normal(size=(4, 24, H, HD)).astype(np.float32)
    k[1, :16], v[1, :16] = k[0, :16], v[0, :16]
    lens = np.asarray([20, 23, 0, 15], np.int32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, block=BLOCK)
    jl = jpaged.with_table(jpaged.init_paged_layer(NPOOL, 4, 64, H, HD, **kw), table)
    jl = jpaged.insert_prefill_rows(jl, rows, jnp.asarray(k), jnp.asarray(v),
                                    valid_len=jnp.asarray(lens))
    tl = tpaged.with_table(tpaged.init_paged_layer(NPOOL, 4, 64, H, HD, device="cpu", **kw),
                           table)
    tl = tpaged.insert_prefill_rows(tl, rows, torch.from_numpy(k), torch.from_numpy(v),
                                    valid_len=torch.from_numpy(lens))
    return tl, jl, np.asarray([20, 23, 5, 15], np.int32)


def _append(pkg_layer, pos, kn, vn, jax_side):
    if jax_side:
        return jkv_ops.quant_kv_append(pkg_layer, jnp.asarray(pos), jnp.asarray(kn),
                                       jnp.asarray(vn), impl="xla")
    return kv_ops.quant_kv_append(pkg_layer, torch.from_numpy(pos), torch.from_numpy(kn),
                                  torch.from_numpy(vn))


@pytest.mark.parametrize("cache", ("dense", "paged"))
@pytest.mark.parametrize("k", (1, 3))
def test_burst_commit_bytes_match_jax(cache, k):
    """snapshot -> K draft appends -> restore (the cache as before) -> K+1
    verify appends -> commit with per-slot accepted counts: the bytes equal
    the JAX package's at every stage.  Dense slot 2 sits in the last block, so
    its snapshot start clamps to nb - nt; its burst runs past the cache end,
    where neither package writes."""
    rng = np.random.default_rng(k * 11 + len(cache))
    tstate, jstate = [], []
    for kb, vb in ((8, 4), (4, 2)):
        tl, jl, *rest = _dense(kb, vb, rng) if cache == "dense" else _paged(kb, vb, rng)
        tstate.append(tl)
        jstate.append(jl)
    pos = LENS if cache == "dense" else rest[0]
    b = len(pos)
    rows = slice(None) if cache == "dense" else slice(1, None)
    if cache == "dense":
        nb = S // BLOCK
        nt = tloop._span_blocks(k, BLOCK, nb)
        assert tloop._start_block(torch.from_numpy(pos), k, BLOCK, nb).tolist()[-1] == nb - nt
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    tsaved = tloop.snapshot_state(tstate, tpos, k)
    jsaved = jloop.snapshot_state(jstate, jpos, k)
    originals = [{n: getattr(tl, n).clone() for n in FIELDS} for tl in tstate]
    for j in range(k):                                 # the draft writes freely
        kn, vn = _kv(rng, b=b)
        jstate = [_append(jl, pos + j, kn, vn, True) for jl in jstate]
        for tl in tstate:
            _append(tl, pos + j, kn, vn, False)
    jstate = jloop.restore_state(jstate, jsaved, jpos, k)
    tloop.restore_state(tstate, tsaved, tpos, k)
    for tl, jl, orig in zip(tstate, jstate, originals):
        _same_layer(tl, jl, rows=rows)
        for n in FIELDS:
            assert torch.equal(getattr(tl, n)[rows], orig[n][rows]), n
    burst = [_kv(rng, t=k + 1, b=b) for _ in tstate]
    for j in range(k + 1):                             # the verify pass
        for i, (kn, vn) in enumerate(burst):
            jstate[i] = _append(jstate[i], pos + j, kn[:, j:j + 1], vn[:, j:j + 1], True)
            _append(tstate[i], pos + j, kn[:, j:j + 1], vn[:, j:j + 1], False)
    acc = np.asarray([k, 0, 1, k - 1][:b], np.int32)
    jstate = jloop.commit_state(jstate, jsaved, jpos, jnp.asarray(acc),
                                [(jnp.asarray(a), jnp.asarray(c)) for a, c in burst], k,
                                qimpl="xla")
    tloop.commit_state(tstate, tsaved, tpos, torch.from_numpy(acc),
                       [(torch.from_numpy(a), torch.from_numpy(c)) for a, c in burst], k)
    for tl, jl in zip(tstate, jstate):
        _same_layer(tl, jl, rows=rows)


# -- acceptance --------------------------------------------------------------------


@pytest.mark.parametrize("k", (1, 4))
def test_greedy_accept_matches_jax(k):
    rng = np.random.default_rng(k)
    b, v = 6, 11
    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    draft = logits[:, :k].argmax(-1).astype(np.int32)
    for i in range(min(b, k)):          # slot i rejects at burst index i
        draft[i, i] = (draft[i, i] + 1) % v
    jacc, jout = jloop.accept_tokens(jnp.asarray(logits), jnp.asarray(draft), None, None)
    tacc, tout = tloop.accept_tokens(torch.from_numpy(logits), torch.from_numpy(draft), None)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tacc.dtype == tout.dtype == torch.int32
    assert tacc.tolist()[: min(b, k)] == list(range(min(b, k)))


#: samples per marginal and the total-variation bound it is held to: at 40000
#: draws over 5 tokens the expected TV distance is about 0.004
N_DRAWS, TV_BOUND = 40_000, 0.015


@pytest.mark.parametrize("filters", [dict(temperature=1.0),
                                     dict(temperature=0.8, top_k=3, top_p=0.9)],
                         ids=["plain", "top_k_top_p"])
def test_stochastic_accept_marginals_match_direct_sampling(filters):
    """The first emitted token of a K=2 burst is distributed as a direct draw
    from the filtered verify distribution p, whatever the draft's q."""
    verify = torch.tensor([2.0, 1.5, 0.5, -1.0, 0.0])
    draft = torch.tensor([0.5, 2.0, 1.0, 0.0, -2.0])          # deliberately unlike p
    gen = torch.Generator().manual_seed(0)
    vl = verify.expand(N_DRAWS, 3, 5).contiguous()
    dl = draft.expand(N_DRAWS, 2, 5).contiguous()
    d_toks = sample(dl, gen, **filters)
    acc, out = tloop.accept_tokens(vl, d_toks, dl, gen, **filters)
    emp = torch.bincount(out[:, 0].long(), minlength=5).double() / N_DRAWS
    p = torch.softmax(filtered_logits(verify, **filters), dim=-1).double()
    jp = jax.nn.softmax(jfiltered_logits(jnp.asarray(verify.numpy()), **filters))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    tv = 0.5 * float((emp - p).abs().sum())
    assert tv <= TV_BOUND, (tv, emp, p)
    if "top_k" in filters:
        assert p[3] == 0 and p[4] == 0 and emp[3] == 0 and emp[4] == 0
    assert 0 < float(acc.float().mean()) < 2


def test_identical_distributions_accept_every_draft():
    """p == q: every draft token is accepted, and the bonus token is a draw
    from p_K."""
    row = torch.tensor([1.0, 0.5, -0.5, 0.0, 2.0])
    gen = torch.Generator().manual_seed(3)
    vl = row.expand(N_DRAWS, 3, 5).contiguous()
    d_toks = sample(vl[:, :2], gen, temperature=1.0)
    acc, out = tloop.accept_tokens(vl, d_toks, vl[:, :2], gen, temperature=1.0)
    assert int(acc.sum()) == 2 * N_DRAWS
    assert torch.equal(out[:, :2], d_toks)
    emp = torch.bincount(out[:, 2].long(), minlength=5).double() / N_DRAWS
    assert 0.5 * float((emp - torch.softmax(row, -1).double()).abs().sum()) <= TV_BOUND
    with pytest.raises(ValueError, match="torch.Generator"):
        tloop.accept_tokens(vl, d_toks, vl[:, :2], None, temperature=1.0)


# -- draft containers --------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdecoder.init(jcfg, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    specs = tapply.layer_specs(tp, tcfg)
    policy = dryrun_policy(specs, "mixed")
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(jp, jcfg),
                                       JBitPolicy.from_json(policy.to_json()), jcfg)
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    infos = state_layer_infos(tcfg, 3, 64)
    state = BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                        for l in infos})
    rng = np.random.default_rng(0)
    hetero = BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4])) for s in specs})
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jserve=jserve, tserve=tserve, specs=specs,
                policy=policy, state=state, hetero=hetero)


def _same_trees(tree, jtree):
    """Every leaf equal: packed containers byte for byte, float leaves exactly."""
    jflat = dict(tapply._walk(params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")))
    flat = dict(tapply._walk(tree))
    assert flat.keys() == jflat.keys()
    for path, leaf in flat.items():
        ref = jflat[path]
        if isinstance(leaf, QuantizedTensor):
            assert leaf.bits == ref.bits and leaf.shape == tuple(ref.shape), path
            np.testing.assert_array_equal(leaf.packed.numpy(), np.asarray(ref.packed))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(ref.scale))
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref), err_msg=str(path))


@pytest.mark.parametrize("spec", ("uniform2", "hetero"))
def test_draft_containers_match_jax(served, spec):
    tspec = 2 if spec == "uniform2" else served["hetero"]
    jspec = 2 if spec == "uniform2" else JBitPolicy.from_json(served["hetero"].to_json())
    draft, bits = build_draft_params(served["tserve"], tspec, served["tcfg"], materialize=False)
    jdraft, jbits = jbuild_draft(served["jserve"], jspec, served["jcfg"], materialize=False)
    assert bits == jbits == tapply.packed_policy_bits(draft)
    _same_trees(draft, jdraft)
    assert draft["final_norm"] is served["tserve"]["final_norm"]     # shared, not copied
    assert draft["layers"][0]["ln1"] is served["tserve"]["layers"][0]["ln1"]


def test_draft_from_a_float_tree_and_materialized(served):
    tcfg, jcfg = served["tcfg"], served["jcfg"]
    tfp = tdecoder.unstack_layers(served["tp"], tcfg)
    jfp = jdecoder.unstack_layers(served["jp"], jcfg)
    draft, bits = build_draft_params(tfp, 4, tcfg, materialize=False)
    jdraft, jbits = jbuild_draft(jfp, 4, jcfg, materialize=False)
    assert bits == jbits
    _same_trees(draft, jdraft)
    assert draft["embed"].shape == (tcfg.d_model, tcfg.vocab_size)     # (d, V) layout
    # "auto" on CPU tensors: the f32 values of the packed levels, as the JAX
    # package's off-TPU draft
    auto, _ = build_draft_params(served["tserve"], 4, tcfg)
    jauto, _ = jbuild_draft(served["jserve"], 4, jcfg, materialize=True)
    _same_trees(auto, jauto)
    assert auto["embed"].shape == (tcfg.vocab_size, tcfg.d_model)
    art = PolicyArtifact.build(served["policy"])
    _raises_alike(lambda: jbuild_draft(served["jserve"], JArtifact.from_json(art.to_json()), jcfg),
                  lambda: build_draft_params(served["tserve"], art, tcfg))


# -- decode_verify -----------------------------------------------------------------


def test_decode_verify_matches_jax_and_the_decode_steps(served):
    """The verify pass over a K+1 = 4 burst of 3 slots (M = 12 rows: the GEMM)
    against the JAX package's (logits and burst K/V to rel 1e-4 as the
    decoder's tests hold them; cache bytes are not compared with the JAX
    package, since a K value a ulp from a rounding tie may move a level), and
    against four ``decode_step`` calls (the GEMV) on a copy of the cache:
    logits to rel 1e-5, packed cache bytes exact and scales to rel 1e-6 (on
    the CPU torch's matmul sums in another order at M = 12 than at M = 3, so
    a scale may move by an ulp)."""
    tcfg, jcfg = served["tcfg"], served["jcfg"]
    tparams = tapply.fuse_projections(served["tserve"])
    jparams = japply.fuse_projections(served["jserve"])
    bits = [(8, 4), (4, 2)]
    rng = np.random.default_rng(5)
    toks = rng.integers(1, tcfg.vocab_size, (3, 12)).astype(np.int32)
    burst = rng.integers(1, tcfg.vocab_size, (3, 4)).astype(np.int32)
    lens = np.asarray([12, 7, 3], np.int32)
    _, tkv = tdecoder.prefill(tparams, tcfg, torch.from_numpy(toks), logits=False)
    jkv = [{n: jnp.asarray(c[n].numpy()) for n in ("k", "v")} for c in tkv]   # the same rows

    def tcache_():
        st = tdecoder.init_cache(tcfg, 3, 32, state_bits=bits, device="cpu")
        return tcache.insert_state_rows(st, torch.arange(3), tkv, torch.from_numpy(lens))

    jst = jcache.insert_state_rows(jdecoder.init_cache(jcfg, 3, 32, state_bits=bits),
                                   jnp.arange(3), jkv, jnp.asarray(lens))
    kernels.reset_counts()
    logits, tst, tburst = tdecoder.decode_verify(tparams, tcfg, tcache_(), torch.from_numpy(burst),
                                                 torch.from_numpy(lens))
    assert kernels.PLAIN_CALLS["quant_kv_decode_step"] == 4 * tcfg.n_layers
    assert kernels.PLAIN_CALLS["quant_matmul"] == 4 * tcfg.n_layers      # one per linear
    assert kernels.PLAIN_CALLS["quant_gemv"] == 0
    verify = jax.jit(lambda p, st, t, q: jdecoder.decode_verify(p, jcfg, st, t, q, qimpl="xla"))
    jlogits, _, jburst = verify(jparams, jst, jnp.asarray(burst), jnp.asarray(lens))
    assert logits.shape == (3, 4, tcfg.vocab_size)
    assert _rel(logits.numpy(), jlogits) <= 1e-4
    for (k, v), (jk, jv) in zip(tburst, jburst):
        assert k.shape == (3, 4, tcfg.n_kv_heads, tcfg.resolved_head_dim)
        assert _rel(k.numpy(), jk) <= 1e-4 and _rel(v.numpy(), jv) <= 1e-4
    st = tcache_()
    for j in range(4):
        step, st = tdecoder.decode_step(tparams, tcfg, st, torch.from_numpy(burst[:, j:j + 1]),
                                        torch.from_numpy(lens + j))
        assert _rel(step[:, 0].numpy(), logits[:, j].numpy()) <= 1e-5
    for a, b in zip(st, tst):
        for n in FIELDS:
            if n.endswith("packed"):
                assert torch.equal(getattr(a, n), getattr(b, n)), n
            else:
                torch.testing.assert_close(getattr(a, n), getattr(b, n), rtol=1e-6, atol=0)


# -- the speculative engine ----------------------------------------------------------

SLOTS, SEQ, NEW = 3, 64, 10
#: the straggler shed reads the host clock: off, so that a slow round under
#: parallel test workers cannot drop K on one twin and not the other
SHED = ShedPolicy(straggler_sheds_spec=False)
JSHED = JShedPolicy(straggler_sheds_spec=False)
#: the first wave's two [9] * 19 share their blocks, the second one's write
#: block too (copy-on-write at the first burst)
PROMPTS = [[9] * 19, [5, 6, 7, 8], [9] * 19, [1, 2, 9, 4, 7, 3], [2], [3, 1, 4, 1, 5],
           list(range(1, 31))]


def _engines(served, *, speculate, from_artifact=False, jax_ref=True, **kw):
    """The JAX speculative engine (None unless ``jax_ref``), the port's, and
    the port's non-speculative one, on the same weights and arguments."""
    args = dict(max_slots=SLOTS, max_seq=kw.pop("max_seq", SEQ), prefill_pad=8)
    jkw = dict(kw, shed=JSHED)
    kw["shed"] = SHED
    kw.setdefault("debug_invariants", True)
    if from_artifact:
        art = PolicyArtifact.build(served["policy"], state_policy=served["state"],
                                   pool={"block": 16, "num_blocks": kw.pop("pool_blocks")},
                                   draft_policy=BitPolicy.uniform(served["specs"], 4),
                                   draft_k=speculate)
        jkw.pop("pool_blocks")
        jeng = JServeEngine(served["jcfg"], served["jserve"], qimpl="xla",
                            artifact=JArtifact.from_json(art.to_json()), **args,
                            **jkw) if jax_ref else None
        eng = ServeEngine(served["tcfg"], served["tserve"], artifact=art, device="cpu", **args,
                          **kw)
        base = ServeEngine(served["tcfg"], served["tserve"], artifact=dataclasses.replace(
            art, draft_policy=None, draft_k=0), device="cpu", shed=SHED, **args)
        return jeng, eng, base
    jstate = JBitPolicy.from_json(served["state"].to_json())
    jeng = JServeEngine(served["jcfg"], served["jserve"], qimpl="xla", state_bits=jstate,
                        speculate=speculate, draft_policy=4, **args,
                        **jkw) if jax_ref else None
    eng = ServeEngine(served["tcfg"], served["tserve"], state_bits=served["state"],
                      speculate=speculate, draft_policy=4, device="cpu", **args, **kw)
    kw.pop("debug_invariants")
    base = ServeEngine(served["tcfg"], served["tserve"], state_bits=served["state"],
                       device="cpu", **args, **kw)
    return jeng, eng, base


def _spec_counts(stats):
    return stats["spec_steps"], stats["spec_proposed"], stats["spec_accepted"]


@pytest.mark.parametrize("case", ["dense_k1", "dense_k3", "paged_k1", "paged_artifact_k3"])
def test_greedy_streams_match_jax_and_non_speculative(served, case):
    """Each case against the port's non-speculative engine and the JAX
    speculative engine, counters and pool counters included."""
    k = int(case[-1])
    kw = dict(paged=True, pool_blocks=16) if "paged" in case else {}
    jeng, eng, base = _engines(served, speculate=k, from_artifact="artifact" in case, **kw)
    kernels.reset_counts()
    got = eng.generate(PROMPTS, max_new_tokens=NEW)
    assert got == base.generate(PROMPTS, max_new_tokens=NEW)
    st = eng.stats()
    assert st["spec_steps"] == st["decode_steps"]
    assert st["spec_accepted"] > 0 and st["speculate_live_k"] == k
    assert got == jeng.generate(PROMPTS, max_new_tokens=NEW)
    jst = jeng.stats()
    assert _spec_counts(st) == _spec_counts(jst)
    assert st["decode_steps"] == jst["decode_steps"]
    assert st["draft_bits"] == dict(jeng.draft_bits)
    if eng.paged:
        assert eng.pool.allocated == eng.pool.reserved == 0
        assert (eng.pool.peak_allocated, eng.pool.shared_maps, eng.pool.cow_copies) == (
            jeng.pool.peak_allocated, jeng.pool.shared_maps, jeng.pool.cow_copies)
        assert eng.pool.shared_maps > 0 and eng.pool.cow_copies > 0
    # the replays are the only appends alone; none of them is a launch here
    layers_ = served["tcfg"].n_layers
    assert st["plain_calls"]["quant_kv_append_paged" if eng.paged else "quant_kv_append"] == (
        layers_ * (k + 1) * st["spec_steps"])
    assert sum(st["launches"].values()) == 0


def test_burst_shrinks_at_max_seq(served):
    """Near max_seq the burst shrinks (K_eff < K) instead of writing past the
    cache; the streams still equal the JAX engine's and the plain ones."""
    jeng, eng, base = _engines(served, speculate=2, max_seq=16)
    prompts = [[5, 6, 7, 8], [1, 2]]
    want = jeng.generate(prompts, max_new_tokens=30)
    assert eng.generate(prompts, max_new_tokens=30) == want
    assert base.generate(prompts, max_new_tokens=30) == want
    assert all(len(o) < 30 for o in want)
    assert _spec_counts(eng.stats()) == _spec_counts(jeng.stats())
    assert eng.stats()["spec_proposed"] % 2 != 0            # some round ran short


def test_eos_inside_a_burst_truncates_and_frees(served):
    """An eos token in the middle of an accepted burst ends the request there:
    the rest of the burst is dropped and the slot is freed in the same round."""
    _, probe, _ = _engines(served, speculate=3, jax_ref=False, paged=True, pool_blocks=16)
    bursts: list[tuple[int, int, list[int]]] = []     # (uid, stream offset, tokens)
    step = probe._spec_step

    def record(active, *args):
        out = step(active, *args)          # (emitted, draft flags, verify flags)
        bursts.extend((probe.slots[i].req.uid, len(probe.slots[i].generated), toks)
                      for i, toks in out[0].items())
        return out

    probe._spec_step = record
    streams = dict(enumerate(probe.generate(PROMPTS, max_new_tokens=NEW)))
    # the second token of a burst of three or more that has not been emitted before
    uid, at, eos = next((u, at + 1, toks[1]) for u, at, toks in bursts
                        if len(toks) >= 3 and at + 3 <= NEW and toks[1] not in streams[u][:at + 1])
    cut = streams[uid][:at + 1]
    assert cut[-1] == eos and len(cut) < NEW
    jeng, eng, base = _engines(served, speculate=3, paged=True, pool_blocks=16)
    for e, req in ((jeng, JRequest), (eng, Request), (base, Request)):
        out = e.run([req(uid=i, prompt=p, max_new_tokens=NEW, eos_id=eos if i == uid else -1)
                     for i, p in enumerate(PROMPTS)])
        assert out[uid] == cut
        assert {u: t for u, t in out.items() if u != uid} == {
            u: t for u, t in streams.items() if u != uid}
    assert eng.pool.allocated == eng.pool.reserved == 0


def test_fp_cache_and_backpressure_streams(served):
    """An fp cache speculates without the commit; a 6-block pool makes
    requests wait while bursts map and copy blocks, under the invariant
    checker; both equal the non-speculative streams."""
    tcfg, tserve = served["tcfg"], served["tserve"]
    args = dict(max_slots=SLOTS, max_seq=SEQ, prefill_pad=8, device="cpu", shed=SHED)
    fp = ServeEngine(tcfg, tserve, speculate=2, draft_policy=served["hetero"], **args)
    assert not fp._quant_state
    assert fp.generate(PROMPTS, max_new_tokens=NEW) == ServeEngine(
        tcfg, tserve, **args).generate(PROMPTS, max_new_tokens=NEW)
    paged = dict(state_bits=served["state"], paged=True, pool_blocks=6)
    eng = ServeEngine(tcfg, tserve, speculate=3, draft_policy=4, debug_invariants=True,
                      **paged, **args)
    out = eng.generate(PROMPTS, max_new_tokens=NEW)
    assert out == ServeEngine(tcfg, tserve, **paged, **args).generate(PROMPTS,
                                                                      max_new_tokens=NEW)
    assert eng.pool.peak_allocated <= 6 and eng.pool.allocated == eng.pool.reserved == 0


def test_stochastic_speculation_gives_valid_streams(served):
    tcfg, tserve = served["tcfg"], served["tserve"]
    kw = dict(max_slots=SLOTS, max_seq=SEQ, state_bits=served["state"], temperature=1.0,
              top_k=40, top_p=0.95, seed=7, speculate=2, draft_policy=4, device="cpu",
              shed=SHED)
    out = ServeEngine(tcfg, tserve, **kw).generate(PROMPTS, max_new_tokens=6)
    assert [len(t) for t in out] == [6] * len(PROMPTS)
    assert all(0 <= t < tcfg.vocab_size for toks in out for t in toks)
    again = ServeEngine(tcfg, tserve, **kw)
    assert again.generate(PROMPTS, max_new_tokens=6) == out     # same seed, same draws
    assert again.stats()["spec_steps"] > 0


@pytest.mark.parametrize("case", ["speculate_alone", "draft_alone", "packed_bits", "pool_block",
                                  "paged_without_state", "state_surface"])
def test_constructor_errors_match_jax(served, case):
    jcfg, tcfg = served["jcfg"], served["tcfg"]
    kw = dict(max_slots=2, max_seq=48)
    art = None
    if case == "speculate_alone":
        kw["speculate"] = 2
    elif case == "draft_alone":
        kw["draft_policy"] = 4
    elif case == "packed_bits":
        art = PolicyArtifact.build(BitPolicy.uniform(served["specs"], 8))
    elif case == "pool_block":
        kw["max_seq"] = 40
        art = PolicyArtifact.build(served["policy"], state_policy=served["state"],
                                   pool={"block": 16, "num_blocks": 8})
    elif case == "paged_without_state":
        kw["paged"] = True
    else:
        infos = [dataclasses.replace(l, shape=l.shape[:2] + (3, 32))
                 for l in served["state"].layers]
        art = PolicyArtifact.build(served["policy"],
                                   state_policy=BitPolicy.uniform(infos, 8))
    jkw = dict(kw, artifact=JArtifact.from_json(art.to_json())) if art else kw
    _raises_alike(lambda: JServeEngine(jcfg, served["jserve"], qimpl="xla", **jkw),
                  lambda: ServeEngine(tcfg, served["tserve"], device="cpu", artifact=art, **kw))
