"""The burst append (the speculative commit's replay) against the JAX package.

``kernels.quant_kv.ops.quant_kv_append_burst`` appends burst positions
``start + j`` for j = 0 .. ``acc`` of every slot in one call: on the card
one launch, on the CPU its plain version, the per-position loop the commit
ran before.  The same seeded numpy inputs go through the JAX package's
sequence of appends (``spec.loop._masked_append`` at each burst index, as
its ``commit_state`` replays them, impl "xla") and the port's plain burst,
dense and paged, at several K/V widths, with bursts that cross a block
edge, slots that run past S, masked slots (``acc`` below the burst index)
and an idle paged slot: bytes and scales exactly equal (paged pools at
blocks 1..P-1: block 0 is the trash block).  Then the port's
``commit_state`` against the JAX package's on every layer of a reduced
gemma-2b, and the two speculative engines' streams and final caches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.kvcache import cache as jcache
from repro.kvcache import paged as jpaged
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro.serve.engine import ServeEngine as JServeEngine
from repro.spec import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core import packing as tpacking
from repro_torch.core.policy import BitPolicy
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import paged as tpaged
from repro_torch.kvcache import state_layer_infos
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.quant import apply as tapply
from repro_torch.serve.engine import ServeEngine
from repro_torch.spec import loop as tloop

torch.set_num_threads(2)

FIELDS = ("k_packed", "k_scale", "v_packed", "v_scale")
BITS = ((8, 4), (4, 4), (8, 8), (2, 8))
#: chip_smoke.py phase 2's burst: 8 slots over S 1024 (block 16); slot 2
#: crosses a block edge, slots 5 and 6 run past S, slot 7 accepts nothing
S, BLOCK, H, HD, K = 1024, 16, 1, 16, 3
START = np.asarray([264, 487, 510, 764, 1015, 1021, 1023, 700], np.int32)
ACC = np.asarray([3, 0, 2, 1, 3, 3, 3, -1], np.int32)


def _same(tl, jl, rows=slice(None), scale_rtol=0.0):
    for name in FIELDS:
        got, want = getattr(tl, name)[rows].numpy(), np.asarray(getattr(jl, name))[rows]
        if name.endswith("packed") or not scale_rtol:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=scale_rtol, atol=0, err_msg=name)


def _jax_burst(jl, start, acc, kb, vb):
    """The JAX package's commit replay of one layer: each burst index a
    masked append of every slot."""
    for j in range(kb.shape[1]):
        jl = jloop._masked_append(jl, jnp.asarray(start + j), jnp.asarray(kb[:, j:j + 1]),
                                  jnp.asarray(vb[:, j:j + 1]), jnp.asarray(j <= acc), "xla")
    return jl


@pytest.mark.parametrize("k_bits,v_bits", BITS)
def test_dense_plain_burst_equals_the_jax_appends(k_bits, v_bits):
    rng = np.random.default_rng(k_bits * 10 + v_bits)
    b = len(START)
    k = rng.normal(size=(b, S, H, HD)).astype(np.float32)
    v = rng.normal(size=(b, S, H, HD)).astype(np.float32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, block=BLOCK)
    jl = jcache.insert_rows(jcache.init_kv_layer(b, S, H, HD, **kw), jnp.arange(b),
                            jnp.asarray(k), jnp.asarray(v), jnp.asarray(START))
    tl = tcache.insert_rows(tcache.init_kv_layer(b, S, H, HD, device="cpu", **kw),
                            torch.arange(b), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(START))
    _same(tl, jl)
    kb = rng.normal(size=(b, K + 1, H, HD)).astype(np.float32) * 1.5
    vb = rng.normal(size=(b, K + 1, H, HD)).astype(np.float32)
    before = {name: getattr(tl, name).clone() for name in FIELDS}
    kernels.reset_counts()
    kv_ops.quant_kv_append_burst(tl, torch.from_numpy(START), torch.from_numpy(ACC),
                                 torch.from_numpy(kb), torch.from_numpy(vb))
    _same(tl, _jax_burst(jl, START, ACC, kb, vb))
    # one counted plain append a burst index, no launch
    assert kernels.PLAIN_CALLS["quant_kv_append"] == K + 1
    assert sum(kernels.LAUNCHES.values()) == 0
    for name in FIELDS:                      # the slot that accepts nothing keeps its bytes
        assert torch.equal(getattr(tl, name)[7], before[name][7]), name


NPOOL, PS = 40, 128                           # a pool of 40 blocks, max_seq 128


def _paged_case(k_bits, v_bits, rng):
    """Six slots over a shuffled pool: slots 0 and 1 share their first two
    blocks; slot 2 crosses into a mapped block, slot 3 into an unmapped one;
    slot 4 is idle (its row all -1); slot 5 sits at S - 1."""
    nb = PS // BLOCK
    ids = iter((rng.permutation(NPOOL - 1) + 1).tolist())
    start = np.asarray([30, 33, 46, 62, 9, PS - 1], np.int32)
    acc = np.asarray([3, 1, 3, 3, 3, 2], np.int32)
    table = np.full((6, nb), -1, np.int32)
    for i, p in enumerate(start):
        if i == 4:
            continue
        last = p // BLOCK + (1 if i in (0, 2) else 0)
        table[i, :last + 1] = [next(ids) for _ in range(last + 1)]
    table[1, :2] = table[0, :2]
    rows = np.full((6, nb), -1, np.int32)
    for i in (0, 2, 3, 5):
        rows[i] = table[i]
    rows[1, 2:] = table[1, 2:]
    kw = dict(k_bits=k_bits, v_bits=v_bits, block=BLOCK)
    k = rng.normal(size=(6, PS, H, HD)).astype(np.float32)
    v = rng.normal(size=(6, PS, H, HD)).astype(np.float32)
    k[1, :32], v[1, :32] = k[0, :32], v[0, :32]
    lens = np.where(np.arange(6) == 4, 0, start).astype(np.int32)
    jl = jpaged.with_table(jpaged.init_paged_layer(NPOOL, 6, PS, H, HD, **kw), table)
    jl = jpaged.insert_prefill_rows(jl, rows, jnp.asarray(k), jnp.asarray(v),
                                    valid_len=jnp.asarray(lens))
    tl = tpaged.with_table(tpaged.init_paged_layer(NPOOL, 6, PS, H, HD, device="cpu", **kw),
                           table)
    tl = tpaged.insert_prefill_rows(tl, rows, torch.from_numpy(k), torch.from_numpy(v),
                                    valid_len=torch.from_numpy(lens))
    return tl, jl, start, acc


@pytest.mark.parametrize("k_bits,v_bits", BITS)
def test_paged_plain_burst_equals_the_jax_appends(k_bits, v_bits):
    rng = np.random.default_rng(k_bits * 3 + v_bits)
    tl, jl, start, acc = _paged_case(k_bits, v_bits, rng)
    _same(tl, jl, rows=slice(1, None))
    kb = rng.normal(size=(6, K + 1, H, HD)).astype(np.float32)
    vb = rng.normal(size=(6, K + 1, H, HD)).astype(np.float32) * 0.5
    kernels.reset_counts()
    kv_ops.quant_kv_append_burst(tl, torch.from_numpy(start), torch.from_numpy(acc),
                                 torch.from_numpy(kb), torch.from_numpy(vb))
    _same(tl, _jax_burst(jl, start, acc, kb, vb), rows=slice(1, None))
    assert kernels.PLAIN_CALLS["quant_kv_append_paged"] == K + 1
    assert sum(kernels.LAUNCHES.values()) == 0


def test_burst_refuses_cuda_on_cpu_tensors():
    layer = tcache.init_kv_layer(1, 16, 1, 16, k_bits=8, v_bits=8, block=8, device="cpu")
    burst = torch.zeros((1, 2, 1, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kv_ops.quant_kv_append_burst(layer, torch.zeros(1, dtype=torch.int32),
                                     torch.ones(1, dtype=torch.int32), burst, burst,
                                     impl="cuda")


@pytest.fixture(scope="module")
def gemma():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdecoder.init(jcfg, jax.random.key(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    policy = dryrun_policy(tapply.layer_specs(tp, tcfg), "mixed")
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(jp, jcfg),
                                       JBitPolicy.from_json(policy.to_json()), jcfg)
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    infos = state_layer_infos(tcfg, 3, 64)
    state = BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                        for l in infos})
    return dict(jcfg=jcfg, tcfg=tcfg, jserve=jserve, tserve=tserve, state=state)


@pytest.mark.parametrize("k", (1, 3))
def test_commit_state_matches_jax_on_reduced_gemma(gemma, k):
    """Every layer of a reduced gemma-2b's K 8 / V 4 cache: snapshot, the
    verify's K+1 appends, then the commit of per-slot accepted counts (the
    last slot's burst runs past the cache's end)."""
    from repro.kvcache import resolve_state_bits as jresolve
    from repro_torch.kvcache import resolve_state_bits as tresolve

    jcfg, tcfg = gemma["jcfg"], gemma["tcfg"]
    b, seq = 3, 64
    tbits = tresolve(gemma["state"], tcfg)
    jbits = jresolve(JBitPolicy.from_json(gemma["state"].to_json()), jcfg)
    jstate = jdecoder.init_cache(jcfg, b, seq, state_bits=jbits)
    tstate = tdecoder.init_cache(tcfg, b, seq, state_bits=tbits, device="cpu")
    rng = np.random.default_rng(k)
    pos = np.asarray([17, 31, seq - 2], np.int32)
    h, hd = tstate[0].shape[2], tstate[0].head_dim
    for i, (tl, jl) in enumerate(zip(tstate, jstate)):
        kv = [rng.normal(size=(b, seq, h, hd)).astype(np.float32) for _ in range(2)]
        jstate[i] = jcache.insert_rows(jl, jnp.arange(b), jnp.asarray(kv[0]),
                                       jnp.asarray(kv[1]), jnp.asarray(pos))
        tcache.insert_rows(tl, torch.arange(b), torch.from_numpy(kv[0]),
                           torch.from_numpy(kv[1]), torch.from_numpy(pos))
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    tsaved, jsaved = tloop.snapshot_state(tstate, tpos, k), jloop.snapshot_state(jstate, jpos, k)
    burst = [[rng.normal(size=(b, k + 1, h, hd)).astype(np.float32) for _ in range(2)]
             for _ in tstate]
    for i, (kb, vb) in enumerate(burst):           # the verify pass writes the whole burst
        for j in range(k + 1):
            jstate[i] = jloop._masked_append(jstate[i], jpos + j, jnp.asarray(kb[:, j:j + 1]),
                                             jnp.asarray(vb[:, j:j + 1]),
                                             jnp.ones(b, bool), "xla")
            kv_ops.quant_kv_append(tstate[i], tpos + j, torch.from_numpy(kb[:, j:j + 1]),
                                   torch.from_numpy(vb[:, j:j + 1]))
    acc = np.asarray([k, 0, k], np.int32)
    jstate = jloop.commit_state(jstate, jsaved, jpos, jnp.asarray(acc),
                                [(jnp.asarray(a), jnp.asarray(c)) for a, c in burst], k,
                                qimpl="xla")
    kernels.reset_counts()
    tloop.commit_state(tstate, tsaved, tpos, torch.from_numpy(acc),
                       [(torch.from_numpy(a), torch.from_numpy(c)) for a, c in burst], k)
    assert kernels.PLAIN_CALLS["quant_kv_append"] == tcfg.n_layers * (k + 1)
    for tl, jl in zip(tstate, jstate):
        _same(tl, jl)


def test_speculative_streams_and_caches_match_jax_on_reduced_gemma(gemma):
    """The dense speculative engines at K = 3 with a 4-bit draft: the port's
    commit (the burst append, one call a layer) leaves the JAX engine's
    streams and accepted counts, and its caches: scales within rel 1e-6 and
    levels within one step at no more than 0.1 % of entries (the JAX
    engine's jitted step rounds a scale's division one ulp apart, as
    tests/test_torch_spec.py notes for "interpret", which can move a level
    at a rounding edge; the commit alone is exact above)."""
    args = dict(max_slots=3, max_seq=64, prefill_pad=8, speculate=3, draft_policy=4)
    jeng = JServeEngine(gemma["jcfg"], gemma["jserve"], qimpl="xla",
                        state_bits=JBitPolicy.from_json(gemma["state"].to_json()), **args)
    eng = ServeEngine(gemma["tcfg"], gemma["tserve"], state_bits=gemma["state"], device="cpu",
                      **args)
    prompts = [[9] * 19, [5, 6, 7, 8], [1, 2, 9, 4, 7, 3], list(range(1, 31))]
    assert eng.generate(prompts, max_new_tokens=8) == jeng.generate(prompts, max_new_tokens=8)
    assert eng.stats()["spec_accepted"] == jeng.stats()["spec_accepted"]
    for tl, jl in zip(eng.state, jeng.state):
        for side, bits in (("k", tl.k_bits), ("v", tl.v_bits)):
            np.testing.assert_allclose(getattr(tl, f"{side}_scale").numpy(),
                                       np.asarray(getattr(jl, f"{side}_scale")), rtol=1e-6,
                                       atol=0)
            lev = tpacking.unpack(getattr(tl, f"{side}_packed"), bits, tl.head_dim)
            jlev = tpacking.unpack(torch.from_numpy(np.array(getattr(jl, f"{side}_packed"))),
                                   bits, tl.head_dim)
            apart = (lev != jlev)
            assert int((lev - jlev).abs().max()) <= 1 and float(apart.float().mean()) <= 1e-3
