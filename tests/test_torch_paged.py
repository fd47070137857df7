"""Port parity of the paged quantized KV cache: block pool, paged layer, the
three paged ops' plain versions, and the paged serving engine.

The same seeded numpy inputs go through the JAX package (``impl="xla"``, its
jnp oracle, and ``impl="interpret"``, the Pallas bodies on the CPU) and the
port on CPU tensors.  Pool bytes and scales are compared at blocks 1..P-1:
block 0 is the trash block, where idle slots' appends land in the JAX
package (duplicate scatter indices, unspecified winner) and where the CUDA
kernels write nothing, so its bytes are no part of the contract.  Outputs in
f32 agree to rel 1e-5 (summation order only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.kernels.quant_kv import ops as jkv_ops
from repro.kvcache import paged as jpaged
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kvcache import paged as tpaged
from repro_torch.kvcache import state_layer_infos
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.quant import apply as tapply
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

JAX_IMPLS = ("xla", "interpret")
KV_BITS = [(8, 8), (8, 4), (4, 2), (6, 4)]


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _assert_same_pool(tl, jl, *, scale_rtol=0.0):
    """Pool bytes exact and scales exact (or to ``scale_rtol``: the Pallas body
    jitted in interpret mode divides by a constant as a reciprocal multiply,
    one ulp off the IEEE division) at blocks 1..P-1; block 0 is the trash block."""
    for name in ("k_packed", "v_packed"):
        np.testing.assert_array_equal(getattr(tl, name)[1:].numpy(),
                                      np.asarray(getattr(jl, name))[1:], err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tl, name)[1:].numpy(),
                                   np.asarray(getattr(jl, name))[1:], rtol=scale_rtol, atol=0,
                                   err_msg=name)


def _clone(layer):
    return dataclasses.replace(layer, **{f: getattr(layer, f).clone() for f in
                                         ("k_packed", "k_scale", "v_packed", "v_scale",
                                          "block_table")})


# -- BlockPool -----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_block_pool_matches_jax_under_random_traffic(seed):
    rng = np.random.default_rng(seed)
    n = 13
    tp, jp = tpaged.BlockPool(n), jpaged.BlockPool(n)
    live: dict[int, int] = {}
    for _ in range(300):
        op = int(rng.integers(0, 5))
        if op == 0 and tp.available > 0:
            bid = tp.alloc()
            assert bid == jp.alloc()
            live[bid] = 1
        elif op == 1 and live:
            bid = int(rng.choice(sorted(live)))
            tp.incref(bid)
            jp.incref(bid)
            live[bid] += 1
        elif op == 2 and live:
            bid = int(rng.choice(sorted(live)))
            tp.decref(bid)
            jp.decref(bid)
            live[bid] -= 1
            if not live[bid]:
                del live[bid]
        elif op == 3 and tp.available > 0:
            k = int(rng.integers(1, tp.available + 1))
            tp.reserve(k)
            jp.reserve(k)
        elif op == 4 and tp.reserved > 0:
            k = int(rng.integers(1, tp.reserved + 1))
            tp.unreserve(k)
            jp.unreserve(k)
        for attr in ("free_count", "available", "allocated", "reserved", "peak_allocated",
                     "shared_maps"):
            assert getattr(tp, attr) == getattr(jp, attr), attr
        assert [tp.refcount(b) for b in range(n + 1)] == [jp.refcount(b) for b in range(n + 1)]
    tp.decref(tpaged.TRASH_BLOCK)                  # a no-op, never raises
    while tp.free_count:
        assert tp.alloc() == jp.alloc()
    with pytest.raises(RuntimeError, match="exhausted"):
        tp.alloc()


def test_paged_layer_sizes_match_jax():
    kw = dict(slots=3, max_seq=64, n_kv=2, hd=16, k_bits=4, v_bits=8, block=16)
    tl = tpaged.init_paged_layer(6, device="cpu", **kw)
    jl = jpaged.init_paged_layer(6, **kw)
    assert tl.num_blocks == jl.num_blocks == 7
    assert tl.bytes_per_block() == jl.bytes_per_block()
    assert tl.container_bytes() == jl.container_bytes()
    assert tl.allocated_bytes(3) == jl.allocated_bytes(3)
    np.testing.assert_array_equal(tl.block_table.numpy(), np.asarray(jl.block_table))
    np.testing.assert_array_equal(tl.k_scale.numpy(), np.asarray(jl.k_scale))
    bits = [(4, 8), (8, 4), (2, 6)]
    for budget in (5000, 123456):
        assert (tpaged.pool_blocks_for_budget(bits, 2, 16, 16, budget)
                == jpaged.pool_blocks_for_budget(bits, 2, 16, 16, budget))
    with pytest.raises(ValueError, match="zero blocks"):
        tpaged.pool_blocks_for_budget(bits, 2, 16, 16, 10)
    with pytest.raises(ValueError, match="at least one usable block"):
        tpaged.init_paged_layer(0, device="cpu", **kw)


# -- the paged layer and the three paged ops -----------------------------------

B, S, H, HQ, HD, BLOCK = 4, 64, 2, 4, 16, 8
NB, NPOOL = S // BLOCK, 16
IDLE = 2
POS0 = np.asarray([20, 23, 5, 15], np.int32)   # slot 1 crosses into a new block at step 2
STEPS = 2


def _geometry(seed):
    """Block table over shuffled physical ids: slots 0 and 1 share their first
    two blocks (refcount 2), slot 2 is idle (row all -1), slot 3's block 0 is
    unmapped but its positions are valid."""
    ids = iter(np.random.default_rng(seed).permutation(np.arange(1, NPOOL + 1)).tolist())
    table = np.full((B, NB), -1, np.int32)
    table[0, :4] = [next(ids) for _ in range(4)]
    table[1, :2] = table[0, :2]
    table[1, 2:4] = [next(ids) for _ in range(2)]
    table[3, 1:3] = [next(ids) for _ in range(2)]
    rows = np.full((B, 3), -1, np.int32)          # prefill destinations, 24 rows
    rows[0] = table[0, :3]
    rows[1, 2] = table[1, 2]
    rows[3, 1] = table[3, 1]
    return table, rows


def _inputs(seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, 24, H, HD)).astype(np.float32)
    v = rng.normal(size=(B, 24, H, HD)).astype(np.float32)
    k[1, :16], v[1, :16] = k[0, :16], v[0, :16]   # the shared prefix holds the same rows
    steps = [(rng.normal(size=(B, HQ, HD)).astype(np.float32),
              rng.normal(size=(B, 1, H, HD)).astype(np.float32) * 1.5,
              rng.normal(size=(B, 1, H, HD)).astype(np.float32)) for _ in range(STEPS)]
    return k, v, steps


def _layers(k_bits, v_bits, seed):
    table, rows = _geometry(seed)
    k, v, steps = _inputs(seed)
    lens = np.asarray([20, 23, 0, 15], np.int32)
    jl = jpaged.init_paged_layer(NPOOL, B, S, H, HD, k_bits=k_bits, v_bits=v_bits, block=BLOCK)
    jl = jpaged.with_table(jl, table)
    jl = jpaged.insert_prefill_rows(jl, rows, jnp.asarray(k), jnp.asarray(v),
                                    valid_len=jnp.asarray(lens))
    tl = tpaged.init_paged_layer(NPOOL, B, S, H, HD, k_bits=k_bits, v_bits=v_bits, block=BLOCK,
                                 device="cpu")
    tl = tpaged.with_table(tl, table)
    tl = tpaged.insert_prefill_rows(tl, rows, torch.from_numpy(k), torch.from_numpy(v),
                                    valid_len=torch.from_numpy(lens))
    return tl, jl, steps


def _valid(pos):
    return np.arange(S)[None, :] <= pos[:, None]


@pytest.mark.parametrize("k_bits,v_bits", KV_BITS)
def test_layer_ops_bytes_match_jax(k_bits, v_bits):
    tl, jl, steps = _layers(k_bits, v_bits, seed=k_bits * 10 + v_bits)
    _assert_same_pool(tl, jl)
    np.testing.assert_array_equal(tl.block_table.numpy(), np.asarray(jl.block_table))
    for t, (_, kn, vn) in enumerate(steps):
        pos = POS0 + t
        jl = jpaged.append_token_paged(jl, jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn))
        tl = tpaged.append_token_paged(tl, torch.from_numpy(pos), torch.from_numpy(kn),
                                       torch.from_numpy(vn))
        _assert_same_pool(tl, jl)
    src = [int(tl.block_table[0, 2]), int(tl.block_table[3, 1])]
    free = sorted(set(range(1, NPOOL + 1)) - set(tl.block_table.flatten().tolist()))
    dst = free[:2]
    jl = jpaged.copy_blocks(jl, src, dst)
    tl = tpaged.copy_blocks(tl, src, dst)
    _assert_same_pool(tl, jl)
    np.testing.assert_array_equal(tl.k_packed[dst].numpy(), tl.k_packed[src].numpy())
    td, jd = tpaged.to_dense(tl), jpaged.to_dense(jl)
    for name in ("k_packed", "k_scale", "v_packed", "v_scale"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                      err_msg=name)
        assert getattr(td, name).is_contiguous(), name     # the dense kernel's layout
    assert float(td.k_scale[3, 0, 0, 0]) == np.float32(1e-12)    # unmapped but valid
    assert not td.k_packed[IDLE].any()                          # idle row reads zeros


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("k_bits,v_bits", KV_BITS)
def test_paged_attention_plain_matches_jax(k_bits, v_bits, impl):
    tl, jl, steps = _layers(k_bits, v_bits, seed=k_bits + v_bits)
    q = steps[0][0]
    valid = _valid(POS0)
    kernels.reset_counts()
    want = jkv_ops.quant_kv_attention(jnp.asarray(q), jl, jnp.asarray(valid), impl=impl)
    got = kv_ops.quant_kv_attention(torch.from_numpy(q), tl, torch.from_numpy(valid))
    assert got.shape == (B, HQ, HD)
    assert _rel(got.numpy(), want) <= 1e-5
    assert kernels.PLAIN_CALLS["quant_kv_attention_paged"] == 1
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("k_bits,v_bits", KV_BITS)
def test_paged_append_plain_matches_jax(k_bits, v_bits, impl):
    tl, jl, steps = _layers(k_bits, v_bits, seed=3 * k_bits + v_bits)
    kernels.reset_counts()
    for t, (_, kn, vn) in enumerate(steps):
        pos = POS0 + t
        jl = jkv_ops.quant_kv_append(jl, jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn),
                                     impl=impl)
        tl = kv_ops.quant_kv_append(tl, torch.from_numpy(pos), torch.from_numpy(kn),
                                    torch.from_numpy(vn))
        _assert_same_pool(tl, jl, scale_rtol=1e-6 if impl == "interpret" else 0.0)
    assert kernels.PLAIN_CALLS["quant_kv_append_paged"] == STEPS


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("k_bits,v_bits", KV_BITS)
def test_paged_decode_step_plain_matches_jax(k_bits, v_bits, impl):
    tl, jl, steps = _layers(k_bits, v_bits, seed=5 * k_bits + v_bits)
    kernels.reset_counts()
    for t, (q, kn, vn) in enumerate(steps):
        pos = POS0 + t
        valid = _valid(pos)
        jo, jl = jkv_ops.quant_kv_decode_step(jnp.asarray(q), jl, jnp.asarray(pos),
                                              jnp.asarray(kn), jnp.asarray(vn),
                                              jnp.asarray(valid), impl=impl)
        to, tl = kv_ops.quant_kv_decode_step(torch.from_numpy(q), tl, torch.from_numpy(pos),
                                             torch.from_numpy(kn), torch.from_numpy(vn),
                                             torch.from_numpy(valid))
        _assert_same_pool(tl, jl, scale_rtol=1e-6 if impl == "interpret" else 0.0)
        assert to.shape == (B, HQ, HD)
        assert _rel(to.numpy(), jo) <= 1e-5
    assert kernels.PLAIN_CALLS["quant_kv_decode_step_paged"] == STEPS
    assert kernels.PLAIN_CALLS["quant_kv_decode_step"] == 0


@pytest.mark.parametrize("k_bits,v_bits", [(8, 4), (4, 2)])
def test_paged_step_equals_append_then_attend_and_the_dense_step(k_bits, v_bits):
    tl, _, steps = _layers(k_bits, v_bits, seed=7)
    seq, dense = _clone(tl), tpaged.to_dense(tl)
    live = [i for i in range(B) if i != IDLE]    # the idle slot's dense block is written
    for t, (q, kn, vn) in enumerate(steps):
        pos = torch.from_numpy(POS0 + t)
        valid = torch.from_numpy(_valid(POS0 + t))
        q, kn, vn = map(torch.from_numpy, (q, kn, vn))
        fused, _ = kv_ops.quant_kv_decode_step(q, tl, pos, kn, vn, valid)
        kv_ops.quant_kv_append(seq, pos, kn, vn)
        sequential = kv_ops.quant_kv_attention(q, seq, valid)
        assert torch.equal(fused, sequential)
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(tl, f), getattr(seq, f)), f
        o_dense, dense = kv_ops.quant_kv_decode_step(q, dense, pos, kn, vn, valid)
        assert torch.equal(fused[live], o_dense[live])
        now = tpaged.to_dense(tl)
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(now, f)[live], getattr(dense, f)[live]), f


def test_dense_attention_and_append_plain_match_jax():
    from repro.kvcache import cache as jcache
    from repro_torch.kvcache import cache as tcache

    k, v, steps = _inputs(11)
    lens = np.asarray([20, 23, 1, 15], np.int32)
    jl = jcache.insert_rows(jcache.init_kv_layer(B, S, H, HD, k_bits=8, v_bits=4, block=BLOCK),
                            jnp.arange(B), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    tl = tcache.insert_rows(tcache.init_kv_layer(B, S, H, HD, k_bits=8, v_bits=4, block=BLOCK,
                                                 device="cpu"),
                            torch.arange(B), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(lens))
    q, kn, vn = steps[0]
    kernels.reset_counts()
    jl = jkv_ops.quant_kv_append(jl, jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn),
                                 impl="xla")
    tl = kv_ops.quant_kv_append(tl, torch.from_numpy(lens), torch.from_numpy(kn),
                                torch.from_numpy(vn))
    for name in ("k_packed", "k_scale", "v_packed", "v_scale"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)))
    valid = _valid(lens)
    want = jkv_ops.quant_kv_attention(jnp.asarray(q)[:, None], jl, jnp.asarray(valid),
                                      impl="xla")
    got = kv_ops.quant_kv_attention(torch.from_numpy(q)[:, None], tl, torch.from_numpy(valid))
    assert got.shape == (B, 1, HQ, HD)
    assert _rel(got.numpy(), want) <= 1e-5
    assert kernels.PLAIN_CALLS["quant_kv_append"] == kernels.PLAIN_CALLS["quant_kv_attention"] == 1


def test_place_paged_block_and_the_cpu_dispatch():
    tl = tpaged.init_paged_layer(4, 2, 16, 1, 16, k_bits=8, v_bits=8, block=4, device="cpu")
    blk = torch.full((2, 1, 4, 16), 7, dtype=torch.int8)
    kv_ops.place_paged_block(tl.k_packed, tl.k_scale, blk, torch.full((2, 1, 1, 1), 0.5),
                             torch.tensor([3, 1]))
    assert tl.k_packed[:, 0, 0, 0].tolist() == [0, 7, 0, 7, 0]
    np.testing.assert_array_equal(tl.k_scale[:, 0, 0, 0].numpy(),
                                  np.float32([1e-12, 0.5, 1e-12, 0.5, 1e-12]))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kv_ops.quant_kv_append(tl, 0, torch.zeros(2, 1, 1, 16), torch.zeros(2, 1, 1, 16),
                               impl="cuda")
    with pytest.raises(TypeError, match="PagedKVLayer"):
        kv_ops.quant_kv_attention(torch.zeros(2, 1, 16), {"k": 0}, torch.ones(2, 16, dtype=bool))
    assert len(kernels.KERNELS) == 11 and sum(kernels.LAUNCHES.values()) == 0


def test_init_cache_paged_shares_one_table():
    cfg = tconfigs.get_config("gemma-2b").reduced()
    st = tdecoder.init_cache(cfg, 3, 64, state_bits=[(8, 4)] * cfg.n_layers, paged=True,
                             device="cpu")
    assert all(isinstance(l, tpaged.PagedKVLayer) for l in st)
    assert all(l.block_table is st[0].block_table for l in st)
    assert st[0].num_blocks == 3 * 64 // 16 + 1
    with pytest.raises(ValueError, match="requires state_bits"):
        tdecoder.init_cache(cfg, 3, 64, paged=True, device="cpu")


# -- the paged engine ----------------------------------------------------------

SLOTS, SEQ, NEW = 3, 64, 6
VAR_PROMPTS = [[5, 6, 7, 8], [1, 2, 9, 4, 7, 3], [9] * 11, [2],
               [(3 * i + 1) % 500 for i in range(22)]]


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdecoder.init(jcfg, jax.random.key(4))
    specs = tapply.layer_specs(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
                               tcfg)
    policy = dryrun_policy(specs, "mixed")
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(jp, jcfg),
                                       JBitPolicy.from_json(policy.to_json()), jcfg)
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    infos = state_layer_infos(tcfg, SLOTS, SEQ)
    state = BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                        for l in infos})
    return jcfg, tcfg, jserve, tserve, state


def _jengine(served, **kw):
    jcfg, _, jserve, _, state = served
    kw.setdefault("max_slots", SLOTS)
    return JServeEngine(jcfg, jserve, max_seq=SEQ, qimpl="xla",
                        state_bits=JBitPolicy.from_json(state.to_json()), **kw)


def _engine(served, **kw):
    _, tcfg, _, tserve, state = served
    kw.setdefault("max_slots", SLOTS)
    return ServeEngine(tcfg, tserve, max_seq=SEQ, state_bits=state, device="cpu", **kw)


def _counters(pool):
    return pool.peak_allocated, pool.shared_maps, pool.cow_copies


def _both(served, drive, **kw):
    """Drive the JAX paged engine and the port's with the same arguments:
    ``drive(engine, request_class)`` -> outputs.  The port runs under its
    invariant checker; the JAX engine without its own, which trips on every
    copy-on-write split (a fault of its reservation ledger, ROADMAP queue 3).
    Asserts equal outputs and returns ``(outputs, port engine, JAX engine)``."""
    jeng = _jengine(served, **kw)
    want = drive(jeng, JRequest)
    eng = _engine(served, debug_invariants=kw.pop("debug_invariants", True), **kw)
    got = drive(eng, Request)
    assert got == want
    return got, eng, jeng


def _same_counters(eng, jeng):
    assert _counters(eng.pool) == _counters(jeng.pool)
    assert eng.pool.allocated == jeng.pool.allocated == 0
    assert eng.pool.reserved == jeng.pool.reserved == 0


@pytest.mark.parametrize("prompts,pool_blocks", [(VAR_PROMPTS, 12), ([[7] * 9] * 3, 12)],
                         ids=["variable", "copy_on_write"])
def test_paged_engine_matches_jax_paged_engine(served, prompts, pool_blocks):
    want_eng = _jengine(served, paged=True, pool_blocks=pool_blocks)
    want = want_eng.generate(prompts, max_new_tokens=NEW)
    kernels.reset_counts()
    eng = _engine(served, paged=True, pool_blocks=pool_blocks, debug_invariants=True)
    got = eng.generate(prompts, max_new_tokens=NEW)
    assert got == want
    assert _counters(eng.pool) == _counters(want_eng.pool)
    assert eng.pool.allocated == 0 and eng.pool.reserved == 0
    assert eng.state_bits == dict(want_eng.state_bits)
    assert eng.state_container_bytes() == want_eng.state_container_bytes()
    assert eng.allocated_state_bytes() == want_eng.allocated_state_bytes()
    st = eng.stats()
    assert st["plain_calls"]["quant_kv_decode_step_paged"] == 2 * st["decode_steps"]
    assert st["plain_calls"]["quant_kv_decode_step"] == 0
    assert sum(st["launches"].values()) == 0
    assert st["pool_peak_allocated"] == eng.pool.peak_allocated
    dense = _engine(served).generate(prompts, max_new_tokens=NEW)
    assert got == dense
    if len(set(map(tuple, prompts))) == 1:       # three identical prompts
        assert eng.pool.shared_maps >= 2 and eng.pool.cow_copies >= 2


def test_small_pool_backpressure_preserves_outputs(served):
    ref = _engine(served).generate(VAR_PROMPTS, max_new_tokens=NEW)
    out, tiny, jtiny = _both(served, lambda e, _: e.generate(VAR_PROMPTS, max_new_tokens=NEW),
                             paged=True, pool_blocks=3)
    assert out == ref
    _same_counters(tiny, jtiny)
    assert tiny.pool.peak_allocated <= 3


def test_zero_max_new_tokens_keeps_reservations_sane(served):
    def drive(eng, req):
        return eng.run([req(uid=0, prompt=[3] * 17, max_new_tokens=0),
                        req(uid=1, prompt=[4] * 5, max_new_tokens=4)])

    out, eng, jeng = _both(served, drive, paged=True, pool_blocks=8)
    assert len(out[0]) == 1 and len(out[1]) == 4  # the loop decodes once
    _same_counters(eng, jeng)
    assert eng.pool.available == jeng.pool.available == 8


def test_oversized_request_raises_and_paged_needs_state_bits(served):
    for eng, req in ((_engine(served, paged=True, pool_blocks=1), Request),
                     (_jengine(served, paged=True, pool_blocks=1), JRequest)):
        with pytest.raises(RuntimeError, match="whole pool"):
            eng.run([req(uid=0, prompt=[7] * 40, max_new_tokens=2)])
    _, tcfg, _, tserve, _ = served
    with pytest.raises(ValueError, match="paged KV cache requires"):
        ServeEngine(tcfg, tserve, max_slots=2, max_seq=SEQ, paged=True, device="cpu")


def test_freed_blocks_never_leak(served):
    def drive(eng, _):
        eng.generate([[(7 * i + 3) % 500 for i in range(30)] for _ in range(3)],
                     max_new_tokens=8)                 # fill and free a previous tenant
        assert eng.pool.allocated == 0
        return eng.generate(VAR_PROMPTS, max_new_tokens=NEW)

    out, eng, jeng = _both(served, drive, paged=True, pool_blocks=12)
    _same_counters(eng, jeng)
    fresh = _engine(served, paged=True, pool_blocks=12)
    assert out == fresh.generate(VAR_PROMPTS, max_new_tokens=NEW)


def test_shared_prefix_allocates_fewer_blocks(served):
    prompts = [[3] * 33, [3] * 33]  # two full shared blocks + tail

    def drive(eng, _):
        return eng.generate(prompts, 4)

    out, shared, jshared = _both(served, drive, paged=True, pool_blocks=16)
    out_u, unshared, junshared = _both(served, drive, paged=True, pool_blocks=16,
                                       share_prefix=False)
    assert out == out_u
    _same_counters(shared, jshared)
    _same_counters(unshared, junshared)
    assert shared.pool.peak_allocated < unshared.pool.peak_allocated
    assert unshared.pool.shared_maps == 0 and shared.pool.cow_copies >= 1
    assert shared.allocated_state_bytes() < unshared.allocated_state_bytes()
    assert shared.allocated_state_bytes() == jshared.allocated_state_bytes()


def test_cross_batch_prefix_sharing(served):
    prompts = [[11] * 20, [11] * 20]  # one slot: admissions are sequential

    def drive(eng, _):
        return eng.generate(prompts, 4)

    out, eng, jeng = _both(served, drive, max_slots=1, paged=True, pool_blocks=12)
    out_u, ref, jref = _both(served, drive, max_slots=1, paged=True, pool_blocks=12,
                             share_prefix=False)
    assert out == out_u
    _same_counters(eng, jeng)
    _same_counters(ref, jref)


def _random_requests(req, seed, lo=17, repeats=(1,), new_hi=7):
    """Prefixes of one random prompt (shared prefixes), each request at
    ``repeats`` a copy of the one before it (it splits its write block on
    the first append), and three unrelated prompts."""
    rng = np.random.default_rng(seed)
    base = [int(x) for x in rng.integers(1, 500, 40)]
    prompts = [base[:int(n)] for n in rng.integers(lo, 40, 4)]
    for i in repeats:
        prompts.insert(i, prompts[i - 1])
    prompts += [[int(x) for x in rng.integers(1, 500, int(n))] for n in rng.integers(2, 36, 3)]
    return [req(uid=i, prompt=p, max_new_tokens=int(rng.integers(1, new_hi)))
            for i, p in enumerate(prompts)]


def test_random_workload_under_the_invariant_checker(served):
    """Random prompts with repeats (shared prefixes and copy-on-write splits),
    a pool far below slots x max_seq, and every accounting invariant checked
    after every step; the pool drains clean, and streams and pool counters
    equal the JAX engine's."""
    out, eng, jeng = _both(served, lambda e, req: e.run(_random_requests(req, 0xC0FFEE)),
                           paged=True, pool_blocks=9)
    reqs = _random_requests(Request, 0xC0FFEE)
    assert {u: len(t) for u, t in out.items()} == {r.uid: r.max_new_tokens for r in reqs}
    _same_counters(eng, jeng)
    assert eng.pool.shared_maps > 0 and eng.pool.cow_copies > 0
    eng.check_invariants()
    dense = _engine(served).run(reqs)
    assert out == dense


#: (seed, pool_blocks) -> the JAX engine's and the port's (shared_maps,
#: cow_copies) where they differ: the JAX ledger keeps a split's reservation
#: after the donor pays for it, so its ``pool.available`` runs lower (to -1)
#: and a waiting request is admitted on a later turn, beside other residents
#: (ROADMAP queue 3).  Streams and peak_allocated agree all the same.
LEDGER_DIVERGES = {(1, 5): ((3, 2), (2, 1)), (3, 5): ((3, 1), (5, 1))}


@pytest.mark.parametrize("seed,pool_blocks", [(0, 5), (1, 5), (3, 5)])
def test_backpressure_workloads_match_jax(served, seed, pool_blocks):
    """Two repeated requests and eleven new tokens at most, on a pool small
    enough that admissions wait: streams and the peak equal the JAX
    engine's, the sharing counters too except where the ledger fix moves
    an admission."""
    out, eng, jeng = _both(
        served, lambda e, req: e.run(_random_requests(req, seed, lo=9, repeats=(1, 3),
                                                      new_hi=12)),
        paged=True, pool_blocks=pool_blocks)
    assert eng.pool.peak_allocated == jeng.pool.peak_allocated <= pool_blocks
    assert eng.pool.allocated == eng.pool.reserved == 0
    sharing = (eng.pool.shared_maps, eng.pool.cow_copies)
    jsharing = (jeng.pool.shared_maps, jeng.pool.cow_copies)
    assert (jsharing, sharing) == LEDGER_DIVERGES.get((seed, pool_blocks), (sharing, sharing))
    assert eng.pool.cow_copies > 0


def test_invariant_checker_catches_a_leak(served):
    eng = _engine(served, paged=True, pool_blocks=6)
    eng.check_invariants()
    eng.pool.reserve(1)                  # a reservation no slot's ledger holds
    with pytest.raises(AssertionError, match="per-slot ledgers"):
        eng.check_invariants()
    eng.pool.unreserve(1)
    eng.pool.alloc()                     # a block no table maps
    with pytest.raises(AssertionError, match="leak or double free"):
        eng.check_invariants()
