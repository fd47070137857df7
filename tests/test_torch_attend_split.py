"""The quantized-KV attention body split over S, on the CPU.

``csrc/quant_kv.cuh`` ``attend`` cuts S into chunks of ``CHUNK`` positions,
gives each a fresh online softmax over 32-position tiles and folds the
chunks' partials one at a time in chunk order, on the CTAs of a cluster or
walked by one CTA (``kernels/quant_kv/kernel.py`` ``attend_plan``).  The
card runs it; these tests hold what the CPU can check: that
``ref.attend_mirror`` (the kernel's arithmetic in its order) agrees with the
JAX package's ``quant_kv_attention`` (impl "xla" and "interpret") and with
the port's plain version on the same seeded numpy inputs, that its bits do
not move when S is padded with masked positions, when the other slots change
or when the cache is paged, and that every plan covers each position once,
cuts S only at chunk edges and folds in an order that depends on the chunk
count alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_kv import ops as jkv_ops
from repro.kvcache import cache as jcache
from repro_torch import kernels
from repro_torch.kernels.quant_kv import kernel as kvk
from repro_torch.kernels.quant_kv.ref import attend_mirror, quant_kv_attention_ref
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import paged as tpaged

torch.set_num_threads(2)

B, H, G, HD, BLOCK = 3, 2, 2, 32, 16
KV_BITS = ((8, 8), (8, 4), (4, 4), (4, 2))
#: one chunk (S < CHUNK, a ragged last tile), two chunks, and five
SEQS = (48, 128, 320)


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _valid(s: int) -> np.ndarray:
    """Slot 0 attends to a prefix that ends inside a chunk, slot 1 to a window
    past the first chunk (for S > 64: an empty chunk before valid ones), slot
    2 to nothing."""
    ar = np.arange(s)
    return np.stack([ar < s - 5, (ar >= min(70, s // 2)) & (ar < s - 9),
                     np.zeros(s, bool)])


def _inputs(s: int, seed: int, rows: int | None = None):
    rng = np.random.default_rng(seed)
    rows = s if rows is None else rows
    k = rng.normal(size=(B, rows, H, HD)).astype(np.float32)
    v = rng.normal(size=(B, rows, H, HD)).astype(np.float32)
    q = rng.normal(size=(B, H * G, HD)).astype(np.float32)
    return k, v, q


def _torch_layer(k, v, s: int, k_bits: int, v_bits: int, lens=None, b: int = B):
    layer = tcache.init_kv_layer(b, s, H, HD, k_bits=k_bits, v_bits=v_bits, block=BLOCK,
                                 device="cpu")
    lens = torch.full((b,), k.shape[1]) if lens is None else torch.as_tensor(lens)
    return tcache.insert_rows(layer, torch.arange(b), torch.from_numpy(k),
                              torch.from_numpy(v), valid_len=lens)


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("k_bits,v_bits", KV_BITS)
def test_mirror_matches_jax_and_the_plain_version(k_bits, v_bits, s):
    k, v, q = _inputs(s, seed=k_bits * 10 + v_bits + s)
    valid = _valid(s)
    jl = jcache.insert_rows(jcache.init_kv_layer(B, s, H, HD, k_bits=k_bits, v_bits=v_bits,
                                                 block=BLOCK),
                            jnp.arange(B), jnp.asarray(k), jnp.asarray(v))
    tl = _torch_layer(k, v, s, k_bits, v_bits)
    kernels.reset_counts()
    out = attend_mirror(torch.from_numpy(q), tl, torch.from_numpy(valid))
    assert out.shape == (B, H * G, HD) and out.dtype == torch.float32
    assert sum(kernels.PLAIN_CALLS.values()) == 0          # the mirror is uncounted
    plain = quant_kv_attention_ref(torch.from_numpy(q), tl, torch.from_numpy(valid),
                                   out_dtype=torch.float32)
    assert _rel(out.numpy(), plain.numpy()) <= 1e-5
    for impl in ("xla", "interpret"):
        ref = jkv_ops.quant_kv_attention(jnp.asarray(q), jl, jnp.asarray(valid), impl=impl,
                                         out_dtype=jnp.float32)
        assert _rel(out.numpy(), ref) <= 1e-5, impl
    # the slot with no valid position: a uniform softmax over all S, as the reference's
    assert _rel(out[2].numpy(), plain[2].numpy()) <= 1e-5
    assert float(out[2].abs().max()) > 0


@pytest.mark.parametrize("s", (48, 64, 112, 128))
@pytest.mark.parametrize("k_bits,v_bits", ((8, 4), (4, 2)))
def test_mirror_bits_ignore_masked_padding_and_the_other_slots(k_bits, v_bits, s):
    """Positions past ``s`` masked in a cache of 1024 (16 chunks) and one of
    2048 (32, folded over two rounds of 16): the same bits.  Slot 0 alone in
    a batch of one, and beside other slots whose cache and queries change:
    the same bits."""
    k, v, q = _inputs(s, seed=s + k_bits)
    lens = np.array([s, s - 3, 7])
    valid = np.arange(s)[None, :] < lens[:, None]
    base = attend_mirror(torch.from_numpy(q), _torch_layer(k, v, s, k_bits, v_bits, lens),
                         torch.from_numpy(valid))
    for big in (1024, 2048):
        pad = np.zeros((B, big), bool)
        pad[:, :s] = valid
        out = attend_mirror(torch.from_numpy(q),
                            _torch_layer(k, v, big, k_bits, v_bits, lens),
                            torch.from_numpy(pad))
        assert torch.equal(out, base), big
    alone = attend_mirror(torch.from_numpy(q[:1]),
                          _torch_layer(k[:1], v[:1], s, k_bits, v_bits, lens[:1], b=1),
                          torch.from_numpy(valid[:1]))
    assert torch.equal(alone[0], base[0])
    k2, v2, q2 = _inputs(s, seed=s + k_bits + 1)
    k2[0], v2[0], q2[0] = k[0], v[0], q[0]
    others = attend_mirror(torch.from_numpy(q2), _torch_layer(k2, v2, s, k_bits, v_bits, lens),
                           torch.from_numpy(valid))
    assert torch.equal(others[0], base[0])


@pytest.mark.parametrize("k_bits,v_bits", KV_BITS)
def test_mirror_bits_are_the_same_paged_and_dense(k_bits, v_bits):
    """A paged layer over a shuffled table (slots 0 and 1 share two blocks,
    slot 2 maps a block it does not attend to, an unmapped block inside slot
    0's valid range) and the dense layer the same rows give: the same bits,
    and the kernels of both take the same plan."""
    s, nb = 192, 192 // BLOCK
    rng = np.random.default_rng(k_bits * 10 + v_bits)
    k, v, q = _inputs(s, seed=k_bits + v_bits, rows=160)
    k[1, :32], v[1, :32] = k[0, :32], v[0, :32]
    lens = np.array([160, 150, 20])
    table = np.full((B, nb), -1, np.int32)
    ids = iter((rng.permutation(40) + 1).tolist())
    table[0, :10] = [next(ids) for _ in range(10)]
    table[1, :2] = table[0, :2]
    table[1, 2:10] = [next(ids) for _ in range(8)]
    table[2, :2] = [next(ids) for _ in range(2)]
    rows = table.copy()
    rows[1, :2] = -1                            # shared: written once, by slot 0
    layer = tpaged.init_paged_layer(40, B, s, H, HD, k_bits=k_bits, v_bits=v_bits,
                                    block=BLOCK, device="cpu")
    tpaged.with_table(layer, table)
    tpaged.insert_prefill_rows(layer, rows[:, :10], torch.from_numpy(k), torch.from_numpy(v),
                               valid_len=torch.from_numpy(lens))
    layer.block_table[0, 5] = -1                # unmapped, yet valid: zero levels
    dense = tcache.insert_rows(
        tcache.init_kv_layer(B, s, H, HD, k_bits=k_bits, v_bits=v_bits, block=BLOCK,
                             device="cpu"),
        torch.arange(B), torch.from_numpy(k), torch.from_numpy(v),
        valid_len=torch.from_numpy(lens))
    for f in ("k_packed", "v_packed"):          # block 5 of slot 0 reads as never written
        getattr(dense, f)[0, :, 80:96] = 0
    for f in ("k_scale", "v_scale"):
        getattr(dense, f)[0, :, 5] = 1e-12
    valid = np.arange(s)[None, :] < np.array([150, 140, 8])[:, None]
    qt, vt = torch.from_numpy(q), torch.from_numpy(valid)
    out_p = attend_mirror(qt, layer, vt)
    out_d = attend_mirror(qt, dense, vt)
    assert torch.equal(out_p, out_d)
    assert torch.equal(out_p, attend_mirror(qt, tpaged.to_dense(layer), vt))
    for fused in (False, True):
        paged_k = "quant_kv_decode_step_paged" if fused else "quant_kv_attention_paged"
        dense_k = "quant_kv_decode_step" if fused else "quant_kv_attention"
        assert kvk.attend_plan(paged_k, s, BLOCK) == kvk.attend_plan(dense_k, s, BLOCK)


ROWS = {3: "quant_kv_decode_step", 4: "quant_kv_attention", 6: "quant_kv_attention_paged",
        7: "quant_kv_decode_step_paged", 8: "quant_kv_decode_step_proj"}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_every_plan_covers_each_position_once_and_folds_in_chunk_order(row):
    kernel = ROWS[row]
    for s in range(16, 2049, 16):
        p = kvk.attend_plan(kernel, s, BLOCK)
        assert p.s == s and p.chunk == kvk.CHUNK == 64
        assert p.chunk % kvk.TILE == 0 and p.chunk % BLOCK == 0
        assert p.chunks == -(-s // p.chunk)
        assert 1 <= p.cluster <= min(p.chunks, kvk.MAX_CLUSTER)
        assert p.mode == ("walk" if p.cluster == 1 else "cluster")
        assert p.cluster == min(p.chunks, kvk.MAX_CLUSTER)
        if row == 8:      # row 3's rule, at every block, also where a block spans chunks
            for block in (8, 16, 32, 48, 64, 128):
                assert kvk.attend_plan(kernel, s, block) == kvk.attend_plan(ROWS[3], s, block)
        # the ranks' chunks partition the chunks; the chunks partition [0, S)
        taken = sorted(c for r in range(p.cluster) for c in p.rank_chunks(r))
        assert taken == list(range(p.chunks))
        cover = np.zeros(s, np.int64)
        for c in range(p.chunks):
            c0, c1 = p.chunk_range(c)
            assert c0 % p.chunk == 0 and c0 < c1 <= s
            cover[c0:c1] += 1
        assert (cover == 1).all()
        # the fold: chunk order, a function of S / C alone, the same walked
        order = p.fold_order()
        assert order == list(range(p.chunks))
        assert kvk.walk_plan(p).fold_order() == order
        for b in range(1, 9):
            assert kvk.attend_plan(kernel, s, BLOCK) == p      # B does not enter
            cs, n_kv, gb = p.grid(b, 1)
            assert (cs, n_kv, gb) == (p.cluster, 1, b)


def test_a_fused_step_walks_where_a_block_spans_chunks():
    """Only one CTA may requantize the touched block, so a fused step whose
    blocks do not each lie inside one chunk walks; attention alone need not,
    and a plan given for another shape is refused."""
    for kernel in kvk.FUSED:
        assert kvk.attend_plan(kernel, 1024, 48).mode == "walk"
        assert kvk.attend_plan(kernel, 1024, 128).mode == "walk"
        assert kvk.attend_plan(kernel, 1024, 32).cluster == 16
    assert kvk.attend_plan("quant_kv_attention", 1024, 128).cluster == 16
    with pytest.raises(ValueError, match="does not run"):
        kvk.attend_plan("quant_kv_append", 1024, 16)
    p = kvk.attend_plan("quant_kv_attention", 1024, 16)
    assert kvk._split("quant_kv_attention", 1024, 16, None) == 16
    assert kvk._split("quant_kv_attention", 1024, 16, kvk.walk_plan(p)) == 1
    with pytest.raises(ValueError, match="plan for S=1024"):
        kvk._split("quant_kv_attention", 512, 16, p)
    with pytest.raises(ValueError, match="plan for"):
        kvk._split("quant_kv_decode_step", 1024, 48, p)
