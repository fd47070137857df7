"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit; without a card they skip.
Run them on one with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  They cover the edges that ``chip_smoke.py``'s
full-width shapes do not reach: ragged N, K padded inside the last byte
(the GEMV's byte-wise path), M = 9 at the GEMV/GEMM switch, 2-bit lanes,
the tensor-core GEMM's two load paths, four token tiles and two split
modes (bit for bit alike), its sums against the CPU mirror of its
arithmetic, and its launches bit for bit repeatable and independent of M,
the dense and paged decode kernels at a reduced head width over a
shuffled block table with a shared block, an idle slot and an unmapped
entry inside a valid range, the dense append and attention alone with a
masked row, at reduced gemma-2b width in f32 the verify pass against
decode steps and the speculative engine against the non-speculative one,
the fake-quant forward and STE backward bit for bit at odd shapes, with
row-wise scales, a zero column and infinite upstream gradients, row 8
(the projection-fused step) bit for bit against the launches it replaces,
at chip_smoke.py's geometry and at an odd one, in its plan's cluster against
one CTA walking the same chunks (S 512 to 2048, B 1 to 8, two kv heads, a
block that spans chunks), and in a reduced f32 engine,
the GEMV against the CPU mirror of its arithmetic with its bits independent
of M and N, the burst append against the appends one position at a
time and the plain version, dense and paged, and the expert stacks of the
GEMV and the GEMM (one launch for all experts) against the 2-D launches bit
for bit, with a shared and a per-expert scale, and in reduced
deepseek-moe-16b's MoE layer, the GEMV's skip of experts whose x is zero
byte for byte against the 2-D launch (zero and -0.0 experts, trailing zero
rows, NaN rows, the routed capacity buffer, every tiles a CTA), and every
candidate of the decode-step autotuner (``kernels/autotune.py``) bit for
bit against the append then the attention kernels at S 128, 512 and 2048,
dense and paged.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kernels.quant_matmul import kernel as qk
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_mirror, quant_matmul_ref
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import paged as tpaged
from repro_torch.quant.tensor import quantize_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-12))


#: the GEMM's two load paths (TMA where rows are 16-byte aligned: K 2048 and
#: 16384; predicated loads at K 37 and 130), its token tiles (M 9, 32, 33,
#: 257, 2560: widths 32, 64, 128, 256), its split modes (a cluster at few
#: output tiles, a CTA walking the K ranges at many) and ragged N
GEMM_CASES = [(m, k, n) for m in (9, 32, 33, 257, 2560) for k in (37, 130, 2048, 16384)
              for n in (17, 192, 2048)]


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (3, 33, 17), (8, 130, 75), (9, 64, 40),
                                   (40, 37, 70), *GEMM_CASES])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_linear_kernels_match_plain(cuda, bits, m, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(bits * 100 + m + k)
    qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) * 0.1, bits)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    scale = qt.scale.reshape(1, -1)
    kernels.reset_counts()
    got = quant_matmul(x, qt.packed, scale, bits, k)
    ref = (quant_gemv_ref if m <= 8 else quant_matmul_ref)(x, qt.packed, scale, bits, k)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == dtype
    assert _rel(got, ref) <= (1e-5 if dtype is torch.float32 else 2e-2)
    assert kernels.LAUNCHES["quant_gemv" if m <= 8 else "quant_matmul"] == 1


def test_gemm_launches_are_bitwise_repeatable_and_row_independent(cuda):
    """The split-K shape (w_down at the verify pass's M = 32: a cluster of 8
    CTAs whose partials meet in a fixed order) gives the same bits on every
    launch, and its rows give them too inside M = 2560 (256-token tiles) and
    M = 9; at wo's shape the rows of M = 32 (a cluster of 4) equal those of
    M = 2560 (one CTA walking the 4 ranges): the sum order depends on N and K
    alone."""
    g = torch.Generator(device=cuda).manual_seed(16)
    kernels.reset_counts()
    for (k, n), mode in (((16384, 2048), "cluster"), ((2048, 2048), "fold")):
        qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) / k ** 0.5, 4)
        x = torch.randn((2560, k), generator=g, device=cuda).to(torch.bfloat16)
        a = quant_matmul(x[:32], qt.packed, qt.scale, 4, k)
        b = quant_matmul(x[:32], qt.packed, qt.scale, 4, k)
        wide = quant_matmul(x, qt.packed, qt.scale, 4, k)
        narrow = quant_matmul(x[:9], qt.packed, qt.scale, 4, k)
        torch.cuda.synchronize()
        assert torch.equal(a, b), mode
        assert torch.equal(wide[:32], a) and torch.equal(narrow, a[:9]), mode
    assert kernels.LAUNCHES["quant_matmul"] == 8


#: the mirror's shapes: clusters of 8 and 4 (TMA), one CTA walking 4 K ranges
#: (f32 x at M 257, bf16 x at M 2560), one range on the predicated path
MIRROR_CASES = [(32, 16384, 2048), (33, 2048, 192), (257, 2048, 2048), (2560, 2048, 2048),
                (9, 130, 17), (32, 37, 75), (2560, 16384, 2048)]


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("m,k,n", MIRROR_CASES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_gemm_sums_as_its_mirror(cuda, bits, m, k, n, dtype):
    """The kernel against ``ref.quant_matmul_mirror`` at the plan's split,
    far inside the plain version's tolerance.  Not bit for bit: within a K
    step the tensor cores add in their own order.  f32 x within rel 1e-6
    (the plain version's gate is 1e-5; a range summed wholly on the tensor
    cores drifts further); bf16 y at most one bf16 step from the mirror
    (plus 4e-6 of the largest output, where a sum cancels), and at most
    0.1 % of the outputs apart at all."""
    g = torch.Generator(device=cuda).manual_seed(bits * 7 + m + k + n)
    qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) / k ** 0.5, bits)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    got = quant_matmul(x, qt.packed, qt.scale, bits, k)
    mirror = quant_matmul_mirror(x, qt.packed, qt.scale, bits, k,
                                 splits=qk.plan(m, n, k, dtype).splits)
    torch.cuda.synchronize()
    assert got.dtype == mirror.dtype == dtype
    if dtype is torch.float32:
        assert _rel(got, mirror) <= 1e-6
    else:
        got, mirror = got.float(), mirror.float()
        diff = (got - mirror).abs()
        step = torch.exp2(torch.floor(torch.log2(mirror.abs().clamp_min(1e-30))) - 7)
        assert (diff <= step + 4e-6 * mirror.abs().max()).all()
        assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_gemm_split_modes_give_the_same_bits(cuda, dtype):
    """wo's shape at M 2560: the plan has each CTA walk the 4 K ranges; a
    cluster of 4 CTAs summing one range each gives the same bits.  A plan
    made for another shape is refused."""
    k, n, m = 2048, 2048, 2560
    g = torch.Generator(device=cuda).manual_seed(17)
    qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) / k ** 0.5, 4)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    p = qk.plan(m, n, k, dtype)
    assert p.cluster == 1 and p.splits == 4
    q = dataclasses.replace(p, nt=qk.TOKEN_TILES[dtype][-1], cluster=p.splits)
    kernels.reset_counts()
    one = qk.quant_matmul_cuda(x, qt.packed, qt.scale, bits=4, k=k, launch=p)
    many = qk.quant_matmul_cuda(x, qt.packed, qt.scale, bits=4, k=k, launch=q)
    torch.cuda.synchronize()
    assert torch.equal(one, many)
    assert kernels.LAUNCHES["quant_matmul"] == 2
    with pytest.raises(ValueError, match="plan for"):
        qk.quant_matmul_cuda(x[:32], qt.packed, qt.scale, bits=4, k=k, launch=p)


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (8, 4), (4, 2), (2, 2), (6, 4)])
def test_decode_step_kernel_matches_plain_bytes_exactly(cuda, k_bits, v_bits):
    b, s, h, hq, hd, block = 3, 64, 2, 4, 32, 8
    rng = np.random.default_rng(k_bits * 10 + v_bits)
    lens = torch.tensor([7, 8, 40], device=cuda)
    k = torch.from_numpy(rng.normal(size=(b, 40, h, hd)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(b, 40, h, hd)).astype(np.float32)).to(cuda)
    base = tcache.init_kv_layer(b, s, h, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                device=cuda)
    base = tcache.insert_rows(base, torch.arange(b, device=cuda), k, v, valid_len=lens)
    layers = [dataclasses.replace(base, **{f: getattr(base, f).clone() for f in
                                           ("k_packed", "k_scale", "v_packed", "v_scale")})
              for _ in range(2)]
    for step in range(3):
        pos = (lens + step).to(torch.int32)
        valid = torch.arange(s, device=cuda)[None, :] <= pos[:, None]
        q = torch.from_numpy(rng.normal(size=(b, hq, hd)).astype(np.float32)).to(cuda)
        kn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
        vn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
        o_k, _ = kv_ops.quant_kv_decode_step(q, layers[0], pos, kn, vn, valid)
        o_p, _ = kv_ops.quant_kv_decode_step(q, layers[1], pos, kn, vn, valid, impl="torch")
        torch.cuda.synchronize()
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(layers[0], f), getattr(layers[1], f)), (step, f)
        assert _rel(o_k, o_p) <= 1e-5


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (8, 4), (4, 2), (2, 2), (6, 4)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dense_append_and_attention_kernels_match_plain(cuda, k_bits, v_bits, dtype):
    """Rows 5 and 4 alone: cache bytes exact against the plain versions with a
    masked row (pos -1) left untouched, outputs within rel 1e-5, and the fused
    step equal to the append followed by the attention bit for bit."""
    b, s, h, hq, hd, block = 3, 64, 2, 4, 32, 8
    rng = np.random.default_rng(k_bits * 10 + v_bits + 7)
    lens = torch.tensor([7, 8, 40], device=cuda)
    k = torch.from_numpy(rng.normal(size=(b, 40, h, hd)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(b, 40, h, hd)).astype(np.float32)).to(cuda)
    base = tcache.init_kv_layer(b, s, h, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                device=cuda)
    base = tcache.insert_rows(base, torch.arange(b, device=cuda), k, v, valid_len=lens)
    pos = lens.to(torch.int32)
    masked = pos.clone()
    masked[1] = -1
    valid = torch.arange(s, device=cuda)[None, :] <= pos[:, None]
    q, kn, vn = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda).to(dtype)
                 for shape in ((b, hq, hd), (b, 1, h, hd), (b, 1, h, hd)))
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    kernels.reset_counts()
    la, lp = _copy(base), _copy(base)
    kv_ops.quant_kv_append(la, masked, kn, vn)
    kv_ops.quant_kv_append(lp, masked, kn, vn, impl="torch")
    o_a = kv_ops.quant_kv_attention(q, la, valid, out_dtype=torch.float32)
    o_p = kv_ops.quant_kv_attention(q, la, valid, impl="torch", out_dtype=torch.float32)
    torch.cuda.synchronize()
    for f in fields:
        assert torch.equal(getattr(la, f), getattr(lp, f)), f
        assert torch.equal(getattr(la, f)[1], getattr(base, f)[1]), f     # the masked row
    assert _rel(o_a, o_p) <= 1e-5
    lf, ls = _copy(base), _copy(base)
    o_f, _ = kv_ops.quant_kv_decode_step(q, lf, pos, kn, vn, valid, out_dtype=torch.float32)
    kv_ops.quant_kv_append(ls, pos, kn, vn)
    o_s = kv_ops.quant_kv_attention(q, ls, valid, out_dtype=torch.float32)
    torch.cuda.synchronize()
    for f in fields:
        assert torch.equal(getattr(lf, f), getattr(ls, f)), f
    assert torch.equal(o_f, o_s)                  # fused = append then attend
    assert kernels.LAUNCHES["quant_kv_append"] == 2     # both sides in one launch
    assert kernels.LAUNCHES["quant_kv_attention"] == 2
    assert kernels.LAUNCHES["quant_kv_decode_step"] == 1


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    qt = quantize_tensor(torch.randn((64, 16), device=cuda), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant_matmul(torch.zeros((4, 64), dtype=torch.float16, device=cuda), qt.packed,
                     qt.scale, 4, 64)
    layer = tcache.init_kv_layer(1, 16, 1, 24, k_bits=8, v_bits=8, block=8, device=cuda)
    with pytest.raises(ValueError, match="hd % 16"):
        kv_ops.quant_kv_decode_step(torch.zeros((1, 2, 24), device=cuda), layer, 0,
                                    torch.zeros((1, 1, 1, 24), device=cuda),
                                    torch.zeros((1, 1, 1, 24), device=cuda),
                                    torch.ones((1, 16), dtype=torch.bool, device=cuda))


def _paged_case(cuda, k_bits, v_bits, seed):
    """B 4, S 64, hd 32, block 8 over 16 shuffled blocks: slots 0 and 1 share
    their first two blocks, slot 2 is idle, slot 3's block 0 is unmapped but
    valid.  Returns the layer and one step's inputs."""
    b, s, h, hq, hd, block = 4, 64, 2, 4, 32, 8
    rng = np.random.default_rng(seed)
    ids = iter((rng.permutation(16) + 1).tolist())
    table = np.full((b, s // block), -1, np.int32)
    table[0, :4] = [next(ids) for _ in range(4)]
    table[1, :2] = table[0, :2]
    table[1, 2:4] = [next(ids) for _ in range(2)]
    table[3, 1:3] = [next(ids) for _ in range(2)]
    rows = np.full((b, 3), -1, np.int32)
    rows[0], rows[1, 2], rows[3, 1] = table[0, :3], table[1, 2], table[3, 1]
    k = rng.normal(size=(b, 24, h, hd)).astype(np.float32)
    v = rng.normal(size=(b, 24, h, hd)).astype(np.float32)
    k[1, :16], v[1, :16] = k[0, :16], v[0, :16]
    layer = tpaged.init_paged_layer(16, b, s, h, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                    device=cuda)
    tpaged.with_table(layer, table)
    tpaged.insert_prefill_rows(layer, rows, torch.from_numpy(k).to(cuda),
                               torch.from_numpy(v).to(cuda),
                               valid_len=torch.tensor([20, 23, 0, 15], device=cuda))
    pos = torch.tensor([20, 23, 5, 15], dtype=torch.int32, device=cuda)
    valid = torch.arange(s, device=cuda)[None, :] <= pos[:, None]
    q = torch.from_numpy(rng.normal(size=(b, hq, hd)).astype(np.float32)).to(cuda)
    kn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
    vn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
    return layer, pos, valid, q, kn, vn


def _copy(layer):
    return dataclasses.replace(layer, **{f: getattr(layer, f).clone() for f in
                                         ("k_packed", "k_scale", "v_packed", "v_scale")})


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (8, 4), (4, 2), (2, 2), (6, 4)])
def test_paged_kernels_match_plain(cuda, k_bits, v_bits):
    base, pos, valid, q, kn, vn = _paged_case(cuda, k_bits, v_bits, seed=k_bits * 10 + v_bits)
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    kernels.reset_counts()
    lk, lp, ls = _copy(base), _copy(base), _copy(base)
    o_k, _ = kv_ops.quant_kv_decode_step(q, lk, pos, kn, vn, valid)
    o_p, _ = kv_ops.quant_kv_decode_step(q, lp, pos, kn, vn, valid, impl="torch")
    kv_ops.quant_kv_append(ls, pos, kn, vn)
    o_s = kv_ops.quant_kv_attention(q, ls, valid)
    o_a = kv_ops.quant_kv_attention(q, ls, valid, impl="torch")
    torch.cuda.synchronize()
    for f in fields:   # block 0 is the trash block, written by the plain version only
        assert torch.equal(getattr(lk, f)[1:], getattr(lp, f)[1:]), f
        assert torch.equal(getattr(lk, f), getattr(ls, f)), f
    assert _rel(o_k, o_p) <= 1e-5
    assert _rel(o_s, o_a) <= 1e-5
    assert torch.equal(o_k, o_s)                  # fused = append then attend
    assert kernels.LAUNCHES["quant_kv_decode_step_paged"] == 1
    assert kernels.LAUNCHES["quant_kv_append_paged"] == 1     # both sides in one launch
    assert kernels.LAUNCHES["quant_kv_attention_paged"] == 1
    # the fused step on the pool = the dense kernel on to_dense of the pool
    # (slot 2 is idle: its dense block is written, its paged one is not)
    lk2 = _copy(base)
    o_pg, _ = kv_ops.quant_kv_decode_step(q, lk2, pos, kn, vn, valid)
    o_d, dense = kv_ops.quant_kv_decode_step(q, tpaged.to_dense(base), pos, kn, vn, valid)
    torch.cuda.synchronize()
    live = [0, 1, 3]
    assert torch.equal(o_pg[live], o_d[live])
    now = tpaged.to_dense(lk2)
    for f in fields:
        assert torch.equal(getattr(now, f)[live], getattr(dense, f)[live]), f


def test_paged_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.quant_kv.kernel import quant_kv_attention_paged_cuda

    layer, pos, valid, q, kn, vn = _paged_case(cuda, 8, 4, seed=1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kv_ops.quant_kv_decode_step(q.half(), layer, pos, kn, vn, valid)
    with pytest.raises(TypeError, match="torch.int32"):
        quant_kv_attention_paged_cuda(
            layer.block_table.long(), q.reshape(4, 2, 2, 32), layer.k_packed, layer.k_scale,
            layer.v_packed, layer.v_scale, torch.where(valid, 0.0, -1e30).float(),
            k_bits=8, v_bits=4, hd=32, block=8)
    odd = tpaged.init_paged_layer(4, 1, 16, 1, 24, k_bits=8, v_bits=8, block=8, device=cuda)
    with pytest.raises(ValueError, match="hd % 16"):
        kv_ops.quant_kv_attention(torch.zeros((1, 2, 24), device=cuda), odd,
                                  torch.ones((1, 16), dtype=torch.bool, device=cuda))
    # the dense attention and append alone have kernels too, with the same limits
    dense = tcache.init_kv_layer(1, 16, 1, 24, k_bits=8, v_bits=8, block=8, device=cuda)
    with pytest.raises(ValueError, match="hd % 16"):
        kv_ops.quant_kv_attention(torch.zeros((1, 2, 24), device=cuda), dense,
                                  torch.ones((1, 16), dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="hd % 16"):
        kv_ops.quant_kv_append(dense, 0, torch.zeros((1, 1, 1, 24), device=cuda),
                               torch.zeros((1, 1, 1, 24), device=cuda))


def _reduced_model(cuda, seed: int):
    """Reduced gemma-2b in f32 on the card, packed under the "mixed" policy,
    with a K 8 / V 4 state policy for 3 slots of 64 positions."""
    from repro_torch import configs
    from repro_torch.core.policy import BitPolicy
    from repro_torch.kvcache import state_layer_infos
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply

    cfg = configs.get_config("gemma-2b").reduced()
    params = decoder.init(cfg, torch.Generator(device=cuda).manual_seed(seed), device=cuda)
    serve = qapply.quantize_for_serve(decoder.unstack_layers(params, cfg),
                                      dryrun_policy(qapply.layer_specs(params, cfg), "mixed"),
                                      cfg)
    infos = state_layer_infos(cfg, 3, 64)
    state = BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                        for l in infos})
    return cfg, serve, state


def test_decode_verify_matches_decode_steps_on_the_card(cuda):
    """The verify pass (its linears through the GEMM, M = 3 x 4) against four
    decode steps on copies of one cache, in f32: logits within rel 1e-4, as
    the GEMV and the GEMM are each held to their plain versions, and cache
    scales within rel 1e-5.  In f32 at this width a decode step projects
    q, k and v inside row 8 (the fused wqkv's GEMV sum, bit for bit) and
    runs the other linears through the GEMV (M = 3)."""
    from repro_torch.kvcache import insert_state_rows, resolve_state_bits
    from repro_torch.models import decoder
    from repro_torch.quant.apply import fuse_projections

    cfg, serve, state = _reduced_model(cuda, 11)
    params = fuse_projections(serve)
    g = torch.Generator(device=cuda).manual_seed(12)
    toks = torch.randint(1, cfg.vocab_size, (3, 20), generator=g, device=cuda)
    burst = torch.randint(1, cfg.vocab_size, (3, 4), generator=g, device=cuda)
    lens = torch.tensor([20, 9, 14], device=cuda)
    _, kv = decoder.prefill(params, cfg, toks, logits=False)
    bits = resolve_state_bits(state, cfg)
    caches = [insert_state_rows(decoder.init_cache(cfg, 3, 64, state_bits=bits, device=cuda),
                                torch.arange(3, device=cuda), kv, lens) for _ in range(2)]
    kernels.reset_counts()
    ver, _, _ = decoder.decode_verify(params, cfg, caches[0], burst, lens.to(torch.int32))
    assert kernels.LAUNCHES["quant_matmul"] == 4 * cfg.n_layers
    assert kernels.LAUNCHES["quant_kv_decode_step"] == 4 * cfg.n_layers
    for j in range(4):
        step, _ = decoder.decode_step(params, cfg, caches[1], burst[:, j:j + 1],
                                      (lens + j).to(torch.int32))
        torch.cuda.synchronize()
        assert _rel(step[:, 0], ver[:, j]) <= 1e-4, j
    for a, b in zip(*caches):
        for f in ("k_scale", "v_scale"):
            assert _rel(getattr(a, f), getattr(b, f)) <= 1e-5, f
    assert kernels.LAUNCHES["quant_kv_decode_step_proj"] == 4 * cfg.n_layers
    assert kernels.LAUNCHES["quant_gemv"] == 4 * 3 * cfg.n_layers
    assert kernels.LAUNCHES["quant_kv_decode_step"] == 4 * cfg.n_layers   # the verify's
    assert sum(kernels.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
def test_speculative_engine_matches_non_speculative_on_the_card(cuda, paged):
    """Greedy streams of the speculative engine (K = 3, a 4-bit draft) equal
    the non-speculative engine's at reduced width in f32, through the
    kernels only; the commit launches the dense or paged burst append once a
    layer."""
    from repro_torch.serve.engine import ServeEngine

    cfg, serve, state = _reduced_model(cuda, 13)
    prompts = [[9] * 19, [5, 6, 7, 8], [9] * 19, [1, 2, 9, 4, 7, 3], [2],
               list(range(1, 31))]
    kw = dict(max_slots=3, max_seq=64, state_bits=state)
    if paged:
        kw.update(paged=True, pool_blocks=12)
    base = ServeEngine(cfg, serve, **kw).generate(prompts, max_new_tokens=10)
    kernels.reset_counts()
    eng = ServeEngine(cfg, serve, speculate=3, draft_policy=4, debug_invariants=True, **kw)
    assert eng.generate(prompts, max_new_tokens=10) == base
    st = eng.stats()
    append = "quant_kv_append_paged" if paged else "quant_kv_append"
    assert st["launches"][append] == cfg.n_layers * st["spec_steps"] > 0   # one burst a layer
    assert sum(st["plain_calls"].values()) == 0
    assert st["spec_accepted"] > 0
    if paged:
        assert eng.pool.allocated == eng.pool.reserved == 0


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN positions compared as NaN (CUDA's and PyTorch's NaN
    payloads differ)."""
    a, b = a.contiguous(), b.contiguous()
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    view = torch.int16 if a.dtype is torch.bfloat16 else torch.int32
    return bool(torch.equal(na, nb) and torch.equal(a.view(view)[~na], b.view(view)[~nb]))


@pytest.mark.parametrize("bits", (2, 4, 6, 8, 32))
@pytest.mark.parametrize("k,n", [(37, 53), (5, 129), (64, 96), (3, 8)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_fake_quant_kernels_match_plain_bit_for_bit(cuda, bits, k, n, dtype):
    """Forward and STE backward, column- and row-wise scales (the head's
    route), odd shapes (the one-element path) and 16-byte rows (the vector
    path), a zero column, and +-inf in the upstream gradient."""
    from repro_torch.core.quantizer import weight_scale
    from repro_torch.kernels.fake_quant import ops as fq_ops
    from repro_torch.kernels.fake_quant.kernel import fake_quant_cuda, fake_quant_ste_bwd_cuda
    from repro_torch.kernels.fake_quant.ref import fake_quant_ref, fake_quant_ste_bwd_ref

    gen = torch.Generator(device=cuda).manual_seed(k * n + bits)
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.05).to(dtype)
    w[:, 1] = 0
    g = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    g[0, :] = float("inf")
    g[-1, :] = -float("inf")
    for rowwise in (False, True):
        scale = weight_scale(w, bits, channel_axis=0 if rowwise else -1)
        kernels.reset_counts()
        got = fake_quant_cuda(w, scale, bits, rowwise=rowwise)
        assert _bits_equal(got, fake_quant_ref(w, scale, bits))
        for s in (scale, scale * 0.5):          # half the scale: half the weights masked
            dw = fake_quant_ste_bwd_cuda(w, s, bits, g, rowwise=rowwise)
            assert _bits_equal(dw, fake_quant_ste_bwd_ref(w, s, bits, g))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fake_quant"] == 1 and kernels.LAUNCHES["fake_quant_ste_bwd"] == 2
    # the autograd route, as QAT runs it: plain layout and the tied head's
    for transposed in (False, True):
        outs, grads = [], []
        for impl in ("torch", "auto"):
            leaf = (w.T.contiguous() if transposed else w).detach().clone().requires_grad_()
            out = fq_ops.fake_quant_ste(leaf.T if transposed else leaf, bits, impl)
            out.backward(g)
            outs.append(out.detach())
            grads.append(leaf.grad)
        torch.cuda.synchronize()
        assert _bits_equal(*outs) and _bits_equal(*grads)


def test_fake_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.core.quantizer import weight_scale
    from repro_torch.kernels.fake_quant.kernel import fake_quant_cuda, fake_quant_ste_bwd_cuda

    w = torch.randn((8, 16), device=cuda)
    scale = weight_scale(w, 4)
    with pytest.raises(TypeError):
        fake_quant_cuda(w.half(), scale, 4)
    with pytest.raises(ValueError, match="scales"):
        fake_quant_cuda(w, scale, 4, rowwise=True)
    with pytest.raises(ValueError, match="2-D"):
        fake_quant_cuda(w[0], scale, 4)
    with pytest.raises(TypeError):
        fake_quant_ste_bwd_cuda(w, scale, 4, w.to(torch.bfloat16))


# -- row 8: the projection-fused decode step ------------------------------------

#: (d, n_kv, g, hd, S, block, positions): chip_smoke.py's phase-2 geometry
#: (gemma-2b's heads, d 512, a position at S), and an odd one whose packed
#: rows are not whole words at 4, 6 and 8 bits (the GEMV's byte-wise path)
PROJ_CASES = {"phase2": (512, 1, 8, 256, 512, 16, (15, 256, 511, 512)),
              "odd": (36, 2, 2, 32, 64, 8, (7, 8, 63))}


def _proj_case(cuda, name, w_bits, k_bits, v_bits):
    d, n_kv, g, hd, s, block, plist = PROJ_CASES[name]
    if name == "odd" and w_bits != 2:
        d = 34                     # 2-bit rows need d % 4 == 0
    b = len(plist)
    gen = torch.Generator(device=cuda).manual_seed(w_bits * 100 + k_bits * 10 + v_bits)
    wq = quantize_tensor(torch.randn((d, (n_kv * g + 2 * n_kv) * hd), generator=gen,
                                     device=cuda) / d ** 0.5, w_bits)
    layer = tcache.init_kv_layer(b, s, n_kv, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                 device=cuda)
    rows = torch.randn((b, s, n_kv, hd), generator=gen, device=cuda)
    pos = torch.tensor(plist, dtype=torch.int32, device=cuda)
    layer = tcache.insert_rows(layer, torch.arange(b, device=cuda), rows, rows.flip(1),
                               valid_len=pos.clamp(max=s))
    x = torch.randn((b, d), generator=gen, device=cuda)
    return wq, layer, pos, x


@pytest.mark.parametrize("name", sorted(PROJ_CASES))
@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (8, 4), (4, 2), (6, 6)])
@pytest.mark.parametrize("w_bits", (2, 4, 6, 8))
def test_proj_kernel_equals_composition_and_matches_plain(cuda, name, w_bits, k_bits, v_bits):
    """Row 8 against the launches it replaces (the GEMV, the torch rotary,
    the dense step): cache and output bit for bit; against its plain version:
    scales rel 1e-6, output rel 1e-5 at the slots that attend."""
    from repro_torch.models.layers import _qkv, decode_attend_one, rope_freqs

    wq, base, pos, x = _proj_case(cuda, name, w_bits, k_bits, v_bits)
    b, s, n_kv, hd = base.shape
    hq = (wq.shape[1] // hd) - 2 * n_kv
    valid = torch.arange(s, device=cuda)[None, :] <= pos[:, None]
    ang = pos[:, None].float() * rope_freqs(hd, 10_000.0, device=cuda)
    lk, lc, lp = _copy(base), _copy(base), _copy(base)
    kernels.reset_counts()
    o_k, _ = kv_ops.quant_kv_decode_step_proj(x, wq.packed, wq.scale, torch.cos(ang),
                                              torch.sin(ang), lk, pos, valid, w_bits=w_bits,
                                              n_heads=hq)
    assert kernels.LAUNCHES["quant_kv_decode_step_proj"] == 1
    cfg = type("Cfg", (), dict(n_heads=hq, n_kv_heads=n_kv, resolved_head_dim=hd,
                               rope="default", rope_theta=10_000.0, qk_norm=False))
    q, kn, vn = _qkv({"wqkv": wq}, x[:, None], cfg, pos[:, None])
    o_c, _ = decode_attend_one(lc, q, kn, vn, pos, cfg)
    o_p, _ = kv_ops.quant_kv_decode_step_proj(x, wq.packed, wq.scale, torch.cos(ang),
                                              torch.sin(ang), lp, pos, valid, w_bits=w_bits,
                                              n_heads=hq, impl="torch")
    torch.cuda.synchronize()
    for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
        assert torch.equal(getattr(lk, f), getattr(lc, f)), f
    assert torch.equal(o_k, o_c[:, 0])
    attends = pos < s
    for f in ("k_scale", "v_scale"):
        assert _rel(getattr(lk, f), getattr(lp, f)) <= 1e-6, f
    assert _rel(o_k[attends], o_p[attends]) <= 1e-5
    assert torch.equal(o_k[~attends], torch.zeros_like(o_k[~attends]))


def test_proj_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    wq, layer, pos, x = _proj_case(cuda, "odd", 8, 8, 8)
    hd = layer.head_dim
    ang = torch.zeros((len(pos), hd // 2), device=cuda)
    valid = torch.ones((len(pos), layer.seq), dtype=torch.bool, device=cuda)
    args = (wq.packed, wq.scale, ang.cos(), ang.sin())
    with pytest.raises(TypeError, match="float32 x"):
        kv_ops.quant_kv_decode_step_proj(x.bfloat16(), *args, layer, pos, valid, w_bits=8,
                                         n_heads=4)
    nine = tcache.init_kv_layer(9, layer.seq, 2, hd, k_bits=8, v_bits=8, block=8, device=cuda)
    ang9 = torch.zeros((9, hd // 2), device=cuda)
    with pytest.raises(ValueError, match="B <= 8"):
        kv_ops.quant_kv_decode_step_proj(torch.zeros((9, x.shape[1]), device=cuda), wq.packed,
                                         wq.scale, ang9.cos(), ang9.sin(), nine,
                                         torch.zeros(9, dtype=torch.int32, device=cuda),
                                         torch.ones((9, layer.seq), dtype=torch.bool,
                                                    device=cuda), w_bits=8, n_heads=4)
    pl = tpaged.init_paged_layer(8, len(pos), layer.seq, 2, hd, k_bits=8, v_bits=8, block=8,
                                 device=cuda)
    with pytest.raises(TypeError, match="PagedKVLayer"):
        kv_ops.quant_kv_decode_step_proj(x, *args, pl, pos, valid, w_bits=8, n_heads=4)


def test_f32_engine_takes_row8_and_matches_the_unfused_engine(cuda):
    """Reduced gemma-2b in f32 under the mixed policy (wqkv fused in every
    layer): the engine launches row 8 once per layer and decode step and no
    dense step, and its streams and final cache bytes equal the same engine's
    with fuse_projections=False (the unfused GEMV -> rotary -> step path)."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.models import decoder
    from repro_torch.quant import apply as qapply
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = configs.get_config("gemma-2b").reduced()
    params = decoder.init(cfg, torch.Generator(device=cuda).manual_seed(3), device=cuda)
    sp = qapply.quantize_for_serve(decoder.unstack_layers(params, cfg),
                                   dryrun_policy(qapply.layer_specs(params, cfg), "mixed"), cfg)
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                    max_new_tokens=8) for i, n in enumerate((3, 19, 8, 30, 12))]
    outs, states = [], []
    for fuse in (True, False):
        eng = ServeEngine(cfg, sp, max_slots=3, max_seq=64, state_bits=8,
                          fuse_projections=fuse)
        kernels.reset_counts()
        outs.append(eng.run(reqs))
        st = eng.stats()
        steps = st["decode_steps"]
        if fuse:
            assert st["launches"]["quant_kv_decode_step_proj"] == cfg.n_layers * steps
            assert st["launches"]["quant_kv_decode_step"] == 0
        else:
            assert st["launches"]["quant_kv_decode_step_proj"] == 0
            assert st["launches"]["quant_kv_decode_step"] == cfg.n_layers * steps
        assert not any(st["plain_calls"].values())
        states.append(eng.state)
    assert outs[0] == outs[1]
    for a, b in zip(*states):
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


#: row 8 split over S: (d, n_kv, g, hd): gemma-2b's heads at d 512 (160
#: tiles a kv head: 20 a rank at a cluster of 8, 10 at 16), and two kv heads of
#: two queries at hd 32 (8 tiles a head: at a cluster of 16 half the ranks
#: project nothing)
PROJ_SPLIT_GEOMS = {"gemma": (512, 1, 8, 256), "two_heads": (64, 2, 2, 32)}
#: (w_bits, k_bits, v_bits), taken in turn by the position sets of a case
PROJ_SPLIT_BITS = [(4, 8, 4), (8, 4, 2), (2, 8, 8), (6, 6, 6)]


def _proj_positions(s: int, b: int) -> list[tuple[int, ...]]:
    """Write positions of b slots, in sets that together visit 0, block (16)
    and chunk (64) edges, the middle, S - 1 and S (outside: writes nothing)."""
    cands = [0, 15, 16, 63, 64, 127, 128, s // 2 + 3, s - 1, s]
    return [tuple(cands[(i + j) % len(cands)] for j in range(b))
            for i in range(0, len(cands), b)]


def _proj_three_ways(cuda, geom, s, block, plist, w_bits, k_bits, v_bits, seed):
    """Row 8 with its plan, row 8 walked by one CTA, and the composition it
    replaces (the GEMV, the torch rotary, row 3), each on its own copy of one
    cache.  Returns the plan, the outputs (B, hq, hd) and the caches."""
    from repro_torch.kernels.quant_kv import kernel as kvk
    from repro_torch.models.layers import _qkv, decode_attend_one, rope_freqs

    d, n_kv, g, hd = PROJ_SPLIT_GEOMS[geom]
    b, hq = len(plist), n_kv * g
    gen = torch.Generator(device=cuda).manual_seed(seed)
    wq = quantize_tensor(torch.randn((d, (hq + 2 * n_kv) * hd), generator=gen, device=cuda)
                         / d ** 0.5, w_bits)
    base = tcache.init_kv_layer(b, s, n_kv, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                device=cuda)
    rows = torch.randn((2, b, s, n_kv, hd), generator=gen, device=cuda)
    pos = torch.tensor(plist, dtype=torch.int32, device=cuda)
    base = tcache.insert_rows(base, torch.arange(b, device=cuda), rows[0], rows[1],
                              valid_len=pos.clamp(max=s))
    x = torch.randn((b, d), generator=gen, device=cuda)
    mask = torch.where(torch.arange(s, device=cuda)[None, :] <= pos[:, None], 0.0, -1e30).float()
    ang = pos[:, None].float() * rope_freqs(hd, 10_000.0, device=cuda)
    p = kvk.attend_plan("quant_kv_decode_step_proj", s, block)
    outs, lays = {}, {}
    for mode, lp in (("plan", p), ("walk", kvk.walk_plan(p))):
        lay = lays[mode] = _copy(base)
        outs[mode] = kvk.quant_kv_decode_step_proj_cuda(
            pos, x, wq.packed, wq.scale.reshape(1, -1), torch.cos(ang), torch.sin(ang),
            lay.k_packed, lay.k_scale, lay.v_packed, lay.v_scale, mask, w_bits=w_bits,
            k_bits=k_bits, v_bits=v_bits, n_heads=hq, hd=hd, block=block,
            launch=lp).reshape(b, hq, hd)
    cfg = type("Cfg", (), dict(n_heads=hq, n_kv_heads=n_kv, resolved_head_dim=hd,
                               rope="default", rope_theta=10_000.0, qk_norm=False))
    lay = lays["composition"] = _copy(base)
    q, kn, vn = _qkv({"wqkv": wq}, x[:, None], cfg, pos[:, None])
    outs["composition"] = decode_attend_one(lay, q, kn, vn, pos, cfg)[0][:, 0]
    torch.cuda.synchronize()
    return p, outs, lays


def _assert_three_ways_equal(outs, lays, what):
    for mode in ("walk", "composition"):
        assert torch.equal(outs["plan"], outs[mode]), (mode, what)
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(lays["plan"], f), getattr(lays[mode], f)), (mode, f, what)


@pytest.mark.parametrize("b", (1, 4, 8))
@pytest.mark.parametrize("s", (512, 1024, 2048))
@pytest.mark.parametrize("geom", sorted(PROJ_SPLIT_GEOMS))
def test_proj_cluster_walk_and_composition_give_the_same_bits(cuda, geom, s, b):
    """Row 8 in its plan's cluster (8 CTAs at S 512, 16 at 1024 and at 2048,
    whose 32 chunks fold in two rounds), walked by one CTA, and the
    composition it replaces: outputs, cache bytes and scales bit for bit, at
    positions on block and chunk edges, at 0, S - 1 and S (zeros out, nothing
    written), across weight and state widths."""
    from repro_torch.kernels.quant_kv import kernel as kvk

    for i, plist in enumerate(_proj_positions(s, b)):
        w_bits, k_bits, v_bits = PROJ_SPLIT_BITS[i % len(PROJ_SPLIT_BITS)]
        kernels.reset_counts()
        p, outs, lays = _proj_three_ways(cuda, geom, s, 16, plist, w_bits, k_bits, v_bits,
                                         seed=s + 10 * b + i)
        assert p.cluster == min(s // kvk.CHUNK, kvk.MAX_CLUSTER) and p.mode == "cluster"
        assert kernels.LAUNCHES["quant_kv_decode_step_proj"] == 2
        _assert_three_ways_equal(outs, lays, (plist, w_bits, k_bits, v_bits))
        at_s = torch.tensor(plist, device=outs["plan"].device) >= s
        assert torch.equal(outs["plan"][at_s], torch.zeros_like(outs["plan"][at_s]))


def test_proj_walks_where_a_block_spans_chunks(cuda):
    """Block 48 (CHUNK % block != 0) at S 1152: a block may span two chunks,
    so the plan walks, as row 3's does, and row 8 still equals the
    composition bit for bit; a cluster plan is refused."""
    from repro_torch.kernels.quant_kv import kernel as kvk

    p, outs, lays = _proj_three_ways(cuda, "gemma", 1152, 48, (47, 48, 600, 1151), 4, 8, 4,
                                     seed=5)
    assert p.mode == "walk" and p == kvk.attend_plan("quant_kv_decode_step", 1152, 48)
    _assert_three_ways_equal(outs, lays, "block 48")
    with pytest.raises(ValueError, match="plan for"):
        kvk._split("quant_kv_decode_step_proj", 1152, 48, dataclasses.replace(p, cluster=16))


# -- the attention body split over S (rows 3, 4, 6, 7): cluster and walk ------

#: (S, block): 32 chunks (two rounds of a 16-CTA cluster), 8 chunks in one
#: round, and one chunk with a ragged last tile
SPLIT_CASES = {"rounds": 2048, "one_round": 512, "one_chunk": 48}
SPLIT_BITS = [(8, 4), (4, 2)]


def _split_case(cuda, s, k_bits, v_bits, paged, seed):
    """B 4, 2 kv heads of 4 queries, hd 32, block 16.  Slot 0 writes in the
    first chunk, slot 1 at the last position, slot 2 between and attends to
    a window of 40 (for S 2048 every chunk before it empty), slot 3 is idle
    (pos -1, nothing valid).  Paged: the dense layer's blocks copied into a
    pool through a shuffled table; slot 3's row is unmapped.  Returns the
    layer, pos, kv_valid, q, k_new, v_new."""
    b, h, hq, hd, block = 4, 2, 8, 32, 16
    nb = s // block
    gen = torch.Generator(device=cuda).manual_seed(seed)
    pos = torch.tensor([5, s - 1, s // 2 + 3, -1], dtype=torch.int32, device=cuda)
    ar = torch.arange(s, device=cuda)[None, :]
    valid = ar <= pos[:, None]
    valid[2] &= ar[0] > pos[2] - 40
    rows = torch.randn((2, b, s, h, hd), generator=gen, device=cuda)
    dense = tcache.init_kv_layer(b, s, h, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                 device=cuda)
    dense = tcache.insert_rows(dense, torch.arange(b, device=cuda), rows[0], rows[1],
                               valid_len=pos.clamp(min=0))
    q = torch.randn((b, hq, hd), generator=gen, device=cuda)
    kn, vn = (torch.randn((b, 1, h, hd), generator=gen, device=cuda) for _ in range(2))
    if not paged:
        return dense, pos, valid, q, kn, vn
    layer = tpaged.init_paged_layer(3 * nb, b, s, h, hd, k_bits=k_bits, v_bits=v_bits,
                                    block=block, device=cuda)
    ids = (torch.randperm(3 * nb, generator=gen, device=cuda) + 1).reshape(3, nb)
    table = torch.full((b, nb), -1, dtype=torch.int32, device=cuda)
    table[:3] = ids.to(torch.int32)
    layer.block_table.copy_(table)
    for side in ("k", "v"):
        pool, scale = getattr(layer, f"{side}_packed"), getattr(layer, f"{side}_scale")
        src = getattr(dense, f"{side}_packed")[:3]                 # (3, H, S, hdp)
        pool[ids.reshape(-1)] = src.reshape(3, h, nb, block, -1).transpose(1, 2).reshape(
            3 * nb, h, block, -1)
        scale[ids.reshape(-1)] = getattr(dense, f"{side}_scale")[:3].transpose(1, 2).reshape(
            3 * nb, h, 1, 1)
    return layer, pos, valid, q, kn, vn


def _split_runs(layer, pos, valid, q, kn, vn, launch, valid_a=None):
    """The fused step (on its own copy) and the attention alone (under
    ``valid_a``, default ``valid``), through the wrappers with ``launch``
    (None: the plan).  Returns (step out, the layer after it, attention out)."""
    from repro_torch.kernels.quant_kv import kernel as kvk

    paged = isinstance(layer, tpaged.PagedKVLayer)
    b, s, n_kv, hd = layer.shape
    qg = q.reshape(b, n_kv, -1, hd).contiguous()
    mask = torch.where(valid, 0.0, -1e30).float()
    mask_a = mask if valid_a is None else torch.where(valid_a, 0.0, -1e30).float()
    kw = dict(k_bits=layer.k_bits, v_bits=layer.v_bits, hd=hd, block=layer.block)
    lay = _copy(layer)
    fields = [getattr(lay, f) for f in ("k_packed", "k_scale", "v_packed", "v_scale")]
    k3, v3 = kn[:, 0].contiguous(), vn[:, 0].contiguous()
    if paged:
        o_s = kvk.quant_kv_decode_step_paged_cuda(
            pos, lay.block_table, qg, k3, v3, *fields, mask, **kw,
            launch=launch and launch("quant_kv_decode_step_paged", s, layer.block))
        o_a = kvk.quant_kv_attention_paged_cuda(
            layer.block_table, qg, layer.k_packed, layer.k_scale, layer.v_packed,
            layer.v_scale, mask_a, **kw,
            launch=launch and launch("quant_kv_attention_paged", s, layer.block))
    else:
        o_s = kvk.quant_kv_decode_step_cuda(
            pos, qg, k3, v3, *fields, mask, **kw,
            launch=launch and launch("quant_kv_decode_step", s, layer.block))
        o_a = kvk.quant_kv_attention_cuda(
            qg, layer.k_packed, layer.k_scale, layer.v_packed, layer.v_scale, mask_a, **kw,
            launch=launch and launch("quant_kv_attention", s, layer.block))
    torch.cuda.synchronize()
    return o_s.reshape(q.shape), lay, o_a.reshape(q.shape)


@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("k_bits,v_bits", SPLIT_BITS)
def test_attend_cluster_and_walk_give_the_same_bits(cuda, case, paged, k_bits, v_bits):
    """Each fused step and attention alone with its plan's cluster and with
    one CTA walking the same chunks: outputs and cache bytes bit for bit.
    S 2048 folds 32 chunks over two rounds of a 16-CTA cluster; S 48 is one
    chunk, where the plan is one CTA already."""
    from repro_torch.kernels.quant_kv import kernel as kvk

    s = SPLIT_CASES[case]
    base, *inputs = _split_case(cuda, s, k_bits, v_bits, paged, seed=s + k_bits)
    valid_a = inputs[1].clone()
    valid_a[0] = False                  # slot 0 attends to nothing valid
    p = kvk.attend_plan("quant_kv_attention", s, base.block)
    assert p.cluster == min(p.chunks, kvk.MAX_CLUSTER) and p.chunks == -(-s // kvk.CHUNK)
    kernels.reset_counts()
    o_s, lay, o_a = _split_runs(base, *inputs, launch=None, valid_a=valid_a)
    w_s, wlay, w_a = _split_runs(base, *inputs, valid_a=valid_a,
                                 launch=lambda *a: kvk.walk_plan(kvk.attend_plan(*a)))
    assert torch.equal(o_s, w_s) and torch.equal(o_a, w_a)
    for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
        assert torch.equal(getattr(lay, f), getattr(wlay, f)), f
    step = "quant_kv_decode_step_paged" if paged else "quant_kv_decode_step"
    assert kernels.LAUNCHES[step] == 2
    assert kernels.LAUNCHES["quant_kv_attention_paged" if paged else "quant_kv_attention"] == 2


@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("k_bits,v_bits", SPLIT_BITS)
def test_attend_sums_as_its_mirror_and_the_touched_blocks_hold(cuda, case, paged, k_bits,
                                                               v_bits):
    """f32: the fused step's cache bytes and scales equal the plain step's
    (touched blocks in the first chunk, the last and between); its output and
    the attention alone within rel 1e-6 of ``ref.attend_mirror`` (the
    kernel's arithmetic on the CPU), the idle slot's step output zero, and
    the attention of a slot with data but no valid position the reference's
    uniform softmax over all S."""
    from repro_torch.kernels.quant_kv.ref import attend_mirror

    s = SPLIT_CASES[case]
    base, pos, valid, q, kn, vn = _split_case(cuda, s, k_bits, v_bits, paged, seed=s + v_bits)
    valid_a = valid.clone()
    valid_a[0] = False
    o_s, lay, o_a = _split_runs(base, pos, valid, q, kn, vn, launch=None, valid_a=valid_a)
    plain = _copy(base)
    kv_ops.quant_kv_decode_step(q, plain, pos, kn, vn, valid, impl="torch")
    for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
        x, y = getattr(lay, f), getattr(plain, f)
        if paged:          # block 0 is the trash block, written by the plain version only
            x, y = x[1:], y[1:]
        assert torch.equal(x, y), f

    def cpu(layer):
        return dataclasses.replace(layer, **{f: getattr(layer, f).cpu() for f in (
            "k_packed", "k_scale", "v_packed", "v_scale", *(("block_table",) if paged else ()))})

    live = pos >= 0
    m_s = attend_mirror(q.cpu(), cpu(lay), valid.cpu())
    m_a = attend_mirror(q.cpu(), cpu(base), valid_a.cpu())
    assert _rel(o_s[live].cpu(), m_s[live.cpu()]) <= 1e-6
    assert _rel(o_a.cpu(), m_a) <= 1e-6
    assert torch.equal(o_s[~live], torch.zeros_like(o_s[~live]))
    assert float(o_a[0].abs().max()) > 0


@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
@pytest.mark.parametrize("mode", ("cluster", "walk"))
def test_attend_idle_slots_write_nothing(cuda, paged, mode):
    """A slot at pos -1, one at pos S and (paged) one whose touched entry is
    unmapped: the fused step leaves their cache rows (their pool blocks, and
    block 0) as they were, and the first two read zeros."""
    from repro_torch.kernels.quant_kv import kernel as kvk

    s = 512
    base, pos, valid, q, kn, vn = _split_case(cuda, s, 8, 4, paged, seed=7)
    pos = torch.tensor([-1, s, 100, 200], dtype=torch.int32, device=cuda)
    if paged:
        base.block_table[3, 200 // base.block] = -1
    walk = (lambda *a: kvk.walk_plan(kvk.attend_plan(*a))) if mode == "walk" else None
    o_s, lay, _ = _split_runs(base, pos, valid, q, kn, vn, launch=walk)
    assert torch.equal(o_s[:2], torch.zeros_like(o_s[:2]))
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    if paged:
        touched = {int(base.block_table[2, 100 // base.block])}
        keep = [i for i in range(base.k_packed.shape[0]) if i not in touched]
        for f in fields:
            assert torch.equal(getattr(lay, f)[keep], getattr(base, f)[keep]), f
    else:
        for f in fields:
            assert torch.equal(getattr(lay, f)[:2], getattr(base, f)[:2]), f


#: the GEMV's mirror shapes: K of whole units (8 ranges, and 8 ranges of 8
#: units), ragged K (byte loads: rows not 16-byte aligned; a short last
#: range), odd N and a part tile
GEMV_MIRROR_CASES = [(2048, 2560), (16384, 130), (37, 17), (700, 75), (2080, 300)]


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("k,n", GEMV_MIRROR_CASES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_gemv_sums_as_its_mirror_whatever_m_and_n(cuda, bits, k, n, dtype):
    """The GEMV against ``ref.quant_gemv_mirror`` (the plan's K ranges, each
    range's exact sum added in f32 in order): f32 x within rel 1e-5 (a range
    is summed tile by tile in f32, the mirror's exactly), bf16 y at most one
    bf16 step from the mirror at 99.9 % of outputs or more; and each row's
    and channel's bits the same at every M and for a slice of the channels."""
    from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda
    from repro_torch.kernels.quant_gemv.ref import quant_gemv_mirror

    g = torch.Generator(device=cuda).manual_seed(bits * 5 + k + n)
    qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) / k ** 0.5, bits)
    x = torch.randn((8, k), generator=g, device=cuda).to(dtype)
    kernels.reset_counts()
    full = quant_gemv_cuda(x, qt.packed, qt.scale, bits=bits, k=k)
    for m in range(1, 8):
        assert torch.equal(quant_gemv_cuda(x[:m], qt.packed, qt.scale, bits=bits, k=k), full[:m])
    n1 = max(1, n // 3)
    part = quant_gemv_cuda(x, qt.packed[:n1].contiguous(), qt.scale.reshape(-1)[:n1].contiguous(),
                           bits=bits, k=k)
    assert torch.equal(part, full[:, :n1])
    assert kernels.LAUNCHES["quant_gemv"] == 9
    mirror = quant_gemv_mirror(x, qt.packed, qt.scale, bits, k).float()
    got = full.float()
    if dtype is torch.float32:
        assert _rel(got, mirror) <= 1e-5
    else:
        step = torch.exp2(torch.floor(torch.log2(mirror.abs().clamp_min(1e-30))) - 7)
        assert ((got - mirror).abs() > step).float().mean().item() <= 1e-3


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_gemv_tilings_give_the_same_bits(cuda, dtype):
    """One weight at K 2048 read at N 4096, 8192, 16384 and 32768, which the
    plan gives 1, 2, 4 and 8 tiles a CTA: its first 4096 channels have the
    same bits at every N."""
    from repro_torch.kernels.quant_gemv import kernel as gk

    k, widths = 2048, (4096, 8192, 16384, 32768)
    g = torch.Generator(device=cuda).manual_seed(23)
    qt = quantize_tensor(torch.randn((k, widths[-1]), generator=g, device=cuda) / k ** 0.5, 4)
    x = torch.randn((4, k), generator=g, device=cuda).to(dtype)
    assert [gk.plan(4, n, k).tiles for n in widths] == [1, 2, 4, gk.MAX_TILES]
    outs = [gk.quant_gemv_cuda(x, qt.packed[:n].contiguous(),
                               qt.scale.reshape(-1)[:n].contiguous(), bits=4, k=k)
            for n in widths]
    torch.cuda.synchronize()
    assert all(torch.equal(o[:, :widths[0]], outs[-1][:, :widths[0]]) for o in outs)


def _burst_case(cuda, paged: bool, k_bits: int, v_bits: int, seed: int):
    """A cache of 6 slots (hd 32, block 8, S 64) and a burst of 4 positions:
    slot 0 crosses a block edge, slot 1 accepts nothing, slot 2 runs past S,
    slot 3 accepts one; paged: a shuffled pool where slot 4's next block is
    unmapped and slot 5 is idle."""
    b, s, h, hd, block, j = 6, 64, 2, 32, 8, 4
    rng = np.random.default_rng(seed)
    start = torch.tensor([6, 20, 62, 33, 46, 10], dtype=torch.int32, device=cuda)
    acc = torch.tensor([3, -1, 3, 1, 3, 3], dtype=torch.int32, device=cuda)
    k = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(np.float32)).to(cuda)
    kw = dict(k_bits=k_bits, v_bits=v_bits, block=block)
    if paged:
        nb = s // block
        ids = iter((rng.permutation(40) + 1).tolist())
        table = torch.full((b, nb), -1, dtype=torch.int32)
        for i, p in enumerate(start.tolist()):
            if i < 5:
                last = min(p // block + (0 if i == 4 else 1), nb - 1)
                table[i, :last + 1] = torch.tensor([next(ids) for _ in range(last + 1)])
        layer = tpaged.with_table(tpaged.init_paged_layer(41, b, s, h, hd, device=cuda, **kw),
                                  table.numpy())
        layer = tpaged.insert_prefill_rows(layer, table.numpy(), k, v,
                                           valid_len=torch.where(torch.arange(b, device=cuda)
                                                                 == 5, 0, start.long()))
    else:
        layer = tcache.insert_rows(tcache.init_kv_layer(b, s, h, hd, device=cuda, **kw),
                                   torch.arange(b, device=cuda), k, v, valid_len=start.long())
    kb = torch.from_numpy(rng.normal(size=(b, j, h, hd)).astype(np.float32)).to(cuda)
    vb = torch.from_numpy(rng.normal(size=(b, j, h, hd)).astype(np.float32)).to(cuda)
    return layer, start, acc, kb, vb


@pytest.mark.parametrize("paged", (False, True))
@pytest.mark.parametrize("k_bits,v_bits", [(8, 4), (4, 4), (8, 8), (2, 8), (6, 2)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_burst_kernel_equals_the_appends_one_at_a_time(cuda, paged, k_bits, v_bits, dtype):
    """The burst append (one launch) against the same kernel one position at
    a time (J = 1, the slots past their ``acc`` masked by ``acc`` -1) bit
    for bit, and against the plain version (paged: blocks 1..P-1)."""
    base, start, acc, kb, vb = _burst_case(cuda, paged, k_bits, v_bits, seed=k_bits + v_bits)
    kb, vb = kb.to(dtype), vb.to(dtype)
    fields = ("k_packed", "k_scale", "v_packed", "v_scale")
    lb, ls, lp = _copy(base), _copy(base), _copy(base)
    kernels.reset_counts()
    kv_ops.quant_kv_append_burst(lb, start, acc, kb, vb)
    assert kernels.LAUNCHES["quant_kv_append_paged" if paged else "quant_kv_append"] == 1
    for j in range(kb.shape[1]):
        kv_ops.quant_kv_append_burst(ls, start + j, torch.where(j <= acc, 0, -1),
                                     kb[:, j:j + 1], vb[:, j:j + 1])
    kv_ops.quant_kv_append_burst(lp, start, acc, kb, vb, impl="torch")
    torch.cuda.synchronize()
    rows = slice(1, None) if paged else slice(None)
    for f in fields:
        assert torch.equal(getattr(lb, f), getattr(ls, f)), f
        assert torch.equal(getattr(lb, f)[rows], getattr(lp, f)[rows]), f
    if paged:                                     # the kernels never write the trash block
        for f in fields:
            assert torch.equal(getattr(lb, f)[0], getattr(base, f)[0]), f


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_attention_matches_direct_on_the_card(cuda, dtype):
    """The flash path (prompts above 2048) against the direct path on the
    card at a mid size, gemma-2b's head geometry: forward and dq, dk, dv
    through autograd.  f32 within 3e-5 (9e-5 on the gradients), the CPU
    tests' tolerance against the JAX package; bf16 within 2e-2."""
    from repro_torch.models import layers

    g = torch.Generator(device=cuda).manual_seed(21)
    b, s, hq, n_kv, hd = 1, 2560, 8, 1, 256
    base = [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((b, s, hq, hd), (b, s, n_kv, hd), (b, s, n_kv, hd))]
    res = []
    for fn in (layers._flash_attention, layers._direct_attention):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        out = fn(q, k, v, n_kv, causal=True)
        (out.float().sum() * 1e-2).backward()
        res.append([t.detach().float() for t in (out, q.grad, k.grad, v.grad)])
    torch.cuda.synchronize()
    tol = 3e-5 if dtype is torch.float32 else 2e-2
    for i, (a, r) in enumerate(zip(*res)):
        assert torch.isfinite(a).all()
        lim = tol * (3 if i and dtype is torch.float32 else 1)
        assert torch.allclose(a, r, atol=lim, rtol=lim), (i, float((a - r).abs().max()))


def test_nan_flags_ride_the_token_copy_on_the_card(cuda, monkeypatch):
    """An injected NaN in one slot's logits fails that request alone, and the
    per-slot flags come back in the tokens' own copy: one device-to-host
    ``.cpu()`` a decode step, nothing else synchronizes."""
    from repro_torch.runtime.resilience import FailureInjector
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.lifecycle import RequestState, ShedPolicy

    cfg, serve, state = _reduced_model(cuda, 14)
    prompts = [[5, 6, 7, 8], [9] * 11, [2, 3], [1, 2, 9, 4, 7, 3]]
    # two engines' streams are compared: no straggler shed (it reads the host clock)
    kw = dict(max_slots=3, max_seq=64, state_bits=state,
              shed=ShedPolicy(straggler_sheds_spec=False))
    ref = ServeEngine(cfg, serve, **kw).generate(prompts, max_new_tokens=8)
    copies, syncs = [], []
    real_cpu, real_sync = torch.Tensor.cpu, torch.cuda.synchronize
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: copies.append(t.device.type)
                        or real_cpu(t, *a, **k))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(1)
                        or real_sync(*a, **k))
    eng = ServeEngine(cfg, serve, fault_injector=FailureInjector(schedule={"nan_logit": (2,)}),
                      **kw)
    out = eng.run([Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)])
    st = eng.stats()
    assert copies.count("cuda") == st["decode_steps"] and not syncs
    failed = [u for u, lc in eng.lifecycles.items() if lc.state is RequestState.FAILED]
    assert len(failed) == 1 and st["nan_quarantined"] == 1
    for u in range(len(prompts)):
        if u not in failed:
            assert out[u] == ref[u]


def _routed(cfg, tokens: int, seed: int, device):
    """``moe_mlp``'s capacity buffer at ``tokens`` token rows (numpy-seeded
    tokens and router, the port's own ``_route`` and ``dispatch``): ``(E,
    C, d)``, zeros where an expert holds no token."""
    from repro_torch.models import moe

    rng = np.random.default_rng(seed)
    xf = torch.from_numpy(rng.standard_normal((tokens, cfg.d_model), dtype=np.float32))
    router = torch.from_numpy(rng.standard_normal((cfg.d_model, cfg.n_experts),
                                                  dtype=np.float32))
    e, c = cfg.n_experts, moe.capacity(tokens, cfg)
    _, _, eidx = moe._route({"router": router.to(device)}, xf.to(device), cfg)
    _, e_s, t_s, pos, keep = moe.dispatch(eidx, e, c)
    buf = torch.zeros((e * c + 1, cfg.d_model), device=device)
    buf[torch.where(keep, e_s * c + pos, e * c)] = xf.to(device)[t_s]
    return buf[:e * c].view(e, c, cfg.d_model)


def _zero_case(case: str, x: torch.Tensor) -> torch.Tensor:
    """x ``(E, 8, K)`` with experts emptied as ``case`` says."""
    x = x.clone()
    e = x.shape[0]
    x[0::3] = 0.0                                   # whole experts of zeros
    if case == "trailing_zero_rows":
        for i in range(1, e, 3):
            x[i, 1 + i % 7:] = 0.0                 # live rows, then zeros
    elif case == "negative_zero":
        x[1] = -0.0                                 # -0.0 counts as zero
        x[2, :, ::2] = -0.0
        x[2, :, 1::2] = 0.0
    elif case == "nan_row":
        x[1, 3, x.shape[2] // 2] = float("nan")     # a NaN in one row of a live expert
        x[3] = 0.0
        x[3, 5, 0] = float("nan")                   # an expert live by its NaN alone
    return x


def _stack_checks(x, packed, scale, bits: int, k: int, per_expert: bool = False):
    """One launch for the stack, each expert's bytes the 2-D launch's, and the
    plain version within rows 1 and 2's tolerances where it is finite."""
    from repro_torch.kernels.quant_matmul.ops import quant_matmul_experts
    from repro_torch.kernels.quant_matmul.ref import experts_matmul

    kernels.reset_counts()
    got = quant_matmul_experts(x, packed, scale, bits, k)
    torch.cuda.synchronize()
    name = "quant_gemv_experts" if x.shape[1] <= 8 else "quant_matmul_experts"
    assert kernels.LAUNCHES[name] == 1 and sum(kernels.LAUNCHES.values()) == 1
    for i in range(x.shape[0]):
        one = quant_matmul(x[i], packed[i], scale[i if per_expert else 0], bits, k)
        assert _bits_equal(got[i], one), i
    ref = experts_matmul(x, packed, scale, bits, k)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    assert _rel(got[fin], ref[fin]) <= (1e-4 if x.dtype is torch.float32 else 2e-2)
    return got


#: expert stacks (E, C, K, N): the GEMV (C <= 8) and the GEMM (C 9 to 300), K
#: on the TMA path (2048, 1408: deepseek-moe-16b's expert linears) and on the
#: predicated one (130, 37), N ragged against the channel tiles, C not a
#: multiple of the token tile: no tile may carry the next expert's rows into
#: an output it keeps
EXPERT_CASES = [(4, 8, 64, 48), (3, 5, 130, 75), (2, 8, 1408, 2048), (4, 9, 64, 40),
                (4, 16, 2048, 1408), (5, 40, 37, 70), (3, 300, 2048, 192), (64, 16, 128, 96)]


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("e,c,k,n", EXPERT_CASES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("per_expert", (False, True), ids=("shared_scale", "expert_scale"))
def test_expert_launch_equals_the_2d_launches(cuda, bits, e, c, k, n, dtype, per_expert):
    """One launch over the stack equals the 2-D kernel on each expert's slice
    byte for byte (the plans share their splits), and the plain version
    within the 2-D kernels' tolerance."""
    g = torch.Generator(device=cuda).manual_seed(bits * 1000 + e * 10 + c)
    w = torch.randn((e, k, n), generator=g, device=cuda) / k ** 0.5
    if per_expert:
        qts = [quantize_tensor(w[i], bits) for i in range(e)]
        packed = torch.stack([q.packed for q in qts])
        scale = torch.stack([q.scale for q in qts])                  # (E, 1, N)
    else:
        qt = quantize_tensor(w, bits)
        packed, scale = qt.packed, qt.scale                           # (1, 1, N)
    x = torch.randn((e, c, k), generator=g, device=cuda).to(dtype)
    got = _stack_checks(x, packed, scale, bits, k, per_expert=per_expert)
    assert got.shape == (e, c, n) and got.dtype == dtype


def test_expert_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.quant_gemv.kernel import quant_gemv_experts_cuda
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_experts_cuda

    qt = quantize_tensor(torch.randn((4, 64, 16), device=cuda), 4)
    x = torch.zeros((4, 8, 64), device=cuda)
    for run in (quant_gemv_experts_cuda, quant_matmul_experts_cuda):
        with pytest.raises(ValueError, match="packed must be"):
            run(x[:3], qt.packed, qt.scale, bits=4, k=64)
        with pytest.raises(ValueError, match="does not broadcast"):
            run(x, qt.packed, torch.ones((2, 1, 16), device=cuda), bits=4, k=64)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            run(x.cpu(), qt.packed, qt.scale, bits=4, k=64)


@pytest.mark.parametrize("tokens", (4, 64))
def test_moe_layer_launches_one_expert_kernel_a_linear(cuda, tokens):
    """Reduced deepseek-moe-16b's MoE layer with packed experts in f32: three
    expert launches (the GEMV at 4 tokens, the GEMM at 64) and the plain
    path's output within rel 1e-4; two runs give the same bits."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get_config("deepseek-moe-16b").reduced()
    g = torch.Generator(device=cuda).manual_seed(tokens)
    p = moe.moe_init(g, cfg, torch.float32, device=cuda)
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = quantize_tensor(p[name], 4)
    x = torch.randn((1, tokens, cfg.d_model), generator=g, device=cuda)
    kernels.reset_counts()
    got = moe.moe_mlp(p, x, cfg)
    again = moe.moe_mlp(p, x, cfg)
    torch.cuda.synchronize()
    name = "quant_gemv_experts" if moe.capacity(tokens, cfg) <= 8 else "quant_matmul_experts"
    assert kernels.LAUNCHES[name] == 6 and torch.equal(got, again)
    assert _rel(got, moe.moe_mlp(p, x, cfg, impl="torch")) <= 1e-4


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("e,k,n", [(8, 2048, 1408), (7, 130, 75)])
@pytest.mark.parametrize("case", ("empty_experts", "trailing_zero_rows", "negative_zero",
                                  "nan_row"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_expert_gemv_skips_empty_experts_byte_for_byte(cuda, bits, e, k, n, case, dtype):
    """Row 1e skips the weights of an expert whose x is all zero (sign aside)
    and writes the bytes the 2-D launch computes for it (+0 times the scale):
    whole experts of zeros, live rows before trailing zero rows, experts of
    -0.0, a NaN in a live expert's row and an expert live by a NaN alone;
    K 2048 takes the 16-byte scan, K 130 the element-wise one.  A scale per
    expert with a negative and a zero entry checks the skipped outputs'
    signs too.  Other tiles a CTA give the same bytes."""
    from repro_torch.kernels.quant_gemv import kernel as gk

    g = torch.Generator(device=cuda).manual_seed(bits * 31 + e + k)
    w = torch.randn((e, k, n), generator=g, device=cuda) / k ** 0.5
    qts = [quantize_tensor(w[i], bits) for i in range(e)]
    packed = torch.stack([q.packed for q in qts])
    scale = torch.stack([q.scale for q in qts])                       # (E, 1, N)
    scale[:, 0, 0] = -scale[:, 0, 0]
    scale[:, 0, 1] = 0.0
    x = _zero_case(case, torch.randn((e, 8, k), generator=g, device=cuda)).to(dtype)
    got = _stack_checks(x, packed, scale, bits, k, per_expert=True)
    for tiles in (1, 3, gk.MAX_TILES):        # other channel blocks, other clusters' votes
        again = gk.quant_gemv_experts_cuda(x, packed, scale, bits=bits, k=k, launch=(
            dataclasses.replace(gk.plan(8, n, k, e), tiles=tiles)))
        assert _bits_equal(again, got), tiles
    empty = (x.reshape(e, -1) == 0).all(-1)                # -0.0 == 0 too
    assert empty.any() and (~empty).any()
    assert (got[empty] == 0).all()
    assert torch.signbit(got[empty][..., 0]).all() and not torch.signbit(got[empty][..., 1:]).any()


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("tokens", (4, 64))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_expert_stacks_on_the_routed_buffer(cuda, bits, tokens, dtype):
    """Reduced deepseek-moe-16b's capacity buffer as the MoE layer builds it
    (4 tokens: C 8, the GEMV, row 1e; 64 tokens: C 24, the GEMM, row 2e),
    with experts that hold no token, against the 2-D launches byte for byte,
    one launch; and the same routing at full width (E 64, d 2048, C 8 at
    both counts: the GEMV)."""
    from repro_torch import configs

    for cfg in (configs.get_config("deepseek-moe-16b").reduced(),
                configs.get_config("deepseek-moe-16b")):
        x = _routed(cfg, tokens, tokens * 10 + bits, cuda).to(dtype)
        e, k = cfg.n_experts, cfg.d_model
        g = torch.Generator(device=cuda).manual_seed(bits + tokens)
        qt = quantize_tensor(torch.randn((e, k, cfg.d_ff), generator=g, device=cuda) / k ** 0.5,
                             bits)
        got = _stack_checks(x, qt.packed, qt.scale, bits, k)
        empty = (x.reshape(e, -1) == 0).all(-1)
        assert (got[empty] == 0).all()
        if tokens == 4:
            assert empty.any()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_expert_gemv_tiles_keep_the_bits(cuda, dtype):
    """deepseek-moe-16b's expert linears at every tiles a CTA, 1 to 8 (the
    plan's split): the same bytes as the plan's own tiles."""
    from repro_torch import configs
    from repro_torch.kernels.quant_gemv import kernel as gk

    cfg = configs.get_config("deepseek-moe-16b")
    x = _routed(cfg, 4, 7, cuda)
    for n, k in ((cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.d_ff)):
        g = torch.Generator(device=cuda).manual_seed(n)
        qt = quantize_tensor(torch.randn((cfg.n_experts, k, n), generator=g, device=cuda), 4)
        xk = (x if k == cfg.d_model else torch.randn((cfg.n_experts, 8, k), generator=g,
                                                     device=cuda) * (x[..., :1] != 0)).to(dtype)
        want = gk.quant_gemv_experts_cuda(xk, qt.packed, qt.scale, bits=4, k=k)
        p = gk.plan(8, n, k, cfg.n_experts)
        for t in range(1, gk.MAX_TILES + 1):
            got = gk.quant_gemv_experts_cuda(xk, qt.packed, qt.scale, bits=4, k=k,
                                             launch=dataclasses.replace(p, tiles=t))
            assert _bits_equal(got, want), t


#: the full-width linears of mamba2-2.7b (in_proj's N 10576 is 82.6 tiles of
#: 128; lm_head's N 50280 is no multiple of 16) and qwen2-vl-2b (wqkv, the
#: fused gate/up, w_down, the untied head of 151936)
WIDE_LINEARS = {"mamba_in_proj": (2560, 10576), "mamba_out_proj": (5120, 2560),
                "mamba_lm_head": (2560, 50280), "qwen_wqkv": (1536, 2048),
                "qwen_w_gu": (1536, 17920), "qwen_w_down": (8960, 1536),
                "qwen_lm_head": (1536, 151936)}


@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("m", (1, 4, 8, 40))
@pytest.mark.parametrize("name", sorted(WIDE_LINEARS))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_wide_linears_of_the_new_families_match_plain(cuda, bits, m, name, dtype):
    """The GEMV (M <= 8) and the GEMM at full width, ragged last channel
    tiles included, against the plain versions."""
    k, n = WIDE_LINEARS[name]
    g = torch.Generator(device=cuda).manual_seed(bits * 7 + m + n)
    qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) / k ** 0.5, bits)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    kernels.reset_counts()
    got = quant_matmul(x, qt.packed, qt.scale, bits, k)
    ref = (quant_gemv_ref if m <= 8 else quant_matmul_ref)(x, qt.packed, qt.scale, bits, k)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert _rel(got, ref) <= (1e-5 if dtype is torch.float32 else 2e-2)
    assert kernels.LAUNCHES["quant_gemv" if m <= 8 else "quant_matmul"] == 1


@pytest.mark.parametrize("shape", ((64, 2048, 1408), (64, 1408, 2048)), ids=("up", "down"))
@pytest.mark.parametrize("bits", (2, 4, 8))
def test_fake_quant_kernel_on_expert_stacks_matches_plain(cuda, shape, bits):
    """deepseek-moe-16b's stacked experts as the MoE QAT runs them: "auto"
    launches the kernel on the (E*K, N) view, forward and STE backward bit
    for bit the plain versions, one scale per channel over E and K."""
    from repro_torch.kernels.fake_quant import ops as fq_ops

    gen = torch.Generator(device=cuda).manual_seed(bits)
    w = torch.randn(shape, generator=gen, device=cuda) * 0.05
    g = torch.randn(shape, generator=gen, device=cuda)
    outs, grads = [], []
    for impl in ("torch", "auto"):
        leaf = w.clone().requires_grad_()
        kernels.reset_counts()
        out = fq_ops.fake_quant_ste(leaf, bits, impl)
        out.backward(g)
        torch.cuda.synchronize()
        outs.append(out.detach())
        grads.append(leaf.grad)
        want = 1 if impl == "auto" else 0
        assert kernels.LAUNCHES["fake_quant"] == kernels.LAUNCHES["fake_quant_ste_bwd"] == want
    assert _bits_equal(*outs) and _bits_equal(*grads)


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (8, 4), (4, 2)])
def test_decode_step_kernel_takes_a_group_of_six(cuda, k_bits, v_bits):
    """qwen2-vl-2b's attention: 12 query heads on 2 KV heads of 128, a query
    group of 6 (not a power of two); bytes exact, output within rel 1e-5."""
    b, s, h, hq, hd, block = 4, 256, 2, 12, 128, 16
    rng = np.random.default_rng(k_bits * 10 + v_bits + 6)
    lens = torch.tensor([7, 16, 100, 200], device=cuda)
    k = torch.from_numpy(rng.normal(size=(b, 200, h, hd)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(b, 200, h, hd)).astype(np.float32)).to(cuda)
    base = tcache.init_kv_layer(b, s, h, hd, k_bits=k_bits, v_bits=v_bits, block=block,
                                device=cuda)
    base = tcache.insert_rows(base, torch.arange(b, device=cuda), k, v, valid_len=lens)
    layers = [dataclasses.replace(base, **{f: getattr(base, f).clone() for f in
                                           ("k_packed", "k_scale", "v_packed", "v_scale")})
              for _ in range(2)]
    for step in range(3):
        pos = (lens + step).to(torch.int32)
        valid = torch.arange(s, device=cuda)[None, :] <= pos[:, None]
        q = torch.from_numpy(rng.normal(size=(b, hq, hd)).astype(np.float32)).to(cuda)
        kn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
        vn = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(cuda)
        kernels.reset_counts()
        o_k, _ = kv_ops.quant_kv_decode_step(q, layers[0], pos, kn, vn, valid)
        o_p, _ = kv_ops.quant_kv_decode_step(q, layers[1], pos, kn, vn, valid, impl="torch")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["quant_kv_decode_step"] == 1
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(layers[0], f), getattr(layers[1], f)), (step, f)
        assert _rel(o_k, o_p) <= 1e-5


#: zamba2-2.7b's shared attention: 32 KV heads of 80 (a group of 1), the
#: window of its decode as a mask over positions (``attn_window``, cut to 128
#: here so that it bites within S 512); the positions sit at a block's first
#: and last row, in the middle and at S - 1
HD80 = dict(b=4, h=32, hd=80, s=512, block=16, window=128, pos=(40, 255, 300, 511))


def _window_valid(pos, s, window, device):
    ar = torch.arange(s, device=device)[None, :]
    return (ar <= pos[:, None]) & (ar > pos[:, None] - window)


def _hd80_layer(cuda, k_bits, v_bits, seed):
    c = HD80
    rng = np.random.default_rng(seed)
    rows = c["s"]
    k = torch.from_numpy(rng.normal(size=(c["b"], rows, c["h"], c["hd"])).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(c["b"], rows, c["h"], c["hd"])).astype(np.float32))
    base = tcache.init_kv_layer(c["b"], c["s"], c["h"], c["hd"], k_bits=k_bits, v_bits=v_bits,
                                block=c["block"], device=cuda)
    pos = torch.tensor(c["pos"], dtype=torch.int32, device=cuda)
    return tcache.insert_rows(base, torch.arange(c["b"], device=cuda), k.to(cuda), v.to(cuda),
                              valid_len=pos), pos, rng


@pytest.mark.parametrize("k_bits,v_bits", [(8, 4), (8, 8), (4, 2)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_decode_step_kernel_at_hd80_under_a_window(cuda, k_bits, v_bits, dtype):
    """Row 3 at zamba2's head dim 80 (5 groups of 16 a row; 2-bit rows of 5
    words) under a windowed ``kv_valid``: cache bytes exact and the output
    within rel 1e-4 of the plain version; only the block at each slot's
    ``pos`` changes; and the output does not move, bit for bit, when the
    K/V rows older than the window hold other finite levels."""
    c = HD80
    base, pos, rng = _hd80_layer(cuda, k_bits, v_bits, k_bits * 10 + v_bits)
    valid = _window_valid(pos, c["s"], c["window"], cuda)
    q = torch.from_numpy(rng.normal(size=(c["b"], c["h"], c["hd"]))).to(cuda, dtype)
    kn = torch.from_numpy(rng.normal(size=(c["b"], 1, c["h"], c["hd"]))).to(cuda, dtype)
    vn = torch.from_numpy(rng.normal(size=(c["b"], 1, c["h"], c["hd"]))).to(cuda, dtype)
    lk, lp, lo = _copy(base), _copy(base), _copy(base)
    # rows older than the window: other levels (packed bytes are per position)
    old = torch.arange(c["s"], device=cuda)[None, :] <= (pos[:, None] - c["window"])
    for side in ("k_packed", "v_packed"):
        t = getattr(lo, side)
        noise = torch.from_numpy(rng.integers(-100, 100, size=t.shape, dtype=np.int8)).to(cuda)
        t.copy_(torch.where(old[:, None, :, None], noise, t))
    kernels.reset_counts()
    o_k, _ = kv_ops.quant_kv_decode_step(q, lk, pos, kn, vn, valid, out_dtype=torch.float32)
    o_o, _ = kv_ops.quant_kv_decode_step(q, lo, pos, kn, vn, valid, out_dtype=torch.float32)
    o_p, _ = kv_ops.quant_kv_decode_step(q, lp, pos, kn, vn, valid, impl="torch",
                                         out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quant_kv_decode_step"] == 2
    for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
        assert torch.equal(getattr(lk, f), getattr(lp, f)), f
    assert _rel(o_k, o_p) <= 1e-4
    assert torch.equal(o_k, o_o)
    blk = c["block"]
    for i, p in enumerate(c["pos"]):
        for side in ("k_packed", "v_packed"):
            moved = (getattr(lk, side)[i] != getattr(base, side)[i]).any(dim=(0, 2))
            rows = torch.nonzero(moved).flatten().tolist()
            assert rows and all(r // blk == p // blk for r in rows), (i, side, rows)


@pytest.mark.parametrize("d", (512, 2560))
@pytest.mark.parametrize("w_bits,k_bits,v_bits", [(4, 8, 4), (8, 8, 8), (2, 4, 2)])
def test_proj_kernel_at_hd80_under_a_window(cuda, d, w_bits, k_bits, v_bits):
    """Row 8 at zamba2's heads (32 of 80: 240 projected rows a kv head, 15
    tiles of 16 over the cluster) under a windowed ``kv_valid``: against the
    plain version, scales rel 1e-6 and output rel 1e-5; at d 512 (the widest
    the engine's gate admits) also bit for bit the launches it replaces."""
    from repro_torch.models.layers import _qkv, decode_attend_one, rope_freqs

    c = HD80
    base, pos, rng = _hd80_layer(cuda, k_bits, v_bits, w_bits + d)
    n = 3 * c["h"] * c["hd"]
    w = torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32) / d ** 0.5).to(cuda)
    wq = quantize_tensor(w, w_bits)
    x = torch.from_numpy(rng.normal(size=(c["b"], d)).astype(np.float32)).to(cuda)
    valid = _window_valid(pos, c["s"], c["window"], cuda)
    ang = pos[:, None].float() * rope_freqs(c["hd"], 10_000.0, device=cuda)
    lk, lc, lp = _copy(base), _copy(base), _copy(base)
    kernels.reset_counts()
    o_k, _ = kv_ops.quant_kv_decode_step_proj(x, wq.packed, wq.scale, torch.cos(ang),
                                              torch.sin(ang), lk, pos, valid, w_bits=w_bits,
                                              n_heads=c["h"])
    o_p, _ = kv_ops.quant_kv_decode_step_proj(x, wq.packed, wq.scale, torch.cos(ang),
                                              torch.sin(ang), lp, pos, valid, w_bits=w_bits,
                                              n_heads=c["h"], impl="torch")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quant_kv_decode_step_proj"] == 1
    for f in ("k_scale", "v_scale"):
        assert _rel(getattr(lk, f), getattr(lp, f)) <= 1e-6, f
    assert _rel(o_k, o_p) <= 1e-5
    if d <= 512:
        cfg = type("Cfg", (), dict(n_heads=c["h"], n_kv_heads=c["h"], resolved_head_dim=c["hd"],
                                   rope="default", rope_theta=10_000.0, qk_norm=False))
        q, kn, vn = _qkv({"wqkv": wq}, x[:, None], cfg, pos[:, None])
        o_c, _ = decode_attend_one(lc, q, kn, vn, pos, cfg, window=c["window"])
        torch.cuda.synchronize()
        for f in ("k_packed", "k_scale", "v_packed", "v_scale"):
            assert torch.equal(getattr(lk, f), getattr(lc, f)), f
        assert torch.equal(o_k, o_c[:, 0])


#: the linears of zamba2-2.7b (in_proj N 10448, out_proj K 5120, the shared
#: block's fused wqkv and gate/up, w_down K 10240, the untied head 32000) and
#: whisper-tiny (K 384: six 64-value steps; w_down K 1536; the head's N 51865,
#: an odd N); (K, N)
HYBRID_ENCDEC_LINEARS = {"zamba_in_proj": (2560, 10448), "zamba_out_proj": (5120, 2560),
                         "zamba_wqkv": (2560, 7680), "zamba_w_gu": (2560, 20480),
                         "zamba_w_down": (10240, 2560), "zamba_lm_head": (2560, 32000),
                         "whisper_wqkv": (384, 1152), "whisper_w_up": (384, 1536),
                         "whisper_w_down": (1536, 384), "whisper_lm_head": (384, 51865)}


@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("m", (1, 4, 8, 40, 1500))
@pytest.mark.parametrize("name", sorted(HYBRID_ENCDEC_LINEARS))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_hybrid_and_encdec_linears_match_plain(cuda, bits, m, name, dtype):
    """The GEMV (M <= 8) and the GEMM (M 40, and 1500: one clip's frames
    through ``cross_kv``) at the two families' full widths, the odd N of
    whisper's head included, against the plain versions."""
    k, n = HYBRID_ENCDEC_LINEARS[name]
    if m == 1500 and not name.startswith("whisper"):
        pytest.skip("M 1500 is whisper's frame count")
    g = torch.Generator(device=cuda).manual_seed(bits * 7 + m + n)
    qt = quantize_tensor(torch.randn((k, n), generator=g, device=cuda) / k ** 0.5, bits)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    kernels.reset_counts()
    got = quant_matmul(x, qt.packed, qt.scale, bits, k)
    ref = (quant_gemv_ref if m <= 8 else quant_matmul_ref)(x, qt.packed, qt.scale, bits, k)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert _rel(got, ref) <= (1e-5 if dtype is torch.float32 else 2e-2)
    assert kernels.LAUNCHES["quant_gemv" if m <= 8 else "quant_matmul"] == 1


#: the autotuner's CUDA candidate at gemma-2b's state geometry: S 128 (its
#: default 8 blocks), 512 and 2048 (two rounds of 16 chunks)
TUNE_S = (128, 512, 2048)


@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
@pytest.mark.parametrize("s", TUNE_S)
@pytest.mark.parametrize("k_bits,v_bits", [(8, 4), (4, 2)])
def test_every_autotune_candidate_is_the_sequential_kernels(cuda, paged, s, k_bits, v_bits):
    """The CUDA candidate (``kernels/autotune.py``: the kernel's own launch),
    passed as ``config`` or replayed from an installed table, gives the
    append kernel then the attention kernel's output and cache bytes bit for
    bit, in one launch; the installed key is the one the served layer's own
    geometry looks up."""
    from repro_torch.kernels import autotune

    key = autotune.KernelKey(family="decode_step_paged" if paged else "decode_step",
                             k_bits=k_bits, v_bits=v_bits, heads=1, head_dim=256, block=16,
                             impl="cuda")
    q, layer, pos, kn, vn, valid = autotune._synthetic_inputs(key, batch=8, blocks=s // 16,
                                                              device=cuda)
    seq = kv_ops.quant_kv_append(autotune.clone_layer(layer), pos, kn, vn)
    o_seq = kv_ops.quant_kv_attention(q, seq, valid, out_dtype=torch.float32)
    cands = autotune.enumerate_candidates(key)
    assert cands == [{"place": "kernel", "attend": "cluster"}]
    _, _, n_kv, hd = layer.shape
    try:
        autotune.set_active_configs([{"key": key.to_dict(), "config": cands[0]}])
        assert autotune.lookup(key.family, layer.k_bits, layer.v_bits, n_kv, hd, layer.block,
                               kernels.resolve_impl("auto", q.device)) == cands[0]
        runs = [{}, dict(config=cands[0])]
        for kw in runs:
            kernels.reset_counts()
            o, new = kv_ops.quant_kv_decode_step(q, autotune.clone_layer(layer), pos, kn, vn,
                                                 valid, out_dtype=torch.float32, **kw)
            assert torch.equal(o, o_seq), kw
            for f in ("k_packed", "v_packed", "k_scale", "v_scale"):
                assert torch.equal(getattr(new, f), getattr(seq, f)), (kw, f)
            assert sum(kernels.LAUNCHES.values()) == 1
    finally:
        autotune.set_active_configs(None)
    o, new = kv_ops.quant_kv_decode_step(q, autotune.clone_layer(layer), pos, kn, vn, valid,
                                         out_dtype=torch.float32)
    assert torch.equal(o, o_seq)
    for f in ("k_packed", "v_packed", "k_scale", "v_scale"):
        assert torch.equal(getattr(new, f), getattr(seq, f)), f


def test_autotune_key_times_the_cuda_candidates(cuda):
    from repro_torch.kernels import autotune

    key = autotune.KernelKey(family="decode_step", k_bits=8, v_bits=4, heads=1, head_dim=256,
                             block=16, impl="cuda")
    res = autotune.autotune_key(key, repeats=3)
    assert res["candidates"] == 1 and res["micros"] > 0
    assert res["config"] in autotune.enumerate_candidates(key)
