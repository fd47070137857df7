"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit; without a card they skip.
Run them on one with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  They cover the edges that ``chip_smoke.py``'s
full-width shapes do not reach: ragged N, K padded inside the last byte
(the GEMV's byte-wise path), M = 9 at the GEMV/GEMM switch, 2-bit lanes,
the dense and paged decode kernels at a reduced head width over a
shuffled block table with a shared block, an idle slot and an unmapped
entry inside a valid range, the dense append and attention alone with a
masked row, at reduced gemma-2b width in f32 the verify pass against
decode steps and the speculative engine against the non-speculative one,
and the fake-quant forward and STE backward bit for bit at odd shapes, with
row-wise scales, a zero column and infinite upstream gradients.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
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


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (3, 33, 17), (8, 130, 75), (9, 64, 40),
                                   (40, 37, 70)])
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
    assert kernels.LAUNCHES["quant_kv_append"] == 4
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
    assert kernels.LAUNCHES["quant_kv_append_paged"] == 2
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
    decode steps (the GEMV, M = 3) on copies of one cache, in f32: logits
    within rel 1e-4, as the GEMV and the GEMM are each held to their plain
    versions, and cache scales within rel 1e-5."""
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
    assert kernels.LAUNCHES["quant_gemv"] == 4 * 4 * cfg.n_layers
    assert sum(kernels.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
def test_speculative_engine_matches_non_speculative_on_the_card(cuda, paged):
    """Greedy streams of the speculative engine (K = 3, a 4-bit draft) equal
    the non-speculative engine's at reduced width in f32, through the
    kernels only; the commit replays launch the dense or paged append."""
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
    assert st["launches"][append] == 2 * cfg.n_layers * 4 * st["spec_steps"] > 0
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
