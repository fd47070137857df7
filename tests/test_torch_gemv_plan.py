"""The CUDA GEMV's launch plan and arithmetic, on the CPU.

``kernels/quant_gemv/kernel.py`` plans each launch in Python (tiles of 128
channels, as many a CTA as keep a wave of CTAs, K cut into ranges of whole
256-value units, a CTA's ranges on a cluster) and ``csrc/quant_gemv.cu``
runs it on the card, where the CPU cannot follow.  These tests hold what
the CPU can check: that the split depends on K alone and its ranges
partition K where the kernel can cut it, that the tiles a CTA takes cover
N once and keep a wave of CTAs, that a channel's value in the kernel's
arithmetic, mirrored in
``ref.quant_gemv_mirror`` (exact range sums added in f32 in range order, the
scale last), does not depend on M or N, and that the mirror agrees with the
JAX package's GEMV (the Pallas kernel in interpret mode, and "xla") and
with the plain version on the same seeded numpy inputs, ragged K and odd N
included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_gemv.kernel import quant_gemv_pallas
from repro.kernels.quant_gemv.ops import quant_gemv as jquant_gemv
from repro.quant.tensor import quantize_tensor as jquantize_tensor
from repro_torch.core.packing import LANES
from repro_torch.kernels.quant_gemv import kernel as gk
from repro_torch.kernels.quant_gemv.ref import quant_gemv_mirror, quant_gemv_ref

torch.set_num_threads(2)

#: gemma-2b's fused linears (N, K)
GEMMA = {"wqkv": (2560, 2048), "wo": (2048, 2048), "w_gu": (32768, 2048),
         "w_down": (2048, 16384)}
#: K values: row 8's d (512), gemma's, ragged ones, and the most one launch takes
KS = (16, 37, 256, 512, 700, 1000, 2048, 2080, 16384, 65536)
DTYPES = (torch.float32, torch.bfloat16)
#: the family tolerances (tests/test_kernel_parity.py)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: (M, K, N): whole units, odd N, ragged K (not a whole unit, not a whole round)
SHAPES = [(1, 256, 48), (4, 512, 130), (8, 1024, 77), (5, 700, 33), (3, 2080, 65)]


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _weights(bits, k, n, seed):
    w = (np.random.default_rng(seed).normal(size=(k, n)) * 0.05).astype(np.float32)
    qt = jquantize_tensor(jnp.asarray(w), bits)
    return np.array(qt.packed), np.array(qt.scale).reshape(1, -1)


@pytest.mark.parametrize("k", KS)
def test_split_depends_on_k_alone(k):
    splits = {gk.plan(m, n, k).splits for m in range(1, gk.GEMV_MAX_M + 1)
              for n in (1, 17, 128, 2560, 32768)}
    assert splits == {gk.split_of(k)}


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("k", KS)
def test_k_ranges_partition_k_at_whole_units(k, bits):
    p = gk.plan(4, 256, k)
    ranges = p.k_ranges()
    assert 1 <= p.splits <= gk.MAX_SPLIT and len(ranges) == p.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 < k1                                   # no empty range
        assert k0 % gk.UNIT == 0 and k0 % LANES[bits] == 0
        assert k1 - k0 <= gk.MAX_UNITS * gk.UNIT         # its x staging fits
    # SPLIT ranges below LONG_UNITS units (fewer if K has fewer), else MAX_SPLIT
    units = -(-k // gk.UNIT)
    assert p.splits == (min(gk.SPLIT, units) if units < gk.LONG_UNITS else gk.MAX_SPLIT)


def test_gemma_plans_fill_the_card():
    """One layer's linears: K 2048 in 8 ranges of one unit, so wqkv and wo
    run 160 and 128 CTAs of one tile and w_gu's 256 tiles go 8 to a CTA
    (256 CTAs, one wave at two an SM); K 16384 in 16 ranges of four units,
    so w_down's 16 tiles make 256 CTAs too; row 8's d 512 takes two ranges."""
    plans = {name: gk.plan(4, n, k) for name, (n, k) in GEMMA.items()}
    assert {name: (p.grid, p.tiles) for name, p in plans.items()} == {
        "wqkv": ((8, 20), 1), "wo": ((8, 16), 1), "w_gu": ((8, 32), 8), "w_down": ((16, 16), 1)}
    assert gk.plan(4, 2560, 16384).k_ranges()[1] == (1024, 2048)
    assert gk.split_of(512) == 2


@pytest.mark.parametrize("n", (1, 17, 128, 129, 2560, 32768, 32769, 262144))
@pytest.mark.parametrize("k", (37, 2048, 16384))
def test_tiles_cover_n_once_and_keep_a_wave(n, k):
    p = gk.plan(8, n, k)
    assert p.tiles == gk.tiles_of(n, p.splits) and 1 <= p.tiles <= gk.MAX_TILES
    assert {gk.plan(m, n, k).tiles for m in range(1, 9)} == {p.tiles}
    ctas, cover = p.grid[1], gk.CHANNELS * p.tiles
    assert (ctas - 1) * cover < n <= ctas * cover        # every channel once, no empty CTA
    if p.tiles > 1:                                       # fewer tiles would still fill a wave
        assert p.grid[0] * ctas >= gk.WAVE // 2


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="needs CUDA tensors|CUDA tensor"):
        gk.quant_gemv_cuda(torch.zeros((1, 64)), torch.zeros((4, 32), dtype=torch.int8),
                           torch.ones(4), bits=4, k=64)
    for m in (0, gk.GEMV_MAX_M + 1):
        with pytest.raises(ValueError, match="GEMV is for"):
            gk.plan(m, 64, 64)
    with pytest.raises(ValueError, match="ranges"):
        gk.plan(4, 64, gk.MAX_SPLIT * gk.MAX_UNITS * gk.UNIT + 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", (2, 4, 6, 8))
def test_a_channels_mirror_value_does_not_depend_on_m_or_n(bits, dtype):
    k, n = 700, 130
    packed, scale = (torch.from_numpy(a) for a in _weights(bits, k, n, seed=bits))
    x = torch.from_numpy(np.random.default_rng(bits + 1).normal(size=(8, k))
                         .astype(np.float32)).to(dtype)
    full = quant_gemv_mirror(x, packed, scale, bits, k)
    view = torch.int16 if dtype is torch.bfloat16 else torch.int32
    for m in range(1, 8):
        assert torch.equal(quant_gemv_mirror(x[:m], packed, scale, bits, k).view(view),
                           full[:m].view(view))
    for n1 in (1, 16, 17, 129):
        part = quant_gemv_mirror(x, packed[:n1], scale[:, :n1], bits, k, rows=7)
        assert torch.equal(part.view(view), full[:, :n1].view(view))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ("xla", "interpret"))
@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_mirror_matches_jax(m, k, n, bits, impl, dtype):
    packed, scale = _weights(bits, k, n, seed=bits * 13 + k)
    x = np.random.default_rng(m + k + bits).normal(size=(m, k)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype is torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x).astype(jdt)
    if impl == "interpret":
        # the Pallas kernel's K block must divide K: one block where 512 does not
        ref = quant_gemv_pallas(jx, jnp.asarray(packed), jnp.asarray(scale), bits=bits, k=k,
                                bk=512 if k % 512 == 0 else k, interpret=True)
    else:
        ref = jquant_gemv(jx, jnp.asarray(packed), jnp.asarray(scale), bits, k, impl="xla")
    out = quant_gemv_mirror(torch.from_numpy(x).to(dtype), torch.from_numpy(packed),
                            torch.from_numpy(scale), bits, k)
    assert out.shape == (m, n) and out.dtype == dtype
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_mirror_matches_plain(m, k, n, bits, dtype):
    packed, scale = (torch.from_numpy(a) for a in _weights(bits, k, n, seed=bits + k))
    x = torch.from_numpy(np.random.default_rng(m * k).normal(size=(m, k))
                         .astype(np.float32)).to(dtype)
    out = quant_gemv_mirror(x, packed, scale, bits, k)
    ref = quant_gemv_ref(x, packed, scale, bits, k)
    assert _rel(out.float().numpy(), ref.float().numpy()) <= TOL[dtype]
