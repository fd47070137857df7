"""The CUDA GEMM's launch plan and arithmetic, on the CPU.

``kernels/quant_matmul/kernel.py`` plans each launch in Python (token tile,
warpgroups, K split, cluster) and ``csrc/quant_matmul.cu`` runs it on the
card, where the CPU cannot follow.  These tests hold what the CPU can check:
that every plan covers each output once and cuts K where the kernel can cut
it, that the split does not depend on M (so a row's bits do not either), and
that the kernel's arithmetic, mirrored in ``ref.quant_matmul_mirror`` (bf16
levels, f32 x as three exact bf16 pieces, f32 sums per K range and for f32 x
per K step, the scale last), agrees with the JAX package's ``quant_matmul`` (impl "xla" and
"interpret") on the same seeded numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul.ops import quant_matmul as jquant_matmul
from repro.quant.tensor import quantize_tensor as jquantize_tensor
from repro_torch.core.packing import LANES
from repro_torch.kernels.quant_matmul import kernel as qk
from repro_torch.kernels.quant_matmul.ref import quant_matmul_mirror, split_f32

torch.set_num_threads(2)

#: gemma-2b's fused linears (N, K) and the row counts the serving paths give the GEMM
GEMMA = {"wqkv": (2560, 2048), "wo": (2048, 2048), "w_gu": (32768, 2048),
         "w_down": (2048, 16384)}
MS = (9, 32, 33, 128, 256, 257, 2560, 6144)
#: the card tests' ragged shapes (N, K) and the reduced wqkv's
RAGGED = {"n17k37": (17, 37), "n70k130": (70, 130), "n192k2048": (192, 2048),
          "n75k130": (75, 130)}
DTYPES = (torch.bfloat16, torch.float32)


def _tiles(extent: int, width: int, count: int) -> np.ndarray:
    """How many of ``count`` tiles of ``width`` cover each index of [0, extent)."""
    cover = np.zeros(extent, np.int64)
    for i in range(count):
        cover[i * width:min((i + 1) * width, extent)] += 1
    return cover


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", [*GEMMA, *RAGGED])
def test_plan_covers_every_output_once(name, m, dtype):
    n, k = {**GEMMA, **RAGGED}[name]
    p = qk.plan(m, n, k, dtype)
    assert p.nt in qk.TOKEN_TILES[dtype]
    assert p.wgs == (2 if dtype is torch.bfloat16 else 1)
    assert p.cluster in (1, p.splits) and 1 <= p.splits <= qk.MAX_SPLIT
    if p.cluster == 1 and p.splits > 1:       # a CTA walking its ranges keeps a running sum
        assert p.nt <= qk.FOLD_MAX_TOKENS
    gx, gy, gz = p.grid
    assert gz == p.cluster
    # the grid's channel tiles x token tiles partition the (N, M) output
    assert (_tiles(n, p.channels, gx) == 1).all()
    assert (_tiles(m, p.nt, gy) == 1).all()
    # no tile lies wholly outside the output
    assert (gx - 1) * p.channels < n and (gy - 1) * p.nt < m


@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("name", [*GEMMA, *RAGGED])
def test_k_ranges_partition_k_at_whole_steps(name, bits):
    n, k = {**GEMMA, **RAGGED}[name]
    splits = {qk.plan(m, n, k, dt).splits for m in MS for dt in DTYPES}
    assert splits == {qk.split_of(n, k)}           # the split never depends on M
    p = qk.plan(32, n, k, torch.bfloat16)
    ranges = p.k_ranges()
    assert len(ranges) == p.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 < k1                              # no empty range
        assert k0 % qk.K_STEP == 0 and k0 % LANES[bits] == 0
        assert (k1 - k0) >= min(k, qk.K_STEP)
    # each range starts a whole number of packed bytes into the row
    assert all(k0 // LANES[bits] * LANES[bits] == k0 for k0, _ in ranges)


def test_small_m_plans_fill_the_card():
    """At M = 32 (the verify pass) w_down gives 16 tiles of 128 channels; its
    split of 8, the most CTAs a portable cluster holds, makes 128 work units
    for the 132 SMs (one wave, 4 SMs idle).  A wider split would need a
    non-portable cluster size, and narrower tiles would read x twice as often
    from L2."""
    n, k = GEMMA["w_down"]
    p = qk.plan(32, n, k, torch.bfloat16)
    assert p.splits == qk.MAX_SPLIT and p.cluster == p.splits
    assert p.units == 16 * qk.MAX_SPLIT == 128
    assert p.units >= qk.SMS or p.splits == qk.MAX_SPLIT
    for name in ("wqkv", "wo"):
        q = qk.plan(32, *GEMMA[name], torch.bfloat16)
        assert q.splits == 4 and q.cluster == 4    # 8 K steps a range at K = 2048
    assert qk.plan(32, *GEMMA["w_gu"], torch.bfloat16).units == 256
    # with many output tiles the short ranges stay inside each CTA; w_down's
    # 32-step ranges still go to a cluster, at the widest token tile
    for name, (n, k) in GEMMA.items():
        q = qk.plan(2560, n, k, torch.bfloat16)
        assert q.units >= qk.SMS, name
        long = q.splits > 1 and -(-k // qk.K_STEP) // q.splits >= qk.CLUSTER_MIN_STEPS
        assert q.cluster == (q.splits if long else 1), name
    assert qk.plan(2560, *GEMMA["w_down"], torch.bfloat16).nt == 256


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qk.plan(32, 64, 64, torch.float16)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_three_bf16_pieces_reconstruct_f32_exactly(seed):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-30, 30, size=4096)
    x = (rng.normal(size=4096) * mag).astype(np.float32)
    # zeros, powers of two, the largest and smallest magnitudes whose pieces
    # stay normal (below about 2^-110 the lo piece is subnormal in bf16)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 2.0 ** -126, 3.0e38, -1.5e-33, 0.1]
    xt = torch.from_numpy(x)
    hi, mid, lo = split_f32(xt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(back, xt)
    # each piece is exact in bf16 and their products with a level are exact in f32
    lev = torch.arange(-128, 128, dtype=torch.float32)
    for piece in (hi, mid, lo):
        p = piece[8:264]                            # |x| <= 1e30: no product overflows
        assert torch.equal((p.float() * lev).double(), p.double() * lev.double())


def _weights(bits, k, n, seed):
    w = (np.random.default_rng(seed).normal(size=(k, n)) * 0.05).astype(np.float32)
    qt = jquantize_tensor(jnp.asarray(w), bits)
    return np.array(qt.packed), np.array(qt.scale).reshape(1, -1)


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ("xla", "interpret"))
@pytest.mark.parametrize("bits", (2, 4, 6, 8))
@pytest.mark.parametrize("m,k,n,splits", [(9, 256, 48, 1), (33, 512, 128, 2),
                                          (40, 1024, 256, 4)])
def test_kernel_arithmetic_mirror_matches_jax(m, k, n, splits, bits, impl, dtype):
    packed, scale = _weights(bits, k, n, seed=bits * 11 + m)
    x = np.random.default_rng(m + bits).normal(size=(m, k)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype is torch.bfloat16 else jnp.float32
    ref = jquant_matmul(jnp.asarray(x).astype(jdt), jnp.asarray(packed), jnp.asarray(scale),
                        bits, k, impl=impl)
    xt = torch.from_numpy(x).to(dtype)
    out = quant_matmul_mirror(xt, torch.from_numpy(packed), torch.from_numpy(scale), bits, k,
                              splits=splits)
    assert out.shape == (m, n) and out.dtype == dtype
    tol = 1e-5 if dtype is torch.float32 else 2e-2
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) <= tol
