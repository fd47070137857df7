"""ctypes binding of the CUDA GEMM (``csrc/quant_matmul.cu``), M > GEMV_MAX_M.

The launch is planned here, in Python, so that the CPU tests can check it:
the token tile (wgmma's N), the warpgroups per block (64 output channels
each) and the split of K over a thread-block cluster.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.quant_gemv.kernel import check_expert_operands, check_operands

#: K values per pipeline step (one 128-byte swizzled bf16 row of the x tile)
K_STEP = 64
#: output channels per warpgroup (wgmma's M)
CHANNELS = 64
#: token tile widths (wgmma's N) by activation type; f32 runs three products
TOKEN_TILES = {torch.bfloat16: (32, 64, 128, 256), torch.float32: (32, 64)}
#: the most CTAs of one cluster (the portable limit), and the fewest K steps a split keeps
MAX_SPLIT = 8
MIN_SPLIT_STEPS = 8
#: streaming multiprocessors of an H100 SXM: the work units a split aims to reach
SMS = 132
#: widest token tile whose CTA can walk several K ranges (a second accumulator set)
FOLD_MAX_TOKENS = 128
#: K steps of a range from which a cluster sums the ranges even with many output
#: tiles: its partials' exchange is then paid over enough steps, and its tile
#: can be the widest (measured on the H100: w_down at M = 2560)
CLUSTER_MIN_STEPS = 16


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """One launch of the GEMM: grid ``(ceil(N/channels), experts * ceil(M/nt),
    cluster)``, the experts of a stack folded into y (1 for a 2-D weight).

    K is cut into ``splits`` ranges (``k_ranges``), each summed from zero and
    added in order.  ``cluster == splits``: a thread-block cluster of that
    many CTAs, rank r summing range r; ``cluster == 1``: each CTA walks the
    ranges itself.  The two give the same bits.
    """

    m: int
    n: int
    k: int
    nt: int          # token rows per block (wgmma N)
    wgs: int         # warpgroups per block
    splits: int      # K ranges
    cluster: int     # CTAs of a cluster: 1 or splits
    experts: int = 1

    @property
    def channels(self) -> int:
        return CHANNELS * self.wgs

    @property
    def grid(self) -> tuple[int, int, int]:
        return (-(-self.n // self.channels), self.experts * -(-self.m // self.nt),
                self.cluster)

    @property
    def units(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def k_ranges(self) -> list[tuple[int, int]]:
        """The K range ``[k0, k1)`` of each split, as the kernel cuts it."""
        nk = -(-self.k // K_STEP)
        cuts = [s * nk // self.splits for s in range(self.splits + 1)]
        return [(min(a * K_STEP, self.k), min(b * K_STEP, self.k))
                for a, b in zip(cuts, cuts[1:])]


def split_of(n: int, k: int) -> int:
    """The K split: the least power of two that gives the 64-channel tiles
    one wave on the SMs, at most ``MAX_SPLIT`` and at least
    ``MIN_SPLIT_STEPS`` K steps a split.  It depends on N and K alone, never
    on M, so the sum order of an output (and so its value) does not depend
    on how many rows share the call: engines that admit the same prompt in
    different batches (paged under backpressure) get the same bits.
    """
    tiles, nk, s = -(-n // CHANNELS), -(-k // K_STEP), 1
    while s < MAX_SPLIT and tiles * s < SMS and nk // (2 * s) >= MIN_SPLIT_STEPS:
        s *= 2
    return s


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int, dtype: torch.dtype, experts: int = 1) -> MatmulPlan:
    """The launch for ``(M, K) x (N, K)``, or ``experts`` of them in one launch.

    The narrowest token tile that holds M (the widest walks M in tiles);
    two warpgroups (128 channels) for bf16 x, one for f32 x, whose split
    pieces take the shared memory.  The K ranges go to a cluster while the
    output tiles alone leave SMs idle, or while each range is long; else
    each CTA walks its ranges (at most 128 tokens then, for the running
    sum's registers).  The experts count toward the output tiles; the split
    stays the 2-D one, so an expert's outputs are the 2-D launch's.
    """
    if dtype not in TOKEN_TILES:
        raise TypeError(f"quant_matmul: the CUDA kernel takes float32 or bfloat16, got {dtype}")
    tiles = TOKEN_TILES[dtype]
    nt = next((t for t in tiles if t >= m), tiles[-1])
    wgs = 2 if dtype is torch.bfloat16 else 1
    splits = split_of(n, k)
    cluster = 1
    if splits > 1:
        steps = -(-k // K_STEP) // splits
        units = experts * -(-m // nt) * -(-n // (CHANNELS * wgs))
        if units < SMS or steps >= CLUSTER_MIN_STEPS:
            cluster = splits
        else:
            nt = min(nt, FOLD_MAX_TOKENS)
    return MatmulPlan(m, n, k, nt, wgs, splits, cluster, experts)


def quant_matmul_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                      bits: int, k: int, launch: MatmulPlan | None = None) -> torch.Tensor:
    """``(M, K)`` x against packed ``(N, ceil(K/lanes))`` -> ``(M, N)`` in x's dtype.

    ``launch`` replaces ``plan(M, N, K, dtype)``, to compare two plans of the
    same shape (the split modes give the same bits).
    """
    x = x.contiguous()
    m, n = check_operands(x, packed, scale, bits, k, "quant_matmul")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    p = launch or plan(m, n, k, x.dtype)
    if (p.m, p.n, p.k) != (m, n, k):
        raise ValueError(f"quant_matmul: a plan for {(p.m, p.n, p.k)} given for {(m, n, k)}")
    rc = _build.lib().rq_quant_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
        packed.shape[1], bits, _build.dtype_code(x, "quant_matmul"), p.nt, p.wgs, p.splits,
        p.cluster, _build.stream_of(x))
    LAUNCHES["quant_matmul"] += 1
    _build.check(rc, "quant_matmul")
    return y


def quant_matmul_experts_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                              bits: int, k: int,
                              launch: MatmulPlan | None = None) -> torch.Tensor:
    """``(E, C, K)`` x against packed ``(E, N, ceil(K/lanes))`` -> ``(E, C, N)`` in x's
    dtype, one launch for all E; the scale broadcasts to ``(E, 1, N)``.

    ``launch`` replaces ``plan(C, N, K, dtype, E)``.
    """
    x = x.contiguous()
    e, c, n, sstride = check_expert_operands(x, packed, scale, bits, k, "quant_matmul_experts")
    y = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if c == 0:
        return y
    p = launch or plan(c, n, k, x.dtype, e)
    if (p.m, p.n, p.k, p.experts) != (c, n, k, e):
        raise ValueError(f"quant_matmul_experts: a plan for {(p.experts, p.m, p.n, p.k)} "
                         f"given for {(e, c, n, k)}")
    rc = _build.lib().rq_quant_matmul_experts(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), e, c, n, k,
        packed.shape[2], bits, _build.dtype_code(x, "quant_matmul_experts"), p.nt, p.wgs,
        p.splits, p.cluster, sstride, _build.stream_of(x))
    LAUNCHES["quant_matmul_experts"] += 1
    _build.check(rc, "quant_matmul_experts")
    return y
