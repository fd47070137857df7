"""ctypes binding of the CUDA GEMM (``csrc/quant_matmul.cu``), M > GEMV_MAX_M, and of
its expert stack (``csrc/quant_matmul_experts.cu``).

The launch is planned here, in Python, so that the CPU tests can check it:
the token tile (wgmma's N), the warpgroups per block (64 output channels
each) and the split of K over a thread-block cluster; for the expert stack
in bf16, the persistent kernel's token tile, CTA count and tile list.
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
#: the expert stack's persistent kernel (bf16 x): its token tiles (wgmma N), and
#: the token tiles up to which a tile is 256 channels (two consumer warpgroups
#: of two 64-channel blocks each), not 128
EXPERT_TOKEN_TILES = (16, 32, 64, 128)
EXPERT_WIDE_TOKENS = 32


def k_ranges(k: int, splits: int) -> list[tuple[int, int]]:
    """The K range ``[k0, k1)`` of each of ``splits`` ranges, as the kernels cut them."""
    nk = -(-k // K_STEP)
    cuts = [s * nk // splits for s in range(splits + 1)]
    return [(min(a * K_STEP, k), min(b * K_STEP, k)) for a, b in zip(cuts, cuts[1:])]


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
        return k_ranges(self.k, self.splits)


@dataclasses.dataclass(frozen=True)
class ExpertPlan:
    """One launch of the expert stack's persistent kernel (bf16 x): ``ctas``
    CTAs walk the list of ``tiles``, CTA b taking tiles b, b + ctas, ...

    A tile is (expert, token tile of ``nt`` rows, channel tile of
    ``channels``), channel tiles fastest within an expert's token tile.
    Every tile sums the 2-D plan's ``splits`` K ranges in order, so an
    expert's outputs are the 2-D launch's bytes whatever ``ctas``.
    """

    experts: int
    m: int
    n: int
    k: int
    nt: int
    splits: int
    ctas: int

    @property
    def channels(self) -> int:
        """Output channels of a tile: 256 at the narrow token tiles, else 128."""
        return 4 * CHANNELS if self.nt <= EXPERT_WIDE_TOKENS else 2 * CHANNELS

    @property
    def token_tiles(self) -> int:
        return -(-self.m // self.nt)

    @property
    def channel_tiles(self) -> int:
        return -(-self.n // self.channels)

    @property
    def tiles(self) -> int:
        return self.experts * self.token_tiles * self.channel_tiles

    def tile(self, t: int) -> tuple[int, int, int]:
        """Tile ``t`` of the list as (expert, token tile, channel tile)."""
        rest, ct = divmod(t, self.channel_tiles)
        ex, mt = divmod(rest, self.token_tiles)
        return ex, mt, ct

    def walk(self, cta: int) -> list[tuple[int, int, int]]:
        """The tiles CTA ``cta`` sums, in its order."""
        return [self.tile(t) for t in range(cta, self.tiles, self.ctas)]

    def k_ranges(self) -> list[tuple[int, int]]:
        return k_ranges(self.k, self.splits)


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


@functools.lru_cache(maxsize=256)
def expert_plan(m: int, n: int, k: int, experts: int, sms: int = SMS) -> ExpertPlan:
    """The persistent launch for ``experts`` stacks of ``(M, K) x (N, K)`` in
    bf16: the narrowest token tile that holds M (the widest, 128, walks M in
    tiles), so that a tile at C <= 16 reads only its expert's rows; tiles of
    256 channels up to 32 tokens, 128 above; the 2-D split of K; one CTA an
    SM, or one a tile where the tiles are fewer."""
    nt = next((t for t in EXPERT_TOKEN_TILES if t >= m), EXPERT_TOKEN_TILES[-1])
    p = ExpertPlan(experts, m, n, k, nt, split_of(n, k), 1)
    return dataclasses.replace(p, ctas=min(p.tiles, sms))


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
                              launch: MatmulPlan | ExpertPlan | None = None) -> torch.Tensor:
    """``(E, C, K)`` x against packed ``(E, N, ceil(K/lanes))`` -> ``(E, C, N)`` in x's
    dtype, one launch for all E; the scale broadcasts to ``(E, 1, N)``.

    bf16 x runs the persistent kernel on ``expert_plan(C, N, K, E, SMs)``; f32
    x runs the 2-D GEMM's kernel on ``plan(C, N, K, dtype, E)``.  ``launch``
    replaces the plan (an ``ExpertPlan`` for bf16, a ``MatmulPlan`` for f32).
    """
    x = x.contiguous()
    e, c, n, sstride = check_expert_operands(x, packed, scale, bits, k, "quant_matmul_experts")
    y = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if c == 0:
        return y
    code = _build.dtype_code(x, "quant_matmul_experts")
    if x.dtype is torch.bfloat16:
        p = launch or expert_plan(c, n, k, e, sm_count(x.device.index))
        if not isinstance(p, ExpertPlan):
            raise TypeError("quant_matmul_experts: bf16 x takes an ExpertPlan")
        nt, wgs, splits, cluster, ctas = p.nt, p.channels // CHANNELS, p.splits, 1, p.ctas
    else:
        p = launch or plan(c, n, k, x.dtype, e)
        if not isinstance(p, MatmulPlan):
            raise TypeError("quant_matmul_experts: f32 x takes a MatmulPlan")
        nt, wgs, splits, cluster, ctas = p.nt, p.wgs, p.splits, p.cluster, 0
    if (p.m, p.n, p.k, p.experts) != (c, n, k, e):
        raise ValueError(f"quant_matmul_experts: a plan for {(p.experts, p.m, p.n, p.k)} "
                         f"given for {(e, c, n, k)}")
    rc = _build.lib().rq_quant_matmul_experts(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), e, c, n, k,
        packed.shape[2], bits, code, nt, wgs, splits, cluster, ctas, sstride,
        _build.stream_of(x))
    LAUNCHES["quant_matmul_experts"] += 1
    _build.check(rc, "quant_matmul_experts")
    return y
