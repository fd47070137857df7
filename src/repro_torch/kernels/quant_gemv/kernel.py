"""ctypes binding of the CUDA GEMV (``csrc/quant_gemv.cu``), M <= GEMV_MAX_M.

The launch is planned here, in Python, so that the CPU tests can check it
(:func:`plan`): 128 output channels a tile, as many tiles a CTA as keep one
wave of CTAs on the card (an expert stack's spread evenly over N), and K
cut into ranges by K alone, the ranges of a CTA's channels on the CTAs of
one cluster.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.packing import LANES
from repro_torch.kernels import LAUNCHES, _build

#: largest M served by the GEMV (the decode regime)
GEMV_MAX_M = 8
#: output channels of one tile (8 warps x the 16 rows of an mma tile)
CHANNELS = 128
#: the most tiles of one CTA, and the CTAs that fill the card once (two a
#: streaming multiprocessor of an H100, as the kernel's registers allow)
MAX_TILES = 8
WAVE = 256
#: K values of one unit: the K ranges are whole units
UNIT = 256
#: ranges K is cut into: SPLIT below LONG_UNITS units of K, MAX_SPLIT from there
SPLIT = 8
LONG_UNITS = 64
#: the most ranges (CTAs of a cluster, above 8 the non-portable size) and the
#: most units of one range (its x staging in shared memory)
MAX_SPLIT = 16
MAX_UNITS = 16


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """One launch of the GEMV: grid ``(splits, ceil(N / (CHANNELS * tiles)))``.

    K is cut into ``splits`` ranges of whole units (:meth:`k_ranges`); rank
    r of a cluster of ``splits`` CTAs sums range r for its ``tiles`` tiles
    of channels from zero, and the ranges' sums are added from zero in
    range order.  ``tiles`` only spreads the channels over CTAs: it does
    not move a channel's bits.
    """

    m: int
    n: int
    k: int
    splits: int
    tiles: int
    #: weights of an expert stack, one on each z of the grid (1: a 2-D weight)
    experts: int = 1

    @property
    def grid(self) -> tuple[int, int]:
        """One expert's grid; an expert stack runs it ``experts`` times on z."""
        return (self.splits, -(-self.n // (CHANNELS * self.tiles)))

    def k_ranges(self) -> list[tuple[int, int]]:
        """The K range ``[k0, k1)`` of each split, as the kernel cuts it."""
        return k_ranges(self.k, self.splits)


def k_ranges(k: int, splits: int) -> list[tuple[int, int]]:
    units = -(-k // UNIT)
    return [(min(s * units // splits * UNIT, k), min((s + 1) * units // splits * UNIT, k))
            for s in range(splits)]


def split_of(k: int) -> int:
    """The K split: ``SPLIT`` ranges (fewer where K has fewer units), and
    ``MAX_SPLIT`` from ``LONG_UNITS`` units on (gemma-2b's w_down, K 16384:
    its 16 tiles then make 256 CTAs, two an SM, where 8 ranges left one CTA
    an SM with too few warps to hide the mma and load latency), more where
    a range would exceed ``MAX_UNITS`` units.  It depends on K alone, so a
    channel's sum order, and so its value, does not depend on M, N or which
    kernel asks (row 8 walks the same ranges)."""
    units = -(-k // UNIT)
    s = min(SPLIT, units) if units < LONG_UNITS else MAX_SPLIT
    while -(-units // s) > MAX_UNITS:
        s += 1
    if s > MAX_SPLIT:
        raise ValueError(f"quant_gemv: K={k} needs more than {MAX_SPLIT} ranges of "
                         f"{MAX_UNITS * UNIT} values")
    return s


def tiles_of(n: int, splits: int, experts: int = 1) -> int:
    """Tiles a CTA takes: doubled while the CTAs (of all ``experts``) still
    make a wave (``WAVE``), at most ``MAX_TILES``.  A CTA pays its launch, its first
    load and its cluster's barriers once, so the widest linears (gemma-2b's
    w_gu: 256 tiles x 8 ranges) take 8 tiles a CTA and stream without
    stopping; the narrow ones keep one tile a CTA, to fill the card."""
    tiles, t = -(-n // CHANNELS), 1
    while t < MAX_TILES and -(-tiles // (2 * t)) * splits * experts >= WAVE:
        t *= 2
    return t


def expert_tiles(n: int, k: int, experts: int) -> int:
    """Tiles a CTA takes in an expert stack: :func:`tiles_of` over all the
    experts' CTAs, then spread evenly, N's tiles cut into as many blocks as
    that gives, equal as whole tiles allow (deepseek-moe-16b's w_gate, N 1408
    = 11 tiles: 6 + 5, not 8 + 3; w_down, N 2048: 8 + 8), chosen by device
    time over tiles 1-8 on the routed decode buffer and on dense x
    (``tools/gemv_times.py --tiles``, PERF.md section 6).  The tiles do not
    move a channel's bits."""
    n_tiles = -(-n // CHANNELS)
    blocks = -(-n_tiles // tiles_of(n, split_of(k), experts))
    return -(-n_tiles // blocks)

@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int, experts: int = 1) -> GemvPlan:
    """The launch for ``(M, K) x (N, K)``, or ``experts`` of them in one
    launch; its split is :func:`split_of` (K alone, so an expert's outputs
    are the 2-D launch's), its tiles a CTA :func:`tiles_of` (N and the
    split) for a 2-D weight and :func:`expert_tiles` for a stack."""
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"GEMV is for 1 <= M <= {GEMV_MAX_M}, got M={m}")
    if experts < 1:
        raise ValueError(f"GEMV: {experts} experts")
    splits = split_of(k)
    if experts == 1:
        return GemvPlan(m, n, k, splits, tiles_of(n, splits))
    return GemvPlan(m, n, k, splits, expert_tiles(n, k, experts), experts)


def check_operands(x, packed, scale, bits: int, k: int, name: str) -> tuple[int, int]:
    """Validate the shared GEMV/GEMM operands; returns ``(M, N)``."""
    _build.require(x, f"{name}: x")
    _build.dtype_code(x, name)
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"{name}: x must be (M, {k}), got {tuple(x.shape)}")
    n = packed.shape[0]
    _build.require(packed, f"{name}: packed", dtype=torch.int8,
                   shape=(n, -(-k // LANES[bits])), device=x.device)
    _build.require(scale, f"{name}: scale", dtype=torch.float32, device=x.device)
    if scale.numel() != n:
        raise ValueError(f"{name}: scale has {scale.numel()} entries for N={n}")
    return x.shape[0], n


def quant_gemv_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                    bits: int, k: int) -> torch.Tensor:
    """``(M, K)`` x against packed ``(N, ceil(K/lanes))`` -> ``(M, N)`` in x's dtype."""
    x = x.contiguous()
    m, n = check_operands(x, packed, scale, bits, k, "quant_gemv")
    p = plan(m, n, k)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _build.lib().rq_quant_gemv(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
        packed.shape[1], bits, _build.dtype_code(x, "quant_gemv"), p.splits, p.tiles,
        _build.stream_of(x))
    LAUNCHES["quant_gemv"] += 1
    _build.check(rc, "quant_gemv")
    return y


def scale_stride(scale: torch.Tensor, e: int, n: int, name: str) -> int:
    """Floats between two experts' scales: 0 for one scale per channel shared
    by the stack (``(1, 1, N)``, as a stacked ``quantize_tensor`` gives it),
    N for one per expert (``(E, 1, N)``)."""
    if scale.numel() == n:
        return 0
    if scale.numel() == e * n and scale.shape[0] == e:
        return n
    raise ValueError(f"{name}: scale of shape {tuple(scale.shape)} does not broadcast to "
                     f"({e}, 1, {n})")


def check_expert_operands(x, packed, scale, bits: int, k: int, name: str):
    """Validate an expert stack's operands; returns ``(E, C, N, sstride)``."""
    _build.require(x, f"{name}: x")
    _build.dtype_code(x, name)
    if x.ndim != 3 or x.shape[2] != k:
        raise ValueError(f"{name}: x must be (E, C, {k}), got {tuple(x.shape)}")
    e, c = x.shape[0], x.shape[1]
    if packed.ndim != 3 or packed.shape[0] != e:
        raise ValueError(f"{name}: packed must be ({e}, N, kp), got {tuple(packed.shape)}")
    n = packed.shape[1]
    _build.require(packed, f"{name}: packed", dtype=torch.int8,
                   shape=(e, n, -(-k // LANES[bits])), device=x.device)
    _build.require(scale, f"{name}: scale", dtype=torch.float32, device=x.device)
    return e, c, n, scale_stride(scale, e, n, name)


def quant_gemv_experts_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                            bits: int, k: int, launch: GemvPlan | None = None) -> torch.Tensor:
    """``(E, C, K)`` x against packed ``(E, N, ceil(K/lanes))`` -> ``(E, C, N)`` in x's
    dtype, C <= GEMV_MAX_M, one launch for all E; the scale broadcasts to ``(E, 1, N)``.
    An expert whose rows of x are all zero reads none of its weights.  ``launch``
    runs a plan of the caller's own (other tiles: the same bits)."""
    x = x.contiguous()
    e, c, n, sstride = check_expert_operands(x, packed, scale, bits, k, "quant_gemv_experts")
    p = plan(c, n, k, e)
    if launch is not None:
        if (launch.m, launch.n, launch.k, launch.experts, launch.splits) != (
                c, n, k, e, p.splits):
            raise ValueError(f"quant_gemv_experts: launch {launch} is not a plan of "
                             f"({e}, {c}, {k}) x ({e}, {n}, {k})")
        p = launch
    y = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    rc = _build.lib().rq_quant_gemv_experts(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), e, c, n, k,
        packed.shape[2], bits, _build.dtype_code(x, "quant_gemv_experts"), p.splits, p.tiles,
        sstride, _build.stream_of(x))
    LAUNCHES["quant_gemv_experts"] += 1
    _build.check(rc, "quant_gemv_experts")
    return y
