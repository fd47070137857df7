"""ctypes bindings of the CUDA quantized-KV kernels (``csrc/quant_kv_decode_step.cu``,
``csrc/quant_kv_dense.cu``, ``csrc/quant_kv_paged.cu``, ``csrc/quant_kv_proj.cu``).

The attention body (``csrc/quant_kv.cuh`` ``attend``) is split over S; its
launch is planned here, in Python, so that the CPU tests can check it
(:func:`attend_plan`), and so is the share of ``wqkv`` each CTA of row 8's
cluster projects (:func:`proj_tiles`, :func:`proj_row`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packing import LANES
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.quant_gemv.kernel import split_of

#: positions per chunk of the split attention (``csrc/quant_kv.cuh`` kChunk)
CHUNK = 64
#: positions per tile of a chunk's online softmax (``kTile``)
TILE = 32
#: the most CTAs one (slot, kv head) takes: a cluster of 16 (above 8 the
#: non-portable cluster size)
MAX_CLUSTER = 16
#: the fused steps: one CTA requantizes the touched block and reads it
FUSED = ("quant_kv_decode_step", "quant_kv_decode_step_paged", "quant_kv_decode_step_proj")
#: every kernel that runs the split attention body
ATTEND_KERNELS = FUSED + ("quant_kv_attention", "quant_kv_attention_paged")


@dataclasses.dataclass(frozen=True)
class AttendPlan:
    """How one (slot, kv head) of the attention body runs.

    S is cut into ``chunks`` chunks of ``chunk`` positions from position 0.
    ``cluster`` CTAs of a thread-block cluster take them, rank r the chunks
    r, r + cluster, ... in rounds (``mode == "cluster"``), or one CTA walks
    them all (``cluster == 1``, ``mode == "walk"``).  Each chunk's partial is
    folded into the result one at a time in :meth:`fold_order`, which is
    chunk order in both modes, so the two give the same bits.
    """

    s: int
    chunk: int
    cluster: int

    @property
    def chunks(self) -> int:
        return -(-self.s // self.chunk)

    @property
    def mode(self) -> str:
        return "walk" if self.cluster == 1 else "cluster"

    def grid(self, b: int, n_kv: int) -> tuple[int, int, int]:
        return (self.cluster, n_kv, b)

    def chunk_range(self, c: int) -> tuple[int, int]:
        """Positions ``[c0, c1)`` of chunk ``c``."""
        return (c * self.chunk, min((c + 1) * self.chunk, self.s))

    def rank_chunks(self, rank: int) -> list[int]:
        """The chunks rank ``rank`` computes, round by round."""
        return list(range(rank, self.chunks, self.cluster))

    def fold_order(self) -> list[int]:
        """The chunks in the order their partials are folded: round by round,
        within a round in rank order, as the kernel folds them."""
        rounds = -(-self.chunks // self.cluster)
        return [k * self.cluster + j for k in range(rounds) for j in range(self.cluster)
                if k * self.cluster + j < self.chunks]


def attend_plan(kernel: str, s: int, block: int) -> AttendPlan:
    """The launch of ``kernel``'s attention over S = ``s`` positions.

    A cluster of one CTA per chunk, at most :data:`MAX_CLUSTER`; one CTA
    walks every chunk for a fused step (rows 3, 7 and 8) whose sequence
    blocks do not each lie inside one chunk (only one CTA may requantize a
    block).  Row 8 takes row 3's rule: its ranks share the projection of
    ``wqkv`` (:func:`proj_tiles`), so a cluster reads ``wqkv`` once a slot,
    as one CTA does.  Never depends on B: the bits do not either.
    """
    if kernel not in ATTEND_KERNELS:
        raise ValueError(f"attend_plan: {kernel!r} does not run the attention body")
    cluster = min(-(-s // CHUNK), MAX_CLUSTER)
    if kernel in FUSED and CHUNK % block:
        cluster = 1
    return AttendPlan(s, CHUNK, cluster)


def walk_plan(p: AttendPlan) -> AttendPlan:
    """The same chunks walked by one CTA (the same bits as ``p``)."""
    return dataclasses.replace(p, cluster=1)


def _split(kernel: str, s: int, block: int, launch: AttendPlan | None) -> int:
    """The cluster size to launch: ``launch``'s (checked) or the plan's."""
    p = launch or attend_plan(kernel, s, block)
    if p.s != s or p.chunk != CHUNK or not 1 <= p.cluster <= min(p.chunks, MAX_CLUSTER) or (
            p.cluster > 1 and kernel in FUSED and CHUNK % block):
        raise ValueError(f"{kernel}: a plan for S={p.s} (chunk {p.chunk}, cluster "
                         f"{p.cluster}) given for S={s}, block={block}")
    return p.cluster


#: values of a touched block the requantization holds in registers (``csrc/quant_kv.cuh``
#: kReqGroups x 16 values x 256 threads)
MAX_BLOCK_VALUES = 16384


def _check_hd(name: str, hd: int, s: int, block: int) -> None:
    if hd % 16 or s % block or block * hd > MAX_BLOCK_VALUES:
        raise ValueError(f"{name}: the CUDA kernel takes hd % 16 == 0 (whole 4-byte packed "
                         f"words), S % block == 0 and block * hd <= {MAX_BLOCK_VALUES}, got "
                         f"hd={hd}, S={s}, block={block}")


def _require_pool(prefix, packed, scale, bits, *, hd, block, n_kv, dev) -> None:
    p = packed.shape[0]
    _build.require(packed, f"{prefix}pool", dtype=torch.int8,
                   shape=(p, n_kv, block, -(-hd // LANES[bits])), device=dev)
    _build.require(scale, f"{prefix}scale", dtype=torch.float32, shape=(p, n_kv, 1, 1),
                   device=dev)


def quant_kv_decode_step_cuda(pos, q, k_new, v_new, k_packed, k_scale, v_packed, v_scale,
                              mask, *, k_bits: int, v_bits: int, hd: int, block: int,
                              launch: AttendPlan | None = None) -> torch.Tensor:
    """One launch: requantize the touched block, then attend, split over S.

    ``pos`` (B,) int32; ``q`` (B, n_kv, g, hd); ``k_new``/``v_new``
    (B, n_kv, hd) in q's dtype; packed ``(B, n_kv, S, hd/lanes)`` int8 and
    scales ``(B, n_kv, S/block, 1)`` f32, WRITTEN IN PLACE (the touched block
    and its scale); ``mask`` (B, S) f32 additive.  Returns (B, n_kv, g, hd) f32.
    ``launch`` replaces :func:`attend_plan`'s (both modes give the same bits).
    """
    b, n_kv, g, _ = q.shape
    s = k_packed.shape[2]
    dev = q.device
    _check_hd("quant_kv_decode_step", hd, s, block)
    csize = _split("quant_kv_decode_step", s, block, launch)
    code = _build.dtype_code(q, "quant_kv_decode_step")
    _build.require(q, "q", shape=(b, n_kv, g, hd))
    _build.require(pos, "pos", dtype=torch.int32, shape=(b,), device=dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _build.require(t, name, dtype=q.dtype, shape=(b, n_kv, hd), device=dev)
    for name, t, bits in (("k", k_packed, k_bits), ("v", v_packed, v_bits)):
        _build.require(t, f"{name}_packed", dtype=torch.int8,
                       shape=(b, n_kv, s, -(-hd // LANES[bits])), device=dev)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _build.require(t, name, dtype=torch.float32, shape=(b, n_kv, s // block, 1),
                       device=dev)
    _build.require(mask, "mask", dtype=torch.float32, shape=(b, s), device=dev)
    out = torch.empty((b, n_kv, g, hd), dtype=torch.float32, device=dev)
    rc = _build.lib().rq_quant_kv_decode_step(
        pos.data_ptr(), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_packed.data_ptr(), k_scale.data_ptr(), v_packed.data_ptr(), v_scale.data_ptr(),
        mask.data_ptr(), out.data_ptr(), b, n_kv, g, s, hd, block, k_bits, v_bits, csize, code,
        _build.stream_of(q))
    LAUNCHES["quant_kv_decode_step"] += 1
    _build.check(rc, "quant_kv_decode_step")
    return out


#: the projection-fused step's batch limit (the GEMV regime, as the JAX gate's B <= 8)
PROJ_MAX_B = 8
#: rows of one projection tile: one ``mma.sync`` A tile (``csrc/quant_gemv.cuh`` kGemvTileRows)
PROJ_TILE = 16


def proj_row(r: int, h: int, n_heads: int, n_kv: int, hd: int) -> int:
    """The ``wqkv`` row of kv head ``h``'s projected row ``r``: its query group's
    g * hd rows, then its K head's hd rows, then its V head's (the Pallas
    BlockSpecs' slices; ``csrc/quant_kv_proj.cu`` ``proj_row``)."""
    qr = n_heads // n_kv * hd
    if r < qr:
        return h * qr + r
    if r < qr + hd:
        return (n_heads + h) * hd + r - qr
    return (n_heads + n_kv + h) * hd + r - qr - hd


def proj_tiles(n_heads: int, n_kv: int, hd: int, cluster: int, rank: int) -> range:
    """The 16-row tiles of a (slot, kv head)'s (g + 2) * hd projected rows that
    rank ``rank`` of a ``cluster``-CTA cluster projects: tiles ``[rank * T //
    cluster, (rank + 1) * T // cluster)`` of T, so the ranks share them
    whole and in order, every tile on one rank (a rank may have none where
    T < cluster).  Tile t's owner is ``((t + 1) * cluster - 1) // T``."""
    tiles = (n_heads // n_kv + 2) * hd // PROJ_TILE
    return range(rank * tiles // cluster, (rank + 1) * tiles // cluster)


def quant_kv_decode_step_proj_cuda(pos, x, w_packed, w_scale, cos, sin, k_packed, k_scale,
                                   v_packed, v_scale, mask, *, w_bits: int, k_bits: int,
                                   v_bits: int, n_heads: int, hd: int, block: int,
                                   launch: AttendPlan | None = None) -> torch.Tensor:
    """One cluster of ``attend_plan``'s size per (slot, kv head): each rank
    projects its :func:`proj_tiles` of the query group and the K/V rows from
    the fused ``wqkv`` (the GEMV's arithmetic over its K ranges,
    ``quant_gemv.kernel.split_of(d)``), the ranks exchange the rows, the rank
    holding ``pos`` requantizes the touched block, and all attend, split over
    S as row 3 does.

    ``pos`` (B,) int32, B <= 8; ``x`` (B, d) f32; ``w_packed``
    ((n_heads + 2 n_kv) hd, d/lanes) int8 and ``w_scale`` (1, that) f32;
    ``cos``/``sin`` (B, hd/2) f32 at ``pos``; packed ``(B, n_kv, S, hd/lanes)``
    int8 and scales ``(B, n_kv, S/block, 1)`` f32, WRITTEN IN PLACE (the
    touched block and its scale); ``mask`` (B, S) f32 additive.  Returns
    (B, n_kv, g, hd) f32.  ``launch`` as in :func:`quant_kv_decode_step_cuda`.
    """
    b, d = x.shape
    n_kv, s = k_packed.shape[1], k_packed.shape[2]
    dev = x.device
    _check_hd("quant_kv_decode_step_proj", hd, s, block)
    csize = _split("quant_kv_decode_step_proj", s, block, launch)
    if x.dtype != torch.float32:
        raise TypeError(f"quant_kv_decode_step_proj: the CUDA kernel takes float32 x, "
                        f"got {x.dtype}")
    if not 1 <= b <= PROJ_MAX_B or n_heads % n_kv or d % LANES[w_bits]:
        raise ValueError(f"quant_kv_decode_step_proj: needs 1 <= B <= {PROJ_MAX_B}, n_heads % "
                         f"n_kv == 0 and d % lanes == 0, got B={b}, n_heads={n_heads}, "
                         f"n_kv={n_kv}, d={d}, w_bits={w_bits}")
    n = (n_heads + 2 * n_kv) * hd
    _build.require(x, "x", shape=(b, d))
    _build.require(pos, "pos", dtype=torch.int32, shape=(b,), device=dev)
    _build.require(w_packed, "w_packed", dtype=torch.int8, shape=(n, d // LANES[w_bits]),
                   device=dev)
    _build.require(w_scale, "w_scale", dtype=torch.float32, shape=(1, n), device=dev)
    for name, t in (("cos", cos), ("sin", sin)):
        _build.require(t, name, dtype=torch.float32, shape=(b, hd // 2), device=dev)
    _require_dense("k_", k_packed, k_scale, k_bits, b=b, h=n_kv, s=s, hd=hd, block=block, dev=dev)
    _require_dense("v_", v_packed, v_scale, v_bits, b=b, h=n_kv, s=s, hd=hd, block=block, dev=dev)
    _build.require(mask, "mask", dtype=torch.float32, shape=(b, s), device=dev)
    out = torch.empty((b, n_kv, n_heads // n_kv, hd), dtype=torch.float32, device=dev)
    rc = _build.lib().rq_quant_kv_decode_step_proj(
        pos.data_ptr(), x.data_ptr(), w_packed.data_ptr(), w_scale.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), k_packed.data_ptr(), k_scale.data_ptr(), v_packed.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), b, d, n_heads, n_kv, s, hd, block,
        w_bits, k_bits, v_bits, split_of(d), csize,
        _build.dtype_code(x, "quant_kv_decode_step_proj"), _build.stream_of(x))
    LAUNCHES["quant_kv_decode_step_proj"] += 1
    _build.check(rc, "quant_kv_decode_step_proj")
    return out


def _require_dense(prefix, packed, scale, bits, *, b, h, s, hd, block, dev) -> None:
    _build.require(packed, f"{prefix}packed", dtype=torch.int8,
                   shape=(b, h, s, -(-hd // LANES[bits])), device=dev)
    _build.require(scale, f"{prefix}scale", dtype=torch.float32, shape=(b, h, s // block, 1),
                   device=dev)


def quant_kv_attention_cuda(q, k_packed, k_scale, v_packed, v_scale, mask, *, k_bits: int,
                            v_bits: int, hd: int, block: int,
                            launch: AttendPlan | None = None) -> torch.Tensor:
    """One launch: attention over the dense packed cache, split over S.

    ``q`` (B, n_kv, g, hd); packed ``(B, n_kv, S, hd/lanes)`` int8 and scales
    ``(B, n_kv, S/block, 1)`` f32, only read; ``mask`` (B, S) f32 additive.
    Returns (B, n_kv, g, hd) f32.  ``launch`` as in :func:`quant_kv_decode_step_cuda`.
    """
    b, n_kv, g, _ = q.shape
    s = k_packed.shape[2]
    dev = q.device
    _check_hd("quant_kv_attention", hd, s, block)
    csize = _split("quant_kv_attention", s, block, launch)
    code = _build.dtype_code(q, "quant_kv_attention")
    _build.require(q, "q", shape=(b, n_kv, g, hd))
    _require_dense("k_", k_packed, k_scale, k_bits, b=b, h=n_kv, s=s, hd=hd, block=block, dev=dev)
    _require_dense("v_", v_packed, v_scale, v_bits, b=b, h=n_kv, s=s, hd=hd, block=block, dev=dev)
    _build.require(mask, "mask", dtype=torch.float32, shape=(b, s), device=dev)
    out = torch.empty((b, n_kv, g, hd), dtype=torch.float32, device=dev)
    rc = _build.lib().rq_quant_kv_attention(
        q.data_ptr(), k_packed.data_ptr(), k_scale.data_ptr(), v_packed.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n_kv, g, s, hd, block, k_bits,
        v_bits, csize, code, _build.stream_of(q))
    LAUNCHES["quant_kv_attention"] += 1
    _build.check(rc, "quant_kv_attention")
    return out


def _burst_operands(name, start, acc, k_burst, v_burst, b: int, h: int, hd: int):
    j = k_burst.shape[1]
    dev = k_burst.device
    _build.dtype_code(k_burst, name)
    for nm, t in (("start", start), ("acc", acc)):
        _build.require(t, nm, dtype=torch.int32, shape=(b,), device=dev)
    for nm, t in (("k_burst", k_burst), ("v_burst", v_burst)):
        _build.require(t, nm, dtype=k_burst.dtype, shape=(b, j, h, hd), device=dev)
    return j


def quant_kv_append_burst_cuda(start, acc, k_burst, v_burst, k_packed, k_scale, v_packed,
                               v_scale, *, k_bits: int, v_bits: int, hd: int,
                               block: int) -> None:
    """Both sides' append in one launch, one CTA per (head, slot, side): for
    every slot, burst positions ``start + j`` for j = 0 .. ``acc`` (``acc``
    < 0: none), row j of ``k_burst`` / ``v_burst`` (B, J, H, hd), appended
    in order IN PLACE in the packed ``(B, H, S, hd/lanes)`` int8 caches and
    their ``(B, H, S/block, 1)`` f32 scales, each position requantizing its
    block with the row inserted; a position outside [0, S) writes nothing
    (a masked row).  The CTA keeps the touched block in registers between
    positions, so a burst gives the bytes of its positions appended one
    launch at a time (J = 1, ``acc`` 0: one decode append).  ``start`` and
    ``acc`` (B,) int32."""
    b = start.shape[0]
    h, s = k_packed.shape[1], k_packed.shape[2]
    dev = k_packed.device
    _check_hd("quant_kv_append_burst", hd, s, block)
    j = _burst_operands("quant_kv_append_burst", start, acc, k_burst, v_burst, b, h, hd)
    _require_dense("k_", k_packed, k_scale, k_bits, b=b, h=h, s=s, hd=hd, block=block, dev=dev)
    _require_dense("v_", v_packed, v_scale, v_bits, b=b, h=h, s=s, hd=hd, block=block, dev=dev)
    rc = _build.lib().rq_quant_kv_append_burst(
        start.data_ptr(), acc.data_ptr(), k_burst.data_ptr(), v_burst.data_ptr(),
        k_packed.data_ptr(), k_scale.data_ptr(), v_packed.data_ptr(), v_scale.data_ptr(), b, h,
        s, hd, block, k_bits, v_bits, j, _build.dtype_code(k_burst, "quant_kv_append_burst"),
        _build.stream_of(k_burst))
    LAUNCHES["quant_kv_append"] += 1
    _build.check(rc, "quant_kv_append_burst")


def quant_kv_decode_step_paged_cuda(pos, table, q, k_new, v_new, k_pool, k_scale, v_pool,
                                    v_scale, mask, *, k_bits: int, v_bits: int, hd: int,
                                    block: int, launch: AttendPlan | None = None) -> torch.Tensor:
    """One launch through the block table: requantize the touched physical
    block in place, then attend over the mapped blocks, split over S.

    ``pos`` (B,) int32; ``table`` (B, S/block) int32 (-1 = unmapped); ``q``
    (B, n_kv, g, hd); ``k_new``/``v_new`` (B, n_kv, hd) in q's dtype; pools
    ``(P, n_kv, block, hd/lanes)`` int8 and scales ``(P, n_kv, 1, 1)`` f32,
    WRITTEN IN PLACE at every slot's mapped touched block (an unmapped one
    is left alone); ``mask`` (B, S) f32 additive.  Returns (B, n_kv, g, hd) f32.
    ``launch`` as in :func:`quant_kv_decode_step_cuda`.
    """
    b, n_kv, g, _ = q.shape
    nb = table.shape[1]
    dev = q.device
    _check_hd("quant_kv_decode_step_paged", hd, nb * block, block)
    csize = _split("quant_kv_decode_step_paged", nb * block, block, launch)
    code = _build.dtype_code(q, "quant_kv_decode_step_paged")
    _build.require(q, "q", shape=(b, n_kv, g, hd))
    _build.require(pos, "pos", dtype=torch.int32, shape=(b,), device=dev)
    _build.require(table, "table", dtype=torch.int32, shape=(b, nb), device=dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _build.require(t, name, dtype=q.dtype, shape=(b, n_kv, hd), device=dev)
    _require_pool("k_", k_pool, k_scale, k_bits, hd=hd, block=block, n_kv=n_kv, dev=dev)
    _require_pool("v_", v_pool, v_scale, v_bits, hd=hd, block=block, n_kv=n_kv, dev=dev)
    _build.require(mask, "mask", dtype=torch.float32, shape=(b, nb * block), device=dev)
    out = torch.empty((b, n_kv, g, hd), dtype=torch.float32, device=dev)
    rc = _build.lib().rq_quant_kv_decode_step_paged(
        pos.data_ptr(), table.data_ptr(), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(), v_scale.data_ptr(),
        mask.data_ptr(), out.data_ptr(), b, n_kv, g, nb, hd, block, k_bits, v_bits, csize, code,
        _build.stream_of(q))
    LAUNCHES["quant_kv_decode_step_paged"] += 1
    _build.check(rc, "quant_kv_decode_step_paged")
    return out


def quant_kv_attention_paged_cuda(table, q, k_pool, k_scale, v_pool, v_scale, mask, *,
                                  k_bits: int, v_bits: int, hd: int, block: int,
                                  launch: AttendPlan | None = None) -> torch.Tensor:
    """One launch: attention over the table-mapped blocks (unmapped entries
    read as zero levels at scale 1e-12), split over S.  Shapes and
    ``launch`` as :func:`quant_kv_decode_step_paged_cuda`; nothing is written."""
    b, n_kv, g, _ = q.shape
    nb = table.shape[1]
    dev = q.device
    _check_hd("quant_kv_attention_paged", hd, nb * block, block)
    csize = _split("quant_kv_attention_paged", nb * block, block, launch)
    code = _build.dtype_code(q, "quant_kv_attention_paged")
    _build.require(q, "q", shape=(b, n_kv, g, hd))
    _build.require(table, "table", dtype=torch.int32, shape=(b, nb), device=dev)
    _require_pool("k_", k_pool, k_scale, k_bits, hd=hd, block=block, n_kv=n_kv, dev=dev)
    _require_pool("v_", v_pool, v_scale, v_bits, hd=hd, block=block, n_kv=n_kv, dev=dev)
    _build.require(mask, "mask", dtype=torch.float32, shape=(b, nb * block), device=dev)
    out = torch.empty((b, n_kv, g, hd), dtype=torch.float32, device=dev)
    rc = _build.lib().rq_quant_kv_attention_paged(
        table.data_ptr(), q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(),
        v_pool.data_ptr(), v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n_kv, g,
        nb, hd, block, k_bits, v_bits, csize, code, _build.stream_of(q))
    LAUNCHES["quant_kv_attention_paged"] += 1
    _build.check(rc, "quant_kv_attention_paged")
    return out


def quant_kv_append_burst_paged_cuda(start, acc, table, k_burst, v_burst, k_pool, k_scale,
                                     v_pool, v_scale, *, k_bits: int, v_bits: int, hd: int,
                                     block: int) -> None:
    """:func:`quant_kv_append_burst_cuda` through the block table ``table``
    (B, S/block) int32 into the pools (P, H, block, hd/lanes) int8 and their
    (P, H, 1, 1) f32 scales: a position whose entry is unmapped writes
    nothing."""
    b, nb = table.shape
    h = k_pool.shape[1]
    dev = k_pool.device
    _check_hd("quant_kv_append_burst_paged", hd, nb * block, block)
    j = _burst_operands("quant_kv_append_burst_paged", start, acc, k_burst, v_burst, b, h, hd)
    _build.require(table, "table", dtype=torch.int32, shape=(b, nb), device=dev)
    _require_pool("k_", k_pool, k_scale, k_bits, hd=hd, block=block, n_kv=h, dev=dev)
    _require_pool("v_", v_pool, v_scale, v_bits, hd=hd, block=block, n_kv=h, dev=dev)
    rc = _build.lib().rq_quant_kv_append_burst_paged(
        start.data_ptr(), acc.data_ptr(), table.data_ptr(), k_burst.data_ptr(),
        v_burst.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(),
        v_scale.data_ptr(), b, h, nb, hd, block, k_bits, v_bits, j,
        _build.dtype_code(k_burst, "quant_kv_append_burst_paged"), _build.stream_of(k_burst))
    LAUNCHES["quant_kv_append_paged"] += 1
    _build.check(rc, "quant_kv_append_burst_paged")
