"""ctypes bindings of the CUDA quantized-KV kernels (``csrc/quant_kv_decode_step.cu``,
``csrc/quant_kv_dense.cu``, ``csrc/quant_kv_paged.cu``, ``csrc/quant_kv_proj.cu``).

The attention body (``csrc/quant_kv.cuh`` ``attend``) is split over S; its
launch is planned here, in Python, so that the CPU tests can check it
(:func:`attend_plan`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packing import LANES
from repro_torch.kernels import LAUNCHES, _build

#: positions per chunk of the split attention (``csrc/quant_kv.cuh`` kChunk)
CHUNK = 64
#: positions per tile of a chunk's online softmax (``kTile``)
TILE = 32
#: the most CTAs one (slot, kv head) takes: a cluster of 16 (above 8 the
#: non-portable cluster size)
MAX_CLUSTER = 16
#: the fused steps: one CTA requantizes the touched block and reads it
FUSED = ("quant_kv_decode_step", "quant_kv_decode_step_paged")
#: every kernel that runs the split attention body; row 8 walks it on one CTA
ATTEND_KERNELS = FUSED + ("quant_kv_attention", "quant_kv_attention_paged",
                          "quant_kv_decode_step_proj")


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
    walks every chunk for row 8 (each of its CTAs reads all of ``wqkv``, so
    a cluster would multiply those reads) and for a fused step whose
    sequence blocks do not each lie inside one chunk (only one CTA may
    requantize a block).  Never depends on B: the bits do not either.
    """
    if kernel not in ATTEND_KERNELS:
        raise ValueError(f"attend_plan: {kernel!r} does not run the attention body")
    cluster = min(-(-s // CHUNK), MAX_CLUSTER)
    if kernel == "quant_kv_decode_step_proj" or (kernel in FUSED and CHUNK % block):
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


def _check_hd(name: str, hd: int, s: int, block: int) -> None:
    if hd % 16 or s % block:
        raise ValueError(f"{name}: the CUDA kernel takes hd % 16 == 0 (whole 4-byte packed "
                         f"words) and S % block == 0, got hd={hd}, S={s}, block={block}")


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


def quant_kv_decode_step_proj_cuda(pos, x, w_packed, w_scale, cos, sin, k_packed, k_scale,
                                   v_packed, v_scale, mask, *, w_bits: int, k_bits: int,
                                   v_bits: int, n_heads: int, hd: int,
                                   block: int) -> torch.Tensor:
    """One CTA per (slot, kv head): project the query group and the K/V rows
    from the fused ``wqkv``, rotate, requantize the touched block, attend
    (the split body walked by that CTA: ``attend_plan``'s walk mode).

    ``pos`` (B,) int32, B <= 8; ``x`` (B, d) f32; ``w_packed``
    ((n_heads + 2 n_kv) hd, d/lanes) int8 and ``w_scale`` (1, that) f32;
    ``cos``/``sin`` (B, hd/2) f32 at ``pos``; packed ``(B, n_kv, S, hd/lanes)``
    int8 and scales ``(B, n_kv, S/block, 1)`` f32, WRITTEN IN PLACE (the
    touched block and its scale); ``mask`` (B, S) f32 additive.  Returns
    (B, n_kv, g, hd) f32.
    """
    b, d = x.shape
    n_kv, s = k_packed.shape[1], k_packed.shape[2]
    dev = x.device
    _check_hd("quant_kv_decode_step_proj", hd, s, block)
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
        w_bits, k_bits, v_bits, _build.dtype_code(x, "quant_kv_decode_step_proj"),
        _build.stream_of(x))
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


def quant_kv_append_cuda(pos, new, packed, scale, *, bits: int, hd: int, block: int) -> None:
    """One side's append, one kernel per (slot, head): requantize the block
    holding each slot's ``pos`` with ``new`` (B, H, hd) inserted, IN PLACE in
    ``packed`` (B, H, S, hd/lanes) int8 and ``scale`` (B, H, S/block, 1) f32.
    A slot whose ``pos`` lies outside [0, S) writes nothing (a masked row)."""
    b, h, _ = new.shape
    s = packed.shape[2]
    dev = new.device
    _check_hd("quant_kv_append", hd, s, block)
    code = _build.dtype_code(new, "quant_kv_append")
    _build.require(new, "new", shape=(b, h, hd))
    _build.require(pos, "pos", dtype=torch.int32, shape=(b,), device=dev)
    _require_dense("", packed, scale, bits, b=b, h=h, s=s, hd=hd, block=block, dev=dev)
    rc = _build.lib().rq_quant_kv_append(
        pos.data_ptr(), new.data_ptr(), packed.data_ptr(), scale.data_ptr(), b, h, s, hd, block,
        bits, code, _build.stream_of(new))
    LAUNCHES["quant_kv_append"] += 1
    _build.check(rc, "quant_kv_append")


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


def quant_kv_append_paged_cuda(pos, table, new, pool, scale, *, bits: int, hd: int,
                               block: int) -> None:
    """One side's append, one kernel per (slot, head): requantize each slot's
    mapped touched block with ``new`` (B, H, hd) inserted, IN PLACE in
    ``pool`` (P, H, block, hd/lanes) int8 and ``scale`` (P, H, 1, 1) f32.
    A slot whose touched entry is unmapped writes nothing."""
    b, h, _ = new.shape
    nb = table.shape[1]
    dev = new.device
    _check_hd("quant_kv_append_paged", hd, nb * block, block)
    code = _build.dtype_code(new, "quant_kv_append_paged")
    _build.require(new, "new", shape=(b, h, hd))
    _build.require(pos, "pos", dtype=torch.int32, shape=(b,), device=dev)
    _build.require(table, "table", dtype=torch.int32, shape=(b, nb), device=dev)
    _require_pool("", pool, scale, bits, hd=hd, block=block, n_kv=h, dev=dev)
    rc = _build.lib().rq_quant_kv_append_paged(
        pos.data_ptr(), table.data_ptr(), new.data_ptr(), pool.data_ptr(), scale.data_ptr(),
        b, h, nb, hd, block, bits, code, _build.stream_of(new))
    LAUNCHES["quant_kv_append_paged"] += 1
    _build.check(rc, "quant_kv_append_paged")
