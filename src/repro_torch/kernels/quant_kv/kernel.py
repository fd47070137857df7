"""ctypes bindings of the CUDA quantized-KV kernels (``csrc/quant_kv_decode_step.cu``,
``csrc/quant_kv_dense.cu``, ``csrc/quant_kv_paged.cu``)."""
from __future__ import annotations

import torch

from repro_torch.core.packing import LANES
from repro_torch.kernels import LAUNCHES, _build


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
                              mask, *, k_bits: int, v_bits: int, hd: int,
                              block: int) -> torch.Tensor:
    """One kernel per (slot, kv head): requantize the touched block + attend.

    ``pos`` (B,) int32; ``q`` (B, n_kv, g, hd); ``k_new``/``v_new``
    (B, n_kv, hd) in q's dtype; packed ``(B, n_kv, S, hd/lanes)`` int8 and
    scales ``(B, n_kv, S/block, 1)`` f32, WRITTEN IN PLACE (the touched block
    and its scale); ``mask`` (B, S) f32 additive.  Returns (B, n_kv, g, hd) f32.
    """
    b, n_kv, g, _ = q.shape
    s = k_packed.shape[2]
    dev = q.device
    _check_hd("quant_kv_decode_step", hd, s, block)
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
        mask.data_ptr(), out.data_ptr(), b, n_kv, g, s, hd, block, k_bits, v_bits, code,
        _build.stream_of(q))
    LAUNCHES["quant_kv_decode_step"] += 1
    _build.check(rc, "quant_kv_decode_step")
    return out


def _require_dense(prefix, packed, scale, bits, *, b, h, s, hd, block, dev) -> None:
    _build.require(packed, f"{prefix}packed", dtype=torch.int8,
                   shape=(b, h, s, -(-hd // LANES[bits])), device=dev)
    _build.require(scale, f"{prefix}scale", dtype=torch.float32, shape=(b, h, s // block, 1),
                   device=dev)


def quant_kv_attention_cuda(q, k_packed, k_scale, v_packed, v_scale, mask, *, k_bits: int,
                            v_bits: int, hd: int, block: int) -> torch.Tensor:
    """One kernel per (slot, kv head): attention over the dense packed cache.

    ``q`` (B, n_kv, g, hd); packed ``(B, n_kv, S, hd/lanes)`` int8 and scales
    ``(B, n_kv, S/block, 1)`` f32, only read; ``mask`` (B, S) f32 additive.
    Returns (B, n_kv, g, hd) f32.
    """
    b, n_kv, g, _ = q.shape
    s = k_packed.shape[2]
    dev = q.device
    _check_hd("quant_kv_attention", hd, s, block)
    code = _build.dtype_code(q, "quant_kv_attention")
    _build.require(q, "q", shape=(b, n_kv, g, hd))
    _require_dense("k_", k_packed, k_scale, k_bits, b=b, h=n_kv, s=s, hd=hd, block=block, dev=dev)
    _require_dense("v_", v_packed, v_scale, v_bits, b=b, h=n_kv, s=s, hd=hd, block=block, dev=dev)
    _build.require(mask, "mask", dtype=torch.float32, shape=(b, s), device=dev)
    out = torch.empty((b, n_kv, g, hd), dtype=torch.float32, device=dev)
    rc = _build.lib().rq_quant_kv_attention(
        q.data_ptr(), k_packed.data_ptr(), k_scale.data_ptr(), v_packed.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n_kv, g, s, hd, block, k_bits,
        v_bits, code, _build.stream_of(q))
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
                                    block: int) -> torch.Tensor:
    """One kernel per (slot, kv head) through the block table: requantize the
    touched physical block in place, then attend over the mapped blocks.

    ``pos`` (B,) int32; ``table`` (B, S/block) int32 (-1 = unmapped); ``q``
    (B, n_kv, g, hd); ``k_new``/``v_new`` (B, n_kv, hd) in q's dtype; pools
    ``(P, n_kv, block, hd/lanes)`` int8 and scales ``(P, n_kv, 1, 1)`` f32,
    WRITTEN IN PLACE at every slot's mapped touched block (an unmapped one
    is left alone); ``mask`` (B, S) f32 additive.  Returns (B, n_kv, g, hd) f32.
    """
    b, n_kv, g, _ = q.shape
    nb = table.shape[1]
    dev = q.device
    _check_hd("quant_kv_decode_step_paged", hd, nb * block, block)
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
        mask.data_ptr(), out.data_ptr(), b, n_kv, g, nb, hd, block, k_bits, v_bits, code,
        _build.stream_of(q))
    LAUNCHES["quant_kv_decode_step_paged"] += 1
    _build.check(rc, "quant_kv_decode_step_paged")
    return out


def quant_kv_attention_paged_cuda(table, q, k_pool, k_scale, v_pool, v_scale, mask, *,
                                  k_bits: int, v_bits: int, hd: int,
                                  block: int) -> torch.Tensor:
    """One kernel per (slot, kv head): attention over the table-mapped blocks
    (unmapped entries read as zero levels at scale 1e-12).  Shapes as
    :func:`quant_kv_decode_step_paged_cuda`; nothing is written."""
    b, n_kv, g, _ = q.shape
    nb = table.shape[1]
    dev = q.device
    _check_hd("quant_kv_attention_paged", hd, nb * block, block)
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
        nb, hd, block, k_bits, v_bits, code, _build.stream_of(q))
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
