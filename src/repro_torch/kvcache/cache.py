"""Packed quantized KV-cache container (port of ``repro/kvcache/cache.py``).

``QuantizedKVLayer`` stores one attention layer's decode state as packed
int lanes plus per-block scales:

  * ``*_packed``  int8 ``(B, H, S, hd/lanes)`` — head-major, packed along hd;
  * ``*_scale``   f32 ``(B, H, S/block, 1)`` — one symmetric scale per
    (slot, head, sequence block), so a decode append touches one block.

Invariant: packed levels at positions >= a slot's write position are zero.

Where the JAX package returns a new container, the port updates the
layer's tensors in place (``insert_rows``, ``append_token``) and returns
the same layer: the cache is the largest state the server holds.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing
from repro_torch.core.quantizer import div_exact, qmax

#: sequence-axis scale-block length (one append requantizes one block)
DEFAULT_BLOCK = 16


@dataclasses.dataclass
class QuantizedKVLayer:
    """One attention layer's packed decode state."""

    k_packed: torch.Tensor   # int8 (B, H, S, hd/lanes_k)
    k_scale: torch.Tensor    # f32  (B, H, S/block, 1)
    v_packed: torch.Tensor   # int8 (B, H, S, hd/lanes_v)
    v_scale: torch.Tensor    # f32  (B, H, S/block, 1)
    k_bits: int
    v_bits: int
    block: int
    shape: tuple[int, ...]   # logical (B, S, H, hd)

    @property
    def seq(self) -> int:
        return self.shape[1]

    @property
    def head_dim(self) -> int:
        return self.shape[3]

    def container_bytes(self) -> int:
        """Packed + scale bytes this layer's state occupies."""
        b, s, h, hd = self.shape
        packed = sum(packing.container_bytes((b, h, s, hd), bits)
                     for bits in (self.k_bits, self.v_bits))
        return packed + 4 * (self.k_scale.numel() + self.v_scale.numel())

    def dequantize(self, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
        """Back to float ``(k, v)``, each ``(B, S, H, hd)``."""
        k = _dequant_side(self.k_packed, self.k_scale, self.k_bits, self.head_dim, self.block)
        v = _dequant_side(self.v_packed, self.v_scale, self.v_bits, self.head_dim, self.block)
        return k.transpose(1, 2).to(dtype), v.transpose(1, 2).to(dtype)


def resolve_block(seq: int, block: int = DEFAULT_BLOCK) -> int:
    """Largest divisor of ``seq`` that is <= the requested block length."""
    for d in range(min(block, seq), 0, -1):
        if seq % d == 0:
            return d
    return 1


def init_kv_layer(batch: int, seq: int, n_kv: int, hd: int, *, k_bits: int, v_bits: int,
                  block: int = DEFAULT_BLOCK, device) -> QuantizedKVLayer:
    """All-zero packed cache for ``batch`` slots of ``seq`` positions."""
    packing.check_bits(k_bits)
    packing.check_bits(v_bits)
    block = resolve_block(seq, block)
    nb = seq // block

    def mk(bits):
        return torch.zeros((batch, n_kv, seq, -(-hd // packing.LANES[bits])),
                           dtype=torch.int8, device=device)

    def sc():  # distinct K and V scale buffers
        return torch.full((batch, n_kv, nb, 1), 1e-12, dtype=torch.float32, device=device)

    return QuantizedKVLayer(k_packed=mk(k_bits), k_scale=sc(), v_packed=mk(v_bits),
                            v_scale=sc(), k_bits=int(k_bits), v_bits=int(v_bits),
                            block=block, shape=(batch, seq, n_kv, hd))


def _block_quantize(x: torch.Tensor, bits: int, block: int):
    """fp ``(..., S, hd)`` -> packed ``(..., S, hd/lanes)`` + scale ``(..., S/block, 1)``."""
    *lead, s, hd = x.shape
    xb = x.to(torch.float32).reshape(*lead, s // block, block, hd)
    amax = torch.amax(xb.abs(), dim=(-1, -2), keepdim=True)
    q = qmax(bits)
    scale = div_exact(torch.clamp_min(amax, 1e-12), q)
    lev = torch.clamp(torch.round(xb / scale), -q, q).to(torch.int32)
    return packing.pack(lev.reshape(*lead, s, hd), bits), scale[..., 0, :]


def _dequant_side(packed: torch.Tensor, scale: torch.Tensor, bits: int, hd: int,
                  block: int) -> torch.Tensor:
    """Inverse of :func:`_block_quantize` on the ``(B, H, S, ·)`` layout."""
    lev = packing.unpack(packed, bits, hd)
    *lead, s, _ = lev.shape
    fp = lev.to(torch.float32).reshape(*lead, s // block, block, hd) * scale[..., None]
    return fp.reshape(*lead, s, hd)


def quantize_kv_rows(k: torch.Tensor, v: torch.Tensor, layer: QuantizedKVLayer,
                     valid_len: torch.Tensor | None = None):
    """Quantize fp prefill rows ``(N, P, H, hd)`` into this layer's format.

    ``valid_len`` (N,) zeroes positions >= each row's prompt length before
    the scales are taken.  ``P`` must be a multiple of ``layer.block``.
    """
    kh = k.transpose(1, 2).to(torch.float32)            # (N, H, P, hd)
    vh = v.transpose(1, 2).to(torch.float32)
    if valid_len is not None:
        keep = (torch.arange(k.shape[1], device=k.device)
                < valid_len.to(k.device)[:, None])[:, None, :, None]
        kh = torch.where(keep, kh, 0.0)
        vh = torch.where(keep, vh, 0.0)
    kp, ks = _block_quantize(kh, layer.k_bits, layer.block)
    vp, vs = _block_quantize(vh, layer.v_bits, layer.block)
    return kp, ks, vp, vs


def insert_rows(layer: QuantizedKVLayer, ids, k_new: torch.Tensor, v_new: torch.Tensor,
                valid_len: torch.Tensor | None = None) -> QuantizedKVLayer:
    """Write quantized prefill rows into slots ``ids`` in place (engine admission).

    ``k_new``/``v_new``: fp ``(N, P, H, hd)``; ``P`` is rounded up to a
    block multiple here (extra positions zero-filled).
    """
    p = k_new.shape[1]
    pad = (-p) % layer.block
    if pad:
        k_new = torch.nn.functional.pad(k_new.to(torch.float32), (0, 0, 0, 0, 0, pad))
        v_new = torch.nn.functional.pad(v_new.to(torch.float32), (0, 0, 0, 0, 0, pad))
        p += pad
    if p > layer.seq:
        raise ValueError(f"prefill rows ({p}) exceed cache seq ({layer.seq})")
    kp, ks, vp, vs = quantize_kv_rows(k_new, v_new, layer, valid_len)
    ids = torch.as_tensor(ids, dtype=torch.long, device=layer.k_packed.device)
    nbp = p // layer.block
    layer.k_packed[ids, :, :p] = kp
    layer.k_scale[ids, :, :nbp] = ks
    layer.v_packed[ids, :, :p] = vp
    layer.v_scale[ids, :, :nbp] = vs
    return layer


def insert_state_rows(state, ids, st_new, valid_len: torch.Tensor):
    """Insert rows of a batched prefill state into a decode state (in place).

    ``QuantizedKVLayer`` nodes quantize the fp prefill rows block-wise on the
    way in; fp leaves take the rows directly — row ``i`` lands in ``ids[i]``.
    """

    def walk(st, new):
        if isinstance(st, QuantizedKVLayer):
            return insert_rows(st, ids, new["k"], new["v"], valid_len=valid_len)
        if isinstance(st, dict):
            return {k: walk(st[k], new[k]) for k in st}
        if isinstance(st, (list, tuple)):
            return [walk(s, n) for s, n in zip(st, new)]
        idx = (torch.as_tensor(ids, dtype=torch.long, device=st.device),) + tuple(
            slice(0, d) for d in new.shape[1:])
        st[idx] = new.to(st.dtype)
        return st

    return walk(state, st_new)


def requantize_block_levels(blk_fp: torch.Tensor, new: torch.Tensor, off: torch.Tensor,
                            bits: int):
    """Insert ``new`` (B, H, hd) at ``off`` (B,) into ``blk_fp`` (B, H, block, hd) and
    requantize -> int32 levels + ``(B, H, 1, 1)`` scale.

    Rows past ``off`` zero out (container invariant), so a stale occupant can
    neither leak into attention nor inflate the fresh scale.
    """
    q = qmax(bits)
    idx = torch.arange(blk_fp.shape[2], device=blk_fp.device)[None, None, :, None]
    offb = off.to(blk_fp.device)[:, None, None, None]
    fp = torch.where(idx < offb, blk_fp, 0.0)
    fp = torch.where(idx == offb, new.to(torch.float32)[:, :, None, :], fp)
    amax = torch.amax(fp.abs(), dim=(2, 3), keepdim=True)
    sc = div_exact(torch.clamp_min(amax, 1e-12), q)
    lev = torch.clamp(torch.round(fp / sc), -q, q).to(torch.int32)
    return lev, sc


def requantize_block(blk_fp, new, off, bits: int):
    """:func:`requantize_block_levels` packed: ``(B, H, block, hdp)`` int8 + scale."""
    lev, sc = requantize_block_levels(blk_fp, new, off, bits)
    return packing.pack(lev, bits), sc


def append_side(packed: torch.Tensor, scale: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor, bits: int, hd: int, block: int) -> torch.Tensor:
    """Requantize, in place, the block holding ``pos`` with the new row inserted.

    ``new``: fp (B, H, hd); ``pos``: (B,).  Returns the block's new levels
    (B, H, block, hd).
    """
    b, h, s, hdp = packed.shape
    pos = pos.to(device=packed.device, dtype=torch.long)
    bidx, off = pos // block, pos % block
    view = packed.view(b, h, s // block, block, hdp)
    blk = torch.take_along_dim(view, bidx[:, None, None, None, None], dim=2)[:, :, 0]
    lev = packing.unpack(blk, bits, hd)
    sc_b = torch.take_along_dim(scale, bidx[:, None, None, None], dim=2)   # (B, H, 1, 1)
    lev_new, sc_new = requantize_block_levels(lev.to(torch.float32) * sc_b, new, off, bits)
    rows = torch.arange(b, device=packed.device)
    view[rows, :, bidx] = packing.pack(lev_new, bits)
    scale[rows, :, bidx] = sc_new[:, :, 0]
    return lev_new


def append_token(layer: QuantizedKVLayer, pos, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> QuantizedKVLayer:
    """Write one decode token's K/V at per-slot ``pos`` in place (plain path).

    ``k_new``/``v_new``: fp ``(B, 1, H, hd)``; a scalar ``pos`` broadcasts.
    """
    b = k_new.shape[0]
    pos = torch.as_tensor(pos, device=layer.k_packed.device).reshape(-1).expand(b)
    append_side(layer.k_packed, layer.k_scale, k_new.transpose(1, 2)[:, :, 0], pos,
                layer.k_bits, layer.head_dim, layer.block)
    append_side(layer.v_packed, layer.v_scale, v_new.transpose(1, 2)[:, :, 0], pos,
                layer.v_bits, layer.head_dim, layer.block)
    return layer
