"""Paged quantized KV cache: a block pool plus per-slot block tables (port of
``repro/kvcache/paged.py``).

The dense ``QuantizedKVLayer`` pre-pays ``max_seq`` positions for every
slot.  The paged layout cuts the cache into physical *blocks* of ``block``
positions (the scale granularity the dense layout already has) and maps
them on demand:

  * ``PagedKVLayer`` holds one packed pool per side, ``(P, H, block,
    hd/lanes)`` int8 with ``(P, H, 1, 1)`` f32 scales, and a block table
    ``(B, max_seq/block)`` int32 from logical to physical blocks (-1 =
    unmapped).  Physical block 0 is the *trash block*: it is never
    allocated, and an idle slot's lockstep append clamps there.
  * ``BlockPool`` is the host-side allocator: a LIFO free list with
    refcounts.  Shared-prefix admission maps one physical block into
    several slots; the first append into a shared block copies it first
    (copy-on-write, ``serve/engine.py``).

Where the JAX package returns a new container, the port writes the pools
and the table in place and returns the same layer.  ``with_table`` copies a
host table into the layer's device table; since nothing is donated, every
layer of a model may share ONE device table tensor (``decoder.init_cache``
does so), and one copy then updates them all.

A paged cache holding the same rows as a dense cache attends to the same
values: ``to_dense`` gathers mapped blocks and reads unmapped positions as
zero levels at the init scale 1e-12, exactly what a dense cache holds
where nothing was written.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packing

from .cache import (DEFAULT_BLOCK, QuantizedKVLayer, _block_quantize, requantize_block,
                    resolve_block)

#: physical block id 0 is never allocated: it absorbs idle-slot appends
TRASH_BLOCK = 0


@dataclasses.dataclass
class PagedKVLayer:
    """One attention layer's paged packed decode state."""

    k_packed: torch.Tensor     # int8 (P, H, block, hd/lanes_k): the K pool
    k_scale: torch.Tensor      # f32  (P, H, 1, 1): one scale per (block, head)
    v_packed: torch.Tensor     # int8 (P, H, block, hd/lanes_v)
    v_scale: torch.Tensor      # f32  (P, H, 1, 1)
    block_table: torch.Tensor  # int32 (B, max_seq/block); -1 = unmapped
    k_bits: int
    v_bits: int
    block: int
    shape: tuple[int, ...]     # logical (B, max_seq, H, hd)

    @property
    def seq(self) -> int:
        return self.shape[1]

    @property
    def head_dim(self) -> int:
        return self.shape[3]

    @property
    def num_blocks(self) -> int:
        return self.k_packed.shape[0]

    def bytes_per_block(self) -> int:
        """Packed + scale bytes ONE physical block occupies (both sides)."""
        _, _, h, hd = self.shape
        packed = sum(packing.container_bytes((h, self.block, hd), bits)
                     for bits in (self.k_bits, self.v_bits))
        return packed + 2 * 4 * h  # two f32 scales per (block, head)

    def container_bytes(self) -> int:
        """Whole-pool footprint on the device (the block table included)."""
        return self.num_blocks * self.bytes_per_block() + 4 * self.block_table.numel()

    def allocated_bytes(self, n_blocks: int) -> int:
        """Footprint of ``n_blocks`` live blocks: what the budget prices."""
        return n_blocks * self.bytes_per_block()


def init_paged_layer(num_blocks: int, slots: int, max_seq: int, n_kv: int, hd: int, *,
                     k_bits: int, v_bits: int, block: int = DEFAULT_BLOCK,
                     device) -> PagedKVLayer:
    """All-unmapped paged cache with ``num_blocks`` usable blocks plus the trash block."""
    packing.check_bits(k_bits)
    packing.check_bits(v_bits)
    block = resolve_block(max_seq, block)
    if num_blocks < 1:
        raise ValueError(f"pool needs at least one usable block, got {num_blocks}")
    p = num_blocks + 1  # + trash

    def mk(bits):
        return torch.zeros((p, n_kv, block, -(-hd // packing.LANES[bits])), dtype=torch.int8,
                           device=device)

    def sc():
        return torch.full((p, n_kv, 1, 1), 1e-12, dtype=torch.float32, device=device)

    table = torch.full((slots, max_seq // block), -1, dtype=torch.int32, device=device)
    return PagedKVLayer(k_packed=mk(k_bits), k_scale=sc(), v_packed=mk(v_bits), v_scale=sc(),
                        block_table=table, k_bits=int(k_bits), v_bits=int(v_bits), block=block,
                        shape=(slots, max_seq, n_kv, hd))


def pool_blocks_for_budget(state_bits: list[tuple[int, int]], n_kv: int, hd: int, block: int,
                           budget_bytes: float) -> int:
    """Most usable physical blocks a ``state_bytes`` budget buys.

    One block is one *logical* block across every layer (the allocator hands
    out the same id in each layer's pool), so its price sums every layer's
    K+V packed lanes and scales.
    """
    per_block = 0
    for kb, vb in state_bits:
        per_block += sum(packing.container_bytes((n_kv, block, hd), bits) for bits in (kb, vb))
        per_block += 2 * 4 * n_kv
    n = int(budget_bytes // per_block)
    if n < 1:
        raise ValueError(f"state_bytes budget {budget_bytes:g} buys zero blocks "
                         f"({per_block} B/block across {len(state_bits)} layers)")
    return n


# ---------------------------------------------------------------------------
# host-side allocator
# ---------------------------------------------------------------------------


class BlockPool:
    """Free-list block allocator with refcounts (host side).

    Physical ids are shared by every layer's pool.  A refcount above 1 marks
    a block mapped into several slots (a shared prefix); ``decref`` returns
    a block to the free list when its last reference drops.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("BlockPool needs at least one usable block")
        self.num_blocks = num_blocks
        # LIFO free list over usable ids [1, num_blocks]; 0 is the trash block
        self._free = list(range(num_blocks, TRASH_BLOCK, -1))
        self._ref = np.zeros(num_blocks + 1, np.int32)
        self.reserved = 0  # blocks promised to admitted requests' future growth
        self.peak_allocated = 0
        self.cow_copies = 0
        self.shared_maps = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def available(self) -> int:
        """Free blocks not already promised to an admitted request."""
        return len(self._free) - self.reserved

    @property
    def allocated(self) -> int:
        return self.num_blocks - len(self._free)

    def reserve(self, n: int) -> None:
        """Promise ``n`` future blocks (an admitted request's decode growth and
        copy-on-write splits), so a mid-decode allocation never strands it."""
        assert n <= self.available, (n, self.available)
        self.reserved += n

    def unreserve(self, n: int) -> None:
        assert n <= self.reserved, (n, self.reserved)
        self.reserved -= n

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(f"block pool exhausted ({self.num_blocks} blocks allocated); "
                               f"raise pool_blocks or admit fewer concurrent requests")
        bid = self._free.pop()
        self._ref[bid] = 1
        self.peak_allocated = max(self.peak_allocated, self.allocated)
        return bid

    def incref(self, bid: int) -> int:
        assert bid != TRASH_BLOCK and self._ref[bid] > 0, bid
        self._ref[bid] += 1
        self.shared_maps += 1
        return bid

    def decref(self, bid: int) -> None:
        if bid == TRASH_BLOCK:
            return
        assert self._ref[bid] > 0, f"double free of block {bid}"
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)


# ---------------------------------------------------------------------------
# dense view (plain versions and tests)
# ---------------------------------------------------------------------------


def to_dense(layer: PagedKVLayer) -> QuantizedKVLayer:
    """Gather the pool into the dense ``QuantizedKVLayer`` layout (a contiguous copy).

    Mapped blocks gather their pool bytes; unmapped positions read as zero
    levels with the init scale 1e-12.
    """
    b, s, h, _ = layer.shape
    tbl = layer.block_table.to(torch.long)                  # (B, nb)
    mapped = tbl >= 0
    idx = tbl.clamp_min(0)

    def side(pool, scale):
        blk = pool[idx]                                     # (B, nb, H, block, hdp)
        blk = torch.where(mapped[:, :, None, None, None], blk, torch.zeros_like(blk))
        packed = blk.transpose(1, 2).reshape(b, h, s, pool.shape[-1])
        sc = scale[idx][..., 0, 0]                          # (B, nb, H)
        sc = torch.where(mapped[..., None], sc, torch.full_like(sc, 1e-12))
        return packed, sc.transpose(1, 2)[..., None].contiguous()   # (B, H, nb, 1)

    kp, ks = side(layer.k_packed, layer.k_scale)
    vp, vs = side(layer.v_packed, layer.v_scale)
    return QuantizedKVLayer(k_packed=kp, k_scale=ks, v_packed=vp, v_scale=vs,
                            k_bits=layer.k_bits, v_bits=layer.v_bits, block=layer.block,
                            shape=layer.shape)


# ---------------------------------------------------------------------------
# prefill insertion (engine admission) and the plain appends
# ---------------------------------------------------------------------------


def place_paged_block(pool: torch.Tensor, scale: torch.Tensor, blk: torch.Tensor,
                      sc: torch.Tensor, phys: torch.Tensor) -> None:
    """Write blocks ``(N, H, block, ·)`` + scales ``(N, H, 1, 1)`` into the pool
    at physical ids ``phys`` (N,), in place: the plain paths' one scatter.

    Live slots own their target block alone (the engine's copy-on-write),
    so real ids never collide; writes that clamp to the trash block collide
    there, and nothing reads it.  (The CUDA kernels write in place themselves.)
    """
    phys = phys.to(device=pool.device, dtype=torch.long)
    pool[phys] = blk
    scale[phys] = sc


def insert_prefill_rows(layer: PagedKVLayer, row_tables, k_new: torch.Tensor,
                        v_new: torch.Tensor,
                        valid_len: torch.Tensor | None = None) -> PagedKVLayer:
    """Quantize fp prefill rows ``(N, P, H, hd)`` into their mapped blocks, in place.

    ``row_tables`` ``(N, ceil(P/block))`` int32 holds the physical destination
    of each (row, logical block); entries < 0 skip the write (shared-prefix
    blocks a donor slot already holds, pad blocks past the row) by landing
    in the trash block.  The quantizer is the dense ``_block_quantize``, so
    identical rows give identical blocks: what makes prefix sharing exact.
    """
    n, p, h, hd = k_new.shape
    dev = layer.k_packed.device
    pad = (-p) % layer.block
    if pad:
        k_new = torch.nn.functional.pad(k_new.to(torch.float32), (0, 0, 0, 0, 0, pad))
        v_new = torch.nn.functional.pad(v_new.to(torch.float32), (0, 0, 0, 0, 0, pad))
        p += pad
    npb = p // layer.block
    row_tables = torch.as_tensor(np.asarray(row_tables), dtype=torch.long, device=dev)
    if tuple(row_tables.shape) != (n, npb):
        raise ValueError(f"row_tables {tuple(row_tables.shape)} != {(n, npb)}")
    dest = row_tables.clamp_min(TRASH_BLOCK).reshape(-1)   # (N*npb,)
    kh = k_new.transpose(1, 2).to(torch.float32)            # (N, H, P, hd)
    vh = v_new.transpose(1, 2).to(torch.float32)
    if valid_len is not None:
        keep = (torch.arange(p, device=dev) < valid_len.to(dev)[:, None])[:, None, :, None]
        kh = torch.where(keep, kh, 0.0)
        vh = torch.where(keep, vh, 0.0)

    def side(pool, scale, x, bits):
        packed, sc = _block_quantize(x, bits, layer.block)  # (N,H,P,hdp), (N,H,nb,1)
        blk = packed.reshape(n, h, npb, layer.block, -1).transpose(1, 2)
        place_paged_block(pool, scale, blk.reshape(n * npb, h, layer.block, -1),
                          sc.transpose(1, 2).reshape(n * npb, h, 1, 1), dest)

    side(layer.k_packed, layer.k_scale, kh, layer.k_bits)
    side(layer.v_packed, layer.v_scale, vh, layer.v_bits)
    return layer


def append_token_paged(layer: PagedKVLayer, pos, k_new: torch.Tensor,
                       v_new: torch.Tensor) -> PagedKVLayer:
    """Write one decode token per slot into its mapped block, in place (plain path).

    ``k_new``/``v_new`` fp ``(B, 1, H, hd)``; ``pos`` () or (B,).  The engine
    guarantees the target block of every active slot is mapped and owned by
    that slot alone (copy-on-write runs host-side before the step); idle
    slots' entries read -1 and clamp to the trash block.
    """
    b = k_new.shape[0]
    dev = layer.k_packed.device
    pos = torch.as_tensor(pos, device=dev).reshape(-1).expand(b).to(torch.long)
    # a position past the table (an idle slot's stale one) writes the trash
    # block, as in the JAX package, whose out-of-range gather reads a fill
    # value below every block id
    nb = layer.block_table.shape[1]
    bidx = pos // layer.block
    phys = torch.take_along_dim(layer.block_table.to(torch.long),
                                bidx.clamp(0, nb - 1)[:, None], dim=1)[:, 0]
    phys = torch.where(bidx < nb, phys, TRASH_BLOCK).clamp_min(TRASH_BLOCK)
    off = pos % layer.block
    kh = k_new.transpose(1, 2)[:, :, 0].to(torch.float32)    # (B, H, hd)
    vh = v_new.transpose(1, 2)[:, :, 0].to(torch.float32)

    def side(pool, scale, new, bits):
        lev = packing.unpack(pool[phys], bits, layer.head_dim)  # (B, H, block, hd)
        blk, sc = requantize_block(lev.to(torch.float32) * scale[phys], new, off, bits)
        place_paged_block(pool, scale, blk, sc, phys)

    side(layer.k_packed, layer.k_scale, kh, layer.k_bits)
    side(layer.v_packed, layer.v_scale, vh, layer.v_bits)
    return layer


def copy_blocks(layer: PagedKVLayer, src, dst) -> PagedKVLayer:
    """Copy pool blocks ``src -> dst`` in every buffer, in place (copy-on-write)."""
    dev = layer.k_packed.device
    src = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    for buf in (layer.k_packed, layer.k_scale, layer.v_packed, layer.v_scale):
        buf[dst] = buf[src]
    return layer


def with_table(layer: PagedKVLayer, table) -> PagedKVLayer:
    """Copy a host-built block table into the layer's device table, in place."""
    layer.block_table.copy_(torch.as_tensor(np.asarray(table, np.int32)))
    return layer
