"""Sub-byte weight packing (the port of ``repro/core/packing.py``).

Signed b-bit integer levels are packed into int8 container lanes along the
*last* axis: value k sits at byte k//lanes, field k%lanes, low bits first,
and is sign-extended on unpack.  6-bit values ride in 8-bit containers.

    bits=2 -> 4 values / byte      bits=6 -> 1 value / byte (6-in-8)
    bits=4 -> 2 values / byte      bits=8 -> 1 value / byte

The padded length is recorded by the caller via the original shape, and
``unpack(pack(q)) == q`` exactly.  The CUDA kernels read this same layout.
"""
from __future__ import annotations

import torch

#: the paper's bit-set — the single source of truth for every layer
VALID_BITS = (2, 4, 6, 8)

#: values per int8 container byte for each supported bitwidth
LANES = {2: 4, 4: 2, 6: 1, 8: 1}
assert tuple(sorted(LANES)) == VALID_BITS


def check_bits(bits: int) -> int:
    """Validate a bitwidth against the shared bit-set (one ValueError everywhere)."""
    if bits not in VALID_BITS:
        raise ValueError(f"bits must be one of {VALID_BITS}, got {bits}")
    return int(bits)


def container_bytes(shape: tuple[int, ...], bits: int) -> int:
    """Bytes the packed buffer occupies in device memory (container accounting)."""
    lanes = LANES[check_bits(bits)]
    *lead, k = shape
    n = 1
    for d in lead:
        n *= d
    return n * -(-k // lanes)


def pack(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed b-bit integer levels into int8 lanes along the last axis.

    The masked fields occupy disjoint bit ranges, so a sum over the lane
    axis is the lane-OR.
    """
    lanes = LANES[check_bits(bits)]
    lev = levels.to(torch.int32)
    if lanes == 1:
        return lev.to(torch.int8)
    pad = (-lev.shape[-1]) % lanes
    if pad:
        lev = torch.nn.functional.pad(lev, (0, pad))
    grouped = lev.reshape(*lev.shape[:-1], -1, lanes)
    mask = (1 << bits) - 1
    sh = bits * torch.arange(lanes, dtype=torch.int32, device=lev.device)
    out = ((grouped & mask) << sh).sum(dim=-1)
    return out.to(torch.uint8).view(torch.int8)


def concat_rows(packed_list: list[torch.Tensor], bits: int) -> torch.Tensor:
    """Concatenate K-packed buffers along the output-channel (row) axis.

    Valid because lanes pack along K: rows are whole output channels, so
    stacking them never splits a container byte.
    """
    check_bits(bits)
    kp = {p.shape[-1] for p in packed_list}
    if len(kp) != 1:
        raise ValueError(f"row-concat needs equal packed-K, got {sorted(kp)}")
    return torch.cat(packed_list, dim=-2)


def unpack(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack` -> int32 levels; ``k`` is the original last-axis length."""
    lanes = LANES[check_bits(bits)]
    if lanes == 1:
        return packed.to(torch.int32)[..., :k]
    u = packed.view(torch.uint8).to(torch.int32).unsqueeze(-1)       # (..., kp, 1)
    sh = bits * torch.arange(lanes, dtype=torch.int32, device=packed.device)
    field = (u >> sh) & ((1 << bits) - 1)
    vals = torch.where(field >= (1 << (bits - 1)), field - (1 << bits), field)
    return vals.reshape(*packed.shape[:-1], -1)[..., :k]
