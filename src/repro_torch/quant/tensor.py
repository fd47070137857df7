"""QuantizedTensor — the serving-side weight container (port of ``repro/quant/tensor.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing, quantizer


@dataclasses.dataclass
class QuantizedTensor:
    """Packed b-bit weight + per-output-channel scale.

    Logical layout ``shape = (K, N)`` (in, out); ``packed`` holds K-packed
    lanes output-channel major, ``(N, ceil(K/lanes))`` int8, which is the
    kernels' B-operand layout; ``scale`` is ``(1, N)`` f32.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    shape: tuple[int, ...]

    @property
    def k(self) -> int:
        return self.shape[-2]

    @property
    def n(self) -> int:
        return self.shape[-1]

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Back to float ``(K, N)``: levels cast to int8, then to ``dtype``, times the scale."""
        if packing.LANES[self.bits] == 1:
            levels = self.packed[..., : self.k]        # already int8 levels
        else:
            levels = packing.unpack(self.packed, self.bits, self.k).to(torch.int8)
        w = levels.to(dtype) * self.scale.transpose(-1, -2).to(dtype)
        return w.transpose(-1, -2)

    def container_bytes(self) -> int:
        return packing.container_bytes(self.shape[:-2] + (self.n, self.k), self.bits)


def quantize_tensor(w: torch.Tensor, bits: int) -> QuantizedTensor:
    """Quantize a float weight ``(K, N)`` per output channel and pack along K."""
    w32 = w.to(torch.float32)
    scale = quantizer.weight_scale(w32, bits, channel_axis=-1)      # (1, N)
    levels = quantizer.quantize(w32, scale, bits)                   # (K, N) int32
    packed = packing.pack(levels.transpose(-1, -2), bits)
    return QuantizedTensor(packed=packed.contiguous(), scale=scale, bits=int(bits),
                           shape=tuple(w.shape))


def concat_quantized(qts: list[QuantizedTensor]) -> QuantizedTensor:
    """Fuse same-K, same-bits 2-D quantized weights along the output axis.

    Packed rows and per-channel scales concatenate; nothing is requantized,
    so slicing the fused product at the N offsets gives each member's result.
    """
    if len({qt.bits for qt in qts}) != 1:
        raise ValueError(f"cannot fuse mixed bitwidths {[qt.bits for qt in qts]}")
    if len({qt.shape[:-1] for qt in qts}) != 1 or any(qt.packed.ndim != 2 for qt in qts):
        raise ValueError("fusion needs 2-D members with identical K "
                         f"(shapes {[qt.shape for qt in qts]})")
    bits = qts[0].bits
    packed = packing.concat_rows([qt.packed for qt in qts], bits)
    scale = torch.cat([qt.scale for qt in qts], dim=-1)
    n = sum(qt.n for qt in qts)
    return QuantizedTensor(packed=packed, scale=scale, bits=bits,
                           shape=qts[0].shape[:-1] + (n,))


def abstract_quantized(shape: tuple[int, ...], bits: int) -> QuantizedTensor:
    """The packed container's shapes and dtypes on the ``meta`` device
    (the dry-run: no allocation)."""
    *lead, k, n = shape
    lanes = packing.LANES[bits]
    packed = torch.empty((*lead, n, -(-k // lanes)), dtype=torch.int8, device="meta")
    scale = torch.empty((*lead, 1, n), dtype=torch.float32, device="meta")
    return QuantizedTensor(packed=packed, scale=scale, bits=int(bits), shape=tuple(shape))
