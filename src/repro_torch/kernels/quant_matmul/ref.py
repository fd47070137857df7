"""Plain PyTorch version of the quantized matmul: unpack -> dequant -> matmul.

Mirrors ``quant_matmul_ref`` (repro/kernels/quant_matmul/ref.py:14): the
weights dequantize into the *compute* dtype (bf16 stays bf16, everything
else f32) and the product accumulates in f32.  It is the CPU path and the
oracle the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import PLAIN_CALLS


def dequant_matmul(x, packed, scale, bits: int, k: int, *, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(packed, scale) for x ``(M, K)`` -> ``(M, N)`` (uncounted)."""
    out_dtype = out_dtype or x.dtype
    cdt = x.dtype if x.dtype in (torch.bfloat16, torch.float16) else torch.float32
    levels = packing.unpack(packed, bits, k).to(torch.int8)        # (N, K)
    w = levels.to(cdt) * scale.reshape(-1, 1).to(cdt)              # (N, K)
    return torch.matmul(x.to(cdt), w.T).to(out_dtype)


def quant_matmul_ref(x, packed, scale, bits: int, k: int, *, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(packed, scale);  x ``(M, K)``, packed ``(N, ceil(K/lanes))``."""
    PLAIN_CALLS["quant_matmul"] += 1
    return dequant_matmul(x, packed, scale, bits, k, out_dtype=out_dtype)
