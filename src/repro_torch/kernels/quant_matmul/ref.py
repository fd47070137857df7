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


def split_f32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 x as the CUDA GEMM splits it: three bf16 pieces with hi + mid + lo
    == x exactly for normal values (hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid); each difference is exact in f32)."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def quant_matmul_mirror(x, packed, scale, bits: int, k: int, *, splits: int = 1,
                        k_step: int = 64) -> torch.Tensor:
    """A CPU mirror of the CUDA GEMM's arithmetic, for the tests (uncounted).

    Integer levels in bf16 (exact), bf16 x as it is and f32 x as its three
    pieces, products summed in f32 over each of ``splits`` K ranges (cut at
    multiples of ``k_step`` as the kernel cuts them; for f32 x each step's
    sum apart, then the steps' sums in order), the ranges' sums added in
    order, and the per-channel scale applied last.
    """
    levels = packing.unpack(packed, bits, k).to(torch.bfloat16).float()      # (N, K)
    f32 = x.dtype == torch.float32
    pieces = split_f32(x.float()) if f32 else (x.to(torch.bfloat16),)
    nk = -(-k // k_step)

    def partial(k0, k1):
        out = None
        for p in pieces:
            prod = p[:, k0:k1].float() @ levels[:, k0:k1].T
            out = prod if out is None else out + prod
        return out

    total = None
    for s in range(splits):
        a, b = s * nk // splits, (s + 1) * nk // splits
        if f32:
            part = None
            for j in range(a, b):
                step = partial(min(k_step * j, k), min(k_step * (j + 1), k))
                part = step if part is None else part + step
        else:
            part = partial(min(k_step * a, k), min(k_step * b, k))
        total = part if total is None else total + part
    return (total * scale.reshape(1, -1).float()).to(x.dtype)
