"""Plain PyTorch version of the skinny-M quantized GEMV.

The GEMV computes the same contraction as the GEMM on the same packed
layout, so its plain version is the shared unpack -> dequant -> matmul; it
is its own symbol (and count) so dispatch and tests read unambiguously.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import PLAIN_CALLS
from repro_torch.kernels.quant_gemv.kernel import k_ranges, split_of
from repro_torch.kernels.quant_matmul.ref import dequant_matmul, experts_matmul, split_f32


def quant_gemv_ref(x, packed, scale, bits: int, k: int, *, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(packed, scale);  x ``(M, K)`` -> ``(M, N)``."""
    PLAIN_CALLS["quant_gemv"] += 1
    return dequant_matmul(x, packed, scale, bits, k, out_dtype=out_dtype)


def quant_gemv_experts_ref(x, packed, scale, bits: int, k: int, *,
                           out_dtype=None) -> torch.Tensor:
    """The GEMV's expert stack, C <= 8: ``(E, C, K)`` x ``(E, N, Kp)`` -> ``(E, C, N)``,
    each expert what :func:`quant_gemv_ref` gives on its slice."""
    PLAIN_CALLS["quant_gemv_experts"] += 1
    return experts_matmul(x, packed, scale, bits, k, out_dtype=out_dtype)


def quant_gemv_mirror(x, packed, scale, bits: int, k: int, *, rows: int = 64) -> torch.Tensor:
    """A CPU mirror of the CUDA GEMV's arithmetic, for the tests (uncounted).

    Integer levels (exact in bf16), bf16 x as it is and f32 x as its three
    bf16 pieces (``split_f32``); K cut into the plan's ranges
    (``kernel.k_ranges(k, kernel.split_of(k))``: K alone); each range's sum
    of the exact products taken in f64 and rounded to f32 (the kernel sums
    a range on the tensor cores, whose internal order it does not repeat);
    the ranges' sums added in f32 from zero in range order; the per-channel
    scale last.  Each output is a reduction over K alone, so a channel's
    value does not depend on M or N.  ``rows`` channels at a time.
    """
    pieces = split_f32(x.float()) if x.dtype == torch.float32 else (x.to(torch.bfloat16),)
    pieces = [p.double() for p in pieces]
    ranges = k_ranges(k, split_of(k))
    out = []
    for n0 in range(0, packed.shape[0], rows):
        lev = packing.unpack(packed[n0:n0 + rows], bits, k).double()          # (n, K)
        total = torch.zeros((x.shape[0], lev.shape[0]), dtype=torch.float32, device=x.device)
        for k0, k1 in ranges:
            part = sum((p[:, None, k0:k1] * lev[None, :, k0:k1]).sum(-1) for p in pieces)
            total = total + part.float()
        out.append(total)
    y = torch.cat(out, dim=1) * scale.reshape(1, -1).float()
    return y.to(x.dtype)
