"""Plain PyTorch version of the skinny-M quantized GEMV.

The GEMV computes the same contraction as the GEMM on the same packed
layout, so its plain version is the shared unpack -> dequant -> matmul; it
is its own symbol (and count) so dispatch and tests read unambiguously.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS
from repro_torch.kernels.quant_matmul.ref import dequant_matmul


def quant_gemv_ref(x, packed, scale, bits: int, k: int, *, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(packed, scale);  x ``(M, K)`` -> ``(M, N)``."""
    PLAIN_CALLS["quant_gemv"] += 1
    return dequant_matmul(x, packed, scale, bits, k, out_dtype=out_dtype)
