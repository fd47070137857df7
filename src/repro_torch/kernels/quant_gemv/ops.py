"""Public quantized GEMV with impl dispatch (mirrors ``repro/kernels/quant_gemv/ops.py``).

  "cuda"   the hand-written Hopper kernel (kernel.py)
  "torch"  the plain PyTorch version (ref.py)
  "auto"   "cuda" for CUDA tensors, "torch" for CPU tensors
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, resolve_impl  # noqa: F401
from .kernel import quant_gemv_cuda
from .ref import quant_gemv_ref


def quant_gemv(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, bits: int,
               k: int, *, impl: str = "auto", out_dtype=None) -> torch.Tensor:
    """``(..., M, K)`` with prod(leading) * M <= GEMV_MAX_M -> ``(..., M, N)``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if resolve_impl(impl, x.device) == "torch":
        y = quant_gemv_ref(x2, packed, scale, bits, k, out_dtype=out_dtype)
    else:
        y = quant_gemv_cuda(x2, packed, scale, bits=bits, k=k).to(out_dtype or x.dtype)
    return y.reshape(*lead, -1)
