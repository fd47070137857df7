"""Public quantized matmul with impl dispatch (mirrors ``repro/kernels/quant_matmul/ops.py``).

  "cuda"   a hand-written Hopper kernel: the skinny-M GEMV (kernels/
           quant_gemv) when M <= GEMV_MAX_M — the decode regime — else the
           tiled GEMM (kernel.py)
  "torch"  the plain PyTorch version (ref.py; the GEMV's for M <= 8, so the
           plain counts line up with the kernel launches)
  "auto"   "cuda" for CUDA tensors, "torch" for CPU tensors
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, resolve_impl  # noqa: F401
from repro_torch.kernels.quant_gemv.kernel import GEMV_MAX_M, quant_gemv_cuda
from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref
from .kernel import quant_matmul_cuda
from .ref import quant_matmul_ref


def resolve_kernel(impl: str, m: int, device) -> str:
    """Dispatch target ``(impl, kernel)``: impl "cuda" | "torch", kernel "gemv" | "gemm".

    The M <= GEMV_MAX_M -> GEMV rule of the JAX package's ``resolve_kernel``.
    """
    return resolve_impl(impl, device), ("gemv" if m <= GEMV_MAX_M else "gemm")


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, bits: int,
                 k: int, *, impl: str = "auto", out_dtype=None) -> torch.Tensor:
    """``(..., M, K)`` x against packed ``(N, ceil(K/lanes))`` -> ``(..., M, N)``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    impl, kernel = resolve_kernel(impl, x2.shape[0], x.device)
    if impl == "torch":
        ref = quant_gemv_ref if kernel == "gemv" else quant_matmul_ref
        y = ref(x2, packed, scale, bits, k, out_dtype=out_dtype)
    else:
        run = quant_gemv_cuda if kernel == "gemv" else quant_matmul_cuda
        y = run(x2, packed, scale, bits=bits, k=k).to(out_dtype or x.dtype)
    return y.reshape(*lead, -1)


def qt_matmul(x: torch.Tensor, qt, *, impl: str = "auto", out_dtype=None) -> torch.Tensor:
    """Matmul against a 2-D ``QuantizedTensor`` (repro_torch.quant.tensor).

    Stacked (MoE expert) tensors are not ported yet (ROADMAP queue 1, 'Other model families').
    """
    if qt.packed.ndim != 2:
        raise NotImplementedError("stacked QuantizedTensor matmul (MoE experts) is not "
                                  "ported yet: ROADMAP queue 1, 'Other model families'")
    return quant_matmul(x, qt.packed, qt.scale.reshape(1, -1), qt.bits, qt.k, impl=impl,
                        out_dtype=out_dtype)
