"""Public quantized matmul with impl dispatch (mirrors ``repro/kernels/quant_matmul/ops.py``).

  "cuda"   a hand-written Hopper kernel: the skinny-M GEMV (kernels/
           quant_gemv) when M <= GEMV_MAX_M — the decode regime — else the
           tiled GEMM (kernel.py)
  "torch"  the plain PyTorch version (ref.py; the GEMV's for M <= 8, so the
           plain counts line up with the kernel launches)
  "auto"   "cuda" for CUDA tensors, "torch" for CPU tensors
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, resolve_impl  # noqa: F401
from repro_torch.kernels.quant_gemv.kernel import (GEMV_MAX_M, quant_gemv_cuda,
                                                   quant_gemv_experts_cuda)
from repro_torch.kernels.quant_gemv.ref import quant_gemv_experts_ref, quant_gemv_ref
from .kernel import quant_matmul_cuda, quant_matmul_experts_cuda
from .ref import quant_matmul_experts_ref, quant_matmul_ref


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


def quant_matmul_experts(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                         bits: int, k: int, *, impl: str = "auto",
                         out_dtype=None) -> torch.Tensor:
    """An expert stack in one launch: x ``(E, C, K)`` against packed ``(E, N,
    ceil(K/lanes))``, the scale broadcasting to ``(E, 1, N)`` -> ``(E, C, N)``.

    The GEMV for C <= GEMV_MAX_M, else the GEMM: the rule the JAX package's
    vmapped dispatch applies to each expert's C rows.
    """
    impl, kernel = resolve_kernel(impl, x.shape[1], x.device)
    if impl == "torch":
        ref = quant_gemv_experts_ref if kernel == "gemv" else quant_matmul_experts_ref
        return ref(x, packed, scale, bits, k, out_dtype=out_dtype)
    run = quant_gemv_experts_cuda if kernel == "gemv" else quant_matmul_experts_cuda
    return run(x, packed, scale, bits=bits, k=k).to(out_dtype or x.dtype)


def qt_matmul(x: torch.Tensor, qt, *, impl: str = "auto", out_dtype=None) -> torch.Tensor:
    """Matmul against a ``QuantizedTensor`` (repro_torch.quant.tensor).

    2-D ``qt``: plain dispatch.  Stacked ``qt`` (leading expert dims, packed
    ``(..., N, K/lanes)``): each leading index against the matching leading
    index of ``x``, as the JAX package's ``jax.vmap`` maps them, in one
    launch over the flattened stack (the MoE expert matmul ``(E, C, d) x
    (E, d, f)``, no dequantized weights); ``x``'s rows past the leading dims
    flatten into C.  The per-channel scale, ``(1, 1, N)`` for an ``(E, d, f)``
    stack, is broadcast to the stack.
    """
    if qt.packed.ndim == 2:
        return quant_matmul(x, qt.packed, qt.scale.reshape(1, -1), qt.bits, qt.k, impl=impl,
                            out_dtype=out_dtype)
    n_batch = qt.packed.ndim - 2
    lead = tuple(qt.packed.shape[:n_batch])
    if x.ndim < n_batch + 2 or tuple(x.shape[:n_batch]) != lead:
        raise ValueError(f"batched QuantizedTensor {lead} needs x with matching leading "
                         f"dims, got x{tuple(x.shape)}")
    e, n = math.prod(lead), qt.n
    scale = qt.scale
    if scale.numel() != n:
        scale = torch.broadcast_to(scale, lead + tuple(scale.shape[n_batch:]))
    y = quant_matmul_experts(x.reshape(e, -1, x.shape[-1]),
                             qt.packed.reshape(e, n, qt.packed.shape[-1]),
                             scale.reshape(-1, 1, n).contiguous(), qt.bits, qt.k, impl=impl,
                             out_dtype=out_dtype)
    return y.reshape(*x.shape[:-1], n)


def qt_matmul_arrays(x, packed, scale, bits: int, k: int, *, impl: str = "auto",
                     out_dtype=None) -> torch.Tensor:
    """:func:`quant_matmul` on a 2-D weight's arrays, the scale of any shape of N entries."""
    return quant_matmul(x, packed, scale.reshape(1, -1), bits, k, impl=impl, out_dtype=out_dtype)
