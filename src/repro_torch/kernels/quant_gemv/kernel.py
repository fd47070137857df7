"""ctypes binding of the CUDA GEMV (``csrc/quant_gemv.cu``), M <= GEMV_MAX_M."""
from __future__ import annotations

import torch

from repro_torch.core.packing import LANES
from repro_torch.kernels import LAUNCHES, _build

#: largest M served by the GEMV (the decode regime)
GEMV_MAX_M = 8


def check_operands(x, packed, scale, bits: int, k: int, name: str) -> tuple[int, int]:
    """Validate the shared GEMV/GEMM operands; returns ``(M, N)``."""
    _build.require(x, f"{name}: x")
    _build.dtype_code(x, name)
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"{name}: x must be (M, {k}), got {tuple(x.shape)}")
    n = packed.shape[0]
    _build.require(packed, f"{name}: packed", dtype=torch.int8,
                   shape=(n, -(-k // LANES[bits])), device=x.device)
    _build.require(scale, f"{name}: scale", dtype=torch.float32, device=x.device)
    if scale.numel() != n:
        raise ValueError(f"{name}: scale has {scale.numel()} entries for N={n}")
    return x.shape[0], n


def quant_gemv_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                    bits: int, k: int) -> torch.Tensor:
    """``(M, K)`` x against packed ``(N, ceil(K/lanes))`` -> ``(M, N)`` in x's dtype."""
    x = x.contiguous()
    m, n = check_operands(x, packed, scale, bits, k, "quant_gemv")
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"GEMV is for 1 <= M <= {GEMV_MAX_M}, got M={m}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _build.lib().rq_quant_gemv(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
        packed.shape[1], bits, _build.dtype_code(x, "quant_gemv"), _build.stream_of(x))
    LAUNCHES["quant_gemv"] += 1
    _build.check(rc, "quant_gemv")
    return y
