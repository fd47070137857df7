"""ctypes binding of the CUDA GEMM (``csrc/quant_matmul.cu``), M > GEMV_MAX_M."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.quant_gemv.kernel import check_operands


def quant_matmul_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                      bits: int, k: int) -> torch.Tensor:
    """``(M, K)`` x against packed ``(N, ceil(K/lanes))`` -> ``(M, N)`` in x's dtype."""
    x = x.contiguous()
    m, n = check_operands(x, packed, scale, bits, k, "quant_matmul")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    rc = _build.lib().rq_quant_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
        packed.shape[1], bits, _build.dtype_code(x, "quant_matmul"), _build.stream_of(x))
    LAUNCHES["quant_matmul"] += 1
    _build.check(rc, "quant_matmul")
    return y
