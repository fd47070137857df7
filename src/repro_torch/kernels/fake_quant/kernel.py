"""ctypes binding of the CUDA fake-quant forward and STE backward (``csrc/fake_quant.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build


def _rows_cols(w: torch.Tensor, scale: torch.Tensor, rowwise: bool, name: str):
    """Validate ``w`` and its scales; returns the storage's ``(rows, cols)``."""
    _build.require(w, f"{name}: w")
    _build.dtype_code(w, name)
    if w.ndim < 2 or (rowwise and w.ndim != 2):
        raise ValueError(f"{name}: w must be 2-D (or n-D per last-axis channel), got "
                         f"{tuple(w.shape)}")
    cols = w.shape[-1]
    rows = w.numel() // cols
    _build.require(scale, f"{name}: scale", dtype=torch.float32, device=w.device)
    if scale.numel() != (rows if rowwise else cols):
        raise ValueError(f"{name}: {scale.numel()} scales for a {'row' if rowwise else 'column'}"
                         f"-wise scale of {tuple(w.shape)}")
    return rows, cols


def fake_quant_cuda(w: torch.Tensor, scale: torch.Tensor, bits: float, *,
                    rowwise: bool = False) -> torch.Tensor:
    """Fake-quantize ``w`` (one scale per column, or per row with ``rowwise``)."""
    w, scale = w.contiguous(), scale.contiguous()
    rows, cols = _rows_cols(w, scale, rowwise, "fake_quant")
    out = torch.empty_like(w)
    if not out.numel():
        return out
    rc = _build.lib().rq_fake_quant(w.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, cols,
                                    float(bits), int(rowwise), _build.dtype_code(w, "fake_quant"),
                                    _build.stream_of(w))
    LAUNCHES["fake_quant"] += 1
    _build.check(rc, "fake_quant")
    return out


def fake_quant_ste_bwd_cuda(w: torch.Tensor, scale: torch.Tensor, bits: float, g: torch.Tensor,
                            *, rowwise: bool = False) -> torch.Tensor:
    """``g * (|w| <= q * scale)``, the mask recomputed from ``w``."""
    w, scale, g = w.contiguous(), scale.contiguous(), g.contiguous()
    rows, cols = _rows_cols(w, scale, rowwise, "fake_quant_ste_bwd")
    _build.require(g, "fake_quant_ste_bwd: g", dtype=w.dtype, shape=tuple(w.shape),
                   device=w.device)
    dw = torch.empty_like(g)
    if not dw.numel():
        return dw
    rc = _build.lib().rq_fake_quant_ste_bwd(
        w.data_ptr(), scale.data_ptr(), g.data_ptr(), dw.data_ptr(), rows, cols, float(bits),
        int(rowwise), _build.dtype_code(w, "fake_quant_ste_bwd"), _build.stream_of(w))
    LAUNCHES["fake_quant_ste_bwd"] += 1
    _build.check(rc, "fake_quant_ste_bwd")
    return dw
