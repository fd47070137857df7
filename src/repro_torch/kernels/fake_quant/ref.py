"""Plain PyTorch versions of fused fake-quant and its STE backward
(``repro/kernels/fake_quant/ref.py`` and the backward of ``ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import qmax
from repro_torch.kernels import PLAIN_CALLS


def fake_quant_ref(w: torch.Tensor, scale: torch.Tensor, bits: float) -> torch.Tensor:
    """``clip(round(w / scale), -q, q) * scale`` in f32, cast to w's dtype.

    ``scale`` broadcasts against ``w`` (keepdims layout of ``weight_scale``).
    """
    PLAIN_CALLS["fake_quant"] += 1
    q = qmax(bits)
    lev = torch.clamp(torch.round(w.to(torch.float32) / scale), -q, q)
    return (lev * scale).to(w.dtype)


def fake_quant_ste_bwd_ref(w: torch.Tensor, scale: torch.Tensor, bits: float,
                           g: torch.Tensor) -> torch.Tensor:
    """The straight-through gradient ``g * (|w| <= q * scale)``."""
    PLAIN_CALLS["fake_quant_ste_bwd"] += 1
    inside = (w.abs() <= qmax(bits) * scale).to(w.dtype)
    return g * inside
