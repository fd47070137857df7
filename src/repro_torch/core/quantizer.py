"""Uniform symmetric weight quantizer (the serving half of ``repro/core/quantizer.py``).

Weights: symmetric min-max per output channel, signed b-bit levels in
[-Q, Q] with Q = 2^(b-1) - 1, rounded half to even (``torch.round``, as
``jnp.round``).  Every division here is tensor by tensor: PyTorch's CUDA
division by a host scalar multiplies by the reciprocal, which moves ties.
"""
from __future__ import annotations

import torch

from .packing import VALID_BITS  # noqa: F401  (canonical bit-set, re-exported)


def qmax(bits: int) -> float:
    """Largest positive level for signed symmetric quantization: 2^(b-1)-1."""
    return 2.0 ** (int(bits) - 1) - 1.0


def div_exact(a: torch.Tensor, q: float) -> torch.Tensor:
    """``a / q`` as an IEEE division on every device (never ``a * (1/q)``)."""
    return a / torch.full_like(a, q)


def weight_scale(w: torch.Tensor, bits: int, *, channel_axis: int | None = -1,
                 mode: str = "max") -> torch.Tensor:
    """Quantization step ``max|w| / Q`` in keepdims layout (``mode="max"`` only).

    1-D tensors and ``channel_axis=None`` reduce over every axis.
    """
    if mode != "max":
        raise ValueError(f"unknown scale mode {mode!r} (the port serves 'max')")
    if channel_axis is None or w.ndim <= 1:
        axes = tuple(range(w.ndim))
    else:
        ch = channel_axis % w.ndim
        axes = tuple(a for a in range(w.ndim) if a != ch)
    amax = torch.amax(w.abs(), dim=axes, keepdim=True)
    # guard all-zero channels: the scale stays strictly positive
    amax = torch.clamp_min(amax, 1e-12)
    return div_exact(amax, qmax(bits)).to(torch.float32)


def quantize(w: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """w -> int32 integer levels (packing is a separate concern)."""
    q = qmax(bits)
    return torch.clamp(torch.round(w / scale), -q, q).to(torch.int32)


def dequantize(levels: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return levels.to(torch.float32) * scale
