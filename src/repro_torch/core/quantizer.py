"""Uniform symmetric weight quantizer (port of ``repro/core/quantizer.py``).

Weights: symmetric min-max per output channel, signed b-bit levels in
[-Q, Q] with Q = 2^(b-1) - 1, rounded half to even (``torch.round``, as
``jnp.round``).  Every division here is tensor by tensor: PyTorch's CUDA
division by a host scalar multiplies by the reciprocal, which moves ties.

``bits`` may be any float (QAT passes 32 while pretraining): Q is the f32
value the JAX package computes, see ``qmax``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .packing import VALID_BITS  # noqa: F401  (canonical bit-set, re-exported)

#: ln 2 rounded to f32, the constant ``jnp.exp2`` multiplies by
LN2_F32 = np.float32(0.693147182)


@functools.lru_cache(maxsize=None)
def qmax(bits: float) -> float:
    """Largest positive level 2^(b-1) - 1, as an f32 value.

    ``jnp.exp2(x)`` lowers to ``exp(f32(ln 2) * x)``, so the reference's Q
    is not always a power of two less one: at 32 bits it is 2^31 - 896, at
    16 bits 32766.984375.  The product is rounded to f32, the exponential
    taken in f64 and rounded to f32 (XLA's f32 exponential is correctly
    rounded on these arguments); bits 2-8 give the exact 1, 7, 31, 127.
    """
    x = LN2_F32 * (np.float32(bits) - np.float32(1.0))
    return float(np.float32(np.exp(np.float64(x))) - np.float32(1.0))


def div_exact(a: torch.Tensor, q: float) -> torch.Tensor:
    """``a / q`` as an IEEE division on every device (never ``a * (1/q)``)."""
    return a / torch.full_like(a, q)


def _reduce_axes(w: torch.Tensor, channel_axis: int | None) -> tuple[int, ...]:
    # 1-D tensors and channel_axis=None quantize per tensor
    if channel_axis is None or w.ndim <= 1:
        return tuple(range(w.ndim))
    ch = channel_axis % w.ndim
    return tuple(a for a in range(w.ndim) if a != ch)


def weight_scale(w: torch.Tensor, bits: float, *, channel_axis: int | None = -1,
                 mode: str = "max") -> torch.Tensor:
    """Quantization step ``max|w| / Q`` in keepdims layout, f32 (``mode="max"`` only).

    The channel maximum and its guard are taken in ``w``'s dtype and the
    division in f32, as the JAX package promotes them.
    """
    if mode != "max":
        raise ValueError(f"unknown scale mode {mode!r} (the port implements 'max')")
    amax = torch.amax(w.abs(), dim=_reduce_axes(w, channel_axis), keepdim=True)
    # guard all-zero channels: the scale stays strictly positive
    amax = torch.clamp_min(amax, 1e-12)
    return div_exact(amax.to(torch.float32), qmax(bits))


def quantize(w: torch.Tensor, scale: torch.Tensor, bits: float) -> torch.Tensor:
    """w -> int32 integer levels (packing is a separate concern)."""
    q = qmax(bits)
    return torch.clamp(torch.round(w / scale), -q, q).to(torch.int32)


def dequantize(levels: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return levels.to(torch.float32) * scale


def quantize_dequantize(w: torch.Tensor, bits: float, *, channel_axis: int | None = -1,
                        mode: str = "max") -> torch.Tensor:
    """Round-trip ``w`` through the b-bit grid (no gradient tricks)."""
    scale = weight_scale(w, bits, channel_axis=channel_axis, mode=mode)
    q = qmax(bits)
    lev = torch.clamp(torch.round(w / scale), -q, q)
    return (lev * scale).to(w.dtype)
