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
from typing import Literal

import numpy as np
import torch

from .packing import VALID_BITS  # noqa: F401  (canonical bit-set, re-exported)

ScaleMode = Literal["max", "sigma"]

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
                 mode: str = "max", sigma_k: float = 3.0) -> torch.Tensor:
    """Quantization step ``amax / Q`` in keepdims layout, f32: ``amax`` is
    ``max|w|`` (``mode="max"``) or ``sigma_k`` population standard
    deviations (``mode="sigma"``).

    The channel statistic and its guard are taken in ``w``'s dtype and the
    division in f32, as the JAX package promotes them.
    """
    axes = _reduce_axes(w, channel_axis)
    if mode == "max":
        amax = torch.amax(w.abs(), dim=axes, keepdim=True)
    elif mode == "sigma":
        amax = sigma_k * torch.std(w, dim=axes, keepdim=True, correction=0)
    else:
        raise ValueError(f"unknown scale mode {mode!r}")
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
                        mode: str = "max", sigma_k: float = 3.0) -> torch.Tensor:
    """Round-trip ``w`` through the b-bit grid (no gradient tricks)."""
    scale = weight_scale(w, bits, channel_axis=channel_axis, mode=mode, sigma_k=sigma_k)
    q = qmax(bits)
    lev = torch.clamp(torch.round(w / scale), -q, q)
    return (lev * scale).to(w.dtype)


# ---------------------------------------------------------------------------
# Straight-through estimator fake-quant (QAT forward op)
# ---------------------------------------------------------------------------


class _FakeQuant(torch.autograd.Function):
    """Forward: quantize-dequantize; backward: the gradient where ``|w| <=
    Q * scale``, zero elsewhere (the reference's ``_fq_bwd``)."""

    @staticmethod
    def forward(ctx, w, bits, channel_axis, mode):
        scale = weight_scale(w, bits, channel_axis=channel_axis, mode=mode)
        q = qmax(bits)
        lev = torch.clamp(torch.round(w / scale), -q, q)
        ctx.save_for_backward((w.abs() <= q * scale).to(w.dtype))
        return (lev * scale).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return g * inside, None, None, None


def fake_quant(w: torch.Tensor, bits, channel_axis: int | None = -1,
               mode: str = "max") -> torch.Tensor:
    """STE fake-quant: forward = quantize-dequantize, backward = clipped
    identity (gradients flow where ``|w|`` lies inside the clip range).
    ``bits`` may be a number or a scalar tensor; it gets no gradient."""
    return _FakeQuant.apply(w, float(bits), channel_axis, mode)


# ---------------------------------------------------------------------------
# Activation quantization (asymmetric, percentile clipped), paper §IV-C
# ---------------------------------------------------------------------------

_F32_TINY = float(np.finfo(np.float32).tiny)


def _exp2_f32(x: float) -> float:
    """``jnp.exp2`` of an f32 value: ``exp(f32(ln 2) * x)``, as ``qmax``."""
    return float(np.float32(np.exp(np.float64(LN2_F32 * np.float32(x)))))


def activation_range(x: torch.Tensor, percentile: float = 99.9
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric clip range from the +/- percentile of the batch, f32
    scalars (``jnp.percentile``'s arithmetic, ``quant.calibration.percentiles``)."""
    from repro_torch.quant.calibration import percentiles

    lo, hi = percentiles(x, (100.0 - percentile, percentile))
    hi = torch.maximum(hi, lo + _F32_TINY)
    return lo.to(torch.float32), hi.to(torch.float32)


def fake_quant_activation(x: torch.Tensor, bits: float = 8, *, lo=None, hi=None,
                          percentile: float = 99.9) -> torch.Tensor:
    """Asymmetric b-bit fake-quant of activations with percentile clipping.

    Without calibrated ``(lo, hi)`` the range comes from the batch itself.
    The gradient is the identity (``x + (y - x).detach()``, the reference's
    ``stop_gradient`` form, so the forward rounds as the reference's does).
    """
    if lo is None or hi is None:
        lo, hi = activation_range(x, percentile)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=x.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=x.device)
    levels = torch.tensor(_exp2_f32(float(bits)) - np.float32(1.0), dtype=torch.float32,
                          device=x.device)
    scale = torch.clamp_min((hi - lo) / levels, _F32_TINY)
    q = torch.round((torch.clamp(x, lo, hi) - lo) / scale)
    y = q * scale + lo
    return x + (y.to(x.dtype) - x).detach()
