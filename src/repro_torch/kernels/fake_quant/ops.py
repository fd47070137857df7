"""Fused fake-quant with impl dispatch and its straight-through estimator
(mirrors ``repro/kernels/fake_quant/ops.py``).

  "cuda"   the hand-written Hopper kernels (kernel.py)
  "torch"  the plain PyTorch versions (ref.py)
  "auto"   "cuda" for CUDA tensors, "torch" for CPU tensors

The per-output-channel scale (``max|w| / q`` over every axis but the last)
is computed outside the kernel, as in the JAX package.  Unlike the JAX
package, ``"auto"`` on a CUDA tensor launches the kernel for any number of
dimensions (as a ``(-1, N)`` view).  A 2-D transposed view (the tied head's
``emb.T``) is fake-quantized from its storage with one scale per storage
row, so no transposed copy is made; the values are those of the view.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizer
from repro_torch.kernels import resolve_impl
from .kernel import fake_quant_cuda, fake_quant_ste_bwd_cuda
from .ref import fake_quant_ref, fake_quant_ste_bwd_ref


def _transposed(w: torch.Tensor) -> bool:
    return w.ndim == 2 and not w.is_contiguous() and w.T.is_contiguous()


def _forward(w: torch.Tensor, scale: torch.Tensor, bits: float, impl: str,
             rowwise: bool) -> torch.Tensor:
    if resolve_impl(impl, w.device) == "torch":
        return fake_quant_ref(w, scale, bits)
    return fake_quant_cuda(w, scale, bits, rowwise=rowwise)


def fake_quant(w: torch.Tensor, bits: float, *, impl: str = "auto") -> torch.Tensor:
    """Forward-only fused fake-quant (per-output-channel max scaling)."""
    if _transposed(w):
        wt = w.T
        return _forward(wt, quantizer.weight_scale(wt, bits, channel_axis=0), float(bits),
                        impl, True).T
    return _forward(w, quantizer.weight_scale(w, bits, channel_axis=-1), float(bits), impl,
                    False)


class _FakeQuantSTE(torch.autograd.Function):
    """Forward: fused fake-quant.  Backward: the masked identity, recomputed
    from ``w`` (only ``w``, which the caller holds anyway, and the scales are
    saved).  No gradient flows to ``bits`` or to the scale."""

    @staticmethod
    def forward(ctx, w, bits, impl, rowwise):
        scale = quantizer.weight_scale(w, bits, channel_axis=0 if rowwise else -1)
        ctx.save_for_backward(w, scale)
        ctx.bits, ctx.impl, ctx.rowwise = bits, impl, rowwise
        return _forward(w, scale, bits, impl, rowwise)

    @staticmethod
    def backward(ctx, g):
        w, scale = ctx.saved_tensors
        if resolve_impl(ctx.impl, w.device) == "torch":
            dw = fake_quant_ste_bwd_ref(w, scale, ctx.bits, g)
        else:
            dw = fake_quant_ste_bwd_cuda(w, scale, ctx.bits, g, rowwise=ctx.rowwise)
        return dw, None, None, None


def fake_quant_ste(w: torch.Tensor, bits, impl: str = "auto") -> torch.Tensor:
    """STE fake-quant: forward = fused fake-quant, backward = masked identity."""
    if _transposed(w):
        return _FakeQuantSTE.apply(w.T, float(bits), impl, True).T
    return _FakeQuantSTE.apply(w, float(bits), impl, False)
