"""Distribution statistics: sigma and KL divergence (port of ``repro/core/stats.py``).

Quantization as distribution fitting: the empirical weight distribution
(a normalized histogram) is approximated by the distribution of the
dequantized weights, and the mismatch is D_KL(p || p~) over the same fixed
symmetric support with epsilon smoothing.  Every statistic is an f32 tensor
op on the weight's device; the vectors come back to the host as numpy.

The histogram counts are exact integers (``torch.bincount``); the JAX
package scatter-adds f32 ones, which agree with them while a bin holds
fewer than 2^24 weights.
"""
from __future__ import annotations

import numpy as np
import torch

from . import quantizer
from .quantizer import div_exact

# 256 bins == the int8 reference grid (keeps D_KL magnitudes comparable to
# the paper's Table I)
DEFAULT_BINS = 256
_EPS = 1e-10


def layer_sigma(w: torch.Tensor) -> torch.Tensor:
    """The paper's first-order sensitivity proxy: std of the layer weights."""
    return torch.std(w.to(torch.float32), correction=0)


def _histogram(w: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, bins: int) -> torch.Tensor:
    """Normalized histogram of ``w`` over [lo, hi] with ``bins`` bins."""
    w = w.reshape(-1).to(torch.float32)
    width = div_exact(hi - lo, float(bins))
    idx = torch.clamp(((w - lo) / width).to(torch.int64), 0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).to(torch.float32)
    return counts / torch.clamp_min(counts.sum(), 1.0)


def kl_divergence(p: torch.Tensor, q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """D_KL(p || q) with additive smoothing; >= 0, 0 iff p == q."""
    p = p + eps
    q = q + eps
    p = p / p.sum()
    q = q / q.sum()
    return torch.sum(p * (torch.log(p) - torch.log(q)))


def quantization_kl(w: torch.Tensor, bits: float, *, bins: int = DEFAULT_BINS,
                    channel_axis: int | None = -1, mode: str = "max") -> torch.Tensor:
    """D_KL(p_l || p~_l): float weight histogram vs dequantized-weight
    histogram, both over [-max|w|, max|w|]."""
    w32 = w.to(torch.float32)
    amax = torch.clamp_min(torch.amax(w32.abs()), torch.finfo(torch.float32).tiny)
    wq = quantizer.quantize_dequantize(w32, bits, channel_axis=channel_axis, mode=mode)
    p = _histogram(w32, -amax, amax, bins)
    q = _histogram(wq, -amax, amax, bins)
    return kl_divergence(p, q)


def normalized_kl(w: torch.Tensor, bits: float, *, bins: int = DEFAULT_BINS,
                  channel_axis: int | None = -1, ref_bits: int = 2) -> torch.Tensor:
    """D^_KL in [0, 1]: KL at ``bits`` divided by the worst-case (2-bit) KL."""
    kl_b = quantization_kl(w, bits, bins=bins, channel_axis=channel_axis)
    kl_ref = quantization_kl(w, ref_bits, bins=bins, channel_axis=channel_axis)
    return kl_b / torch.clamp_min(kl_ref, 1e-6)


def sensitivity_score(w: torch.Tensor, bits: float, *, sigma_weight: float = 0.5,
                      sigma_ref: float = 0.05, bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Phase-2 sensitivity: ``(1 - a) * D^_KL + a * sigma / sigma_ref``.

    High score => layer is fragile => raise its bits first / lower it last.
    """
    dkl = normalized_kl(w, bits, bins=bins)
    sig = div_exact(layer_sigma(w), sigma_ref)
    return (1.0 - sigma_weight) * dkl + sigma_weight * sig


# ---------------------------------------------------------------------------
# registry-order vectors (the envs supply a weight iterator)
# ---------------------------------------------------------------------------


def sigma_vector(weights) -> np.ndarray:
    """Per-layer weight std-devs (phase-1 clustering features), host-side."""
    return np.asarray([float(layer_sigma(w)) for w in weights])


def sensitivity_vector(weights, bits, **kwargs) -> np.ndarray:
    """Per-layer phase-2 sensitivity scores at the given bits, host-side.

    ``weights`` and ``bits`` iterate in layer-registry order (zip-aligned).
    """
    return np.asarray([float(sensitivity_score(w, b, **kwargs))
                       for w, b in zip(weights, bits)])
