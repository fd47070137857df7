"""Activation calibration (port of ``repro/quant/calibration.py``, paper
§IV-C): asymmetric ranges at the 99.9th percentile, collected over
calibration batches, and the fake-quant that consumes them in the BOPs-target
mode.

The percentile is ``jnp.percentile``'s linear interpolation, written out in
f32 over the order statistics it needs (``torch.kthvalue``):
``torch.quantile`` refuses inputs above 2^24 elements, which a full-width
activation (gemma-2b's ``w_down`` input at batch 8 x seq 128 holds 16.8 M)
already crosses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ActRange:
    lo: torch.Tensor   # ()
    hi: torch.Tensor   # ()

    def merge(self, other: "ActRange") -> "ActRange":
        return ActRange(torch.minimum(self.lo, other.lo), torch.maximum(self.hi, other.hi))


def percentiles(x: torch.Tensor, ps) -> list[torch.Tensor]:
    """``jnp.percentile(x, p)`` for each ``p`` over the flattened ``x``: the
    interpolation point ``p / 100 * (n - 1)``, its floor and ceil and their
    weights in f32, as the compiled JAX function computes them, and the
    order statistics at floor and ceil (``torch.kthvalue``); NaN if any value
    is NaN."""
    x32 = x.to(torch.float32).reshape(-1)
    n = x32.numel()
    has_nan = torch.isnan(x32).any()
    f = np.float32
    last = f(n) - f(1)              # in f32, as JAX counts; rounds above 2^24
    # XLA turns the division by 100 into a multiply by f32(1 / 100) and folds
    # it into the constant: (p / 100) * last becomes p * (f32(0.01) * last)
    per_point = f(0.01) * last
    order: dict[int, torch.Tensor] = {}

    def at(i) -> torch.Tensor:
        # JAX's gather clamps an index that f32 rounding carried past the end
        i = min(int(min(max(i, f(0)), last)), n - 1)
        if i not in order:
            order[i] = torch.kthvalue(x32, i + 1).values
        return order[i]

    out = []
    for p in ps:
        q = f(p) * per_point
        low, high = np.floor(q), np.ceil(q)
        hw = q - low
        lw = f(1) - hw
        # XLA contracts the sum into fma(high, hw, low * lw); the product of two
        # f32 values is exact in f64, so one rounding of the f64 sum gives it
        v = (at(high).double() * float(hw) + (at(low) * torch.tensor(lw)).double()).float()
        out.append(torch.where(has_nan, torch.full_like(v, float("nan")), v))
    return out


def observe(x: torch.Tensor, percentile: float = 99.9) -> ActRange:
    """Asymmetric percentile-clipped range of one activation batch."""
    lo, hi = percentiles(x, (100.0 - percentile, percentile))
    return ActRange(torch.clamp(lo, max=0.0), torch.clamp(hi, min=0.0))


def calibrate(batches, percentile: float = 99.9) -> ActRange:
    """Union of percentile ranges over calibration batches."""
    r: ActRange | None = None
    for x in batches:
        cur = observe(x, percentile)
        r = cur if r is None else r.merge(cur)
    if r is None:
        raise ValueError("empty calibration stream")
    return r


def fake_quant_act(x: torch.Tensor, r: ActRange, bits: int) -> torch.Tensor:
    """Asymmetric uniform fake-quant into [lo, hi] at ``bits``."""
    n_levels = 2 ** bits - 1
    scale = torch.clamp((r.hi - r.lo) / n_levels, min=1e-12)
    zp = torch.round(-r.lo / scale)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale + zp), 0, n_levels)
    return ((q - zp) * scale).to(x.dtype)
