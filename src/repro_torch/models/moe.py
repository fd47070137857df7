"""Mixture-of-Experts FFN: shared + routed top-k with capacity dispatch
(port of ``repro/models/moe.py``).

Sort-based capacity dispatch, as in the JAX package:

  1. router -> top-k expert ids + renormalized gates per token
  2. assignments sorted by expert; position-in-expert = rank - expert start
  3. tokens written into an (E, C, d) buffer (capacity C, overflow dropped)
  4. the expert matmuls (E, C, d) x (E, d, f): packed weights in one kernel
     launch over all experts (``qt_matmul`` on the stacked tensor)
  5. results gathered back and combined with the gates; shared experts dense

Where the reference's bits depend on an order, the port keeps that order:
top-k ties go to the lower expert (a stable descending sort, as
``jax.lax.top_k``), the assignment sort is stable (``jnp.argsort``), and each
token's k contributions are summed from zero in ascending expert order, the
order the reference's scatter-add meets them, without atomics.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.dist import expert_parallel
from repro_torch.kernels.fake_quant.ops import fake_quant_ste
from repro_torch.kernels.quant_matmul.ops import qt_matmul
from repro_torch.quant.tensor import QuantizedTensor
from . import layers


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def capacity(n_tokens: int, cfg) -> int:
    """Slots of each expert's buffer for ``n_tokens`` tokens: the reference's
    float expression, rounded up to a multiple of 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.moe_capacity_factor) + 1
    return _round_up(c, 8)


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32, *, lead=(), device) -> dict:
    """Router ``(d, E)`` in f32, stacked experts ``(E, d, f)`` / ``(E, f, d)``,
    and the shared experts as one MLP of width ``n_shared_experts * d_ff``;
    every leaf stacked over ``lead``.  The experts are scaled in place before
    the cast, so a stack costs one f32 transient."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, std):
        w = torch.randn((*lead, *shape), generator=generator, device=device)
        return w.mul_(std).to(dtype)

    p = {
        "router": layers.dense_init(generator, d, e, torch.float32, lead=lead, device=device),
        "w_gate": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_up": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared_experts:
        shared_cfg = dataclasses.replace(cfg, d_ff=cfg.n_shared_experts * cfg.d_ff)
        p["shared"] = layers.mlp_init(generator, shared_cfg, dtype, lead=lead, device=device)
    return p


def _expert_weight(w, bits, dtype=None, impl: str = "auto"):
    """Stacked ``(E, ., .)`` expert weights: dequantized (packed) or
    fake-quantized (QAT) or as they are.  The QAT branch takes the caller's
    ``impl``: on a CUDA tensor ``"auto"`` runs the fake-quant kernel on the
    stack as a ``(-1, N)`` view, one scale per output channel over E and K,
    which is the scale the reference computes for a stack."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize(dtype or torch.bfloat16)
    if bits is not None:
        return fake_quant_ste(w, bits, impl)
    return w


def _expert_weights(p: dict, bits, dtype, impl: str) -> tuple:
    """The three stacks as the expert linears take them: packed, or float
    (fake-quantized under QAT)."""
    if isinstance(p["w_gate"], QuantizedTensor):
        return p["w_gate"], p["w_up"], p["w_down"]
    return tuple(_expert_weight(p[n], None if bits is None else bits.get(n), dtype, impl)
                 for n in ("w_gate", "w_up", "w_down"))


def _experts(buf: torch.Tensor, ws: tuple, dtype, impl: str) -> torch.Tensor:
    """The expert MLP on an ``(E, C, d)`` buffer: a packed stack in one launch
    per linear."""
    wg, wu, wd = ws
    if isinstance(wg, QuantizedTensor):
        g = qt_matmul(buf, wg, impl=impl, out_dtype=dtype)
        u = qt_matmul(buf, wu, impl=impl, out_dtype=dtype)
        h = F.silu(g) * u
        return qt_matmul(h, wd, impl=impl, out_dtype=dtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg.to(dtype))) * torch.einsum(
        "ecd,edf->ecf", buf, wu.to(dtype))
    return torch.einsum("ecf,efd->ecd", h, wd.to(dtype))


def _route(p: dict, xf: torch.Tensor, cfg):
    """Top-k expert ids ``(t, k)`` and renormalized gates, the router in f32."""
    logits = torch.matmul(xf.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def dispatch(eidx: torch.Tensor, n_experts: int, c: int):
    """Sort ``(t, k)`` assignments by expert (stably): the sorted order, the
    experts and tokens in it, each one's position in its expert, and which
    fit the capacity ``c``."""
    t, k = eidx.shape
    e_flat = eidx.reshape(-1)
    t_flat = torch.arange(t, device=eidx.device).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    e_s, t_s = e_flat[order], t_flat[order]
    starts = torch.searchsorted(e_s, torch.arange(n_experts, device=eidx.device))
    pos = torch.arange(t * k, device=eidx.device) - starts[e_s]
    return order, e_s, t_s, pos, pos < c


def _routed(p: dict, xf: torch.Tensor, gates, eidx, e: int, c: int, bits,
            impl: str) -> torch.Tensor:
    """Steps 2-5 on one device's tokens ``(t, d)``."""
    t, d = xf.shape
    k = eidx.shape[1]

    # 2. sort assignments by expert
    order, e_s, t_s, pos, keep = dispatch(eidx, e, c)
    g_s = gates.reshape(-1)[order]

    # 3. the kept assignments into the capacity buffer: each kept (e, pos) is
    # one row, so a plain write; dropped ones go to a spare row past the end
    slot = torch.where(keep, e_s * c + pos, e * c)
    buf = torch.zeros((e * c + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[t_s]
    buf = buf[:e * c].view(e, c, d)

    # 4. the expert matmuls
    y_e = _experts(buf, _expert_weights(p, bits, xf.dtype, impl), xf.dtype, impl)

    # 5. gather back and combine: each token's k contributions in ascending
    # expert order (the sorted order), summed from zero in x's dtype
    y_tok = y_e[e_s, torch.where(keep, pos, 0)] * (g_s * keep)[:, None].to(xf.dtype)
    per_tok = torch.empty_like(y_tok)
    per_tok[order] = y_tok
    per_tok = per_tok.view(t, k, d)
    by_expert = torch.argsort(eidx, dim=1)
    rows = torch.arange(t, device=xf.device)
    y = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        y = y + per_tok[rows, by_expert[:, j]]
    return y


def moe_mlp(p: dict, x: torch.Tensor, cfg, *, bits=None, impl: str = "auto") -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    c = capacity(t, cfg)
    xf = x.reshape(t, d)

    # 1. routing (pad tokens route and take capacity, as in the reference)
    _, gates, eidx = _route(p, xf, cfg)

    # 2-5 on DTensors (the dry-run's mesh): the same global dispatch on every
    # rank, the buffer written and read shard-locally, the experts split over
    # the mesh as their weights are
    if expert_parallel.is_distributed(x):
        y = expert_parallel.routed_experts(
            x, gates, eidx, n_experts=e, capacity=c,
            weights=_expert_weights(p, bits, x.dtype, impl), dispatch=dispatch,
            experts=lambda buf, ws: _experts(buf, ws, x.dtype, impl))
    else:
        y = _routed(p, xf, gates, eidx, e, c, bits, impl)
    y = y.reshape(b, s, d)

    if "shared" in p:
        y = y + layers.mlp(p["shared"], x, cfg.mlp,
                           bits=None if bits is None else bits.get("shared"), impl=impl)
    return y


def aux_load_balance_loss(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction * prob per expert)."""
    t = x.shape[0] * x.shape[1]
    probs, _, eidx = _route(p, x.reshape(t, -1), cfg)
    frac = F.one_hot(eidx, cfg.n_experts).to(torch.float32).mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac * probs.mean(0))
