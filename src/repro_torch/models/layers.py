"""Shared layer library, dense family (port of ``repro/models/layers.py``).

Conventions: params are nested dicts of tensors; dense kernels are
``(in, out)``; a ``QuantizedTensor`` weight runs through the packed
dequant-matmul kernels (serving).  Activations keep the JAX layouts:
``(B, S, H, hd)`` for heads.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.quant_kv.ops import quant_kv_decode_step
from repro_torch.kernels.quant_matmul.ops import qt_matmul
from repro_torch.quant.tensor import QuantizedTensor

# ---------------------------------------------------------------------------
# initializers (stacked over ``lead`` leading dims, e.g. (n_layers,))
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype=torch.float32, *,
               lead: tuple[int, ...] = (), device) -> torch.Tensor:
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((*lead, d_in, d_out), generator=generator, device=device) * std
    return w.to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype=torch.float32, *,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=device) * 0.02
    return w.to(dtype)


# ---------------------------------------------------------------------------
# dense, norms, rotary embeddings
# ---------------------------------------------------------------------------


def qdense(w: Any, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """x @ w for a float weight or a packed ``QuantizedTensor`` (serving)."""
    if isinstance(w, QuantizedTensor):
        return qt_matmul(x, w, impl=impl, out_dtype=x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32 (not HF Gemma's ``1 + scale``)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _check_norm(kind: str) -> None:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet (ROADMAP queue 1, "
                                  "'Other model families')")


def norm(p: Any, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    _check_norm(kind)
    return rmsnorm(p, x, eps)


def norm_init(d: int, kind: str, dtype=torch.float32, *, lead: tuple[int, ...] = (),
              device) -> torch.Tensor:
    _check_norm(kind)
    return torch.ones((*lead, d), dtype=dtype, device=device)


def rope_freqs(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int — half-split rotation."""
    hd = x.shape[-1]
    ang = positions[..., None].to(torch.float32) * rope_freqs(hd, theta, device=x.device)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def position_ids(batch: int, seq: int, *, device) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

FLASH_THRESHOLD = 2_048  # the direct path below this length (the only one ported)


def attention_init(generator, cfg, dtype=torch.float32, *, lead=(), device) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    p = {
        "wq": dense_init(generator, d, cfg.n_heads * hd, dtype, lead=lead, device=device),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, dtype, lead=lead, device=device),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, dtype, lead=lead, device=device),
        "wo": dense_init(generator, cfg.n_heads * hd, d, dtype, lead=lead, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd)


def _qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor, *, impl: str = "auto"):
    hd = cfg.resolved_head_dim
    if "wqkv" in p:
        # pack-time fused projection group: one packed buffer, one launch,
        # split on the N-contiguous output
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        qf, kf, vf = torch.split(qdense(p["wqkv"], x, impl=impl), [nq, nkv, nkv], dim=-1)
    else:
        qf, kf, vf = (qdense(p[n], x, impl=impl) for n in ("wq", "wk", "wv"))
    q = _split_heads(qf, cfg.n_heads, hd)
    k = _split_heads(kf, cfg.n_kv_heads, hd)
    v = _split_heads(vf, cfg.n_kv_heads, hd)
    return _qkv_post(p, q, k, v, cfg, positions)


def _qkv_post(p: dict, q, k, v, cfg, positions):
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope == "default":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope {cfg.rope!r} is not ported yet "
                                  "(ROADMAP queue 1, 'Other model families')")
    return q, k, v


def _direct_attention(q, k, v, n_kv: int, *, causal: bool, window: int = 0,
                      kv_valid: torch.Tensor | None = None, q_offset: int | None = None):
    """Materialized-scores attention (plain PyTorch; not a TPU kernel).

    Scores and the probability-weighted sum accumulate in f32 from the
    storage dtype, as the JAX einsums with ``preferred_element_type=f32``.
    """
    b, sq, hq, hd = q.shape
    skv = k.shape[1]
    g = hq // n_kv
    qg = q.reshape(b, sq, n_kv, g, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg.to(torch.float32), k.to(torch.float32))
    s = s * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    off = (skv - sq) if q_offset is None else q_offset
    if causal:
        mask &= k_pos <= (q_pos + off)
    if window:
        mask &= k_pos > (q_pos + off - window)
    if kv_valid is not None and kv_valid.ndim == 2:          # per-slot validity (B, skv)
        full = mask[None, None, None] & kv_valid[:, None, None, None, :]
        s = torch.where(full, s, -1e30)
    else:
        if kv_valid is not None:
            mask &= kv_valid[None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkh->bqkgh", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return o.reshape(b, sq, hq, hd).to(q.dtype)


def decode_attend_one(cache, q, k_new, v_new, pos, cfg, *, window: int = 0,
                      impl: str = "auto"):
    """Write ONE position's K/V at ``pos`` (B,) and attend over ``cache[: pos+1]``.

    ``cache`` is an fp ``{"k", "v"}`` dict or a ``QuantizedKVLayer``; both are
    updated in place.  Returns ``(o (B, 1, hq, hd), cache)``.
    """
    b = q.shape[0]
    posv = torch.as_tensor(pos, device=q.device).reshape(-1)
    if isinstance(cache, dict):
        skv = cache["k"].shape[1]
        rows = torch.arange(b, device=q.device)
        posb = posv.expand(b).to(torch.long)
        cache["k"][rows, posb] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, posb] = v_new[:, 0].to(cache["v"].dtype)
        kv_valid = torch.arange(skv, device=q.device)[None, :] <= posb[:, None]
        if window:
            kv_valid &= torch.arange(skv, device=q.device)[None, :] > (posb[:, None] - window)
        o = _direct_attention(q, cache["k"], cache["v"], cfg.n_kv_heads, causal=False,
                              kv_valid=kv_valid)
        return o, cache
    skv = cache.seq
    ar = torch.arange(skv, device=q.device)[None, :]
    kv_valid = (ar <= posv[:, None]).expand(b, skv)
    if window:
        kv_valid = kv_valid & (ar > (posv[:, None] - window)).expand(b, skv)
    # ONE dispatch per layer: requantize the touched block + attend
    return quant_kv_decode_step(q, cache, posv, k_new, v_new, kv_valid, impl=impl,
                                out_dtype=q.dtype)


def _decode_positions(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1, 1).expand(b, 1)


def attention_decode(p: dict, x: torch.Tensor, cache: dict, pos, cfg, *, window: int = 0,
                     impl: str = "auto"):
    """One decode step over an fp ``{"k", "v"}`` cache (updated in place)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, _decode_positions(pos, b, x.device), impl=impl)
    o, cache = decode_attend_one(cache, q, k_new, v_new, pos, cfg, window=window, impl=impl)
    return qdense(p["wo"], o.reshape(b, 1, -1), impl=impl), cache


def attention_decode_quant(p: dict, x: torch.Tensor, cache, pos, cfg, *, window: int = 0,
                           impl: str = "auto"):
    """One decode step over a packed ``QuantizedKVLayer`` (updated in place).

    The JAX package's projection-fused branch is gated off at full width
    (f32 activations and d <= 512 only), so this is always the unfused one.
    """
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, _decode_positions(pos, b, x.device), impl=impl)
    o, cache = decode_attend_one(cache, q, k_new, v_new, pos, cfg, window=window, impl=impl)
    o = o.to(x.dtype)
    return qdense(p["wo"], o.reshape(b, 1, -1), impl=impl), cache


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_init(generator, cfg, dtype=torch.float32, *, lead=(), device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, d, f, dtype, lead=lead, device=device),
            "w_up": dense_init(generator, d, f, dtype, lead=lead, device=device),
            "w_down": dense_init(generator, f, d, dtype, lead=lead, device=device),
        }
    return {"w_up": dense_init(generator, d, f, dtype, lead=lead, device=device),
            "w_down": dense_init(generator, f, d, dtype, lead=lead, device=device)}


def mlp(p: dict, x: torch.Tensor, kind: str, *, impl: str = "auto") -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        if "w_gu" in p:  # pack-time fused gate|up group (one launch, halve)
            g, u = torch.chunk(qdense(p["w_gu"], x, impl=impl), 2, dim=-1)
        else:
            g = qdense(p["w_gate"], x, impl=impl)
            u = qdense(p["w_up"], x, impl=impl)
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        return qdense(p["w_down"], act * u, impl=impl)
    h = F.gelu(qdense(p["w_up"], x, impl=impl), approximate="tanh")
    return qdense(p["w_down"], h, impl=impl)
