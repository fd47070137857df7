"""Shared layer library, dense family (port of ``repro/models/layers.py``).

Conventions: params are nested dicts of tensors; dense kernels are
``(in, out)``; a float weight passes through the fake-quant STE when
``bits`` is given (QAT), and a ``QuantizedTensor`` weight runs through the
packed dequant-matmul kernels (serving).  Per-layer bits are plain floats
in a dict mirroring the param dict.  Activations keep the JAX layouts:
``(B, S, H, hd)`` for heads.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.fake_quant.ops import fake_quant_ste
from repro_torch.kernels.quant_kv.ops import (can_fuse_qkv, quant_kv_decode_step,
                                               quant_kv_decode_step_proj)
from repro_torch.kernels.quant_matmul.ops import qt_matmul
from repro_torch.quant.tensor import QuantizedTensor
from repro_torch.dist import sharding

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


def qdense(w: Any, x: torch.Tensor, *, bits=None, impl: str = "auto") -> torch.Tensor:
    """x @ w with optional QAT fake-quant (``bits``) or a packed
    ``QuantizedTensor`` weight (serving)."""
    if isinstance(w, QuantizedTensor):
        return qt_matmul(x, w, impl=impl, out_dtype=x.dtype)
    if bits is not None:
        w = fake_quant_ste(w, bits, impl)
    return sharding.contiguous_grad(torch.matmul(x, w.to(x.dtype)))


def _b(bits, name):
    return None if bits is None else bits.get(name)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32 (not HF Gemma's ``1 + scale``)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32.  The population
    variance is written out as ``jnp.var`` computes it: ``torch.var``'s f32
    backward parts from the JAX package's (``models/cnn.py`` ``_norm_act``).
    On a DTensor the model dim is made whole first (``sharding.whole_dim``)."""
    x32 = sharding.whole_dim(x).to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def norm(p: Any, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm(p, x, eps) if kind == "rmsnorm" else layernorm(p, x, eps)


def norm_init(d: int, kind: str, dtype=torch.float32, *, lead: tuple[int, ...] = (),
              device):
    """RMSNorm: a ``(*lead, d)`` scale of ones; LayerNorm: ``{"scale", "bias"}``."""
    if kind == "rmsnorm":
        return torch.ones((*lead, d), dtype=dtype, device=device)
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple[int, ...],
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the frequency bands split across the (t, h, w)
    position ids.  x: (B, S, H, hd); positions: (3, B, S) int; ``sections``
    counts the frequencies of each band and sums to hd/2."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    sec_id = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                     torch.tensor(sections, device=x.device),
                                     output_size=sum(sections))
    pos_per_freq = positions[sec_id].permute(1, 2, 0)              # (B, S, hd/2)
    ang = pos_per_freq.to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mrope_sections(hd: int) -> tuple[int, int, int]:
    """The (t, h, w) band sizes over hd/2 frequencies, as the reference splits them."""
    half = hd // 2
    return (half - 2 * (half // 3), half // 3, half // 3)


def position_ids(batch: int, seq: int, rope_kind: str = "default", *, device) -> torch.Tensor:
    """(B, S) positions, or (3, B, S) for M-RoPE (text: the three ids coincide)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)
    if rope_kind == "mrope":
        return pos.expand(3, batch, seq)
    return pos


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

FLASH_THRESHOLD = 2_048  # direct softmax up to this sequence length, flash above
Q_CHUNK = 512
KV_CHUNK = 1_024


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
    return sharding.keep_heads_whole(x, n_heads).reshape(b, s, n_heads, hd)


def _group_heads(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(b, s, hq, hd) -> (b, s, n_kv, hq // n_kv, hd): the query heads by KV group."""
    b, s, hq, hd = x.shape
    return sharding.keep_heads_whole(x, n_kv, dim=2).reshape(b, s, n_kv, hq // n_kv, hd)


def _qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor, *, bits=None,
         impl: str = "auto"):
    hd = cfg.resolved_head_dim
    if "wqkv" in p:
        # pack-time fused projection group: one packed buffer, one launch,
        # split on the N-contiguous output
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        qf, kf, vf = torch.split(qdense(p["wqkv"], x, bits=_b(bits, "wqkv"), impl=impl),
                                 [nq, nkv, nkv], dim=-1)
    else:
        qf, kf, vf = (qdense(p[n], x, bits=_b(bits, n), impl=impl) for n in ("wq", "wk", "wv"))
    q = _split_heads(qf, cfg.n_heads, hd)
    k = _split_heads(kf, cfg.n_kv_heads, hd)
    v = _split_heads(vf, cfg.n_kv_heads, hd)
    return _qkv_post(p, q, k, v, cfg, positions)


def _q_proj(p: dict, x: torch.Tensor, cfg, *, bits=None, impl: str = "auto") -> torch.Tensor:
    """The Q projection alone (the cross-attention query).  On a fused tree
    the whole ``wqkv`` product runs and the K/V columns are dropped, as in
    the JAX package: cross-attention is off the decode step's hot path."""
    if "wqkv" in p:
        nq = cfg.n_heads * cfg.resolved_head_dim
        return qdense(p["wqkv"], x, bits=_b(bits, "wqkv"), impl=impl)[..., :nq]
    return qdense(p["wq"], x, bits=_b(bits, "wq"), impl=impl)


def _kv_proj(p: dict, x: torch.Tensor, cfg, *, bits=None, impl: str = "auto"):
    """The K and V projections alone (the cross-attention K/V); fused-tree aware."""
    hd = cfg.resolved_head_dim
    if "wqkv" in p:
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        kvf = qdense(p["wqkv"], x, bits=_b(bits, "wqkv"), impl=impl)[..., nq:]
        return kvf[..., :nkv], kvf[..., nkv:]
    return (qdense(p["wk"], x, bits=_b(bits, "wk"), impl=impl),
            qdense(p["wv"], x, bits=_b(bits, "wv"), impl=impl))


def _qkv_post(p: dict, q, k, v, cfg, positions):
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope == "default":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        sections = mrope_sections(cfg.resolved_head_dim)
        if positions.ndim == 2:          # text: the (t, h, w) positions coincide
            positions = positions.expand(3, *positions.shape)
        q = apply_mrope(q, positions, sections, cfg.rope_theta)
        k = apply_mrope(k, positions, sections, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope {cfg.rope!r}: no configuration uses it, and the "
                                  "JAX package's _qkv_post applies nothing for it")
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
    qg = _group_heads(q, n_kv)
    s = sharding.batch_einsum("bqkgh,btkh->bkgqt", qg.to(torch.float32), k.to(torch.float32))
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
    o = sharding.batch_einsum("bkgqt,btkh->bqkgh", p.to(v.dtype).to(torch.float32),
                              v.to(torch.float32))
    return sharding.grad_heads_whole(o.reshape(b, sq, hq, hd), n_kv, dim=2).to(q.dtype)


def _largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (chunk sizes must tile exactly)."""
    for d in range(min(target, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _pair_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    return mask


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _flash_forward(q, k, v, n_kv: int, causal: bool, window: int, q_chunk: int,
                   kv_chunk: int, q_offset: int | None = None):
    """Chunked online-softmax attention -> ``(out, lse)`` (plain PyTorch, no
    TPU kernel behind it: the reference is ``jnp`` too).

    Scores per step are ``q_chunk x kv_chunk`` instead of ``S x S``; the
    logsumexp ``(b, n_kv, g, sq)`` is the flash-2 backward's residual.  The
    products run in f32 from the storage dtype, as ``_direct_attention``'s
    do, and ``p`` is rounded to the storage dtype before the PV product, as
    the reference's ``p.astype(vblk.dtype)``.  A causal block lying wholly in
    the queries' future is skipped: with the row maximum already finite its
    ``p`` is exactly 0 and its correction exactly 1, so the sums are the
    reference's bit for bit.
    """
    b, sq, hq, hd = q.shape
    skv = k.shape[1]
    g = hq // n_kv
    scale = 1.0 / math.sqrt(hd)
    off = (skv - sq) if q_offset is None else q_offset
    dev = q.device
    qg = _group_heads(q, n_kv)
    outs, lses = [], []
    for q0 in range(0, sq, q_chunk):
        qblk = _f32(qg[:, q0:q0 + q_chunk])
        q_pos = torch.arange(q0, q0 + q_chunk, device=dev) + off
        acc = torch.zeros((b, n_kv, g, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, n_kv, g, q_chunk), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, n_kv, g, q_chunk), dtype=torch.float32, device=dev)
        for k0 in range(0, skv, kv_chunk):
            if causal and k0 > 0 and k0 > off + q0 + q_chunk - 1:
                break                       # every later block is in the future too
            kblk, vblk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqkgh,btkh->bkgqt", qblk, _f32(kblk)) * scale
            mask = _pair_mask(q_pos, torch.arange(k0, k0 + kv_chunk, device=dev), causal,
                              window)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", _f32(p.to(vblk.dtype)), _f32(vblk))
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype), torch.cat(lses, dim=3)


def _flash_backward(q, k, v, out, lse, do, n_kv: int, causal: bool, window: int,
                    kv_chunk: int, q_offset: int | None):
    """Flash-2 backward (mirrors the reference's ``_flash_cvjp_bwd``): per kv
    chunk the probabilities are recomputed from the saved logsumexp, so no
    ``S x S`` residual is kept.  Under a causal mask the query rows before a
    chunk's first key (where ``p`` is 0) are left out of that chunk's sums."""
    b, sq, hq, hd = q.shape
    skv = k.shape[1]
    g = hq // n_kv
    scale = 1.0 / math.sqrt(hd)
    off = (skv - sq) if q_offset is None else q_offset
    dev = q.device
    qg = _f32(_group_heads(q, n_kv))
    dog = _f32(_group_heads(do, n_kv))
    delta = torch.einsum("bqkgh,bqkgh->bkgq", dog, _f32(_group_heads(out, n_kv)))
    q_pos = torch.arange(sq, device=dev) + off
    # like the operands (a DTensor's in the dry-run), zero, f32, contiguous
    dq, dk, dv = (torch.zeros_like(t, dtype=torch.float32, memory_format=torch.contiguous_format)
                  for t in (qg, k, v))
    for k0 in range(0, skv, kv_chunk):
        r0 = min(max(k0 - off, 0), sq) if causal else 0
        if r0 == sq:
            continue
        kblk, vblk = _f32(k[:, k0:k0 + kv_chunk]), v[:, k0:k0 + kv_chunk]
        qr, dor = qg[:, r0:], dog[:, r0:]
        s = torch.einsum("bqkgh,btkh->bkgqt", qr, kblk) * scale
        mask = _pair_mask(q_pos[r0:], torch.arange(k0, k0 + kv_chunk, device=dev), causal,
                          window)
        p = torch.where(mask, torch.exp(s - lse[..., r0:, None]), 0.0)
        dv[:, k0:k0 + kv_chunk] = torch.einsum("bkgqt,bqkgh->btkh", _f32(p.to(v.dtype)), dor)
        dp = torch.einsum("bqkgh,btkh->bkgqt", dor, _f32(vblk))
        ds = _f32((p * (dp - delta[..., r0:, None]) * scale).to(q.dtype))
        dq[:, r0:] += torch.einsum("bkgqt,btkh->bqkgh", ds, kblk)
        dk[:, k0:k0 + kv_chunk] = torch.einsum("bkgqt,bqkgh->btkh", ds, qr)
    return dq.reshape(b, sq, hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with an O(S h) residual: the forward saves q, k, v,
    the output and the logsumexp; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, q, k, v, n_kv, causal, window, q_chunk, kv_chunk, q_offset):
        out, lse = _flash_forward(q, k, v, n_kv, causal, window, q_chunk, kv_chunk,
                                  q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (n_kv, causal, window, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None


def _flash_attention(q, k, v, n_kv: int, *, causal: bool, window: int = 0,
                     q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                     q_offset: int | None = None) -> torch.Tensor:
    """Flash attention with the flash-2 backward (port of the reference's
    ``_flash_attention``).  ``q_offset``: the global position of q row 0
    (default: q is the trailing window of the keys).  The chunks are the
    reference's, the largest divisors of the lengths up to ``q_chunk`` and
    ``kv_chunk``, so the f32 sums run in its order."""
    sq, skv = q.shape[1], k.shape[1]
    q_chunk = _largest_divisor_leq(sq, q_chunk)
    kv_chunk = _largest_divisor_leq(skv, kv_chunk)
    return _FlashAttention.apply(q, k, v, n_kv, causal, window, q_chunk, kv_chunk, q_offset)


def attention(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor, *, causal: bool = True,
              window: int = 0, kv: tuple[torch.Tensor, torch.Tensor] | None = None, bits=None,
              impl: str = "auto") -> torch.Tensor:
    """Full-sequence attention (training, QAT, the encoder, cross-attention):
    projections, the direct path up to ``FLASH_THRESHOLD`` or the flash path
    above it, and the output projection.  ``kv`` (K, V), each (B, S_kv, H,
    hd), replaces the keys and values (cross-attention): only the query is
    projected here."""
    if kv is None:
        q, k, v = _qkv(p, x, cfg, positions, bits=bits, impl=impl)
    else:
        q = _split_heads(_q_proj(p, x, cfg, bits=bits, impl=impl), cfg.n_heads,
                         cfg.resolved_head_dim)
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        if cfg.rope == "default":
            q = apply_rope(q, positions, cfg.rope_theta)
        k, v = kv
    if max(x.shape[1], k.shape[1]) > FLASH_THRESHOLD and x.shape[1] > 1:
        o = _flash_attention(q, k, v, cfg.n_kv_heads, causal=causal, window=window)
    else:
        o = _direct_attention(q, k, v, cfg.n_kv_heads, causal=causal, window=window)
    b, s, _, _ = o.shape
    return qdense(p["wo"], o.reshape(b, s, -1), bits=_b(bits, "wo"), impl=impl)


def cross_kv(p: dict, ctx: torch.Tensor, cfg, *, bits=None, impl: str = "auto"):
    """Cross-attention K/V of an encoder output ``ctx`` (B, S_enc, d), each
    (B, S_enc, H, hd): computed once a clip (whisper's decode)."""
    hd = cfg.resolved_head_dim
    kf, vf = _kv_proj(p, ctx, cfg, bits=bits, impl=impl)
    k = _split_heads(kf, cfg.n_kv_heads, hd)
    v = _split_heads(vf, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def decode_attend_one(cache, q, k_new, v_new, pos, cfg, *, window: int = 0,
                      impl: str = "auto"):
    """Write ONE position's K/V at ``pos`` (B,) and attend over ``cache[: pos+1]``.

    ``cache`` is an fp ``{"k", "v"}`` dict, a ``QuantizedKVLayer`` or a
    ``PagedKVLayer``; each is updated in place.  Returns ``(o (B, 1, hq, hd), cache)``.
    """
    b = q.shape[0]
    posv = torch.as_tensor(pos, device=q.device).reshape(-1)
    if isinstance(cache, dict):
        skv = cache["k"].shape[1]
        rows = torch.arange(b, device=q.device)
        posb = posv.expand(b).to(torch.long)
        # the write clamps into the cache as the JAX package's dynamic update
        # does (an idle slot's stale position may lie past it)
        wpos = posb.clamp(0, skv - 1)
        for name, new in (("k", k_new), ("v", v_new)):
            _write_position(cache[name], rows, wpos, new[:, 0].to(cache[name].dtype))
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


def _write_position(buf: torch.Tensor, rows, wpos, val) -> None:
    """``buf[rows, wpos] = val`` in place; a DTensor cache (the dry-run's)
    writes shard-locally (``dist.sharding.write_positions``)."""
    if type(buf) is torch.Tensor:
        buf[rows, wpos] = val
    else:
        sharding.write_positions(buf, wpos, val)


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
    """One decode step over a packed ``QuantizedKVLayer`` or ``PagedKVLayer``
    (updated in place).

    Where :func:`_can_fuse_step_proj` admits it (the CUDA kernels, a dense
    cache, a fused ``wqkv``, f32 activations, ``d <= 512``), the projection
    and the rotary embedding run inside the fused step's launch; otherwise
    the projections, the rotation and the step run one after another.
    """
    b = x.shape[0]
    positions = _decode_positions(pos, b, x.device)
    if _can_fuse_step_proj(p, cfg, cache, None, impl, x):
        o, cache = _decode_step_proj_fused(p, x, cache, positions, cfg, window=window, impl=impl)
    else:
        q, k_new, v_new = _qkv(p, x, cfg, positions, impl=impl)
        o, cache = decode_attend_one(cache, q, k_new, v_new, pos, cfg, window=window, impl=impl)
    o = o.to(x.dtype)
    return qdense(p["wo"], o.reshape(b, 1, -1), impl=impl), cache


def _can_fuse_step_proj(p: dict, cfg, cache, bits, impl: str, x: torch.Tensor) -> bool:
    """Gate for pulling the fused-``wqkv`` GEMV into the fused decode step.

    The CUDA kernel on a dense quantized cache, a fused ``wqkv``
    ``QuantizedTensor``, default rope, no qk-norm, f32 activations in the
    GEMV's batch regime, and no per-call bits override: every condition the
    in-kernel projection needs to reproduce the composition bit for bit
    (``csrc/quant_kv_proj.cu``).  On CPU tensors ``"auto"`` resolves to
    ``"torch"``, so the unfused path runs there, as in the JAX package.
    """
    w = p.get("wqkv")
    return (isinstance(w, QuantizedTensor)
            and cfg.rope == "default" and not cfg.qk_norm
            and _b(bits, "wqkv") is None
            and x.dtype == torch.float32 and x.shape[0] <= 8
            and can_fuse_qkv(cache, cfg.d_model, w.bits, impl))


def _decode_step_proj_fused(p: dict, x: torch.Tensor, cache, positions: torch.Tensor, cfg, *,
                            window: int, impl: str):
    """Projection + rotary + append + attend in the fused step's launch."""
    pos = positions[:, 0]                                      # (B,)
    skv = cache.seq
    ar = torch.arange(skv, device=x.device)[None, :]
    kv_valid = ar <= pos[:, None]
    if window:
        kv_valid &= ar > (pos[:, None] - window)
    hd = cfg.resolved_head_dim
    # the angle formula of apply_rope, at the one decode position
    ang = pos[:, None].to(torch.float32) * rope_freqs(hd, cfg.rope_theta, device=x.device)
    w = p["wqkv"]
    o, cache = quant_kv_decode_step_proj(x[:, 0], w.packed, w.scale, torch.cos(ang),
                                         torch.sin(ang), cache, pos, kv_valid, w_bits=w.bits,
                                         n_heads=cfg.n_heads, impl=impl, out_dtype=x.dtype)
    return o[:, None], cache


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


def mlp(p: dict, x: torch.Tensor, kind: str, *, bits=None, impl: str = "auto") -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        if "w_gu" in p:  # pack-time fused gate|up group (one launch, halve)
            g, u = torch.chunk(qdense(p["w_gu"], x, bits=_b(bits, "w_gu"), impl=impl), 2, dim=-1)
        else:
            g = qdense(p["w_gate"], x, bits=_b(bits, "w_gate"), impl=impl)
            u = qdense(p["w_up"], x, bits=_b(bits, "w_up"), impl=impl)
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        return qdense(p["w_down"], act * u, bits=_b(bits, "w_down"), impl=impl)
    h = F.gelu(qdense(p["w_up"], x, bits=_b(bits, "w_up"), impl=impl), approximate="tanh")
    return qdense(p["w_down"], h, bits=_b(bits, "w_down"), impl=impl)
