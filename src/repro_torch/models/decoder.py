"""Decoder-only LM, dense family (port of ``repro/models/decoder.py``).

Two parameter layouts, as in the JAX package:
  * train: per-layer params stacked ``(L, ...)`` — what ``init`` returns and
    what ``quant.apply.layer_specs`` enumerates;
  * serve: a per-layer list (``unstack_layers``) run unrolled, so packed
    per-layer shapes may differ (mixed bitwidths).
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.device import resolve_device
from repro_torch.kvcache.cache import DEFAULT_BLOCK, QuantizedKVLayer, init_kv_layer
from repro_torch.quant.tensor import QuantizedTensor
from . import layers


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init(cfg, generator: torch.Generator | None = None, device=None) -> dict:
    """Random train-layout params, made on ``device`` (default ``cuda``).

    Stacked leaves are drawn whole, ``(L, ...)`` at a time, from
    ``generator`` (default: seed 0 on ``device``).
    """
    device = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP queue 1, 'Other model families')")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = _dtype(cfg)
    lead = (cfg.n_layers,)
    stacked = {
        "attn": layers.attention_init(generator, cfg, dt, lead=lead, device=device),
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, dt, lead=lead, device=device),
        "ln2": layers.norm_init(cfg.d_model, cfg.norm, dt, lead=lead, device=device),
        "mlp": layers.mlp_init(generator, cfg, dt, lead=lead, device=device),
    }
    params = {
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model, dt, device=device),
        "layers": stacked,
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(generator, cfg.d_model, cfg.vocab_size, dt,
                                              device=device)
    return params


def unstack_layers(params: dict, cfg) -> dict:
    """(L, ...)-stacked train params -> per-layer list (views) for the serve path."""

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]

    out = dict(params)
    out["layers"] = [take(params["layers"], i) for i in range(cfg.n_layers)]
    return out


def embed_tokens(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    emb = params["embed"]
    if isinstance(emb, QuantizedTensor):
        # stored in lm_head layout (d, V): packed (V, d/lanes), scale (1, V)
        tokens = tokens.to(torch.long)
        lev = packing.unpack(emb.packed[tokens], emb.bits, emb.k)
        scale = emb.scale[0][tokens][..., None]
        return (lev.to(torch.float32) * scale).to(_dtype(cfg))
    return emb[tokens.to(torch.long)]


def logits_fn(params: dict, hidden: torch.Tensor, cfg, *, impl: str = "auto") -> torch.Tensor:
    """The LM head.  A packed tied embedding dequantizes whole, ``(d, V)`` in
    the hidden dtype, on every call — as the JAX package does."""
    if cfg.tie_embeddings and "lm_head" not in params:
        emb = params["embed"]
        if isinstance(emb, QuantizedTensor):
            return layers.qdense(emb.dequantize(hidden.dtype), hidden, impl=impl)
        return layers.qdense(emb.T, hidden, impl=impl)
    return layers.qdense(params["lm_head"], hidden, impl=impl)


def init_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16, *, state_bits=None,
               block: int | None = None, device=None) -> list:
    """Decode KV cache: fp ``{"k", "v"}`` dicts, or packed ``QuantizedKVLayer``
    containers when ``state_bits`` (per-layer ``[(k_bits, v_bits), ...]``) is given."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    if state_bits is not None:
        if len(state_bits) != cfg.n_layers:
            raise ValueError(f"state_bits has {len(state_bits)} entries for "
                             f"{cfg.n_layers} layers")
        return [init_kv_layer(batch, seq, cfg.n_kv_heads, hd, k_bits=kb, v_bits=vb,
                              block=block or DEFAULT_BLOCK, device=device)
                for kb, vb in state_bits]
    shape = (batch, seq, cfg.n_kv_heads, hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def prefill(params: dict, cfg, tokens: torch.Tensor, *, impl: str = "auto", lengths=None,
            logits: bool = True):
    """Full-sequence forward that also returns the fp KV rows (serve prefill).

    Layers run unrolled.  ``lengths`` is accepted for API symmetry and
    ignored: causal attention keeps valid positions independent of right
    padding.  ``logits=False`` skips the LM head and returns ``None`` in its
    place: the serve engine samples its first token from the replay step, and
    the head would dequantize the whole tied embedding for nothing.
    """
    del lengths
    x = embed_tokens(params, tokens, cfg)
    b, s = x.shape[:2]
    if s > layers.FLASH_THRESHOLD:
        raise NotImplementedError("prefill above FLASH_THRESHOLD needs the chunked flash "
                                  "attention, not ported yet")
    positions = layers.position_ids(b, s, device=x.device)
    caches = []
    for lp in params["layers"]:
        xn = layers.norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        q, k, v = layers._qkv(lp["attn"], xn, cfg, positions, impl=impl)
        caches.append({"k": k, "v": v})
        o = layers._direct_attention(q, k, v, cfg.n_kv_heads, causal=True)
        h = x + layers.qdense(lp["attn"]["wo"], o.reshape(b, s, -1), impl=impl)
        hn = layers.norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
        x = h + layers.mlp(lp["mlp"], hn, cfg.mlp, impl=impl)
    if not logits:
        return None, caches
    hidden = layers.norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_fn(params, hidden[:, -1:], cfg, impl=impl), caches


def decode_step(params: dict, cfg, caches: list, token: torch.Tensor, pos, *,
                impl: str = "auto"):
    """One token per slot through the unrolled layers, cache update at ``pos``.

    ``token`` (B, 1); ``pos`` (B,) or scalar.  Each layer's cache (fp dict or
    ``QuantizedKVLayer``) is updated in place.  Returns ``(logits (B, 1, V), caches)``.
    """
    x = embed_tokens(params, token, cfg)
    for lp, cache in zip(params["layers"], caches):
        xn = layers.norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        if isinstance(cache, QuantizedKVLayer):
            att, _ = layers.attention_decode_quant(lp["attn"], xn, cache, pos, cfg, impl=impl)
        else:
            att, _ = layers.attention_decode(lp["attn"], xn, cache, pos, cfg, impl=impl)
        h = x + att
        hn = layers.norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
        x = h + layers.mlp(lp["mlp"], hn, cfg.mlp, impl=impl)
    hidden = layers.norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_fn(params, hidden, cfg, impl=impl), caches
