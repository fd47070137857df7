"""Decoder-only LM, dense family (port of ``repro/models/decoder.py``).

Two parameter layouts, as in the JAX package:
  * train: per-layer params stacked ``(L, ...)`` — what ``init`` returns and
    what ``quant.apply.layer_specs`` enumerates; ``forward`` runs them in a
    Python loop over per-layer views (QAT bits per layer ride along);
  * serve: a per-layer list (``unstack_layers``) run unrolled, so packed
    per-layer shapes may differ (mixed bitwidths).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.quantizer import div_exact
from repro_torch.device import resolve_device
from repro_torch.kernels.fake_quant.ops import fake_quant_ste
from repro_torch.kvcache.cache import DEFAULT_BLOCK, QuantizedKVLayer, init_kv_layer, resolve_block
from repro_torch.kvcache.paged import PagedKVLayer, init_paged_layer
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


def _per_layer(tree, i: int):
    """Layer ``i``'s slice of a nested dict of stacked tensors or per-layer sequences."""
    if isinstance(tree, dict):
        return {k: _per_layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree):
    """``(L, ...)`` leaves -> tuples of per-layer views; one ``unbind`` per
    leaf, so the backward writes each stacked gradient once."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def unstack_layers(params: dict, cfg) -> dict:
    """(L, ...)-stacked train params -> per-layer list (views) for the serve path."""
    out = dict(params)
    out["layers"] = [_per_layer(params["layers"], i) for i in range(cfg.n_layers)]
    return out


def embed_tokens(params: dict, tokens: torch.Tensor, cfg, *, bits=None,
                 impl: str = "auto") -> torch.Tensor:
    """Embedding lookup; under QAT (``bits``) the table is fake-quantized
    whole first, with one scale per model dimension, as in the JAX package."""
    emb = params["embed"]
    if isinstance(emb, QuantizedTensor):
        # stored in lm_head layout (d, V): packed (V, d/lanes), scale (1, V)
        tokens = tokens.to(torch.long)
        lev = packing.unpack(emb.packed[tokens], emb.bits, emb.k)
        scale = emb.scale[0][tokens][..., None]
        return (lev.to(torch.float32) * scale).to(_dtype(cfg))
    if bits is not None:
        emb = fake_quant_ste(emb, bits, impl)
    return F.embedding(tokens.to(torch.long), emb)


def _layer_body(x, lp: dict, cfg, positions, lb, impl: str):
    h = x + layers.attention(lp["attn"], layers.norm(lp["ln1"], x, cfg.norm, cfg.norm_eps),
                             cfg, positions, causal=True,
                             bits=None if lb is None else lb.get("attn"), impl=impl)
    hn = layers.norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
    return h + layers.mlp(lp["mlp"], hn, cfg.mlp, bits=None if lb is None else lb.get("mlp"),
                          impl=impl)


def forward(params: dict, cfg, tokens: torch.Tensor, *, bits=None,
            impl: str = "auto") -> torch.Tensor:
    """Full-sequence forward over the stacked train layout -> final hidden (B, S, d).

    ``bits``: None, or ``{"embed": b, "layers": {... per-layer lists ...}}``
    as ``quant.apply.bits_for_scan`` builds it (QAT per-layer bitwidths).
    """
    x = embed_tokens(params, tokens, cfg, bits=None if bits is None else bits.get("embed"),
                     impl=impl)
    b, s = x.shape[:2]
    positions = layers.position_ids(b, s, device=x.device)
    stacked = _unbind(params["layers"])
    for i in range(cfg.n_layers):
        lb = None if bits is None else _per_layer(bits["layers"], i)
        x = _layer_body(x, _per_layer(stacked, i), cfg, positions, lb, impl)
    return layers.norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)


def logits_fn(params: dict, hidden: torch.Tensor, cfg, *, bits=None,
              impl: str = "auto") -> torch.Tensor:
    """The LM head.  A packed tied embedding dequantizes whole, ``(d, V)`` in
    the hidden dtype, on every call — as the JAX package does.  Under QAT the
    tied head fake-quantizes ``emb.T``, one scale per vocabulary entry."""
    if cfg.tie_embeddings and "lm_head" not in params:
        emb = params["embed"]
        if isinstance(emb, QuantizedTensor):
            return layers.qdense(emb.dequantize(hidden.dtype), hidden, impl=impl)
        return layers.qdense(emb.T, hidden, bits=None if bits is None else bits.get("embed"),
                             impl=impl)
    return layers.qdense(params["lm_head"], hidden,
                         bits=None if bits is None else bits.get("lm_head"), impl=impl)


def lm_loss(params: dict, cfg, tokens: torch.Tensor, labels: torch.Tensor, *, bits=None,
            impl: str = "auto", loss_chunk: int = 2048) -> torch.Tensor:
    """Mean softmax cross-entropy, chunked over the sequence (the JAX package
    recomputes each chunk's logits in the backward; here autograd keeps them,
    which at the search's sequence lengths is one chunk)."""
    hidden = forward(params, cfg, tokens, bits=bits, impl=impl)
    return lm_loss_from_hidden(params, cfg, hidden, labels, bits=bits, impl=impl,
                               loss_chunk=loss_chunk)


def lm_loss_from_hidden(params: dict, cfg, hidden: torch.Tensor, labels: torch.Tensor, *,
                        bits=None, impl: str = "auto", loss_chunk: int = 2048) -> torch.Tensor:
    """Chunked softmax cross-entropy of ``hidden`` against the LM head."""
    b, s, _ = hidden.shape
    chunk = min(loss_chunk, s)
    assert s % chunk == 0, (s, chunk)
    labels = labels.to(torch.long)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s, chunk):
        logits = logits_fn(params, hidden[:, c:c + chunk], cfg, bits=bits,
                           impl=impl).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c:c + chunk, None])[..., 0]
        total = total + torch.sum(logz - gold)
    return div_exact(total, float(b * s))


def init_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16, *, state_bits=None,
               block: int | None = None, paged: bool = False, pool_blocks: int | None = None,
               device=None) -> list:
    """Decode KV cache: fp ``{"k", "v"}`` dicts, packed ``QuantizedKVLayer``
    containers when ``state_bits`` (per-layer ``[(k_bits, v_bits), ...]``) is
    given, or block-pool ``PagedKVLayer`` containers when additionally
    ``paged`` (``pool_blocks`` usable blocks, default the dense equivalent
    ``batch * seq / block``).  The paged layers share one block-table tensor."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    if paged and state_bits is None:
        raise ValueError("paged KV cache requires state_bits (the pool stores packed "
                         "lanes only)")
    if state_bits is not None:
        if len(state_bits) != cfg.n_layers:
            raise ValueError(f"state_bits has {len(state_bits)} entries for "
                             f"{cfg.n_layers} layers")
        if paged:
            blk = resolve_block(seq, block or DEFAULT_BLOCK)
            n_blocks = pool_blocks or (batch * seq) // blk
            layers_ = [init_paged_layer(n_blocks, batch, seq, cfg.n_kv_heads, hd, k_bits=kb,
                                        v_bits=vb, block=blk, device=device)
                       for kb, vb in state_bits]
            table = layers_[0].block_table
            for layer in layers_:
                layer.block_table = table
            return layers_
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


def init_prefill_scratch(cfg, seq: int, dtype=None, *, device=None) -> list[dict]:
    """Per-layer fp K/V scratch carried across prefill chunks (one slot).

    The chunked prefill never reads the (possibly quantized) decode state:
    each chunk writes its fp K/V rows here and attends over the scratch, so
    the rows that finally insert into the cache are computed from the same
    fp values a whole-prompt prefill produces, which keeps chunked admission
    token-identical across fp / quantized / paged caches (the quantizer runs
    once, at insert, on full fp rows).
    """
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    dt = _dtype(cfg) if dtype is None else dtype
    shape = (1, seq, cfg.n_kv_heads, hd)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)} for _ in range(cfg.n_layers)]


def prefill_chunk(params: dict, cfg, scratch: list, tokens: torch.Tensor, offset: int, *,
                  impl: str = "auto") -> list[dict]:
    """One prefill chunk: ``tokens`` (1, C) at absolute positions ``offset ..
    offset + C - 1`` -> the updated scratch (see :func:`init_prefill_scratch`).

    Per layer the chunk's K/V rows land in the scratch at ``offset`` and its
    queries attend causally over the whole scratch with ``q_offset=offset``:
    rows below ``offset`` hold earlier chunks' K/V, rows at and after
    ``offset + C`` are causally masked, so chunk boundaries never change what
    a valid query position sees.  No logits: the engine samples the first
    token from the decode step that replays the last prompt token.
    """
    x = embed_tokens(params, tokens, cfg)
    b, c = x.shape[:2]
    positions = layers.position_ids(b, c, device=x.device) + offset
    seq = scratch[0]["k"].shape[1]
    # a masked row write, not a slice: the last (short) chunk of a prompt
    # near the scratch's end keeps the rows past it instead of being
    # clamped onto earlier rows (rows past the head zero at the insert)
    src = torch.arange(seq, device=x.device) - offset
    take = ((src >= 0) & (src < c))[None, :, None, None]
    src = src.clamp(0, c - 1)
    out = []
    for lp, buf in zip(params["layers"], scratch):
        xn = layers.norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        q, k, v = layers._qkv(lp["attn"], xn, cfg, positions, impl=impl)
        sk = torch.where(take, k.to(buf["k"].dtype)[:, src], buf["k"])
        sv = torch.where(take, v.to(buf["v"].dtype)[:, src], buf["v"])
        out.append({"k": sk, "v": sv})
        o = layers._direct_attention(q, sk, sv, cfg.n_kv_heads, causal=True, q_offset=offset)
        h = x + layers.qdense(lp["attn"]["wo"], o.reshape(b, c, -1), impl=impl)
        hn = layers.norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
        x = h + layers.mlp(lp["mlp"], hn, cfg.mlp, impl=impl)
    return out


def decode_step(params: dict, cfg, caches: list, token: torch.Tensor, pos, *,
                impl: str = "auto"):
    """One token per slot through the unrolled layers, cache update at ``pos``.

    ``token`` (B, 1); ``pos`` (B,) or scalar.  Each layer's cache (fp dict or
    ``QuantizedKVLayer``) is updated in place.  Returns ``(logits (B, 1, V), caches)``.
    """
    x = embed_tokens(params, token, cfg)
    for lp, cache in zip(params["layers"], caches):
        xn = layers.norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        if isinstance(cache, (QuantizedKVLayer, PagedKVLayer)):
            att, _ = layers.attention_decode_quant(lp["attn"], xn, cache, pos, cfg, impl=impl)
        else:
            att, _ = layers.attention_decode(lp["attn"], xn, cache, pos, cfg, impl=impl)
        h = x + att
        hn = layers.norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
        x = h + layers.mlp(lp["mlp"], hn, cfg.mlp, impl=impl)
    hidden = layers.norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_fn(params, hidden, cfg, impl=impl), caches


def decode_verify(params: dict, cfg, caches: list, tokens: torch.Tensor, pos, *,
                  impl: str = "auto"):
    """Speculative verify: T burst tokens per slot through ONE weight pass.

    ``tokens`` (B, T): the pending token, then T-1 draft proposals; ``pos``
    (B,): each slot's write position of burst index 0.  The linears
    (projections, ``wo``, MLP, LM head) run once over all B*T rows, so the
    weights are read once; the cache append + attend runs position by
    position through ``layers.decode_attend_one``, so a quantized cache sees
    the non-speculative sequence of appends.  Caches are updated in place.
    Returns ``(logits (B, T, V), caches, burst_kv)`` with ``burst_kv`` the
    per-layer fp K/V ``[(k, v), ...]``, each (B, T, H, hd), that the commit
    replays for the accepted prefix.
    """
    b, t = tokens.shape
    x = embed_tokens(params, tokens, cfg)                          # (B, T, d)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(-1)
    positions = pos[:, None] + torch.arange(t, dtype=torch.int32, device=x.device)
    burst_kv = []
    for lp, cache in zip(params["layers"], caches):
        xn = layers.norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        q, k_new, v_new = layers._qkv(lp["attn"], xn, cfg, positions, impl=impl)
        burst_kv.append((k_new, v_new))
        outs = []
        for j in range(t):
            att, _ = layers.decode_attend_one(cache, q[:, j:j + 1], k_new[:, j:j + 1],
                                              v_new[:, j:j + 1], pos + j, cfg, impl=impl)
            outs.append(att.to(x.dtype))
        o = torch.cat(outs, dim=1)                                 # (B, T, hq, hd)
        h = x + layers.qdense(lp["attn"]["wo"], o.reshape(b, t, -1), impl=impl)
        hn = layers.norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
        x = h + layers.mlp(lp["mlp"], hn, cfg.mlp, impl=impl)
    hidden = layers.norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_fn(params, hidden, cfg, impl=impl), caches, burst_kv
