"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] (port of
``repro/models/encdec.py``).

The audio conv frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``(B, encoder_seq, d)``.  Sinusoidal positions
on both sides (the JAX package's deviation from whisper's learned decoder
positions), LayerNorm, a GELU MLP and full multi-head attention.  The
self- and cross-attention run on fp K/V in plain PyTorch (the JAX package
computes them in ``jnp``, not in a Pallas kernel); the linears go through
``layers.qdense``, so the GEMV and the GEMM kernels when packed.

Layouts: ``init`` stacks the encoder and the decoder layers ``(L, ...)``
under ``enc_layers`` / ``dec_layers``; ``unstack_layers`` gives per-layer
lists.  The decode state is ``{"self": [per layer {"k", "v"}], "cross": [per
layer {"k", "v"}]}``, the cross K/V computed once from the frames.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import shard_batch_act
from . import decoder, layers


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def sinusoid(seq: int, d: int, offset=0, *, device=None) -> torch.Tensor:
    """(seq, d) f32: ``[sin(pos / 10000^(2i/d)), cos(...)]``, positions from ``offset``.

    The power is taken in f64 and rounded once, which is what XLA's f32
    ``pow`` gives bit for bit (``torch.pow`` in f32 is an ulp off on some
    exponents, and the angle of position 1499 carries it); ``sin`` and
    ``cos`` stay f32, within an ulp of XLA's."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None] + offset
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    denom = torch.pow(10_000.0, (2 * dim / d).to(torch.float64)).to(torch.float32)
    ang = pos / denom
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_layer_init(generator, cfg, dt, *, lead, device) -> dict:
    return {
        "attn": layers.attention_init(generator, cfg, dt, lead=lead, device=device),
        "mlp": layers.mlp_init(generator, cfg, dt, lead=lead, device=device),
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, dt, lead=lead, device=device),
        "ln2": layers.norm_init(cfg.d_model, cfg.norm, dt, lead=lead, device=device),
    }


def _dec_layer_init(generator, cfg, dt, *, lead, device) -> dict:
    return {
        "self_attn": layers.attention_init(generator, cfg, dt, lead=lead, device=device),
        "cross_attn": layers.attention_init(generator, cfg, dt, lead=lead, device=device),
        "mlp": layers.mlp_init(generator, cfg, dt, lead=lead, device=device),
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, dt, lead=lead, device=device),
        "ln2": layers.norm_init(cfg.d_model, cfg.norm, dt, lead=lead, device=device),
        "ln3": layers.norm_init(cfg.d_model, cfg.norm, dt, lead=lead, device=device),
    }


def init(cfg, generator: torch.Generator | None = None, device=None) -> dict:
    """Random train-layout params on ``device`` (default ``cuda``), each
    stack's leaves drawn whole from ``generator``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = _dtype(cfg)
    return {
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model, dt, device=device),
        "enc_layers": _enc_layer_init(generator, cfg, dt, lead=(cfg.n_encoder_layers,),
                                      device=device),
        "enc_norm": layers.norm_init(cfg.d_model, cfg.norm, dt, device=device),
        "dec_layers": _dec_layer_init(generator, cfg, dt, lead=(cfg.n_layers,), device=device),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dt, device=device),
        "lm_head": layers.dense_init(generator, cfg.d_model, cfg.vocab_size, dt, device=device),
    }


def _norm(p, x, cfg):
    return layers.norm(p, x, cfg.norm, cfg.norm_eps)


def _enc_layer(lp: dict, h: torch.Tensor, cfg, positions, lb, impl: str) -> torch.Tensor:
    h = shard_batch_act(h)
    h = h + layers.attention(lp["attn"], _norm(lp["ln1"], h, cfg), cfg, positions, causal=False,
                             bits=layers._b(lb, "attn"), impl=impl)
    return h + layers.mlp(lp["mlp"], _norm(lp["ln2"], h, cfg), cfg.mlp,
                          bits=layers._b(lb, "mlp"), impl=impl)


def _frames_in(frames: torch.Tensor, cfg) -> torch.Tensor:
    s = frames.shape[1]
    dt = _dtype(cfg)
    return frames.to(dt) + sinusoid(s, cfg.d_model, device=frames.device).to(dt)


def encode(params: dict, cfg, frames: torch.Tensor, *, bits=None,
           impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """frames (B, encoder_seq, d), the frontend stub's embeddings -> the
    normed encoder output.  The layers run in a Python loop over the
    stacked layout; under ``remat`` each is recomputed in the backward, as
    the decoder's are (``decoder.checkpointed``)."""
    x = shard_batch_act(_frames_in(frames, cfg))
    positions = layers.position_ids(x.shape[0], x.shape[1], "none", device=x.device)
    enc_bits = layers._b(bits, "enc_layers")
    stacked = decoder._unbind(params["enc_layers"])
    for i in range(cfg.n_encoder_layers):
        lb = None if enc_bits is None else decoder._per_layer(enc_bits, i)
        x = decoder.checkpointed(_enc_layer, decoder._per_layer(stacked, i), x, cfg, positions,
                                 lb, impl, remat=remat)
    return _norm(params["enc_norm"], x, cfg)


def _dec_layer(lp: dict, h: torch.Tensor, enc_out: torch.Tensor, cfg, positions, lb,
               impl: str) -> torch.Tensor:
    h = shard_batch_act(h)
    h = h + layers.attention(lp["self_attn"], _norm(lp["ln1"], h, cfg), cfg, positions,
                             causal=True, bits=layers._b(lb, "self_attn"), impl=impl)
    kv = layers.cross_kv(lp["cross_attn"], enc_out, cfg, bits=layers._b(lb, "cross_attn"),
                         impl=impl)
    h = h + layers.attention(lp["cross_attn"], _norm(lp["ln2"], h, cfg), cfg, positions,
                             causal=False, kv=kv, bits=layers._b(lb, "cross_attn"), impl=impl)
    return h + layers.mlp(lp["mlp"], _norm(lp["ln3"], h, cfg), cfg.mlp,
                          bits=layers._b(lb, "mlp"), impl=impl)


def decode_train(params: dict, cfg, tokens: torch.Tensor, enc_out: torch.Tensor, *, bits=None,
                 impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """The teacher-forced decoder -> normed hidden states (B, S, d).  Under
    ``remat`` each layer, its ``cross_kv`` over ``enc_out`` included, is
    recomputed in the backward, as in the JAX package."""
    b, s = tokens.shape
    x = decoder.embed_tokens(params, tokens, cfg, bits=layers._b(bits, "embed"), impl=impl)
    x = shard_batch_act(x + sinusoid(s, cfg.d_model, device=x.device).to(x.dtype))
    positions = layers.position_ids(b, s, "none", device=x.device)
    dec_bits = layers._b(bits, "dec_layers")
    stacked = decoder._unbind(params["dec_layers"])
    for i in range(cfg.n_layers):
        lb = None if dec_bits is None else decoder._per_layer(dec_bits, i)
        x = decoder.checkpointed(_dec_layer, decoder._per_layer(stacked, i), x, enc_out, cfg,
                                 positions, lb, impl, remat=remat)
    return _norm(params["final_norm"], x, cfg)


def loss(params: dict, cfg, batch: dict, *, bits=None, impl: str = "auto") -> torch.Tensor:
    """Mean cross-entropy of the decoder's next tokens given the frames."""
    enc_out = encode(params, cfg, batch["frames"], bits=bits, impl=impl)
    hidden = decode_train(params, cfg, batch["tokens"], enc_out, bits=bits, impl=impl)
    return decoder.lm_loss_from_hidden(params, cfg, hidden, batch["labels"], bits=bits,
                                       impl=impl)


# ---------------------------------------------------------------------------
# the serving layout
# ---------------------------------------------------------------------------


def unstack_layers(params: dict, cfg) -> dict:
    """Stacked train params -> per-layer lists (views) of both stacks."""
    out = dict(params)
    out["enc_layers"] = [decoder._per_layer(params["enc_layers"], i)
                         for i in range(cfg.n_encoder_layers)]
    out["dec_layers"] = [decoder._per_layer(params["dec_layers"], i)
                         for i in range(cfg.n_layers)]
    return out


def _encode_unrolled(params: dict, cfg, frames: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    x = _frames_in(frames, cfg)
    positions = layers.position_ids(x.shape[0], x.shape[1], "none", device=x.device)
    for lp in params["enc_layers"]:
        x = _enc_layer(lp, x, cfg, positions, None, impl)
    return _norm(params["enc_norm"], x, cfg)


def prepare_decode(params: dict, cfg, frames: torch.Tensor, *, impl: str = "auto") -> list:
    """Encode the frames once and precompute each decoder layer's cross K/V."""
    enc_out = _encode_unrolled(params, cfg, frames, impl=impl)
    return [dict(zip(("k", "v"), layers.cross_kv(lp["cross_attn"], enc_out, cfg, impl=impl)))
            for lp in params["dec_layers"]]


def init_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16, abstract=False, *,
               device=None) -> dict:
    """fp self-attention caches of ``seq`` positions and cross caches of
    ``encoder_seq``, a layer each (on the ``meta`` device when ``abstract``)."""
    device = resolve_device("meta" if abstract else device)
    hd = cfg.resolved_head_dim

    def kv(s):
        shape = (batch, s, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"self": [kv(seq) for _ in range(cfg.n_layers)],
            "cross": [kv(cfg.encoder_seq) for _ in range(cfg.n_layers)]}


def decode_step(params: dict, cfg, state: dict, token: torch.Tensor, pos: int, *,
                impl: str = "auto"):
    """One decoder token a row, every row at the scalar position ``pos``: the
    self-attention cache written there (in place), cross-attention over the
    fixed K/V.  Returns ``(logits (B, 1, V), state)``."""
    x = decoder.embed_tokens(params, token, cfg)
    x = x + sinusoid(1, cfg.d_model, offset=pos, device=x.device).to(x.dtype)
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    for lp, sc, cc in zip(params["dec_layers"], state["self"], state["cross"]):
        att, _ = layers.attention_decode(lp["self_attn"], _norm(lp["ln1"], x, cfg), sc, pos, cfg,
                                         impl=impl)
        x = x + att
        x = x + layers.attention(lp["cross_attn"], _norm(lp["ln2"], x, cfg), cfg, positions,
                                 causal=False, kv=(cc["k"], cc["v"]), impl=impl)
        x = x + layers.mlp(lp["mlp"], _norm(lp["ln3"], x, cfg), cfg.mlp, impl=impl)
    hidden = _norm(params["final_norm"], x, cfg)
    return layers.qdense(params["lm_head"], hidden, impl=impl), state


def prefill(params: dict, cfg, tokens: torch.Tensor | None = None,
            frames: torch.Tensor | None = None, *, impl: str = "auto"):
    """The frames through the encoder, then the unrolled teacher-forced
    decoder over ``tokens`` (B, S) -> (last-position logits (B, 1, V), the
    decode state with the self caches of S positions and the cross caches)."""
    enc_out = _encode_unrolled(params, cfg, frames, impl=impl)
    b, s = tokens.shape
    x = decoder.embed_tokens(params, tokens, cfg)
    x = shard_batch_act(x + sinusoid(s, cfg.d_model, device=x.device).to(x.dtype))
    positions = layers.position_ids(b, s, "none", device=x.device)
    self_caches, cross_caches = [], []
    for lp in params["dec_layers"]:
        q, k, v = layers._qkv(lp["self_attn"], _norm(lp["ln1"], x, cfg), cfg, positions,
                              impl=impl)
        self_caches.append({"k": k, "v": v})
        attend = (layers._flash_attention if s > layers.FLASH_THRESHOLD
                  else layers._direct_attention)
        o = attend(q, k, v, cfg.n_kv_heads, causal=True)
        x = x + layers.qdense(lp["self_attn"]["wo"], o.reshape(b, s, -1), impl=impl)
        ck, cv = layers.cross_kv(lp["cross_attn"], enc_out, cfg, impl=impl)
        cross_caches.append({"k": ck, "v": cv})
        x = x + layers.attention(lp["cross_attn"], _norm(lp["ln2"], x, cfg), cfg, positions,
                                 causal=False, kv=(ck, cv), impl=impl)
        x = x + layers.mlp(lp["mlp"], _norm(lp["ln3"], x, cfg), cfg.mlp, impl=impl)
    hidden = _norm(params["final_norm"], x, cfg)
    logits = layers.qdense(params["lm_head"], hidden[:, -1:], impl=impl)
    return logits, {"self": self_caches, "cross": cross_caches}
