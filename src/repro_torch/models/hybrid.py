"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
applied every ``attn_every`` layers [arXiv:2411.15242] (port of
``repro/models/hybrid.py``).

The shared block has one parameter set (one policy entry a weight, so its
QAT gradient sums over every application) but a KV cache of its own at each
application at decode, since the activations differ with depth.  It attends
over a sliding window of ``cfg.attn_window`` positions, in training, at
prefill and at decode (as a mask over ``kv_valid``; the window is not a ring
buffer).  The SSM states stay fp; ``state_bits`` packs only the attention
caches.

Layouts: ``init`` stacks the Mamba blocks ``(L, ...)`` as ``mamba2.init``
does; ``unstack_layers`` gives the serve path its per-layer list.  The
decode state is ``{"mamba": [per-layer {"conv", "ssm"}], "attn": [per
application {"k", "v"} or QuantizedKVLayer]}``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import shard_batch_act
from repro_torch.kvcache.cache import DEFAULT_BLOCK, QuantizedKVLayer, init_kv_layer
from . import decoder, layers, mamba2


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def n_attn_applications(cfg) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def shared_block_init(generator: torch.Generator, cfg, dtype=torch.float32, *, device) -> dict:
    return {
        "attn": layers.attention_init(generator, cfg, dtype, device=device),
        "mlp": layers.mlp_init(generator, cfg, dtype, device=device),
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, device=device),
        "ln2": layers.norm_init(cfg.d_model, cfg.norm, dtype, device=device),
    }


def init(cfg, generator: torch.Generator | None = None, device=None) -> dict:
    """Random train-layout params on ``device`` (default ``cuda``): the Mamba
    blocks stacked ``(L, ...)`` and drawn whole from ``generator``, then the
    shared block."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = _dtype(cfg)
    return {
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model, dt, device=device),
        "layers": mamba2.block_init(generator, cfg, dt, lead=(cfg.n_layers,), device=device),
        "shared_attn": shared_block_init(generator, cfg, dt, device=device),
        "final_norm": layers.norm_init(cfg.d_model, "rmsnorm", dt, device=device),
        "lm_head": layers.dense_init(generator, cfg.d_model, cfg.vocab_size, dt, device=device),
    }


def _apply_shared(sp: dict, x: torch.Tensor, cfg, positions, *, bits=None,
                  impl: str = "auto") -> torch.Tensor:
    h = x + layers.attention(sp["attn"], layers.norm(sp["ln1"], x, cfg.norm, cfg.norm_eps),
                             cfg, positions, causal=True, window=cfg.attn_window,
                             bits=layers._b(bits, "attn"), impl=impl)
    return h + layers.mlp(sp["mlp"], layers.norm(sp["ln2"], h, cfg.norm, cfg.norm_eps),
                          cfg.mlp, bits=layers._b(bits, "mlp"), impl=impl)


def forward(params: dict, cfg, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, *, bits=None,
            impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """Full-sequence forward over the stacked layout -> final hidden (B, S, d).

    The JAX package's ``lax.cond(idx % attn_every == 0)`` inside its layer
    scan is a Python loop here; under ``remat`` layer ``i``'s body, the
    shared block's application included where ``i`` takes it, is
    recomputed in the backward (``decoder.checkpointed``), as the JAX
    package's checkpointed scan body is.  The shared block's leaves are the
    same tensors at every application, so autograd sums their gradients.
    ``bits`` as ``quant.apply.bits_for_scan`` builds it (``"shared_attn"``
    one float a leaf, ``"layers"`` per-layer lists)."""
    x = shard_batch_act(decoder._inputs(params, tokens, embeds, cfg,
                                        bits=layers._b(bits, "embed"), impl=impl))
    b, s = x.shape[:2]
    positions = layers.position_ids(b, s, cfg.rope, device=x.device)
    sp = params["shared_attn"]
    shared_bits = layers._b(bits, "shared_attn")
    layer_bits = layers._b(bits, "layers")
    stacked = decoder._unbind(params["layers"])

    def body(x, lp, lb, shared: bool):
        x = shard_batch_act(x)
        if shared:
            x = _apply_shared(sp, x, cfg, positions, bits=shared_bits, impl=impl)
        return x + mamba2.block_forward(lp, layers.rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
                                        bits=lb, impl=impl)

    for i in range(cfg.n_layers):
        lb = None if layer_bits is None else decoder._per_layer(layer_bits, i)
        x = decoder.checkpointed(body, x, decoder._per_layer(stacked, i), lb,
                                 i % cfg.attn_every == 0, remat=remat)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# the serving layout
# ---------------------------------------------------------------------------


#: (L, ...)-stacked train params -> per-layer list (views); the shared block stays one
unstack_layers = decoder.unstack_layers


def init_decode_state(cfg, batch: int, seq: int, dtype=torch.bfloat16, abstract=False, *,
                      state_bits=None, block: int | None = None, device=None) -> dict:
    """Mamba states and the shared attention's caches, one per application.

    ``state_bits`` (per application ``[(k_bits, v_bits), ...]``) packs the
    attention caches as ``QuantizedKVLayer``; the SSM states stay f32.
    ``abstract`` puts the fp state on the ``meta`` device (the dry-run)."""
    if abstract:
        if state_bits is not None:
            raise NotImplementedError("abstract quantized decode state")
        device = "meta"
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    n_app = n_attn_applications(cfg)
    if state_bits is not None:
        if len(state_bits) != n_app:
            raise ValueError(f"state_bits has {len(state_bits)} entries for "
                             f"{n_app} shared-attention applications")
        attn = [init_kv_layer(batch, seq, cfg.n_kv_heads, hd, k_bits=kb, v_bits=vb,
                              block=block or DEFAULT_BLOCK, device=device)
                for kb, vb in state_bits]
    else:
        shape = (batch, seq, cfg.n_kv_heads, hd)
        attn = [{"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)} for _ in range(n_app)]
    return {"mamba": [mamba2.init_state(cfg, batch, device=device) for _ in range(cfg.n_layers)],
            "attn": attn}


def _apply_shared_decode(sp: dict, x: torch.Tensor, cfg, cache, pos, *, impl: str):
    """One application of the shared block at decode; the cache (fp or
    packed) is updated in place, through row 3 (or row 8 where its gate
    admits it) on a packed cache, under the window."""
    xn = layers.norm(sp["ln1"], x, cfg.norm, cfg.norm_eps)
    if isinstance(cache, QuantizedKVLayer):
        att, cache = layers.attention_decode_quant(sp["attn"], xn, cache, pos, cfg,
                                                   window=cfg.attn_window, impl=impl)
    else:
        att, cache = layers.attention_decode(sp["attn"], xn, cache, pos, cfg,
                                             window=cfg.attn_window, impl=impl)
    h = x + att
    h = h + layers.mlp(sp["mlp"], layers.norm(sp["ln2"], h, cfg.norm, cfg.norm_eps), cfg.mlp,
                       impl=impl)
    return h, cache


def decode_step(params: dict, cfg, state: dict, token: torch.Tensor, pos, *,
                embeds: torch.Tensor | None = None, impl: str = "auto"):
    """One token a row: ``token`` (B, 1), ``pos`` (B,) or scalar (the shared
    block's write position).  Returns ``(logits (B, 1, V), state)``."""
    x = decoder._inputs(params, token, embeds, cfg)
    sp = params["shared_attn"]
    new_mamba, new_attn = [], []
    for i, (lp, st) in enumerate(zip(params["layers"], state["mamba"])):
        if i % cfg.attn_every == 0:
            x, cache = _apply_shared_decode(sp, x, cfg, state["attn"][len(new_attn)], pos,
                                            impl=impl)
            new_attn.append(cache)
        y, nst = mamba2.block_decode(lp, layers.rmsnorm(lp["ln"], x, cfg.norm_eps), st, cfg,
                                     impl=impl)
        new_mamba.append(nst)
        x = x + y
    hidden = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.qdense(params["lm_head"], hidden, impl=impl), {"mamba": new_mamba,
                                                                  "attn": new_attn}


def prefill(params: dict, cfg, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, *, impl: str = "auto", lengths=None,
            logits: bool = True):
    """Unrolled full-sequence pass -> (last-position logits (B, 1, V), decode state).

    ``lengths`` masks right-pad tokens out of the Mamba states
    (``mamba2.block_forward``); the shared attention needs no mask: pads lie
    right of every valid causal query, and their K/V rows are masked at
    decode by each slot's ``kv_valid``.  Above ``FLASH_THRESHOLD`` the shared
    block runs the flash path under the window.  ``logits=False`` skips the
    LM head."""
    x = shard_batch_act(decoder._inputs(params, tokens, embeds, cfg))
    b, s = x.shape[:2]
    positions = layers.position_ids(b, s, cfg.rope, device=x.device)
    sp = params["shared_attn"]
    new_mamba, new_attn = [], []
    for i, lp in enumerate(params["layers"]):
        if i % cfg.attn_every == 0:
            xn = layers.norm(sp["ln1"], x, cfg.norm, cfg.norm_eps)
            q, k, v = layers._qkv(sp["attn"], xn, cfg, positions, impl=impl)
            new_attn.append({"k": k, "v": v})
            attend = (layers._flash_attention if s > layers.FLASH_THRESHOLD
                      else layers._direct_attention)
            o = attend(q, k, v, cfg.n_kv_heads, causal=True, window=cfg.attn_window)
            h = x + layers.qdense(sp["attn"]["wo"], o.reshape(b, s, -1), impl=impl)
            x = h + layers.mlp(sp["mlp"], layers.norm(sp["ln2"], h, cfg.norm, cfg.norm_eps),
                               cfg.mlp, impl=impl)
        y, st = mamba2.block_forward(lp, layers.rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
                                     impl=impl, return_state=True, lengths=lengths)
        new_mamba.append(st)
        x = x + y
    state = {"mamba": new_mamba, "attn": new_attn}
    if not logits:
        return None, state
    hidden = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.qdense(params["lm_head"], hidden[:, -1:], impl=impl), state
