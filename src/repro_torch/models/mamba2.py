"""Mamba2 (SSD, state-space duality) blocks and the attention-free LM
(port of ``repro/models/mamba2.py``).

The chunked SSD algorithm of the Mamba-2 paper [arXiv:2405.21060]: an
intra-chunk quadratic term, per-chunk states and an inter-chunk recurrence
(a loop over chunks where the JAX package runs ``lax.scan``), with
n_groups = 1 (B and C shared across heads).  The scan is plain PyTorch, as
the JAX package computes it in ``jnp`` and not in a Pallas kernel.  The
multi-operand einsums contract pairwise in the order ``jnp.einsum`` picks
for them, so the f32 sums group as the JAX package's do.

Quantizable weights: ``in_proj``, ``out_proj`` and the untied ``lm_head``
go through ``layers.qdense`` (the GEMV and the GEMM kernels when packed).
The decay parameters (``A_log``, ``dt_bias``, ``D``), the short conv and
``gate_norm`` stay fp, as in the JAX package.

Layouts: ``init`` stacks every block leaf ``(L, ...)`` (drawn whole, as the
decoder's); ``unstack_layers`` gives the serve path its per-layer list.  The
decode state is a per-layer list of ``{"conv": (B, W-1, C), "ssm": (B, H,
P, N)}`` f32 dicts, the same size whatever the sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import shard_batch_act
from . import decoder, layers


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def block_init(generator: torch.Generator, cfg, dtype=torch.float32, *, lead=(),
               device) -> dict:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = din + 2 * n

    def per_layer(t: torch.Tensor) -> torch.Tensor:
        return t.expand(*lead, *t.shape).clone()

    return {
        "in_proj": layers.dense_init(generator, d, 2 * din + 2 * n + h, dtype, lead=lead,
                                     device=device),
        "conv_w": torch.randn((*lead, cfg.ssm_conv_width, conv_ch), generator=generator,
                              device=device) * 0.2,
        "conv_b": torch.zeros((*lead, conv_ch), dtype=torch.float32, device=device),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                                    device=device))),
        "dt_bias": torch.zeros((*lead, h), dtype=torch.float32, device=device),
        "D": torch.ones((*lead, h), dtype=torch.float32, device=device),
        "gate_norm": torch.ones((*lead, din), dtype=dtype, device=device),
        "out_proj": layers.dense_init(generator, din, d, dtype, lead=lead, device=device),
        "ln": layers.norm_init(d, "rmsnorm", dtype, lead=lead, device=device),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    """``in_proj``'s output -> z (din), xc = [x, B, C] (the conv channels), dt (h)."""
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    return torch.split(zxbcdt, [din, din + 2 * n, h], dim=-1)


def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of width W: (B, S, C) with (W, C) filters, the
    taps summed in order from the oldest."""
    wlen, s = w.shape[0], xc.shape[1]
    pad = F.pad(xc, (0, 0, wlen - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, wlen):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def _segsum_exp(da: torch.Tensor) -> torch.Tensor:
    """exp(cumulative decay), lower-triangular: da (..., L) per-step log-decay
    -> out[..., i, j] = exp(sum_{j<k<=i} da_k), zero above the diagonal.

    The mask goes in BEFORE the exp: masked differences are large and
    positive, exp overflows to inf, and inf * 0 in the backward turns every
    gradient NaN."""
    n = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                       # (..., i, j)
    mask = torch.ones((n, n), dtype=torch.bool, device=da.device).tril()
    return torch.exp(torch.where(mask, diff, -1e30))


def ssd_chunked(x, dt, a_log, b_in, c_in, d_skip, chunk: int):
    """SSD scan.  x (B, S, H, P), dt (B, S, H), A = -exp(a_log) (H,), B and C
    (B, S, N) shared across heads, D (H,).  Returns (y (B, S, H, P) in x's
    dtype, the final state (B, H, P, N) in f32)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q
    a = -torch.exp(a_log)                                            # (H,)

    x32 = x.to(torch.float32).reshape(bsz, nc, q, h, p)
    dt32 = dt.to(torch.float32).reshape(bsz, nc, q, h)
    b32 = b_in.to(torch.float32).reshape(bsz, nc, q, n)
    c32 = c_in.to(torch.float32).reshape(bsz, nc, q, n)

    da = dt32 * a                                                    # (b, c, l, h)
    da_hl = da.transpose(-1, -2)                                     # (b, c, h, l)
    da_cum = torch.cumsum(da_hl, dim=-1)

    # intra-chunk: "bcln,bcsn,bchls,bcshp->bclhp" as (C B), then the decay,
    # then x dt
    decay_mat = _segsum_exp(da_hl)                                   # (b, c, h, l, l)
    xdt = x32 * dt32[..., None]                                      # (b, c, l, h, p)
    cb = torch.einsum("bcln,bcsn->bcls", c32, b32)
    y_diag = torch.einsum("bcshp,bchls->bclhp", xdt, decay_mat * cb[:, :, None])

    # per-chunk input states: "bcln,bchl,bclhp->bchpn" as (decay x), then B
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)              # (b, c, h, l)
    dsx = (decay_states * dt32.transpose(-1, -2)).permute(0, 1, 3, 2)[..., None] * x32
    states = torch.einsum("bcln,bclhp->bchpn", b32, dsx)

    # inter-chunk recurrence
    chunk_decay = torch.exp(da_cum[..., -1])                         # (b, c, h)
    carry = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                           # (b, c, h, p, n)

    # the carried-in state: "bcln,bchpn,bchl->bclhp", grouped as jnp.einsum's
    # optimal path groups it (C with the decay first where N < P)
    state_decay = torch.exp(da_cum)                                  # (b, c, h, l)
    if n < p:
        cd = c32[:, :, :, None, :] * state_decay.permute(0, 1, 3, 2)[..., None]  # bclhn
        y_off = torch.einsum("bclhn,bchpn->bclhp", cd, prev_states)
    else:
        y_off = torch.einsum("bcln,bchpn->bclhp", c32, prev_states) * \
            state_decay.permute(0, 1, 3, 2)[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p) + x32.reshape(bsz, s, h, p) * d_skip[:, None]
    return y.to(x.dtype), carry


def block_forward(p: dict, x: torch.Tensor, cfg, *, bits=None, impl: str = "auto",
                  return_state: bool = False, lengths=None):
    """Full-sequence Mamba2 mixer (train / prefill).

    ``lengths`` (B,) int: per-row valid prompt lengths of a right-padded
    prefill.  Pad tokens are masked out of the state update (dt -> 0: the
    decay exp(dt A) is 1 and the update dt x B is 0), so the returned decode
    state is the unpadded one; pads to the right never reach valid
    positions through the causal conv or the causal scan.
    """
    bsz, s, _ = x.shape
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = layers.qdense(p["in_proj"], x, bits=layers._b(bits, "in_proj"), impl=impl)
    z, xc_raw, dt = _split_proj(cfg, zxbcdt)
    xc = _causal_conv(xc_raw.to(torch.float32), p["conv_w"], p["conv_b"]).to(x.dtype)
    xs, b_in, c_in = torch.split(xc, [din, n, n], dim=-1)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device)
        valid = torch.arange(s, device=x.device)[None, :] < lengths[:, None]     # (B, S)
        dt = dt * valid[..., None]
    y, final_state = ssd_chunked(xs.reshape(bsz, s, h, cfg.ssm_head_dim), dt, p["A_log"], b_in,
                                 c_in, p["D"], cfg.ssm_chunk)
    y = y.reshape(bsz, s, din)
    y = layers.rmsnorm(p["gate_norm"], y * F.silu(z.to(torch.float32)).to(y.dtype),
                       cfg.norm_eps)
    out = layers.qdense(p["out_proj"], y, bits=layers._b(bits, "out_proj"), impl=impl)
    if not return_state:
        return out
    w = cfg.ssm_conv_width
    xr = xc_raw.to(torch.float32)
    if lengths is not None:
        # the conv history ends at each row's LAST VALID token, not at the
        # pad boundary: rows [L-(w-1), L), zeros before position 0
        xr = torch.where(valid[..., None], xr, 0.0)
        idx = lengths[:, None] - (w - 1) + torch.arange(w - 1, device=x.device)[None, :]
        tail = torch.gather(xr, 1, idx.clamp(0, s - 1).to(torch.long)[..., None].expand(
            -1, -1, xr.shape[-1]))
        conv_tail = torch.where((idx >= 0)[..., None], tail, 0.0)
    elif s >= w - 1:
        conv_tail = xr[:, s - (w - 1):]
    else:
        conv_tail = F.pad(xr, (0, 0, w - 1 - s, 0))
    return out, {"conv": conv_tail, "ssm": final_state}


def block_decode(p: dict, x: torch.Tensor, state: dict, cfg, *, impl: str = "auto"):
    """One token a row.  state = {"conv": (B, W-1, C), "ssm": (B, H, P, N)}."""
    bsz = x.shape[0]
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = layers.qdense(p["in_proj"], x, impl=impl)               # (B, 1, .)
    z, xc, dt = _split_proj(cfg, zxbcdt)
    xc = xc[:, 0].to(torch.float32)                                  # (B, C)
    conv_hist = torch.cat([state["conv"], xc[:, None]], dim=1)       # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", conv_hist, p["conv_w"]) + p["conv_b"])
    xs, b_in, c_in = torch.split(conv_out, [din, n, n], dim=-1)
    dt1 = _softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])      # (B, H)
    da = torch.exp(dt1 * -torch.exp(p["A_log"]))                     # (B, H)
    xh = xs.reshape(bsz, h, cfg.ssm_head_dim).to(torch.float32)
    upd = (dt1[..., None, None] * xh[..., None]) * b_in[:, None, None, :]
    new_ssm = state["ssm"] * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_ssm, c_in) + xh * p["D"][:, None]
    y = y.reshape(bsz, 1, din).to(x.dtype)
    y = layers.rmsnorm(p["gate_norm"], y * F.silu(z.to(torch.float32)).to(y.dtype),
                       cfg.norm_eps)
    out = layers.qdense(p["out_proj"], y, impl=impl)
    return out, {"conv": conv_hist[:, 1:], "ssm": new_ssm}


def init_state(cfg, batch: int, *, device=None) -> dict:
    device = resolve_device(device)
    din, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, din + 2 * n), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=device),
    }


def abstract_state(cfg, batch: int) -> dict:
    """:func:`init_state`'s shapes and dtypes on the ``meta`` device."""
    return init_state(cfg, batch, device="meta")


# ---------------------------------------------------------------------------
# the attention-free LM (mamba2-2.7b)
# ---------------------------------------------------------------------------


def init(cfg, generator: torch.Generator | None = None, device=None) -> dict:
    """Random train-layout params on ``device`` (default ``cuda``), block
    leaves stacked ``(L, ...)`` and drawn whole from ``generator``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = _dtype(cfg)
    return {
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model, dt, device=device),
        "layers": block_init(generator, cfg, dt, lead=(cfg.n_layers,), device=device),
        "final_norm": layers.norm_init(cfg.d_model, "rmsnorm", dt, device=device),
        "lm_head": layers.dense_init(generator, cfg.d_model, cfg.vocab_size, dt, device=device),
    }


def _layer_body(x, lp: dict, cfg, lb, impl: str) -> torch.Tensor:
    x = shard_batch_act(x)
    return x + block_forward(lp, layers.rmsnorm(lp["ln"], x, cfg.norm_eps), cfg, bits=lb,
                             impl=impl)


def forward(params: dict, cfg, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, *, bits=None,
            impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """Full-sequence forward over the stacked layout -> final hidden (B, S, d).
    The layers run in a Python loop over per-layer views; under ``remat``
    each is recomputed in the backward, as the decoder's are
    (``decoder.checkpointed``); ``bits`` as ``quant.apply.bits_for_scan``
    builds it."""
    x = decoder._inputs(params, tokens, embeds, cfg, bits=layers._b(bits, "embed"), impl=impl)
    x = shard_batch_act(x)
    stacked = decoder._unbind(params["layers"])
    for i in range(cfg.n_layers):
        lb = None if bits is None else decoder._per_layer(bits["layers"], i)
        x = decoder.checkpointed(_layer_body, x, decoder._per_layer(stacked, i), cfg, lb, impl,
                                 remat=remat)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# the serving layout (unrolled layers, a fixed-size state: no KV growth)
# ---------------------------------------------------------------------------


#: (L, ...)-stacked train params -> per-layer list (views) for the serve path
unstack_layers = decoder.unstack_layers


def prefill(params: dict, cfg, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, *, impl: str = "auto", lengths=None,
            logits: bool = True):
    """Serve prefill -> (last-position logits (B, 1, V), per-layer states).

    ``lengths`` masks right-pad tokens out of the state (see
    :func:`block_forward`), so a padded batched admission's state equals
    each request's unpadded one.  ``logits=False`` skips the LM head."""
    x = shard_batch_act(decoder._inputs(params, tokens, embeds, cfg))
    states = []
    for lp in params["layers"]:
        y, st = block_forward(lp, layers.rmsnorm(lp["ln"], x, cfg.norm_eps), cfg, impl=impl,
                              return_state=True, lengths=lengths)
        states.append(st)
        x = x + y
    if not logits:
        return None, states
    hidden = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.qdense(params["lm_head"], hidden[:, -1:], impl=impl), states


def decode_step(params: dict, cfg, states: list, token: torch.Tensor, pos, *,
                embeds: torch.Tensor | None = None, impl: str = "auto"):
    """One token a row; the state carries all history, so ``pos`` is unused."""
    del pos
    x = decoder._inputs(params, token, embeds, cfg)
    new_states = []
    for lp, st in zip(params["layers"], states):
        y, nst = block_decode(lp, layers.rmsnorm(lp["ln"], x, cfg.norm_eps), st, cfg, impl=impl)
        new_states.append(nst)
        x = x + y
    hidden = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.qdense(params["lm_head"], hidden, impl=impl), new_states
