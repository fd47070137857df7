"""Plain reference of the SSM family (mamba2-2.7b) as served.

A request's rows do not meet any other request's in this family (no layer
mixes the rows of a batch), so the reference runs each sampled request on
its own: its prompt and the tokens it was served, in one causal pass, layer
by layer in f32.  Each layer: RMSNorm, then the Mamba2 mixer (the input
projection to z, x, B, C and dt; the depthwise causal conv of width 4 over
x, B and C; the selective scan with one group,
``y_t = sum_{s<=t} exp(sum_{s<k<=t} dt_k A) dt_s (C_t . B_s) x_s + D x_t``,
taken in chunks of 64 with the state carried; the gated RMSNorm
``norm(y * silu(z))``; the output projection), added to the residual.  Then
the final RMSNorm and the LM head.

Imports nothing of the program.  Mamba2: arXiv:2405.21060.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Numerics, Weights, no_tf32, rmsnorm

SCAN_CHUNK = 64


def _scan(x, dt, a, b, c, d_skip):
    """x (R, L, H, P), dt (R, L, H), a (H,) < 0, b and c (R, L, N), d_skip (H,)."""
    r, length, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((r, h, p, n), device=x.device)
    ys = []
    for t0 in range(0, length, SCAN_CHUNK):
        sl = slice(t0, t0 + SCAN_CHUNK)
        xc, dtc, bc, cc = x[:, sl], dt[:, sl], b[:, sl], c[:, sl]
        q = xc.shape[1]
        cs = torch.cumsum(dtc * a, dim=1)                                  # (R, q, H)
        diff = cs[:, :, None, :] - cs[:, None, :, :]                       # (R, t, s, H)
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~causal[None, :, :, None], float("-inf")))
        cb = torch.einsum("rtn,rsn->rts", cc, bc)
        y = torch.einsum("rtsh,rts,rsh,rshp->rthp", decay, cb, dtc, xc)
        y = y + torch.einsum("rtn,rhpn,rth->rthp", cc, state, torch.exp(cs))
        ys.append(y + xc * d_skip[:, None])
        last = cs[:, -1:, :]                                                # (R, 1, H)
        w = torch.exp(last - cs) * dtc                                      # (R, q, H)
        state = state * torch.exp(last[:, 0])[..., None, None] + torch.einsum(
            "rsh,rshp,rsn->rhpn", w, xc, bc)
    return torch.cat(ys, dim=1)


def _conv(xc, w, bias):
    """Depthwise causal conv: xc (R, L, C), w (W, C), zeros before position 0."""
    width, length = w.shape[0], xc.shape[1]
    pad = F.pad(xc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + length] * w[i] for i in range(width))
    return F.silu(out + bias)


def forward(seed: int, m: dict, bits: dict, requests: list[tuple[list[int], list[int]]],
            num: Numerics, device) -> list[torch.Tensor]:
    """Logits (n, V) at each served token of each request ``(prompt, served)``."""
    no_tf32()
    d, eps = m["d_model"], m["norm_eps"]
    din = m["ssm_expand"] * d
    n, ph = m["ssm_state"], m["ssm_head_dim"]
    h_ssm = din // ph
    seqs = [list(p) + list(s[:-1]) for p, s in requests]
    r, lmax = len(seqs), max(len(s) for s in seqs)
    tok = torch.zeros((r, lmax), dtype=torch.long, device=device)
    for i, s in enumerate(seqs):
        tok[i, :len(s)] = torch.tensor(s, device=device)
    W = Weights(seed, bits, device, getattr(torch, m["dtype"]))
    x = W.embedding(m["vocab_size"], d)[tok]
    for i in range(m["n_layers"]):
        p = f"layer{i:03d}."
        h = rmsnorm(x, W.raw("layers.ln", i, (d,)), eps)
        zxbcdt = num.mm(h, W.packed("layers.in_proj", i, (d, 2 * din + 2 * n + h_ssm),
                                    p + "in_proj"))
        z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * n, h_ssm], dim=-1)
        conv_w = W.raw("layers.conv_w", i, (m["ssm_conv_width"], din + 2 * n), torch.float32)
        conv_b = W.raw("layers.conv_b", i, (din + 2 * n,), torch.float32)
        xbc = _conv(xbc, conv_w, conv_b)
        xs, b_in, c_in = torch.split(xbc, [din, n, n], dim=-1)
        dt = F.softplus(dt + W.raw("layers.dt_bias", i, (h_ssm,), torch.float32))
        a = -torch.exp(W.raw("layers.A_log", i, (h_ssm,), torch.float32))
        y = _scan(xs.reshape(r, lmax, h_ssm, ph), dt, a, b_in, c_in,
                  W.raw("layers.D", i, (h_ssm,), torch.float32))
        y = rmsnorm(y.reshape(r, lmax, din) * F.silu(z), W.raw("layers.gate_norm", i, (din,)), eps)
        x = x + num.mm(y, W.packed("layers.out_proj", i, (din, d), p + "out_proj"))
        del h, zxbcdt, z, xbc, dt, xs, b_in, c_in, y
    fin = W.raw("final_norm", -1, (d,))
    head = W.packed("lm_head", -1, (d, m["vocab_size"]), "lm_head")
    out = []
    for i, (p, s) in enumerate(requests):
        rows = x[i, len(p) - 1: len(p) - 1 + len(s)]
        out.append(num.mm(rmsnorm(rows, fin, eps), head))
    return out


def served_logits(seed: int, m: dict, bits: dict, batches, rec, uids: list[int], num: Numerics,
                  device) -> dict:
    """``check.py``'s entry: logits at every served token of ``uids`` (the
    batches are not needed: no layer of the family mixes rows)."""
    del batches
    reqs = [(rec.jobs[u].prompt, rec.tokens[u]) for u in uids]
    return dict(zip(uids, forward(seed, m, bits, reqs, num, device)))
