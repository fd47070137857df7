"""Plain reference of the MoE decoder family (deepseek-moe-16b) as served.

Replays the batches the engine ran (``batches.py``, as it handed them to the
model), layer by layer, in f32: each admission's prefill (its rows padded to
the call's length, the pad tokens included, since they route and take expert
capacity) and each decode step (every row, an idle one at token 0, position
0), up to the last call that holds a sampled request.  Per layer: RMSNorm, Q/K/V, RoPE,
attention (causal within a prefill row over the float K/V; over the K8/V4
cache at decode, ``common.cached_attention``), the output projection, then
the router in f32, the stable top-k with renormalized gates, the capacity
of each call (``int(tokens * k / E * factor) + 1`` rounded up to a multiple
of 8, assignments past it dropped in token order), the routed experts and
the shared experts.  Weights are made again from the seed a layer at a time
and quantized here at the policy's bits.

Imports nothing of the program.  DeepSeekMoE: arXiv:2401.06066.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Numerics, Weights, cached_attention, causal_attention, no_tf32, rmsnorm, rope

CHUNK = 32768          # instances a dense product takes at a time


def capacity(tokens: int, m: dict) -> int:
    c = int(tokens * m["top_k"] / m["n_experts"] * m["moe_capacity_factor"]) + 1
    return -(-c // 8) * 8


class ReplayError(AssertionError):
    """A batch the reference cannot replay."""


class Replay:
    """The token instances of every call, in call order, up to the last one
    that holds a decode of ``sample``, and per request where its prefill row
    and its decode tokens lie among them."""

    def __init__(self, batches, jobs: dict, sample: list[int], device):
        calls = batches.calls
        want = set(sample)
        last = max((n for n, c in enumerate(calls) if hasattr(c, "slots")
                    and any(u in want for u, _, _ in c.slots)), default=-1)
        tok, pos, grp, caps_n = [], [], [], []
        self.pre: dict[int, tuple[int, int]] = {}        # uid -> (first instance, pad)
        self.dec: dict[int, list[int]] = {}              # uid -> instance of decode j
        self.calls: list[tuple[int, int, int, int]] = []  # (start, rows, length, kind 0/1)
        for c in calls[:last + 1]:
            start = len(tok)
            if not hasattr(c, "slots"):                  # an admission's prefill
                if any(uid is None for _, uid in c.rows):
                    raise ReplayError(f"turn {c.turn}: a prefill row holds no request")
                for _, uid in c.rows:
                    head = jobs[uid].prompt[:-1]
                    self.pre[uid] = (len(tok), c.pad)
                    tok += [head[s] if s < len(head) else 0 for s in range(c.pad)]
                    pos += list(range(c.pad))
                self.calls.append((start, len(c.rows), c.pad, 0))
            else:
                for (uid, t, p), j in zip(c.slots, c.js):
                    if uid is None:
                        if t != 0 or p != 0:
                            raise ReplayError(f"turn {c.turn}: an idle row at token {t}, "
                                              f"position {p}: the replay holds no stale cache")
                    else:
                        lst = self.dec.setdefault(uid, [])
                        if j != len(lst):
                            raise ReplayError(f"request {uid}: decode {j} out of order")
                        lst.append(len(tok))
                    tok.append(t)
                    pos.append(p)
                self.calls.append((start, len(c.slots), 1, 1))
            grp += [len(caps_n)] * (len(tok) - start)
            caps_n.append(len(tok) - start)
        self.tok = torch.tensor(tok, dtype=torch.long, device=device)
        self.pos = torch.tensor(pos, dtype=torch.long, device=device)
        self.grp = torch.tensor(grp, dtype=torch.long, device=device)
        self.group_sizes = caps_n
        self.jobs = jobs
        self.uids = sorted(self.dec)
        self.n = len(tok)
        owned = {i for lst in self.dec.values() for i in lst}
        self.idle = [i for start, rows, _, kind in self.calls if kind == 1
                     for i in range(start, start + rows) if i not in owned]


def _attention(rp: Replay, q, k, v, m: dict, kv_bits: tuple[int, int]) -> torch.Tensor:
    """Every instance's attention output (N, Hq * hd)."""
    dev = q.device
    out = torch.zeros_like(q)
    for start, rows, length, kind in rp.calls:
        if kind == 0:
            sl = slice(start, start + rows * length)
            shp = (rows, length) + q.shape[1:]
            out[sl] = causal_attention(q[sl].view(shp), k[sl].view(shp[:2] + k.shape[1:]),
                                       v[sl].view(shp[:2] + v.shape[1:])).reshape(-1, *q.shape[1:])
    # decode: each request over its own cache
    uids = rp.uids
    if uids:
        n_head = torch.tensor([len(rp.jobs[u].prompt) - 1 for u in uids], device=dev)
        n_dec = torch.tensor([len(rp.dec[u]) for u in uids], device=dev)
        jmax = int(n_dec.max())
        pmax = max(max((rp.pre[u][1] for u in uids if u in rp.pre), default=1), 1)
        pre_idx = torch.full((len(uids), pmax), -1, dtype=torch.long, device=dev)
        dec_idx = torch.full((len(uids), jmax), -1, dtype=torch.long, device=dev)
        for r, u in enumerate(uids):
            if u in rp.pre:
                s0, pad = rp.pre[u]
                pre_idx[r, :pad] = torch.arange(s0, s0 + pad, device=dev)
            dec_idx[r, :len(rp.dec[u])] = torch.tensor(rp.dec[u], device=dev)

        def take(x, idx):
            return torch.where((idx >= 0)[..., None, None], x[idx.clamp_min(0)], 0.0)

        o = cached_attention(take(q, dec_idx), take(k, pre_idx), take(v, pre_idx),
                             take(k, dec_idx), take(v, dec_idx), n_head, n_dec, *kv_bits)
        live = dec_idx >= 0
        out[dec_idx[live]] = o[live]
    # idle slots: position 0 of an empty cache, the value itself as quantized there
    if rp.idle:
        idle = rp.idle
        ii = torch.tensor(idle, device=dev)
        o = cached_attention(q[ii][:, None], k[ii][:, None, :, :][:, :0], v[ii][:, None][:, :0],
                             k[ii][:, None], v[ii][:, None],
                             torch.zeros(len(idle), dtype=torch.long, device=dev),
                             torch.ones(len(idle), dtype=torch.long, device=dev), *kv_bits)
        out[ii] = o[:, 0]
    return out


def _moe(rp: Replay, h: torch.Tensor, W: Weights, l: int, m: dict, num: Numerics):
    """The routed experts over every call, each with its own capacity."""
    e, d, f, k = m["n_experts"], m["d_model"], m["d_ff"], m["top_k"]
    p = f"layer{l:03d}.mlp."
    router = W.raw("layers.mlp.router", l, (d, e), dtype=torch.float32)
    probs = torch.softmax(h @ router, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each assignment in its expert, within its call, in token order
    cnt = torch.zeros((rp.n, e), dtype=torch.long, device=h.device)
    cnt.scatter_(1, eidx, 1)
    before = torch.cumsum(cnt, dim=0) - cnt
    sizes = torch.tensor(rp.group_sizes, device=h.device)
    first = torch.cumsum(sizes, 0) - sizes
    before = before - before[first][rp.grp]
    pos_in = torch.gather(before, 1, eidx)
    caps = torch.tensor([capacity(n, m) for n in rp.group_sizes], device=h.device)
    keep = pos_in < caps[rp.grp][:, None]
    wg = W.packed("layers.mlp.w_gate", l, (e, d, f), p + "w_gate")
    wu = W.packed("layers.mlp.w_up", l, (e, d, f), p + "w_up")
    wd = W.packed("layers.mlp.w_down", l, (e, f, d), p + "w_down")
    y = torch.zeros_like(h)
    for x in range(e):
        ii, jj = torch.nonzero((eidx == x) & keep, as_tuple=True)
        for c0 in range(0, len(ii), CHUNK):
            i, j = ii[c0:c0 + CHUNK], jj[c0:c0 + CHUNK]
            xe = h[i]
            he = F.silu(num.mm(xe, wg[x])) * num.mm(xe, wu[x])
            y.index_add_(0, i, num.mm(he, wd[x]) * gates[i, j, None])
    dropped = int((~keep).sum())
    return y, dropped


def _dense_mlp(h, wg, wu, wd, num: Numerics):
    out = torch.empty_like(h)
    for c0 in range(0, h.shape[0], CHUNK):
        x = h[c0:c0 + CHUNK]
        out[c0:c0 + CHUNK] = num.mm(F.silu(num.mm(x, wg)) * num.mm(x, wu), wd)
    return out


def _mm(x, w, num: Numerics):
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for c0 in range(0, x.shape[0], CHUNK):
        out[c0:c0 + CHUNK] = num.mm(x[c0:c0 + CHUNK], w)
    return out


def replay(seed: int, m: dict, bits: dict, batches, jobs: dict, sample: list[int],
           num: Numerics, device) -> dict:
    """Logits (n, V) of each sampled request at each of its decode tokens,
    and the count of dropped expert assignments."""
    no_tf32()
    rp = Replay(batches, jobs, sample, device)
    d, hq, hk = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m["head_dim"] or d // hq
    eps, theta = m["norm_eps"], m["rope_theta"]
    kv_bits = (bits["layer000.state.k"], bits["layer000.state.v"])
    W = Weights(seed, bits, device, getattr(torch, m["dtype"]))
    x = W.embedding(m["vocab_size"], d)[rp.tok]
    dropped = 0
    for l in range(m["n_layers"]):
        p = f"layer{l:03d}."
        if (bits[p + "state.k"], bits[p + "state.v"]) != kv_bits:
            raise NotImplementedError("per-layer K/V bits")
        h = rmsnorm(x, W.raw("layers.ln1", l, (d,)), eps)
        wqkv = torch.cat([W.packed(f"layers.attn.{n}", l, (d, (hq if n == "wq" else hk) * hd),
                                   p + f"attn.{n}") for n in ("wq", "wk", "wv")], dim=1)
        qkv = _mm(h, wqkv, num)
        del h, wqkv
        q = rope(qkv[:, :hq * hd].view(-1, hq, hd), rp.pos, theta)
        k = rope(qkv[:, hq * hd:(hq + hk) * hd].view(-1, hk, hd), rp.pos, theta)
        v = qkv[:, (hq + hk) * hd:].reshape(-1, hk, hd)
        del qkv
        o = _attention(rp, q, k, v, m, kv_bits)
        del q, k, v
        x = x + _mm(o.reshape(rp.n, hq * hd), W.packed("layers.attn.wo", l, (hq * hd, d),
                                                        p + "attn.wo"), num)
        del o
        h = rmsnorm(x, W.raw("layers.ln2", l, (d,)), eps)
        y, n_drop = _moe(rp, h, W, l, m, num)
        dropped += n_drop
        fs = m["n_shared_experts"] * m["d_ff"]
        sp = "layers.mlp.shared."
        y += _dense_mlp(h, W.packed(sp + "w_gate", l, (d, fs), p + "mlp.shared.w_gate"),
                        W.packed(sp + "w_up", l, (d, fs), p + "mlp.shared.w_up"),
                        W.packed(sp + "w_down", l, (fs, d), p + "mlp.shared.w_down"), num)
        x = x + y
        del h, y
    head = W.packed("lm_head", -1, (d, m["vocab_size"]), "lm_head")
    fin = W.raw("final_norm", -1, (d,))
    out = {}
    for u in sample:
        idx = torch.tensor(rp.dec[u], device=device)
        out[u] = num.mm(rmsnorm(x[idx], fin, eps), head)
    return {"logits": out, "dropped": dropped}


def served_logits(seed: int, m: dict, bits: dict, batches, rec, uids: list[int], num: Numerics,
                  device) -> dict:
    """``check.py``'s entry: logits at every served token of ``uids``."""
    return replay(seed, m, bits, batches, rec.jobs, uids, num, device)["logits"]
