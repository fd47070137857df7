"""Plain PyTorch pieces the references share, in f32 with TF32 off.

Nothing here imports the program.  The quantizers are written from the
formats' definitions: weights symmetric per output channel (the channel's
largest magnitude over ``2^(b-1) - 1``, rounded half to even, clamped), an
expert stack ``(E, K, N)`` with one scale a channel over all experts; the
K/V cache symmetric per slot, head and block of 16 positions, a decode
append re-quantizing the block it lands in from the block's stored values,
with the rows past it zeroed.

``Numerics`` is the precision the reference computes in: ``"f32"``;
``"fp8"``, the control, which rounds the input of every packed linear to
float8 e4m3 with one scale a row, as an fp8 serving path would; or
``"bf16"``, a witness of what bf16 alone does, which rounds each packed
linear's input and output to bfloat16, as the program carries its
activations.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from portbench import weights

KV_BLOCK = 16
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Numerics:
    mode: str = "f32"

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a packed linear as this precision holds it."""
        if self.mode == "f32":
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        if self.mode == "fp8":
            amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
            scale = amax / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        raise ValueError(f"unknown numerics {self.mode!r}")

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(self.act(x), w)
        return out.to(torch.bfloat16).to(torch.float32) if self.mode == "bf16" else out


def qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def quantize_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """``w`` (..., K, N) -> its dequantized f32 values at ``bits``: one scale
    a column over every other axis."""
    w = w.to(torch.float32)
    axes = tuple(range(w.ndim - 1))
    amax = torch.amax(w.abs(), dim=axes, keepdim=True).clamp_min(1e-12)
    q = qmax(bits)
    scale = amax / torch.full_like(amax, q)
    return torch.clamp(torch.round(w / scale), -q, q) * scale


class Weights:
    """A configuration's weights, made again from the seed a leaf (a layer) at a time."""

    def __init__(self, seed: int, bits: dict, device, dtype=torch.bfloat16):
        self.seed, self.bits, self.device, self.dtype = seed, bits, device, dtype

    def raw(self, path: str, layer: int, shape, dtype=None) -> torch.Tensor:
        return weights.make_leaf(self.seed, path, layer, shape, dtype or self.dtype,
                                 self.device).to(torch.float32)

    def packed(self, path: str, layer: int, shape, policy_name: str) -> torch.Tensor:
        """A packed linear's dequantized f32 weight."""
        return quantize_weight(self.raw(path, layer, shape), self.bits[policy_name])

    def embedding(self, vocab: int, d: int) -> torch.Tensor:
        """The embedding table (V, d), quantized with one scale a row (the
        program stores it as the (d, V) head layout)."""
        emb = self.raw("embed", -1, (vocab, d))
        return quantize_weight(emb.T, self.bits["embed"]).T.contiguous()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x (..., H, hd), positions (...)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, window: int = 0) -> torch.Tensor:
    """Causal softmax attention within rows: q (B, S, Hq, hd), k/v (B, S, Hk, hd)."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    i = torch.arange(s, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def _block_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., nblocks, 16, hd) -> dequantized values, one scale a block."""
    q = qmax(bits)
    amax = torch.amax(x.abs(), dim=(-1, -2), keepdim=True).clamp_min(1e-12)
    scale = amax / torch.full_like(amax, q)
    return torch.clamp(torch.round(x / scale), -q, q) * scale


def cached_attention(q_dec, k_pre, v_pre, k_dec, v_dec, n_head, n_dec, k_bits: int,
                     v_bits: int, window: int = 0, chunk: int = 16) -> torch.Tensor:
    """Decode attention over the quantized K/V cache, per request.

    Request r's head of ``n_head[r]`` positions goes into the cache at
    admission (quantized by blocks, rows past the head zero); its j-th decode
    token, at position ``n_head[r] + j``, appends its K/V (the block holding
    it re-quantized) and attends over positions ``0 .. n_head[r] + j``.

    q_dec (R, J, Hq, hd); k_pre, v_pre (R, P, Hk, hd) with P >= max n_head;
    k_dec, v_dec (R, J, Hk, hd); n_head, n_dec (R,) int.  -> (R, J, Hq, hd).
    Positions in blocks before the one a query's token lands in hold their
    final values once that block is left; the block itself holds the values
    of the append just made.  So the attention splits into a part over the
    finished blocks (one batched product at the end) and a part over the
    current block (taken at each append), merged by their softmax sums.
    """
    dev = q_dec.device
    r, jmax, hq, hd = q_dec.shape
    hk = k_pre.shape[2]
    g = hq // hk
    blk = KV_BLOCK
    n_head = n_head.to(dev).long()
    n_dec = n_dec.to(dev).long()
    ptot = int((n_head + n_dec).max().item()) if r else 0
    nb = -(-max(ptot, 1) // blk) + 1
    scale = 1.0 / math.sqrt(hd)

    def store(pre, bits):
        x = torch.zeros((r, nb * blk, hk, hd), dtype=torch.float32, device=dev)
        p = min(pre.shape[1], nb * blk)
        keep = torch.arange(p, device=dev)[None, :] < n_head[:, None]
        x[:, :p] = torch.where(keep[..., None, None], pre[:, :p], 0.0)
        x = x.view(r, nb, blk, hk, hd).permute(0, 3, 1, 2, 4)          # (R, Hk, nb, 16, hd)
        return _block_quant(x, bits).contiguous()

    kv = {"k": store(k_pre, k_bits), "v": store(v_pre, v_bits)}
    rows = torch.arange(blk, device=dev)
    ar = torch.arange(r, device=dev)
    m2 = torch.full((r, jmax, hq), float("-inf"), device=dev)
    l2 = torch.zeros((r, jmax, hq), device=dev)
    a2 = torch.zeros((r, jmax, hq, hd), device=dev)
    for j in range(jmax):
        live = j < n_dec
        if not bool(live.any()):
            break
        pos = torch.where(live, n_head + j, 0)
        b, off = pos // blk, pos % blk
        cur = {}
        for side, new, bits in (("k", k_dec[:, j], k_bits), ("v", v_dec[:, j], v_bits)):
            block = kv[side][ar, :, b]                                     # (R, Hk, 16, hd)
            fp = torch.where(rows[None, None, :, None] < off[:, None, None, None], block, 0.0)
            fp = torch.where(rows[None, None, :, None] == off[:, None, None, None],
                             new[:, :, None, :], fp)
            nq = _block_quant(fp[:, :, None], bits)[:, :, 0]
            nq = torch.where(live[:, None, None, None], nq, block)
            kv[side][ar, :, b] = nq
            cur[side] = nq
        # the current block's part: rows up to the new one (and inside the window)
        kpos = b[:, None] * blk + rows[None, :]                             # (R, 16)
        ok = rows[None, :] <= off[:, None]
        if window:
            ok &= kpos > (pos[:, None] - window)
        kc = cur["k"].repeat_interleave(g, dim=1)                           # (R, Hq, 16, hd)
        vc = cur["v"].repeat_interleave(g, dim=1)
        s = torch.einsum("rhd,rhkd->rhk", q_dec[:, j], kc) * scale
        s = s.masked_fill(~ok[:, None, :], float("-inf"))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        m2[:, j], l2[:, j] = m, p.sum(-1)
        a2[:, j] = torch.einsum("rhk,rhkd->rhd", p, vc)
    # the finished blocks' part, a few requests at a time
    out = torch.empty_like(q_dec)
    for r0 in range(0, r, chunk):
        sl = slice(r0, r0 + chunk)
        kf = kv["k"][sl].reshape(-1, hk, nb * blk, hd).repeat_interleave(g, dim=1)
        vf = kv["v"][sl].reshape(-1, hk, nb * blk, hd).repeat_interleave(g, dim=1)
        s = torch.einsum("rjhd,rhkd->rjhk", q_dec[sl], kf) * scale
        pos = n_head[sl, None] + torch.arange(jmax, device=dev)[None, :]     # (r, J)
        kp = torch.arange(nb * blk, device=dev)
        ok = kp[None, None, :] < (pos // blk * blk)[..., None]
        if window:
            ok &= kp[None, None, :] > (pos[..., None] - window)
        s = s.masked_fill(~ok[:, :, None, :], float("-inf"))
        m1 = s.amax(dim=-1)
        mm = torch.maximum(m1, m2[sl])
        e1 = torch.exp(s - mm[..., None]).nan_to_num(0.0)
        w2 = torch.exp(m2[sl] - mm).nan_to_num(0.0)
        num = torch.einsum("rjhk,rhkd->rjhd", e1, vf) + w2[..., None] * a2[sl]
        den = e1.sum(-1) + w2 * l2[sl]
        out[sl] = num / den[..., None]
    return out
