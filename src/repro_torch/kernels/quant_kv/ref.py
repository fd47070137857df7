"""Plain PyTorch versions of the quantized-KV decode ops (dense and paged).

Mirror ``repro/kernels/quant_kv/ref.py`` in its default config
(``place="select"``, ``attend="substitute"``; every JAX config is
bitwise-equal): an append requantizes exactly the block holding ``pos``
with the new row inserted, and attention folds the per-block scales into
the (·, S) scores and probabilities.  Caches and pools are updated in place.

The paged versions go through the dense ones: paged attention is dense
attention over ``to_dense`` of the pool, so a pool and a dense cache with
the same contents give the same output bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import packing
from repro_torch.kernels import PLAIN_CALLS
from repro_torch.kernels.quant_kv.kernel import CHUNK, TILE
from repro_torch.kernels.quant_matmul.ref import dequant_matmul
from repro_torch.kvcache.cache import QuantizedKVLayer, append_side, append_token
from repro_torch.kvcache.paged import append_token_paged, to_dense


def _scale_per_pos(scale: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, S/block, 1) block scales -> (B, H, 1, S) per-position factors."""
    b, h, nb, _ = scale.shape
    return scale.expand(b, h, nb, block).reshape(b, h, nb * block)[:, :, None, :]


def _attention_from_levels(qg, klev, k_scale, vlev, v_scale, kv_valid, *, block: int,
                           hd: int) -> torch.Tensor:
    """Masked decode attention over unpacked int levels.

    ``qg``: f32 (B, H, g, hd); ``klev``/``vlev``: int (B, H, S, hd); scales
    (B, H, S/block, 1); ``kv_valid`` (B, S) bool -> (B, H, g, hd) f32.
    """
    scores = torch.einsum("bkgh,bkth->bkgt", qg, klev.to(torch.float32))
    scores = scores * (_scale_per_pos(k_scale, block) * (1.0 / math.sqrt(hd)))
    scores = torch.where(kv_valid[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    p = p * _scale_per_pos(v_scale, block)                    # fold V scales
    return torch.einsum("bkgt,bkth->bkgh", p, vlev.to(torch.float32))


def _attend_dense(q: torch.Tensor, layer: QuantizedKVLayer, kv_valid: torch.Tensor,
                  out_dtype) -> torch.Tensor:
    b, s, n_kv, hd = layer.shape
    hq = q.shape[1]
    qg = q.to(torch.float32).reshape(b, n_kv, hq // n_kv, hd)
    klev = packing.unpack(layer.k_packed, layer.k_bits, hd)   # (B, H, S, hd)
    vlev = packing.unpack(layer.v_packed, layer.v_bits, hd)
    o = _attention_from_levels(qg, klev, layer.k_scale, vlev, layer.v_scale, kv_valid,
                               block=layer.block, hd=hd)
    return o.reshape(b, hq, hd).to(out_dtype or q.dtype)


def quant_kv_attention_ref(q: torch.Tensor, layer: QuantizedKVLayer, kv_valid: torch.Tensor,
                           *, out_dtype=None) -> torch.Tensor:
    """softmax(q @ dequant(K).T / sqrt(hd), masked) @ dequant(V) -> (B, hq, hd)."""
    PLAIN_CALLS["quant_kv_attention"] += 1
    return _attend_dense(q, layer, kv_valid, out_dtype)


def quant_kv_append_ref(layer: QuantizedKVLayer, pos, k_new, v_new) -> QuantizedKVLayer:
    """One-token append, in place: requantize exactly the block containing ``pos``."""
    PLAIN_CALLS["quant_kv_append"] += 1
    return append_token(layer, pos, k_new, v_new)


def quant_kv_decode_step_ref(q: torch.Tensor, layer: QuantizedKVLayer, pos, k_new, v_new,
                             kv_valid: torch.Tensor, *, out_dtype=None):
    """Append + attend for one decode token per slot.

    ``q`` (B, hq, hd); ``pos`` (B,) or scalar; ``k_new``/``v_new``
    (B, 1, H, hd); ``kv_valid`` (B, S) bool, already including ``pos``.
    Returns ``(out (B, hq, hd), layer)`` with the layer updated in place.
    """
    PLAIN_CALLS["quant_kv_decode_step"] += 1
    return _decode_step_dense(q, layer, pos, k_new, v_new, kv_valid, out_dtype), layer


def _decode_step_dense(q, layer: QuantizedKVLayer, pos, k_new, v_new, kv_valid,
                       out_dtype) -> torch.Tensor:
    b, s, n_kv, hd = layer.shape
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    append_side(layer.k_packed, layer.k_scale, k_new.transpose(1, 2)[:, :, 0], pos,
                layer.k_bits, hd, layer.block)
    append_side(layer.v_packed, layer.v_scale, v_new.transpose(1, 2)[:, :, 0], pos,
                layer.v_bits, hd, layer.block)
    return _attend_dense(q, layer, kv_valid, out_dtype)


def _rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of ``x`` (B, rows, hd) by (B, 1, hd/2) ``cos``/``sin``:
    ``models.layers.apply_rope``'s arithmetic at one position per slot."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def quant_kv_decode_step_proj_ref(x: torch.Tensor, w_packed: torch.Tensor,
                                  w_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                                  layer: QuantizedKVLayer, pos, kv_valid: torch.Tensor, *,
                                  w_bits: int, n_heads: int, out_dtype=None):
    """The projection-fused step as its composition: the plain GEMV on ``x``
    (B, d) against the fused ``wqkv``, the split into the query heads and the
    K and V rows (q group ``j`` is rows ``j*g*hd``, K head ``j`` rows
    ``(n_heads + j)*hd``, V head ``j`` rows ``(n_heads + n_kv + j)*hd``), the
    rotation of q and k by ``cos``/``sin`` (B, hd/2), then the plain decode
    step.  Returns ``(out (B, hq, hd), layer)`` with the layer updated in place.
    """
    PLAIN_CALLS["quant_kv_decode_step_proj"] += 1
    b, d = x.shape
    _, s, n_kv, hd = layer.shape
    y = dequant_matmul(x.to(torch.float32), w_packed, w_scale, w_bits, d,
                       out_dtype=torch.float32)                     # (B, N)
    nq = n_heads * hd
    q = y[:, :nq].reshape(b, n_heads, hd)
    k = y[:, nq:nq + n_kv * hd].reshape(b, n_kv, hd)
    v = y[:, nq + n_kv * hd:].reshape(b, n_kv, hd)
    cs, sn = cos[:, None, :], sin[:, None, :]
    q, k = _rope_rows(q, cs, sn), _rope_rows(k, cs, sn)
    o = _decode_step_dense(q, layer, pos, k[:, None], v[:, None], kv_valid,
                           out_dtype or x.dtype)
    return o, layer


# ---------------------------------------------------------------------------
# paged variants
# ---------------------------------------------------------------------------


def quant_kv_attention_paged_ref(q: torch.Tensor, layer, kv_valid: torch.Tensor, *,
                                 out_dtype=None) -> torch.Tensor:
    """Paged attention: the dense version over ``to_dense`` of the pool."""
    PLAIN_CALLS["quant_kv_attention_paged"] += 1
    return _attend_dense(q, to_dense(layer), kv_valid, out_dtype)


def quant_kv_append_paged_ref(layer, pos, k_new, v_new):
    """Paged append, in place: requantize each slot's mapped block."""
    PLAIN_CALLS["quant_kv_append_paged"] += 1
    return append_token_paged(layer, pos, k_new, v_new)


def quant_kv_append_burst_ref(layer, start, acc, k_burst, v_burst):
    """The burst append as positions appended one at a time, in place: at
    burst index j every slot whose ``acc`` >= j appends row j of ``k_burst``
    / ``v_burst`` (B, J, H, hd) at ``start + j``; the others are masked (a
    dense position -1, a paged table row -1), as the JAX package's commit
    masks them.  Each position is one counted plain append.  Returns the
    layer."""
    dev = layer.k_packed.device
    start = torch.as_tensor(start, device=dev).reshape(-1).to(torch.int32)
    acc = torch.as_tensor(acc, device=dev).reshape(-1)
    for j in range(k_burst.shape[1]):
        mask = j <= acc
        kn, vn = k_burst[:, j:j + 1], v_burst[:, j:j + 1]
        if isinstance(layer, QuantizedKVLayer):
            quant_kv_append_ref(layer, torch.where(mask, start + j, -1), kn, vn)
        else:
            table = torch.where(mask[:, None], layer.block_table, -1)
            quant_kv_append_paged_ref(dataclasses.replace(layer, block_table=table), start + j,
                                      kn, vn)
    return layer


def quant_kv_decode_step_paged_ref(q: torch.Tensor, layer, pos, k_new, v_new,
                                   kv_valid: torch.Tensor, *, out_dtype=None):
    """Fused paged step: the paged append, then dense attention over ``to_dense``.

    The JAX package's ``attend="reunpack"`` graph, bitwise equal to its
    default ``"substitute"`` because the engine's copy-on-write leaves a live
    slot's touched block mapped by that slot alone, and an idle slot's write
    lands in the never-mapped trash block.  Returns ``(out (B, hq, hd), layer)``.
    """
    PLAIN_CALLS["quant_kv_decode_step_paged"] += 1
    append_token_paged(layer, pos, k_new, v_new)
    return _attend_dense(q, to_dense(layer), kv_valid, out_dtype), layer


# ---------------------------------------------------------------------------
# the CUDA attention body's arithmetic, for the tests
# ---------------------------------------------------------------------------


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf(a, b, c)``: the product is exact in f64, then one rounding
    to f64 and one to f32 (a double rounding that differs from ``fmaf`` only
    at rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """``common.cuh`` warp_sum over the last axis (32 lanes): the xor
    butterfly, lane 0's total."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _fold(state, part):
    """``quant_kv.cuh`` fold_chunk: the running (M, L, O) and one chunk's
    partial (m, l, acc); an empty chunk (m = -inf) adds nothing."""
    big_m, big_l, big_o = state
    m, l, acc = part
    mn = torch.maximum(big_m, m)
    a, b = torch.exp(big_m - mn), torch.exp(m - mn)
    keep = m != -math.inf
    return (torch.where(keep, mn, big_m),
            torch.where(keep, _fma(big_l, a, l * b), big_l),
            torch.where(keep[..., None], _fma(big_o, a[..., None], acc * b[..., None]), big_o))


def attend_mirror(q: torch.Tensor, layer, kv_valid: torch.Tensor) -> torch.Tensor:
    """A CPU mirror of ``csrc/quant_kv.cuh`` ``attend``, for the tests (uncounted).

    ``q`` (B, hq, hd); ``layer`` dense or paged (read through ``to_dense``);
    ``kv_valid`` (B, S) bool.  Returns (B, hq, hd) f32.  The kernel's
    arithmetic in its order: K and V dequantized as level * scale; S cut into
    chunks of ``CHUNK`` positions, each a fresh online softmax over
    ``TILE``-position tiles (a tile with no valid position skipped unless the
    slot has none; scores a sequential fused dot product, times hd^-0.5 plus
    the mask in one fma, exp sums by the warp's butterfly; probabilities times
    V a sequential fma chain after the rescale); the chunks' partials folded
    in chunk order; out = O / max(L, 1e-30).  It does not depend on how the
    kernel spreads the chunks over CTAs.
    """
    if not isinstance(layer, QuantizedKVLayer):
        layer = to_dense(layer)
    b, s, n_kv, hd = layer.shape
    g = q.shape[1] // n_kv
    qg = q.to(torch.float32).reshape(b, n_kv, g, hd)

    def deq(packed, scale, bits):
        lev = packing.unpack(packed, bits, hd).to(torch.float32)          # (B, H, S, hd)
        return lev * _scale_per_pos(scale, layer.block).transpose(2, 3)

    kf = deq(layer.k_packed, layer.k_scale, layer.k_bits)
    vf = deq(layer.v_packed, layer.v_scale, layer.v_bits)
    mask = torch.where(kv_valid, 0.0, -1e30).to(torch.float32)
    inv_sqrt = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd)))
    any_valid = kv_valid.any(dim=1)
    neg = torch.full((b, n_kv, g), -math.inf)
    state = (neg, torch.zeros((b, n_kv, g)), torch.zeros((b, n_kv, g, hd)))
    for c0 in range(0, s, CHUNK):
        m, l, acc = neg, torch.zeros((b, n_kv, g)), torch.zeros((b, n_kv, g, hd))
        for t0 in range(c0, min(c0 + CHUNK, s), TILE):
            t1 = min(t0 + TILE, s)
            live = (kv_valid[:, t0:t1].any(dim=1) | ~any_valid)[:, None, None]     # (B, 1, 1)
            if not bool(live.any()):
                continue
            kt, vt = kf[:, :, t0:t1], vf[:, :, t0:t1]                      # (B, H, n, hd)
            dot = torch.zeros((b, n_kv, g, t1 - t0))
            for c in range(hd):
                dot = _fma(qg[..., c, None], kt[:, :, None, :, c], dot)
            sc = _fma(dot, inv_sqrt, mask[:, None, None, t0:t1])
            sc = torch.cat([sc, torch.full((b, n_kv, g, TILE - (t1 - t0)), -math.inf)], -1)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            e = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = _fma(l, corr, _warp_sum(e))
            a = acc * corr[..., None]
            for t in range(t1 - t0):
                a = _fma(e[..., t, None], vt[:, :, None, t, :], a)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live[..., None], a, acc)
        state = _fold(state, (m, l, acc))
    _, big_l, big_o = state
    return (big_o / torch.clamp(big_l, min=1e-30)[..., None]).reshape(b, n_kv * g, hd)
