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

import math

import torch

from repro_torch.core import packing
from repro_torch.kernels import PLAIN_CALLS
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
    b, s, n_kv, hd = layer.shape
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    append_side(layer.k_packed, layer.k_scale, k_new.transpose(1, 2)[:, :, 0], pos,
                layer.k_bits, hd, layer.block)
    append_side(layer.v_packed, layer.v_scale, v_new.transpose(1, 2)[:, :, 0], pos,
                layer.v_bits, hd, layer.block)
    return _attend_dense(q, layer, kv_valid, out_dtype), layer


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
