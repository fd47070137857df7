"""Plain PyTorch version of the quantized-KV decode step (dense cache).

Mirrors ``quant_kv_decode_step_ref`` (repro/kernels/quant_kv/ref.py:82) in
its default config (``place="select"``, ``attend="substitute"``; every JAX
config is bitwise-equal): requantize exactly the block holding ``pos``
with the new row inserted, then attend over the post-append view, with the
per-block scales folded into the (·, S) scores and probabilities.  The
cache is updated in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import packing
from repro_torch.kernels import PLAIN_CALLS
from repro_torch.kvcache.cache import QuantizedKVLayer, append_side


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


def quant_kv_decode_step_ref(q: torch.Tensor, layer: QuantizedKVLayer, pos, k_new, v_new,
                             kv_valid: torch.Tensor, *, out_dtype=None):
    """Append + attend for one decode token per slot.

    ``q`` (B, hq, hd); ``pos`` (B,) or scalar; ``k_new``/``v_new``
    (B, 1, H, hd); ``kv_valid`` (B, S) bool, already including ``pos``.
    Returns ``(out (B, hq, hd), layer)`` with the layer updated in place.
    """
    PLAIN_CALLS["quant_kv_decode_step"] += 1
    b, s, n_kv, hd = layer.shape
    hq = q.shape[1]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    append_side(layer.k_packed, layer.k_scale, k_new.transpose(1, 2)[:, :, 0], pos,
                layer.k_bits, hd, layer.block)
    append_side(layer.v_packed, layer.v_scale, v_new.transpose(1, 2)[:, :, 0], pos,
                layer.v_bits, hd, layer.block)
    klev = packing.unpack(layer.k_packed, layer.k_bits, hd)
    vlev = packing.unpack(layer.v_packed, layer.v_bits, hd)
    qg = q.to(torch.float32).reshape(b, n_kv, hq // n_kv, hd)
    o = _attention_from_levels(qg, klev, layer.k_scale, vlev, layer.v_scale, kv_valid,
                               block=layer.block, hd=hd)
    return o.reshape(b, hq, hd).to(out_dtype or q.dtype), layer
