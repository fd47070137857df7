"""Public dispatch for the quantized-KV decode step (dense half of
``repro/kernels/quant_kv/ops.py``):

  "cuda"   the hand-written Hopper kernel (kernel.py)
  "torch"  the plain PyTorch version (ref.py)
  "auto"   "cuda" for CUDA tensors, "torch" for CPU tensors

Both paths update the cache container in place and return it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, resolve_impl  # noqa: F401
from repro_torch.kvcache.cache import QuantizedKVLayer
from .kernel import quant_kv_decode_step_cuda
from .ref import quant_kv_decode_step_ref


def place_block(packed: torch.Tensor, scale: torch.Tensor, blk: torch.Tensor,
                sc: torch.Tensor, pos: torch.Tensor, block: int) -> None:
    """Write requantized ``(B, H, block, ·)`` blocks + ``(B, H, 1, 1)`` scales at
    ``pos`` in place (the CUDA kernel does this itself)."""
    b, h, s, hdp = packed.shape
    bidx = pos.to(device=packed.device, dtype=torch.long) // block
    rows = torch.arange(b, device=packed.device)
    packed.view(b, h, s // block, block, hdp)[rows, :, bidx] = blk
    scale[rows, :, bidx] = sc[:, :, 0]


def quant_kv_decode_step(q: torch.Tensor, layer: QuantizedKVLayer, pos, k_new, v_new,
                         kv_valid: torch.Tensor, *, impl: str = "auto", out_dtype=None):
    """ONE dispatch per layer per decode step: append + attend.

    ``q`` (B, 1, hq, hd) or (B, hq, hd); ``pos`` (B,) or scalar write
    positions; ``k_new``/``v_new`` (B, 1, H, hd); ``kv_valid`` (B, S) bool
    (already includes ``pos``).  Returns ``(o shaped like q, layer)``.
    """
    if not isinstance(layer, QuantizedKVLayer):
        raise NotImplementedError("the paged decode step is not ported yet "
                                  "(ROADMAP queue 1, 'Paging')")
    impl = resolve_impl(impl, q.device)
    lead4 = q.ndim == 4
    q3 = q[:, 0] if lead4 else q
    if impl == "torch":
        o, layer = quant_kv_decode_step_ref(q3, layer, pos, k_new, v_new, kv_valid,
                                            out_dtype=out_dtype or q.dtype)
    else:
        b, s, n_kv, hd = layer.shape
        g = q3.shape[1] // n_kv
        pos = torch.as_tensor(pos, device=q.device).to(torch.int32).reshape(-1).expand(b)
        mask = torch.where(kv_valid, 0.0, -1e30).to(torch.float32)
        o = quant_kv_decode_step_cuda(
            pos.contiguous(), q3.reshape(b, n_kv, g, hd).contiguous(),
            k_new[:, 0].to(q.dtype).contiguous(), v_new[:, 0].to(q.dtype).contiguous(),
            layer.k_packed, layer.k_scale, layer.v_packed, layer.v_scale, mask.contiguous(),
            k_bits=layer.k_bits, v_bits=layer.v_bits, hd=hd, block=layer.block)
        o = o.reshape(b, n_kv * g, hd).to(out_dtype or q.dtype)
    return (o[:, None] if lead4 else o), layer
