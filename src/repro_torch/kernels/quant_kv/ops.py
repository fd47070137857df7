"""Public dispatch for the quantized-KV decode ops (``repro/kernels/quant_kv/ops.py``):

  "cuda"   the hand-written Hopper kernels (kernel.py)
  "torch"  the plain PyTorch versions (ref.py)
  "auto"   "cuda" for CUDA tensors, "torch" for CPU tensors

Every op takes the cache container, the dense ``QuantizedKVLayer`` or the
paged ``PagedKVLayer``, and dispatches on its type, so
``models/layers.attention_decode_quant`` is the one call site that needs to
know.  Both paths update the container in place and return it.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import LANES
from repro_torch.kernels import IMPLS, LAUNCHES, PLAIN_CALLS, autotune, resolve_impl  # noqa: F401
from repro_torch.kvcache.cache import QuantizedKVLayer
from repro_torch.kvcache.paged import PagedKVLayer, place_paged_block  # noqa: F401
from .kernel import (quant_kv_append_burst_cuda, quant_kv_append_burst_paged_cuda,
                     quant_kv_attention_cuda, quant_kv_attention_paged_cuda,
                     quant_kv_decode_step_cuda, quant_kv_decode_step_paged_cuda,
                     quant_kv_decode_step_proj_cuda)
from .ref import (quant_kv_append_burst_ref, quant_kv_append_paged_ref, quant_kv_append_ref,
                  quant_kv_attention_paged_ref, quant_kv_attention_ref,
                  quant_kv_decode_step_paged_ref, quant_kv_decode_step_proj_ref,
                  quant_kv_decode_step_ref)


def _container(layer) -> bool:
    """True for a paged layer, False for a dense one; raise on anything else."""
    if isinstance(layer, PagedKVLayer):
        return True
    if isinstance(layer, QuantizedKVLayer):
        return False
    raise TypeError(f"expected a QuantizedKVLayer or PagedKVLayer, got {type(layer).__name__}")


def _mask(kv_valid: torch.Tensor) -> torch.Tensor:
    return torch.where(kv_valid, 0.0, -1e30).to(torch.float32).contiguous()


def _positions(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1).expand(b).contiguous()


def place_block(packed: torch.Tensor, scale: torch.Tensor, blk: torch.Tensor,
                sc: torch.Tensor, pos: torch.Tensor, block: int) -> None:
    """Write requantized ``(B, H, block, ·)`` blocks + ``(B, H, 1, 1)`` scales at
    ``pos`` in place (the CUDA kernel does this itself)."""
    b, h, s, hdp = packed.shape
    bidx = pos.to(device=packed.device, dtype=torch.long) // block
    rows = torch.arange(b, device=packed.device)
    packed.view(b, h, s // block, block, hdp)[rows, :, bidx] = blk
    scale[rows, :, bidx] = sc[:, :, 0]


def quant_kv_attention(q: torch.Tensor, layer, kv_valid: torch.Tensor, *, impl: str = "auto",
                       out_dtype=None) -> torch.Tensor:
    """One decode token per slot attends over the packed (dense or paged) cache.

    ``q`` (B, 1, hq, hd) or (B, hq, hd); ``kv_valid`` (B, S) bool.  Returns
    the output shaped like ``q``.
    """
    paged = _container(layer)
    impl = resolve_impl(impl, q.device)
    lead4 = q.ndim == 4
    q3 = q[:, 0] if lead4 else q
    if impl == "torch":
        ref = quant_kv_attention_paged_ref if paged else quant_kv_attention_ref
        o = ref(q3, layer, kv_valid, out_dtype=out_dtype)
    else:
        b, s, n_kv, hd = layer.shape
        g = q3.shape[1] // n_kv
        args = (q3.reshape(b, n_kv, g, hd).contiguous(), layer.k_packed, layer.k_scale,
                layer.v_packed, layer.v_scale, _mask(kv_valid))
        kw = dict(k_bits=layer.k_bits, v_bits=layer.v_bits, hd=hd, block=layer.block)
        if paged:
            o = quant_kv_attention_paged_cuda(layer.block_table, *args, **kw)
        else:
            o = quant_kv_attention_cuda(*args, **kw)
        o = o.reshape(b, n_kv * g, hd).to(out_dtype or q.dtype)
    return o[:, None] if lead4 else o


def quant_kv_append(layer, pos, k_new: torch.Tensor, v_new: torch.Tensor, *,
                    impl: str = "auto"):
    """Write one decode token's K/V (``(B, 1, H, hd)``) at ``pos``, in place;
    requantizes only the touched block.  Returns the layer.

    A slot whose position lies outside ``[0, S)`` (dense) or whose touched
    table entry is unmapped (paged) is left alone by the kernels; the plain
    versions write nothing there on a dense cache either, and write the
    trash block on a paged one.  On the card this is the burst append of
    one position (:func:`quant_kv_append_burst`, ``acc`` 0)."""
    paged = _container(layer)
    impl = resolve_impl(impl, layer.k_packed.device)
    if impl == "torch":
        ref = quant_kv_append_paged_ref if paged else quant_kv_append_ref
        return ref(layer, pos, k_new, v_new)
    b = k_new.shape[0]
    return quant_kv_append_burst(layer, pos, torch.zeros(b, dtype=torch.int32,
                                                         device=layer.k_packed.device),
                                 k_new, v_new, impl=impl)


def quant_kv_append_burst(layer, start, acc, k_burst: torch.Tensor, v_burst: torch.Tensor, *,
                          impl: str = "auto"):
    """Append burst positions ``start + j`` for j = 0 .. ``acc`` of every
    slot, in order, in place: the speculative commit's replay of the
    accepted positions.  ``k_burst``/``v_burst`` (B, J, H, hd) hold row j
    at index j (positions past J - 1 are not written); ``start`` (B,) ints
    and ``acc`` (B,) accepted draft counts (< 0: the slot writes nothing).

    The same bytes as :func:`quant_kv_append` at position j with the slots
    whose ``acc`` < j masked (position -1 on a dense cache, table row -1 on
    a paged one), for j = 0, 1, ...: "torch" runs exactly that
    (:func:`ref.quant_kv_append_burst_ref`), "cuda" one launch.  Returns
    the layer."""
    paged = _container(layer)
    impl = resolve_impl(impl, layer.k_packed.device)
    if impl == "torch":
        return quant_kv_append_burst_ref(layer, start, acc, k_burst, v_burst)
    b = k_burst.shape[0]
    dev = layer.k_packed.device
    args = (_positions(start, b, dev), _positions(acc, b, dev), k_burst.contiguous(),
            v_burst.to(k_burst.dtype).contiguous(), layer.k_packed, layer.k_scale,
            layer.v_packed, layer.v_scale)
    kw = dict(k_bits=layer.k_bits, v_bits=layer.v_bits, hd=layer.head_dim, block=layer.block)
    if paged:
        quant_kv_append_burst_paged_cuda(args[0], args[1], layer.block_table, *args[2:], **kw)
    else:
        quant_kv_append_burst_cuda(*args, **kw)
    return layer


def quant_kv_decode_step(q: torch.Tensor, layer, pos, k_new, v_new, kv_valid: torch.Tensor, *,
                         impl: str = "auto", out_dtype=None, config: dict | None = None):
    """ONE dispatch per layer per decode step: append + attend.

    Bitwise equal to :func:`quant_kv_append` followed by
    :func:`quant_kv_attention` on each path, for every ``config``.  ``q``
    (B, 1, hq, hd) or (B, hq, hd); ``pos`` (B,) or scalar write positions;
    ``k_new``/``v_new`` (B, 1, H, hd); ``kv_valid`` (B, S) bool (already
    includes ``pos``).  ``config`` is one of
    ``autotune.enumerate_candidates``' knob sets for the resolved impl; None
    consults the installed table (``autotune.set_active_configs``), and with
    no entry for this geometry runs the default.  On "cuda" the one
    candidate is the kernel's own launch, so the config and the table are
    not read.
    Returns ``(o shaped like q, layer)``.
    """
    paged = _container(layer)
    impl = resolve_impl(impl, q.device)
    lead4 = q.ndim == 4
    q3 = q[:, 0] if lead4 else q
    if impl == "torch":
        if config is None:
            _, _, n_kv, hd = layer.shape
            config = autotune.lookup("decode_step_paged" if paged else "decode_step",
                                     layer.k_bits, layer.v_bits, n_kv, hd, layer.block, impl)
        ref = quant_kv_decode_step_paged_ref if paged else quant_kv_decode_step_ref
        o, layer = ref(q3, layer, pos, k_new, v_new, kv_valid, out_dtype=out_dtype or q.dtype,
                       config=config)
    else:
        b, s, n_kv, hd = layer.shape
        g = q3.shape[1] // n_kv
        args = (q3.reshape(b, n_kv, g, hd).contiguous(), k_new[:, 0].to(q.dtype).contiguous(),
                v_new[:, 0].to(q.dtype).contiguous(), layer.k_packed, layer.k_scale,
                layer.v_packed, layer.v_scale, _mask(kv_valid))
        kw = dict(k_bits=layer.k_bits, v_bits=layer.v_bits, hd=hd, block=layer.block)
        pos = _positions(pos, b, q.device)
        if paged:
            o = quant_kv_decode_step_paged_cuda(pos, layer.block_table, *args, **kw)
        else:
            o = quant_kv_decode_step_cuda(pos, *args, **kw)
        o = o.reshape(b, n_kv * g, hd).to(out_dtype or q.dtype)
    return (o[:, None] if lead4 else o), layer


def can_fuse_qkv(layer, d_model: int, w_bits: int, impl: str) -> bool:
    """Geometry gate for pulling the Q/K/V projection into the fused step.

    The CUDA kernel on a dense cache only (a ``PagedKVLayer`` is refused),
    and the projection must be one GEMV pass (``d <= 512``) over whole
    packed bytes, as the JAX package's gate (``"cuda"`` in the place of its
    ``"pallas"``/``"interpret"``; ``"auto"`` resolves by the cache's device).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        impl = resolve_impl(impl, getattr(layer, "k_packed", torch.empty(0)).device)
    return (impl == "cuda" and isinstance(layer, QuantizedKVLayer)
            and d_model <= 512 and d_model % LANES[w_bits] == 0)


def quant_kv_decode_step_proj(x: torch.Tensor, w_packed: torch.Tensor, w_scale: torch.Tensor,
                              cos: torch.Tensor, sin: torch.Tensor, layer, pos,
                              kv_valid: torch.Tensor, *, w_bits: int, n_heads: int,
                              impl: str = "auto", out_dtype=None):
    """The decode step with the skinny-M Q/K/V projection in the same launch.

    ``x`` (B, d) post-norm hidden, one token per slot; ``w_packed``/``w_scale``
    the fused ``wqkv``; ``cos``/``sin`` (B, hd/2) f32 at ``pos``; ``kv_valid``
    (B, S) bool.  "cuda" launches the kernel (callers pass
    :func:`can_fuse_qkv` first), "torch" runs the plain composition, the
    kernel's oracle.  The dense layer is updated in place.  Returns
    ``(o (B, hq, hd), layer)``.
    """
    if _container(layer):
        raise TypeError("the projection-fused step takes a dense QuantizedKVLayer, not a "
                        "PagedKVLayer")
    impl = resolve_impl(impl, x.device)
    if impl == "torch":
        return quant_kv_decode_step_proj_ref(x, w_packed, w_scale, cos, sin, layer, pos,
                                             kv_valid, w_bits=w_bits, n_heads=n_heads,
                                             out_dtype=out_dtype)
    b, s, n_kv, hd = layer.shape
    o = quant_kv_decode_step_proj_cuda(
        _positions(pos, b, x.device), x.contiguous(), w_packed, w_scale.reshape(1, -1),
        cos.to(torch.float32).contiguous(), sin.to(torch.float32).contiguous(),
        layer.k_packed, layer.k_scale, layer.v_packed, layer.v_scale, _mask(kv_valid),
        w_bits=w_bits, k_bits=layer.k_bits, v_bits=layer.v_bits, n_heads=n_heads, hd=hd,
        block=layer.block)
    return o.reshape(b, n_heads, hd).to(out_dtype or x.dtype), layer
