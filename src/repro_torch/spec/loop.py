"""Speculative accept/reject and the quantized-cache burst rewind (port of
``repro/spec/loop.py``).

**Acceptance.**  ``accept_tokens`` turns a verify pass's logits and the
draft's proposals into per-slot accepted counts and the emitted tokens.
Greedy accepts the longest prefix where the draft token equals the verify
argmax and emits the verify argmaxes, so the stream is the non-speculative
one.  Stochastic mode is distribution-preserving speculative sampling over
the *filtered* distributions ``serve.sampling`` draws from: draft token
``d_j`` is accepted with probability ``min(1, p(d_j) / q(d_j))`` and the
first rejection resamples from ``max(p - q, 0)``; q padded with zeros at
burst index K makes the all-accepted bonus a sample from p_K.  The draws
come from a ``torch.Generator`` and cannot repeat ``jax.random``'s bits,
only its distribution.

**Rewind.**  Every append requantizes its whole sequence block under a
fresh scale, so a burst's rejected tail perturbs the accepted positions'
levels.  The commit therefore brackets the burst:

  1. ``snapshot_state`` saves the blocks each slot's burst can touch;
  2. the draft appends freely and ``restore_state`` rewinds before the
     verify pass;
  3. the verify pass appends the whole burst, and ``commit_state`` restores
     the snapshot again and replays only the accepted appends from the
     verify's fp K/V: the append sequence the non-speculative engine runs,
     so the cache bytes are the same.

fp caches skip all three: a positional write touches nothing else.

Where the JAX package returns new containers, these write the caches in
place and return them.  A dense masked replay row keeps its bytes through
a position of -1, which the append skips on either path: the bytes the JAX
package's append-then-select leaves.  A paged masked slot reads
table entry -1: the CUDA append writes nothing there, the plain append
writes the trash block (block 0, whose bytes are no part of the contract).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.quant_kv.ops import quant_kv_append
from repro_torch.kvcache.cache import QuantizedKVLayer
from repro_torch.kvcache.paged import TRASH_BLOCK, PagedKVLayer
from repro_torch.serve.sampling import filtered_logits

_SIDES = ("k_packed", "k_scale", "v_packed", "v_scale")


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------


def accept_tokens(verify_logits: torch.Tensor, draft_tokens: torch.Tensor,
                  draft_logits: torch.Tensor | None, generator: torch.Generator | None = None,
                  *, temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0):
    """``verify_logits`` (B, K+1, V), ``draft_tokens`` (B, K), ``draft_logits``
    (B, K, V) -> ``(acc (B,) int32 in [0, K], out_tokens (B, K+1) int32)``.

    ``out_tokens[:, : acc + 1]`` are the step's emitted tokens: the accepted
    draft prefix plus one bonus token from the verify distribution (greedy:
    the verify argmaxes).
    """
    k = draft_tokens.shape[1]
    if temperature <= 0.0:
        v_toks = torch.argmax(verify_logits, dim=-1).to(torch.int32)
        match = (v_toks[:, :k] == draft_tokens).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        return acc, v_toks
    if generator is None:
        raise ValueError("stochastic acceptance needs a torch.Generator")
    filt = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    p = torch.softmax(filtered_logits(verify_logits[:, :k], **filt), dim=-1)
    q = torch.softmax(filtered_logits(draft_logits, **filt), dim=-1)
    d = draft_tokens.to(torch.long)[..., None]
    p_d = torch.take_along_dim(p, d, dim=-1)[..., 0]                 # (B, K)
    q_d = torch.take_along_dim(q, d, dim=-1)[..., 0]
    u = torch.rand(p_d.shape, generator=generator, device=p_d.device)
    ok = (u * q_d <= p_d).to(torch.int32)       # accept w.p. min(1, p/q); q_d > 0
    acc = torch.cumprod(ok, dim=1).sum(dim=1)                         # (B,)
    # bonus at burst index acc: the residual max(p - q, 0) after a rejection,
    # p_K after a fully accepted burst (q padded with zeros there)
    p_k = torch.softmax(filtered_logits(verify_logits[:, k:], **filt), dim=-1)
    p_full = torch.cat([p, p_k], dim=1)                               # (B, K+1, V)
    q_pad = torch.cat([q, torch.zeros_like(p_k)], dim=1)
    idx = acc.to(torch.long)[:, None, None]
    p_at = torch.take_along_dim(p_full, idx, dim=1)[:, 0]            # (B, V)
    q_at = torch.take_along_dim(q_pad, idx, dim=1)[:, 0]
    resid = torch.clamp_min(p_at - q_at, 0.0)
    resid = resid / torch.clamp_min(resid.sum(dim=-1, keepdim=True), 1e-20)
    bonus = torch.multinomial(torch.clamp_min(resid, 1e-38), 1, generator=generator)[:, 0]
    draft_pad = torch.cat([draft_tokens.to(torch.int32),
                           torch.zeros_like(draft_tokens[:, :1], dtype=torch.int32)], dim=1)
    burst = torch.arange(k + 1, device=acc.device)[None, :]
    out = torch.where(burst < acc[:, None], draft_pad, bonus.to(torch.int32)[:, None])
    return acc.to(torch.int32), out


# ---------------------------------------------------------------------------
# quantized-cache burst snapshot / restore / commit
# ---------------------------------------------------------------------------


def _span_blocks(k: int, block: int, nb: int) -> int:
    """Blocks a K+1-position burst can touch, a partial start block included."""
    return min((k + block - 1) // block + 1, nb)


def _start_block(pos: torch.Tensor, k: int, block: int, nb: int) -> torch.Tensor:
    """First snapshot block per slot, clamped so the span stays in range."""
    nt = _span_blocks(k, block, nb)
    return torch.clamp_max(pos.to(torch.long) // block, nb - nt)


def _span(layer, pos: torch.Tensor, k: int) -> torch.Tensor:
    """(B, nt) logical blocks of each slot's burst span."""
    nb = layer.seq // layer.block
    nt = _span_blocks(k, layer.block, nb)
    start = _start_block(pos, k, layer.block, nb)
    return start[:, None] + torch.arange(nt, device=start.device)[None, :]


def _block_views(layer: QuantizedKVLayer) -> list[torch.Tensor]:
    """The dense buffers with the sequence axis split into blocks: packed
    (B, H, nb, block, hdp) and scales (B, H, nb, 1), views that write through."""
    b, h = layer.k_packed.shape[:2]
    nb = layer.seq // layer.block
    out = []
    for name in _SIDES:
        buf = getattr(layer, name)
        out.append(buf.view(b, h, nb, layer.block, buf.shape[-1]) if name.endswith("packed")
                   else buf)
    return out


def _snapshot_dense(layer: QuantizedKVLayer, pos: torch.Tensor, k: int) -> dict:
    span = _span(layer, pos, k)
    rows = torch.arange(span.shape[0], device=span.device)[:, None]
    # advanced indices on axes 0 and 2: (B, nt, H, ...) copies
    return {name: view[rows, :, span] for name, view in zip(_SIDES, _block_views(layer))}


def _restore_dense(layer: QuantizedKVLayer, saved: dict, pos: torch.Tensor, k: int) -> None:
    span = _span(layer, pos, k)
    rows = torch.arange(span.shape[0], device=span.device)[:, None]
    for name, view in zip(_SIDES, _block_views(layer)):
        view[rows, :, span] = saved[name]


def _snapshot_paged(layer: PagedKVLayer, pos: torch.Tensor, k: int) -> dict:
    span = _span(layer, pos, k)
    phys = torch.take_along_dim(layer.block_table.to(torch.long), span, dim=1)
    phys = phys.clamp_min(TRASH_BLOCK).reshape(-1)          # unmapped -> trash
    return {"phys": phys, **{name: getattr(layer, name)[phys] for name in _SIDES}}


def _restore_paged(layer: PagedKVLayer, saved: dict) -> None:
    # duplicate ids (unmapped entries clamped to the trash block, or a block
    # two slots map) scatter identical snapshot content
    for name in _SIDES:
        getattr(layer, name)[saved["phys"]] = saved[name]


def snapshot_state(state, pos: torch.Tensor, k: int) -> list:
    """Per layer, a copy of the blocks a K+1 burst from ``pos`` can touch (fp: None)."""
    out = []
    for layer in state:
        if isinstance(layer, QuantizedKVLayer):
            out.append(_snapshot_dense(layer, pos, k))
        elif isinstance(layer, PagedKVLayer):
            out.append(_snapshot_paged(layer, pos, k))
        else:
            out.append(None)
    return out


def restore_state(state, saved, pos: torch.Tensor, k: int):
    """Write a burst snapshot back, in place: the cache as if the burst never ran."""
    for layer, sv in zip(state, saved):
        if isinstance(layer, QuantizedKVLayer):
            _restore_dense(layer, sv, pos, k)
        elif isinstance(layer, PagedKVLayer):
            _restore_paged(layer, sv)
    return state


def _masked_append(layer, pos_j: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                   mask: torch.Tensor, impl: str):
    """Append one burst position's K/V where ``mask`` (B,) holds, in place."""
    if isinstance(layer, PagedKVLayer):
        table = torch.where(mask[:, None], layer.block_table, -1)
        quant_kv_append(dataclasses.replace(layer, block_table=table), pos_j, k_new, v_new,
                        impl=impl)
        return layer
    # a dense append writes nothing at a position outside [0, S)
    return quant_kv_append(layer, torch.where(mask, pos_j, -1), k_new, v_new, impl=impl)


def commit_state(state, saved, pos: torch.Tensor, acc: torch.Tensor, burst_kv, k: int, *,
                 impl: str = "auto"):
    """Rewind the burst and replay exactly the accepted appends, in place.

    ``burst_kv``: the verify pass's per-layer fp K/V ``[(k, v), ...]``, each
    (B, K+1, H, hd); ``acc``: per-slot accepted draft counts.  Burst indices
    ``0..acc`` replay (index 0 is the committed pending token).
    """
    restore_state(state, saved, pos, k)
    pos = pos.to(torch.int32)
    for j in range(k + 1):
        mask = j <= acc
        for layer, sv, (k_new, v_new) in zip(state, saved, burst_kv):
            if sv is None:          # fp layer: the verify's writes stand
                continue
            _masked_append(layer, pos + j, k_new[:, j:j + 1], v_new[:, j:j + 1], mask, impl)
    return state
