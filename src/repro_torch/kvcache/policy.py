"""State bitwidth resolution (the serving half of ``repro/kvcache/policy.py``).

The decode state is a quantizable surface like the weights: one
``LayerInfo`` per KV entry and side (``kind="state"``), named
``layer{i:03d}.state.k`` / ``.v`` for the decoder families.
"""
from __future__ import annotations

from repro_torch.core.policy import BitPolicy, LayerInfo

from .cache import QuantizedKVLayer


def kv_entry_names(cfg) -> list[str]:
    """Ordered names of the KV entries the family's decode state carries."""
    if cfg.family in ("dense", "moe", "vlm"):
        return [f"layer{i:03d}" for i in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        raise NotImplementedError("hybrid KV entries need models/hybrid, not ported yet "
                                  "(ROADMAP queue 1, 'Other model families')")
    return []


def state_layer_infos(cfg, batch: int, seq: int, *,
                      allocated_tokens: int | None = None) -> tuple[LayerInfo, ...]:
    """The quantizable decode-state surface for a serving geometry.

    Shape is the multi-slot cache ``(batch, seq, n_kv, hd)`` (or
    ``(1, allocated_tokens, n_kv, hd)`` for a paged deployment); macs are
    the per-decode-step attention MACs that read the entry.
    """
    hd = cfg.resolved_head_dim
    if allocated_tokens is not None:
        shape = (1, int(allocated_tokens), cfg.n_kv_heads, hd)
    else:
        shape = (batch, seq, cfg.n_kv_heads, hd)
    macs = batch * cfg.n_heads * seq * hd
    infos = [LayerInfo(f"{nm}.state.{side}", shape, macs=macs, kind="state")
             for nm in kv_entry_names(cfg) for side in ("k", "v")]
    return tuple(sorted(infos, key=lambda l: l.name))


def state_bits_by_name(policy: BitPolicy) -> dict[str, tuple[int, int]]:
    """Policy -> entry name -> (k_bits, v_bits)."""
    out: dict[str, tuple[int, int]] = {}
    for l in policy.state_layers():
        nm, _, side = l.name.rpartition(".state.")
        kb, vb = out.get(nm, (0, 0))
        out[nm] = (policy.bits[l.name], vb) if side == "k" else (kb, policy.bits[l.name])
    return out


def resolve_state_bits(spec, cfg) -> list[tuple[int, int]] | None:
    """Engine-facing: None (fp state), an int (uniform) or a state ``BitPolicy``
    -> per-entry ``(k_bits, v_bits)`` in entry order."""
    if spec is None:
        return None
    names = kv_entry_names(cfg)
    if not names:
        raise ValueError(f"family {cfg.family!r} has no quantizable KV state")
    if isinstance(spec, int):
        return [(spec, spec)] * len(names)
    if isinstance(spec, BitPolicy):
        by_name = state_bits_by_name(spec)
        missing = [nm for nm in names if nm not in by_name]
        if missing:
            raise ValueError(f"state policy missing KV entries: {missing[:4]}")
        return [by_name[nm] for nm in names]
    raise TypeError(f"cannot resolve state bits from {type(spec).__name__}")


def packed_state_bits(state) -> dict[str, int]:
    """State-entry name -> bits actually packed into a decoder's decode state."""
    out: dict[str, int] = {}
    if isinstance(state, (list, tuple)):
        for i, node in enumerate(state):
            if isinstance(node, QuantizedKVLayer):
                out[f"layer{i:03d}.state.k"] = node.k_bits
                out[f"layer{i:03d}.state.v"] = node.v_bits
    return out
