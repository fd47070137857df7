"""State bitwidth resolution and verification (the serving half of
``repro/kvcache/policy.py``).

The decode state is a quantizable surface like the weights: one
``LayerInfo`` per KV entry and side (``kind="state"``), named
``layer{i:03d}.state.k`` / ``.v`` for the decoder families and
``shared_attn.app{j:03d}.state.k`` / ``.v`` for the hybrid's shared
attention, one entry an application.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.policy import BitPolicy, LayerInfo, PolicyArtifact, layer_registry_hash

from .cache import QuantizedKVLayer
from .paged import PagedKVLayer


#: families whose decode state carries quantizable K/V entries
KV_FAMILIES = ("dense", "moe", "vlm", "hybrid")


def kv_entry_names(cfg) -> list[str]:
    """Ordered names of the KV entries the family's decode state carries."""
    if cfg.family in ("dense", "moe", "vlm"):
        return [f"layer{i:03d}" for i in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_applications
        return [f"shared_attn.app{j:03d}" for j in range(n_attn_applications(cfg))]
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


def state_surface_hash(layers) -> str:
    """Identity of a state registry without its geometry: each entry's shape
    keeps only ``(n_kv, hd)``, since slots and max_seq are deployment choices.
    Two deployments agree iff they expose the same KV entries with the same
    head geometry (``PolicyArtifact.verify_state_layers`` is the strict,
    geometry-inclusive check)."""
    canon = tuple(LayerInfo(l.name, tuple(l.shape[-2:]), 0, l.kind) for l in layers)
    return layer_registry_hash(canon)


def state_bits_by_name(policy: BitPolicy) -> dict[str, tuple[int, int]]:
    """Policy -> entry name -> (k_bits, v_bits)."""
    out: dict[str, tuple[int, int]] = {}
    for l in policy.state_layers():
        nm, _, side = l.name.rpartition(".state.")
        kb, vb = out.get(nm, (0, 0))
        out[nm] = (policy.bits[l.name], vb) if side == "k" else (kb, policy.bits[l.name])
    return out


def resolve_state_bits(spec, cfg) -> list[tuple[int, int]] | None:
    """Engine-facing: None (fp state), an int (uniform), a state ``BitPolicy``
    or a ``PolicyArtifact`` (its state policy) -> per-entry ``(k_bits,
    v_bits)`` in entry order."""
    if spec is None:
        return None
    names = kv_entry_names(cfg)
    if not names:
        raise ValueError(f"family {cfg.family!r} has no quantizable KV state")
    if isinstance(spec, PolicyArtifact):
        spec = spec.state_policy
        if spec is None:
            return None
    if isinstance(spec, int):
        return [(spec, spec)] * len(names)
    if isinstance(spec, BitPolicy):
        by_name = state_bits_by_name(spec)
        missing = [nm for nm in names if nm not in by_name]
        if missing:
            raise ValueError(f"state policy missing KV entries: {missing[:4]}")
        return [by_name[nm] for nm in names]
    raise TypeError(f"cannot resolve state bits from {type(spec).__name__}")


def extract_kv_entries(state) -> list[tuple[str, Any]]:
    """Ordered ``(entry name, node)`` pairs of a decode state's KV entries.

    Works on fp states (a list of ``{"k", "v"}`` dicts) and on quantized
    ones, dense (``QuantizedKVLayer``) or paged (``PagedKVLayer``); the
    hybrid's ``{"mamba", "attn"}`` state gives its attention caches, and SSM
    entries are skipped.
    """
    if isinstance(state, dict) and "attn" in state:                  # hybrid
        return [(f"shared_attn.app{j:03d}", e) for j, e in enumerate(state["attn"])]
    if not isinstance(state, (list, tuple)):
        return []
    return [(f"layer{i:03d}", e) for i, e in enumerate(state)
            if isinstance(e, (QuantizedKVLayer, PagedKVLayer))
            or (isinstance(e, dict) and set(e) == {"k", "v"})]


def packed_state_bits(state) -> dict[str, int]:
    """State-entry name -> bits actually packed into a decoder's decode state."""
    out: dict[str, int] = {}
    for nm, node in extract_kv_entries(state):
        if isinstance(node, (QuantizedKVLayer, PagedKVLayer)):
            out[f"{nm}.state.k"] = node.k_bits
            out[f"{nm}.state.v"] = node.v_bits
    return out


def verify_state_bits(state, artifact: PolicyArtifact, *, surface=None) -> None:
    """Raise unless a decode state carries exactly the artifact's state bits.

    A cache packed at another width fails, and so does a searched entry left
    fp.  With the deployment's ``state_layer_infos`` as ``surface``, an
    artifact searched on another state surface (other KV entries or head
    geometry) fails too, by ``state_surface_hash``.
    """
    packed = packed_state_bits(state)
    if artifact.state_policy is not None and surface is not None:
        want = state_surface_hash(artifact.state_policy.layers)
        got = state_surface_hash(surface)
        if want != got:
            raise ValueError(f"policy artifact state-surface mismatch: artifact was "
                             f"searched on {want}, this deployment exposes {got} "
                             f"(different KV entries or head geometry)")
    if artifact.state_policy is None:
        if packed:
            raise ValueError(f"decode state is quantized ({len(packed)} entries) but the "
                             f"policy artifact carries no state policy")
        return
    want = artifact.state_policy.bits
    wrong = {n: (b, want.get(n)) for n, b in packed.items() if want.get(n) != b}
    if wrong:
        sample = dict(list(wrong.items())[:4])
        raise ValueError(f"decode-state bitwidths disagree with the policy artifact on "
                         f"{len(wrong)} entries (packed, artifact): {sample}")
    missing = sorted(set(want) - set(packed))
    if missing:
        raise ValueError(f"{len(missing)} searched state entries are not quantized in the "
                         f"decode state (fp cache?): {missing[:4]}")
