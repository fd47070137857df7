"""Glue between bit policies and parameter trees (the serve half of ``repro/quant/apply.py``).

Naming convention: stacked per-layer leaves expand to ``layer{i:03d}.<path>``;
top-level leaves keep their dotted path (``embed``, ``lm_head``).  The
enumeration order is the sorted path order, so policies line up with the
JAX package's.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.policy import BitPolicy, LayerInfo
from repro_torch.quant.tensor import QuantizedTensor, concat_quantized, quantize_tensor

#: leaf names that are quantizable weights
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "in_proj", "out_proj", "embed", "lm_head",
})
#: stacked per-layer subtrees
STACKED_KEYS = ("layers", "enc_layers", "dec_layers")


def _walk(tree: Any, path: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _is_quant_leaf(path: tuple[str, ...], leaf) -> bool:
    if path[-1] not in QUANT_KEYS:
        return False
    return len(getattr(leaf, "shape", ())) >= 2


def _macs_for(path: tuple[str, ...], shape: tuple[int, ...], cfg) -> int:
    """Per-token MACs for the layer (BOPs accounting)."""
    if path[-1] == "embed":
        return shape[-1]
    if len(shape) == 3:  # stacked experts (E, d, f): only top_k of E active
        e, d, f = shape
        return max(getattr(cfg, "top_k", 1), 1) * d * f
    return shape[-2] * shape[-1]


def layer_specs(params: dict, cfg) -> tuple[LayerInfo, ...]:
    """Enumerate quantizable layers from a train-layout (stacked) tree."""
    infos: list[LayerInfo] = []
    for path, leaf in _walk(params):
        if not _is_quant_leaf(path, leaf):
            continue
        if path[0] in STACKED_KEYS:
            per_layer_shape = tuple(leaf.shape[1:])
            prefix = "" if path[0] == "layers" else path[0] + "."
            for i in range(leaf.shape[0]):
                name = f"{prefix}layer{i:03d}." + ".".join(path[1:])
                kind = "expert" if len(per_layer_shape) == 3 else (
                    "embedding" if path[-1] in ("embed", "lm_head") else "dense")
                infos.append(LayerInfo(name, per_layer_shape,
                                       macs=_macs_for(path, per_layer_shape, cfg), kind=kind))
        else:
            kind = "embedding" if path[-1] in ("embed", "lm_head") else "dense"
            infos.append(LayerInfo(".".join(path), tuple(leaf.shape),
                                   macs=_macs_for(path, tuple(leaf.shape), cfg), kind=kind))
    return tuple(sorted(infos, key=lambda l: l.name))


def quantize_for_serve(params: dict, policy: BitPolicy, cfg) -> dict:
    """Unstacked (serve-layout) float params -> packed ``QuantizedTensor`` leaves.

    The embedding is stored in lm_head layout ``(d, V)`` (see
    ``decoder.embed_tokens``).  Leaves are quantized one at a time, so a
    caller that drops its float tree right after keeps one transient.
    """
    def rec(tree, path):
        if isinstance(tree, dict):
            return {k: rec(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rec(v, path + (str(i),)) for i, v in enumerate(tree)]
        name = _serve_name(path)
        if name in policy.bits and path[-1] in QUANT_KEYS and tree.ndim >= 2:
            bits = policy.bits[name]
            return quantize_tensor(tree.T if path[-1] == "embed" else tree, bits)
        return tree

    return rec(params, ())


#: decode-path kernel-launch fusion groups: members -> fused leaf name
FUSE_GROUPS = ((("wq", "wk", "wv"), "wqkv"), (("w_gate", "w_up"), "w_gu"))
#: fused leaves -> their pre-fusion members (equal bitwidth by construction)
FUSED_MEMBERS = {fused: names for names, fused in FUSE_GROUPS}


def fuse_projections(params: dict) -> dict:
    """Concatenate Q/K/V and gate/up packed weights per layer (pack time).

    Fusion applies only where it preserves outputs exactly: every group
    member is a 2-D ``QuantizedTensor`` at the same bitwidth and the same K;
    float weights are left alone.
    """

    def fuse_group(node: dict, names: tuple[str, ...], fused_name: str) -> dict:
        if not all(n in node for n in names):
            return node
        members = [node[n] for n in names]
        if not all(isinstance(w, QuantizedTensor) and w.packed.ndim == 2 for w in members):
            return node
        if len({w.bits for w in members}) != 1 or len({w.k for w in members}) != 1:
            return node
        node = {k: v for k, v in node.items() if k not in names}
        node[fused_name] = concat_quantized(members)
        return node

    def rec(node):
        if isinstance(node, dict):
            node = {k: rec(v) for k, v in node.items()}
            for names, fused_name in FUSE_GROUPS:
                node = fuse_group(node, names, fused_name)
            return node
        if isinstance(node, list):
            return [rec(v) for v in node]
        return node

    return rec(params)


def packed_policy_bits(serve_params: dict) -> dict[str, int]:
    """Policy name -> bits actually packed into a serve-layout tree.

    Fused ``wqkv``/``w_gu`` leaves expand back to their members, so the
    mapping compares against a policy before or after ``fuse_projections``.
    """
    out: dict[str, int] = {}
    for path, leaf in _walk(serve_params):
        if not isinstance(leaf, QuantizedTensor):
            continue
        for m in FUSED_MEMBERS.get(path[-1], (path[-1],)):
            out[_serve_name(path[:-1] + (m,))] = leaf.bits
    return out


def _serve_name(path: tuple[str, ...]) -> str:
    """Serve-layout path (lists of layers) -> policy name."""
    parts = list(path)
    for skey in STACKED_KEYS:
        if parts and parts[0] == skey and len(parts) > 1 and parts[1].isdigit():
            prefix = "" if skey == "layers" else skey + "."
            return f"{prefix}layer{int(parts[1]):03d}." + ".".join(parts[2:])
    return ".".join(parts)
