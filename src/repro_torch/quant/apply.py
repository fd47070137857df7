"""Glue between bit policies and parameter trees (port of ``repro/quant/apply.py``).

* ``layer_specs``        — enumerate quantizable layers (LayerInfo) from params
* ``get_weight``         — fetch one layer's float weight by policy name
* ``bits_for_scan``      — policy -> per-layer bit lists in the stacked layout (QAT)
* ``quantize_for_serve`` — float params -> packed QuantizedTensor leaves

Naming convention: stacked per-layer leaves expand to ``layer{i:03d}.<path>``;
top-level leaves keep their dotted path (``embed``, ``lm_head``).  The
enumeration order is the sorted path order, so policies line up with the
JAX package's.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.policy import BitPolicy, LayerInfo, PolicyArtifact
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


def get_weight(params: dict, name: str):
    """Fetch a (possibly stacked-sliced) weight by policy name."""
    parts = name.split(".")
    tree: Any = params
    if parts[0].startswith("layer") and parts[0][5:].isdigit():
        tree = params["layers"]
        for p in parts[1:]:
            tree = tree[p]
        return tree[int(parts[0][5:])]
    if len(parts) >= 2 and parts[1].startswith("layer") and parts[1][5:].isdigit():
        tree = params[parts[0]]
        for p in parts[2:]:
            tree = tree[p]
        return tree[int(parts[1][5:])]
    for p in parts:
        tree = tree[int(p)] if isinstance(tree, (list, tuple)) else tree[p]
    return tree


def _bits_subtree(policy: BitPolicy, subtree: dict, n_layers: int, prefix: str) -> Any:
    """Mirror a stacked param subtree with per-layer bit lists."""

    def rec(tree, path):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                sub = rec(v, path + (k,))
                if sub is not None:
                    out[k] = sub
            return out or None
        if path[-1] in QUANT_KEYS and len(getattr(tree, "shape", ())) >= 3:
            return [float(policy.bits[f"{prefix}layer{i:03d}." + ".".join(path)])
                    for i in range(n_layers)]
        return None

    return rec(subtree, ())


def bits_for_scan(policy: BitPolicy, params: dict, cfg) -> dict:
    """Policy -> QAT ``bits`` tree: a float for each top-level weight and a
    per-layer list (mirroring the stacked layout) for each stacked one.  The
    JAX package carries (L,) arrays through ``lax.scan``; the port's forward
    loops the layers in Python and reads one float per layer."""
    out: dict[str, Any] = {}
    for key in STACKED_KEYS:
        if key in params:
            prefix = "" if key == "layers" else key + "."
            n_layers = next(leaf for _, leaf in _walk(params[key])).shape[0]
            sub = _bits_subtree(policy, params[key], n_layers, prefix)
            if sub:
                out[key] = sub
    for path, leaf in _walk({k: v for k, v in params.items() if k not in STACKED_KEYS}):
        if _is_quant_leaf(path, leaf):
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = float(policy.bits[".".join(path)])
    return out


def quantize_for_serve(params: dict, policy: BitPolicy | PolicyArtifact, cfg) -> dict:
    """Unstacked (serve-layout) float params -> packed ``QuantizedTensor`` leaves.

    Packs exactly the bitwidths the policy carries; a ``PolicyArtifact``
    packs its weight policy (its registry hash is checked by the callers
    that hold the model's specs: ``launch/serve.py``, ``ServeEngine``).
    The embedding is stored in lm_head layout ``(d, V)`` (see
    ``decoder.embed_tokens``).  Leaves are quantized one at a time, so a
    caller that drops its float tree right after keeps one transient.
    """
    if isinstance(policy, PolicyArtifact):
        policy = policy.policy
    return _serve_tree(params, (), policy)


def _serve_tree(tree, path: tuple[str, ...], policy: BitPolicy):
    if isinstance(tree, dict):
        return {k: _serve_tree(v, path + (k,), policy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_serve_tree(v, path + (str(i),), policy) for i, v in enumerate(tree)]
    return _serve_leaf(tree, path, policy)


def _serve_leaf(leaf, path: tuple[str, ...], policy: BitPolicy):
    """One serve-layout leaf, packed where the policy names it (a stacked
    ``(E, d, f)`` expert leaf packs whole, one scale per channel over E)."""
    name = _serve_name(path)
    if name in policy.bits and path[-1] in QUANT_KEYS and leaf.ndim >= 2:
        return quantize_tensor(leaf.T if path[-1] == "embed" else leaf, policy.bits[name])
    return leaf


def pack_for_serve(params: dict, policy: BitPolicy | PolicyArtifact, cfg) -> dict:
    """Train-layout (stacked) float params -> the packed serve-layout tree,
    consuming ``params``.

    The tree ``quantize_for_serve(unstack_layers(params), policy, cfg)``
    gives, built one stacked leaf at a time: each leaf leaves ``params`` as
    its layers are packed, so the float tree and the packed tree are never
    both whole on the device (deepseek-moe-16b: 33.8 GB of bf16 weights
    against about 10 GB packed).
    """
    del cfg
    if isinstance(policy, PolicyArtifact):
        policy = policy.policy

    def layers_of(tree: dict, path: tuple[str, ...], n: int) -> list[dict]:
        out = [{} for _ in range(n)]
        for k in list(tree):
            leaf = tree.pop(k)
            if isinstance(leaf, dict):
                for o, sub in zip(out, layers_of(leaf, path + (k,), n)):
                    o[k] = sub
            else:
                for i, o in enumerate(out):
                    o[k] = _serve_leaf(leaf[i], (path[0], str(i)) + path[1:] + (k,), policy)
            del leaf
        return out

    out = {}
    for key in list(params):
        tree = params.pop(key)
        if key in STACKED_KEYS:
            n = next(leaf for _, leaf in _walk(tree)).shape[0]
            out[key] = layers_of(tree, (key,), n)
        else:
            out[key] = _serve_tree(tree, (key,), policy)
    return out


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


def verify_packed_bits(serve_params: dict, artifact: PolicyArtifact) -> None:
    """Raise unless a packed tree carries exactly the artifact's bitwidths:
    a layer packed at another width fails, and so does a searched layer that
    was never packed (a float or partly quantized tree)."""
    packed = packed_policy_bits(serve_params)
    wrong = {n: (b, artifact.policy.bits.get(n))
             for n, b in packed.items() if artifact.policy.bits.get(n) != b}
    if wrong:
        sample = dict(list(wrong.items())[:4])
        raise ValueError(f"packed weights disagree with the policy artifact on "
                         f"{len(wrong)} layers (packed, artifact): {sample}")
    missing = sorted(set(artifact.policy.bits) - set(packed))
    if missing:
        raise ValueError(f"{len(missing)} searched layers are not packed in the serve tree "
                         f"(float or partially-quantized params?): {missing[:4]}")


def _serve_name(path: tuple[str, ...]) -> str:
    """Serve-layout path (lists of layers) -> policy name."""
    parts = list(path)
    for skey in STACKED_KEYS:
        if parts and parts[0] == skey and len(parts) > 1 and parts[1].isdigit():
            prefix = "" if skey == "layers" else skey + "."
            return f"{prefix}layer{int(parts[1]):03d}." + ".".join(parts[2:])
    return ".".join(parts)


def sigma_vector(params: dict, specs: tuple[LayerInfo, ...]) -> np.ndarray:
    """Per-layer weight std-devs in spec order (phase-1 clustering features)."""
    from repro_torch.core import stats

    return stats.sigma_vector(get_weight(params, s.name) for s in specs)


def kl_vector(params: dict, specs: tuple[LayerInfo, ...], policy: BitPolicy,
              *, bins: int = 256) -> np.ndarray:
    """Per-layer normalized KL at the policy's bits (phase-2 sensitivity)."""
    from repro_torch.core import stats

    return np.asarray([float(stats.normalized_kl(get_weight(params, s.name),
                                                 policy.bits[s.name], bins=bins))
                       for s in specs])
