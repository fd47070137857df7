"""Draft-weight containers for self-speculative decoding (port of ``repro/spec/draft.py``).

The draft model IS the deployed model at lower weight bitwidths: every
quantizable leaf of the serve tree re-packs under a second ``BitPolicy``
(the *draft policy*), while norms and any leaf the policy does not name are
shared by reference, and the draft reads the very KV cache the deployed
policy maintains.

``build_draft_params`` takes the deployed tree in either form:

* packed ``QuantizedTensor`` leaves (the engine's case) dequantize and
  re-pack, bit for bit what the JAX package does;
* float leaves quantize directly, with the embedding transposed to the
  ``(d, V)`` layout ``quant.apply.quantize_for_serve`` gives it.

``materialize="auto"`` keeps the draft containers packed on a CUDA tree,
where the quantized kernels read them, and replaces them with their f32
values on a CPU tree, as the JAX package does off the TPU: the same
values, so the CPU draft computes what the JAX CPU draft computes.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import BitPolicy, PolicyArtifact
from repro_torch.quant.apply import QUANT_KEYS, _serve_name, _walk
from repro_torch.quant.tensor import QuantizedTensor, quantize_tensor


def _resolve_bits(spec, name: str) -> int | None:
    if isinstance(spec, int):
        return spec
    return spec.bits.get(name)


def _tree_device(params) -> torch.device | None:
    for _, leaf in _walk(params):
        t = leaf.packed if isinstance(leaf, QuantizedTensor) else leaf
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def build_draft_params(params: dict, spec, cfg, *, materialize: str | bool = "auto"):
    """Serve-layout tree -> ``(draft tree, draft bits)``.

    ``spec``: an int (uniform draft bits), a ``BitPolicy`` over the weight
    registry, or a ``PolicyArtifact`` (its ``draft_policy``).  ``draft bits``
    maps policy names to the draft bitwidths (the analogue of
    ``quant.apply.packed_policy_bits``).
    """
    del cfg
    if isinstance(spec, PolicyArtifact):
        if spec.draft_policy is None:
            raise ValueError("artifact carries no draft policy")
        spec = spec.draft_policy
    if not isinstance(spec, (int, BitPolicy)):
        raise TypeError(f"cannot resolve draft bits from {type(spec).__name__}")
    if materialize == "auto":
        dev = _tree_device(params)
        materialize = dev is None or dev.type != "cuda"
    draft_bits: dict[str, int] = {}

    def pack(fp, name: str, bits: int, *, embed: bool):
        draft_bits[name] = int(bits)
        qt = quantize_tensor(fp, bits)
        if not materialize:
            return qt
        w = qt.dequantize(torch.float32)
        # a packed embedding lives transposed, (d, V); its float view takes
        # rows, (V, d) (decoder.embed_tokens)
        return w.T if embed else w

    def rec(tree, path):
        if isinstance(tree, dict):
            return {k: rec(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rec(v, path + (str(i),)) for i, v in enumerate(tree)]
        name = _serve_name(path)
        embed = path[-1] == "embed"
        if isinstance(tree, QuantizedTensor):
            bits = _resolve_bits(spec, name)
            if bits is None:
                return tree                      # share the deployed container
            return pack(tree.dequantize(torch.float32), name, bits, embed=embed)
        if path[-1] in QUANT_KEYS and getattr(tree, "ndim", 0) >= 2:
            bits = _resolve_bits(spec, name)
            if bits is None:
                return tree
            fp = tree.to(torch.float32).T if embed else tree
            return pack(fp, name, bits, embed=embed)
        return tree                              # norms: shared by reference

    draft = rec(params, ())
    if not draft_bits:
        raise ValueError("draft policy matched no quantizable leaves "
                         "(wrong layer registry for this tree?)")
    return draft, draft_bits
