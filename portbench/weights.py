"""Random weights from the run's seed, one leaf at a time.

Every leaf, and every layer of a leaf stacked over layers, draws from a
generator of its own, seeded from ``(seed, leaf path, layer)``.  The harness
fills the program's parameter tree this way, and the plain references under
``reference/`` make any one layer again on their own, without a float copy
of the model.  The distributions follow the port's initializers: matrices
``(in, out)`` (expert stacks ``(E, in, out)``, the router) are normal with
standard deviation ``1/sqrt(in)``, the embedding 0.02, the SSM's short conv
0.2; norm scales and ``D`` are ones, biases zeros, ``A_log`` is
``log(linspace(1, 16, heads))``.

The rules cover every leaf name of the port's model families, so that a
configuration added later needs no change here.  Imports nothing of the
program.
"""
from __future__ import annotations

import hashlib
import math

import torch

ONES = frozenset({"ln1", "ln2", "ln", "final_norm", "gate_norm", "q_norm", "k_norm", "D",
                  "scale"})
ZEROS = frozenset({"conv_b", "dt_bias", "bias"})
STD = {"embed": 0.02, "conv_w": 0.2}


def leaf_seed(seed: int, path: str, layer: int) -> int:
    """A 63-bit generator seed for one layer of one leaf (``layer`` -1: unstacked)."""
    digest = hashlib.sha256(f"{int(seed)}/{path}/{int(layer)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def make_leaf(seed: int, path: str, layer: int, shape, dtype, device) -> torch.Tensor:
    """One leaf (one layer of it, for a stacked leaf) as the program holds it."""
    name = path.rsplit(".", 1)[-1]
    shape = tuple(shape)
    if name in ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "A_log":
        heads = torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32, device=device)
        return torch.log(heads).expand(shape).to(dtype).clone()
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, path, layer))
    std = STD.get(name, 1.0 / math.sqrt(shape[-2]) if len(shape) >= 2 else 1.0)
    w = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def fill(skeleton: dict, seed: int, device) -> dict:
    """The program's train-layout tree with every leaf made from the seed.

    ``skeleton`` is the tree on the ``meta`` device (shapes and dtypes only);
    leaves under ``layers`` carry a leading layer axis and are made a layer
    at a time."""

    def walk(node, path: tuple[str, ...], is_stacked: bool):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,), is_stacked or (not path and k == "layers"))
                    for k, v in node.items()}
        name = ".".join(path)
        if not is_stacked:
            return make_leaf(seed, name, -1, node.shape, node.dtype, device)
        out = torch.empty(tuple(node.shape), dtype=node.dtype, device=device)
        for i in range(node.shape[0]):
            out[i] = make_leaf(seed, name, i, node.shape[1:], node.dtype, device)
        return out

    return walk(skeleton, (), False)
