"""Baseline bit allocators the paper compares against, and one proxy extra
(port of ``repro/core/baselines.py``).

* ``uniform_policy``      — A8W{2,4,6,8} (the paper's main baseline, Figs. 4-5).
* ``bop_greedy_policy``   — the Table-I "Init Bits" style heuristic: greedily
                            lower bits on the layers with the most MACs until
                            a BOPs budget holds (no accuracy feedback).
* ``hawq_proxy_policy``   — a stand-in for HAWQ-style second-order
                            sensitivity: Hutchinson estimates of the per-layer
                            Hessian trace of the loss; bits are allocated by
                            sorting trace * quantization error.

The Rademacher draws come from a ``torch.Generator`` (JAX's have no torch
twin), and the Hessian-vector products from a double backward.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import _rebuild

from .packing import VALID_BITS
from .policy import BitPolicy, LayerInfo


def uniform_policy(layers: Sequence[LayerInfo], w_bits: int, act_bits: int = 8) -> BitPolicy:
    return BitPolicy.uniform(layers, w_bits, act_bits)


def bop_greedy_policy(
    layers: Sequence[LayerInfo],
    bop_budget: float,
    act_bits: int = 8,
) -> BitPolicy:
    """Lower bits on the MAC-heaviest layers first until BOPs <= budget."""
    policy = BitPolicy.uniform(layers, max(VALID_BITS), act_bits)
    order = sorted(layers, key=lambda l: -l.macs)
    for step in range(len(layers) * (len(VALID_BITS) - 1)):
        if policy.bops() <= bop_budget:
            break
        l = order[step % len(order)]
        if policy.bits[l.name] > min(VALID_BITS):
            policy = policy.bumped([l.name], -2)
    return policy


def leaf_paths(tree: Any, path: tuple = ()) -> list[tuple]:
    """Each leaf's path (dict keys, list indices) in the JAX package's
    flattening order (sorted dict keys), the order of ``optimizer.leaves``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, path + (i,))]
    return [path]


def hutchinson_layer_traces(
    loss_fn: Callable,
    params,
    quant_leaves: dict[str, tuple],  # name -> leaf path (dict keys, list indices)
    generator: torch.Generator,
    n_samples: int = 4,
) -> dict[str, float]:
    """Per-layer Hessian-trace estimates via Hutchinson's estimator.

    trace(H_l) ~= E_v [ v^T H_l v ],  v ~ Rademacher, computed with one
    Hessian-vector product per sample over the whole tree, then reduced per
    layer.  ``generator`` lives on the params' device.
    """
    index = {p: i for i, p in enumerate(leaf_paths(params))}
    leaves = opt_mod.leaves(params)
    traces = {name: 0.0 for name in quant_leaves}
    for _ in range(n_samples):
        vs = [torch.where(torch.rand(leaf.shape, generator=generator, device=leaf.device) < 0.5,
                          1.0, -1.0).to(leaf.dtype) for leaf in leaves]
        alias = [leaf.detach().requires_grad_() for leaf in leaves]
        grads = torch.autograd.grad(loss_fn(_rebuild(params, iter(alias))), alias,
                                    create_graph=True, allow_unused=True)
        live = [i for i, g in enumerate(grads) if g is not None and g.requires_grad]
        hvp = torch.autograd.grad([grads[i] for i in live], alias,
                                  grad_outputs=[vs[i] for i in live], allow_unused=True)
        for name, path in quant_leaves.items():
            i = index.get(path)
            if i is not None and hvp[i] is not None:
                traces[name] += float(torch.vdot(vs[i].reshape(-1), hvp[i].reshape(-1))) \
                    / n_samples
    return traces


def hawq_proxy_policy(
    layers: Sequence[LayerInfo],
    traces: dict[str, float],
    size_budget_mib: float,
    act_bits: int = 8,
) -> BitPolicy:
    """Allocate bits by second-order sensitivity under a size budget.

    Start at 8 bits everywhere; repeatedly lower the layer whose marginal
    (trace-weighted quantization-noise increase) / (bytes saved) is smallest,
    until the size budget holds: a greedy knapsack on the HAWQ objective
    trace(H_l) * ||dW_l||^2 with dW^2 ∝ 2^(-2b).
    """
    policy = BitPolicy.uniform(layers, max(VALID_BITS), act_bits)

    def marginal(l: LayerInfo, b_now: int) -> float:
        tr = max(traces.get(l.name, 0.0), 0.0) + 1e-12
        noise_now = 2.0 ** (-2 * b_now)
        noise_next = 2.0 ** (-2 * (b_now - 2))
        d_obj = tr * l.n_params * (noise_next - noise_now)
        d_bytes = l.n_params * 2 / 8.0
        return d_obj / d_bytes

    guard = len(layers) * (len(VALID_BITS) - 1) + 1
    while policy.model_size_mib() > size_budget_mib and guard > 0:
        guard -= 1
        movable = [l for l in layers if policy.bits[l.name] > min(VALID_BITS)]
        if not movable:
            break
        pick = min(movable, key=lambda l: marginal(l, policy.bits[l.name]))
        policy = policy.bumped([pick.name], -2)
    return policy
