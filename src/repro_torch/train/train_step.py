"""The training step: loss + gradients (+ microbatch accumulation) + the
optimizer update (port of ``repro/train/train_step.py``).  QAT rides along
through the ``bits`` tree."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    optimizer: opt_mod.OptimizerConfig = dataclasses.field(
        default_factory=opt_mod.OptimizerConfig)
    moe_aux_weight: float = 0.0


def _rebuild(tree: Any, it) -> Any:
    """``tree`` with its leaves replaced, in ``optimizer.leaves`` order, from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def value_and_grad(loss_fn: Callable, params: Any, *args) -> tuple[torch.Tensor, list]:
    """``loss_fn(params, *args)`` and its gradients, one per leaf of
    ``params`` in ``optimizer.leaves`` order.  The params are differentiated
    through aliases (``detach``), so they themselves never carry autograd state.
    A leaf the loss does not read (the token table under ``embeds`` inputs)
    gets a zero gradient, as ``jax.grad`` gives it."""
    alias = [p.detach().requires_grad_() for p in opt_mod.leaves(params)]
    loss = loss_fn(_rebuild(params, iter(alias)), *args)
    grads = torch.autograd.grad(loss, alias, allow_unused=True)
    return loss.detach(), [torch.zeros_like(a) if g is None else g
                           for a, g in zip(alias, grads)]


def _slice_microbatch(batch: dict, i: int, n: int) -> dict:
    def sl(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]

    return {k: sl(v) for k, v in batch.items()}


def make_train_step(cfg, tcfg: TrainConfig, loss_fn: Callable, *,
                    reduce_grads: Callable | None = None) -> Callable:
    """``loss_fn(params, batch, bits)`` -> scalar.  Returns
    ``step(params, opt_state, batch, bits=None) -> (params, opt_state, metrics)``.

    ``reduce_grads(loss, grads) -> (loss, grads)`` runs between the gradients
    and the update: a data-parallel step averages them over the data ranks
    there (what the reference's batch-sharded step computes in one program).
    """

    def compute_grads(params, batch, bits):
        if tcfg.microbatches <= 1:
            return value_and_grad(loss_fn, params, batch, bits)
        loss_sum = None
        grad_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in opt_mod.leaves(params)]
        for i in range(tcfg.microbatches):
            loss, grads = value_and_grad(loss_fn, params,
                                         _slice_microbatch(batch, i, tcfg.microbatches), bits)
            grad_sum = [a + g for a, g in zip(grad_sum, grads)]
            loss_sum = loss if loss_sum is None else loss_sum + loss
        scale = 1.0 / tcfg.microbatches
        return loss_sum * scale, [g * scale for g in grad_sum]

    def step(params, opt_state, batch, bits=None):
        loss, grads = compute_grads(params, batch, bits)
        if reduce_grads is not None:
            loss, grads = reduce_grads(loss, grads)
        params, opt_state, metrics = opt_mod.apply(tcfg.optimizer, grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return step
