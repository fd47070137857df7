"""Optimizers: AdamW and momentum SGD (port of ``repro/train/optimizer.py``).

Written out rather than taken from ``torch.optim``, which places the bias
correction, eps and the decay differently: every step here is the JAX
package's, operation for operation, in f32 over params of any dtype, with
moments in ``state_dtype``.  Weight decay applies to leaves with ``ndim >= 2``
of the tree as given, so the stacked ``(L, d)`` norm scales of the train
layout are decayed, as in the JAX package.  The port updates params and
moments in place (the JAX package returns new trees); ``apply`` returns the
same objects.  The learning-rate schedule runs on the host in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch



@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | sgd
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9        # sgd
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    decay_steps: int = 10_000


def leaves(tree: Any) -> list:
    """Tensor leaves in the JAX package's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def lr_schedule(cfg: OptimizerConfig, step: int) -> np.float32:
    """Linear warmup + cosine decay, in f32."""
    f = np.float32
    s = f(step)
    warm = min(f(1.0), (s + f(1)) / f(max(cfg.warmup_steps, 1)))
    prog = np.clip((s - f(cfg.warmup_steps)) / f(max(cfg.decay_steps, 1)), f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return f(cfg.lr) * warm * (f(0.1) + f(0.9) * cos)


def init(cfg: OptimizerConfig, params: Any) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    zeros = [torch.zeros(p.shape, dtype=dt, device=p.device) for p in leaves(params)]
    if cfg.name == "adamw":
        return {"step": 0, "m": zeros,
                "v": [torch.zeros_like(z) for z in zeros]}
    if cfg.name == "sgd":
        return {"step": 0, "m": zeros}
    raise ValueError(cfg.name)


def global_norm(grads: list) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads))


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar on ``like``'s device (a tensor operand divides exactly)."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def apply(cfg: OptimizerConfig, grads: list, state: dict, params: Any) -> tuple[Any, dict, dict]:
    """One update; ``grads`` in ``leaves(params)`` order -> (params, state, metrics)."""
    ps = leaves(params)
    if len(grads) != len(ps):
        raise ValueError(f"{len(grads)} gradients for {len(ps)} params")
    gnorm = global_norm(grads)
    clip = (torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
            if cfg.grad_clip else torch.ones_like(gnorm))
    step = state["step"]
    lr = lr_schedule(cfg, step)
    sdt = getattr(torch, cfg.state_dtype)
    if cfg.name == "adamw":
        t = np.float32(step + 1)
        bc1 = np.float32(1) - np.float32(cfg.beta1) ** t
        bc2 = np.float32(1) - np.float32(cfg.beta2) ** t
        for p, g, m, v in zip(ps, grads, state["m"], state["v"]):
            g32 = g.to(torch.float32) * clip
            m32 = cfg.beta1 * m.to(torch.float32) + (1 - cfg.beta1) * g32
            v32 = cfg.beta2 * v.to(torch.float32) + (1 - cfg.beta2) * g32 * g32
            u = (m32 / _scalar(bc1, p)) / (torch.sqrt(v32 / _scalar(bc2, p)) + cfg.eps)
            p32 = p.to(torch.float32)
            u = u + (cfg.weight_decay * p32 if p.ndim >= 2 else 0.0)
            p.copy_(p32 - _scalar(lr, p) * u)
            m.copy_(m32.to(sdt))
            v.copy_(v32.to(sdt))
    else:  # sgd + momentum
        for p, g, m in zip(ps, grads, state["m"]):
            g32 = g.to(torch.float32) * clip
            m32 = cfg.momentum * m.to(torch.float32) + g32
            p.copy_(p.to(torch.float32) - _scalar(lr, p) * m32)
            m.copy_(m32.to(sdt))
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": float(lr)}


def state_specs(opt_state: dict, param_specs: Any) -> dict:
    """Optimizer-state PartitionSpecs mirror the param specs: the moments,
    which the port keeps as lists in ``leaves`` order, take the param specs
    in that order, and the step count is replicated."""
    from repro_torch.dist.sharding import PartitionSpec as P, spec_leaves

    out: dict = {"step": P()}
    for k in ("m", "v"):
        if k in opt_state:
            out[k] = spec_leaves(param_specs)
    return out
