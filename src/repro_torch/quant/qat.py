"""Quantization-aware training, the controller's Calibrate+QAT inner step
(port of ``repro/quant/qat.py``).

Each step takes the QAT ``bits`` tree (one float per quantizable weight, or
per weight and layer for the LM's stacked layout) as an argument, so every
policy the controller tries runs the same code.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import BitPolicy
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import registry
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainConfig, make_train_step, value_and_grad


# ---------------------------------------------------------------------------
# CNN (the paper-faithful path)
# ---------------------------------------------------------------------------


def cnn_bits_pytree(policy: BitPolicy) -> dict[str, float]:
    return {name: float(b) for name, b in policy.bits.items()}


def make_cnn_qat_step(cfg: cnn_mod.CNNConfig, lr: float = 0.02):
    """SGD-with-momentum QAT step over the synthetic image task; -> (step, ocfg).

    ``step(params, opt_state, (imgs, labels), bits) -> (params, opt_state, loss)``.
    """
    ocfg = opt_mod.OptimizerConfig(name="sgd", lr=lr, warmup_steps=0, decay_steps=10_000,
                                   grad_clip=1.0)

    def loss_fn(params, batch, bits):
        imgs, labels = batch
        logits = cnn_mod.forward(params, imgs, cfg, bits=bits)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return torch.mean(logz - gold)

    def step(params, opt_state, batch, bits):
        loss, grads = value_and_grad(loss_fn, params, batch, bits)
        params, opt_state, _ = opt_mod.apply(ocfg, grads, opt_state, params)
        return params, opt_state, loss

    return step, ocfg


def make_cnn_eval(cfg: cnn_mod.CNNConfig):
    @torch.no_grad()
    def top1(params, imgs, labels, bits):
        logits = cnn_mod.forward(params, imgs, cfg, bits=bits)
        return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))

    return top1


# ---------------------------------------------------------------------------
# LM (the assigned-architecture path)
# ---------------------------------------------------------------------------


def make_lm_qat_step(cfg, tcfg: TrainConfig | None = None, *, reduce_grads=None):
    """LM train step with the QAT ``bits`` tree as an input; -> (step, tcfg).
    ``reduce_grads`` as ``train_step.make_train_step`` takes it."""
    tcfg = tcfg or TrainConfig(optimizer=opt_mod.OptimizerConfig(lr=1e-3, warmup_steps=10))
    api = registry.get_api(cfg)

    def loss_fn(params, batch, bits):
        return api.loss(params, cfg, batch, bits=bits)

    return make_train_step(cfg, tcfg, loss_fn, reduce_grads=reduce_grads), tcfg


def make_lm_eval(cfg):
    api = registry.get_api(cfg)

    @torch.no_grad()
    def val_loss(params, batch, bits):
        return api.loss(params, cfg, batch, bits=bits)

    return val_loss
