"""Quantization-aware training, the LM half (port of ``repro/quant/qat.py``).

The step takes the QAT ``bits`` tree (one float per quantizable weight and
layer, ``quant.apply.bits_for_scan``) as an argument, so every policy the
controller tries runs the same code.  The CNN half waits for
``models/cnn.py`` (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models import registry
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainConfig, make_train_step


def make_lm_qat_step(cfg, tcfg: TrainConfig | None = None):
    """LM train step with the QAT ``bits`` tree as an input; -> (step, tcfg)."""
    tcfg = tcfg or TrainConfig(optimizer=opt_mod.OptimizerConfig(lr=1e-3, warmup_steps=10))
    api = registry.get_api(cfg)

    def loss_fn(params, batch, bits):
        return api.loss(params, cfg, batch, bits=bits)

    return make_train_step(cfg, tcfg, loss_fn), tcfg


def make_lm_eval(cfg):
    api = registry.get_api(cfg)

    @torch.no_grad()
    def val_loss(params, batch, bits):
        return api.loss(params, cfg, batch, bits=bits)

    return val_loss
