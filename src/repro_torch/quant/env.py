"""QuantEnv implementations: the bridge between the SigmaQuant controller
(``core/controller.py``) and real models (port of ``repro/quant/env.py``).

* ``CNNQuantEnv`` — the paper-faithful path: top-1 accuracy on the synthetic
  image task, SGD QAT, conv/fc layers (the paper's ResNet/CIFAR-100 analogue).
* ``LMQuantEnv`` — quality = ``-val_loss`` (the accuracy constraint sign-flips
  into a loss constraint), AdamW QAT over the synthetic token task.

``QuantEnvBase`` holds the one implementation of the sigma/KL sensitivity
vectors (``core/stats.py``) and of resource accounting, which delegates to
an injected ``CostModel``.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import stats
from repro_torch.core.policy import BitPolicy, LayerInfo
from repro_torch.cost import CostModel, ShiftAddCostModel
from repro_torch.data.images import ImageTask
from repro_torch.data.pipeline import TokenTask, batch_on, global_batch
from repro_torch.models import cnn as cnn_mod
from repro_torch.obs import search as obs_search
from repro_torch.train import optimizer as opt_mod
from . import apply as apply_mod
from . import qat as qat_mod


class QuantEnvBase:
    """Shared statistics + CostModel-backed resource accounting.

    Subclasses set ``self._specs`` and implement ``_weight(name)``.
    """

    _specs: tuple[LayerInfo, ...]
    objective: str = "size"
    cost_model: CostModel

    def _weight(self, name: str):
        raise NotImplementedError

    def _span(self, name: str, **args):
        """A search-work span on the process tracer (the no-op when disabled)."""
        return obs_search.work_span(name, **args)

    # -- QuantEnv protocol ---------------------------------------------------
    def layer_infos(self) -> tuple[LayerInfo, ...]:
        return self._specs

    def sigmas(self) -> np.ndarray:
        with self._span("sigmas"), torch.no_grad():
            return stats.sigma_vector(self._weight(s.name) for s in self._specs)

    def sensitivities(self, policy: BitPolicy) -> np.ndarray:
        with self._span("sensitivities"), torch.no_grad():
            return stats.sensitivity_vector(
                (self._weight(s.name) for s in self._specs),
                (policy.bits[s.name] for s in self._specs))

    def costs(self, policy: BitPolicy) -> dict[str, float]:
        """Full cost vector from the injected backend (Budget metric keys),
        plus the legacy "resource" scalar."""
        with self._span("costs"):
            costs = self.cost_model.report(policy).as_costs()
            costs["resource"] = (costs["bops"] if self.objective == "bops"
                                 else costs["size_mib"])
            return costs

    def resource(self, policy: BitPolicy) -> float:
        return self.costs(policy)["resource"]


#: where a CNN env's batches come from: (step, batch size) -> (images, labels)
ImageSource = Callable[[int, int], tuple]


def _on(device, imgs, labels) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(np.array(imgs)).to(device, torch.float32),
            torch.as_tensor(np.array(labels)).to(device, torch.long))


class CNNQuantEnv(QuantEnvBase):
    """QuantEnv over the reduced ResNet and the teacher-labelled image task.

    Params are updated in place.  ``batches`` replaces ``task.batch_at`` and
    ``eval_set`` the task's held-out set (the tests feed both packages the
    JAX draws); what they give is moved to the params' device.
    ``train_steps`` and ``eval_passes`` count the forward passes run (each
    fake-quantizes every conv and the fc once; each train step also runs
    every STE backward once).
    """

    def __init__(self, params: dict, cfg: cnn_mod.CNNConfig, task: ImageTask, *,
                 batch: int = 128, steps_per_epoch: int = 20, objective: str = "size",
                 seed: int = 0, cost_model: CostModel | None = None,
                 batches: ImageSource | None = None, eval_set: tuple | None = None):
        self.params = params
        self.cfg = cfg
        self.task = task
        self.batch = batch
        self.steps_per_epoch = steps_per_epoch
        self.objective = objective
        self.cost_model = cost_model or ShiftAddCostModel()
        self.device = params["stem"].device
        self.batches = batches or task.batch_at
        self._specs = cnn_mod.quant_layer_specs(params, cfg)
        self._step_fn, ocfg = qat_mod.make_cnn_qat_step(cfg)
        self._opt_state = opt_mod.init(ocfg, params)
        self._eval_fn = qat_mod.make_cnn_eval(cfg)
        self._eval_imgs, self._eval_labels = _on(self.device, *(eval_set or task.eval_set(512)))
        self._data_step = seed * 1_000_003  # a disjoint stream per env
        self.train_steps = 0
        self.eval_passes = 0

    def _weight(self, name: str):
        return cnn_mod.get_weight(self.params, name)

    def _eval(self, bits: dict) -> float:
        self.eval_passes += 1
        return float(self._eval_fn(self.params, self._eval_imgs, self._eval_labels, bits))

    def _train(self, bits: dict, steps: int) -> float:
        loss = float("nan")
        for _ in range(steps):
            batch = _on(self.device, *self.batches(self._data_step, self.batch))
            self._data_step += 1
            self.params, self._opt_state, loss = self._step_fn(self.params, self._opt_state,
                                                               batch, bits)
            self.train_steps += 1
        return float(loss)

    def evaluate(self, policy: BitPolicy) -> float:
        with self._span("evaluate"):
            return self._eval(qat_mod.cnn_bits_pytree(policy))

    def calibrate_and_qat(self, policy: BitPolicy, epochs: int) -> None:
        with self._span("qat", epochs=epochs):
            self._train(qat_mod.cnn_bits_pytree(policy), epochs * self.steps_per_epoch)

    # -- extras the table recipes use ----------------------------------------
    def float_accuracy(self) -> float:
        return self._eval({s.name: 32.0 for s in self._specs})

    def pretrain(self, steps: int = 300) -> float:
        """Float pretraining (the paper trains the FP32 baseline first)."""
        with self._span("pretrain", steps=steps):
            return self._train({s.name: 32.0 for s in self._specs}, steps)


#: where an env's batches come from: (task, cfg, shape, step) -> {"tokens", "labels"}
BatchSource = Callable[[TokenTask, Any, Any, int], dict]


class LMQuantEnv(QuantEnvBase):
    """QuantEnv over an LM architecture + the synthetic token task.

    quality = -val_loss; resource priced by the injected CostModel.  Params
    are updated in place.  ``batches`` replaces ``data.pipeline.global_batch``
    (the tests feed both packages the same batches); whatever it returns is
    moved to the params' device.
    ``train_steps`` and ``eval_passes`` count the forward passes run (each
    fake-quantizes every quantizable weight once; each train step also runs
    every STE backward once).
    """

    def __init__(self, params: dict, cfg: Any, shape, task: TokenTask | None = None,
                 *, qat_steps_per_epoch: int = 4, objective: str = "size",
                 cost_model: CostModel | None = None, batches: BatchSource | None = None):
        self.params = params
        self.cfg = cfg
        self.shape = shape
        self.task = task or TokenTask(vocab_size=cfg.vocab_size)
        self.qat_steps_per_epoch = qat_steps_per_epoch
        self.objective = objective
        self.cost_model = cost_model or ShiftAddCostModel()
        self.batches = batches or global_batch
        self.device = params["embed"].device
        self._specs = apply_mod.layer_specs(params, cfg)
        self._step_fn, tcfg = qat_mod.make_lm_qat_step(cfg)
        self._opt_state = opt_mod.init(tcfg.optimizer, params)
        self._eval_fn = qat_mod.make_lm_eval(cfg)
        self._val_batch = self._batch(2**30)
        self._data_step = 0
        self.train_steps = 0
        self.eval_passes = 0

    def _batch(self, step: int) -> dict:
        return batch_on(self.batches(self.task, self.cfg, self.shape, step), self.device)

    def _weight(self, name: str):
        return apply_mod.get_weight(self.params, name)

    def _eval(self, bits) -> float:
        self.eval_passes += 1
        return float(self._eval_fn(self.params, self._val_batch, bits))

    def _train(self, bits, steps: int) -> float:
        loss = float("nan")
        for _ in range(steps):
            batch = self._batch(self._data_step)
            self._data_step += 1
            self.params, self._opt_state, m = self._step_fn(self.params, self._opt_state,
                                                            batch, bits)
            self.train_steps += 1
            loss = m["loss"]
        return float(loss)

    def evaluate(self, policy: BitPolicy) -> float:
        with self._span("evaluate"):
            return -self._eval(apply_mod.bits_for_scan(policy, self.params, self.cfg))

    def calibrate_and_qat(self, policy: BitPolicy, epochs: int) -> None:
        with self._span("qat", epochs=epochs):
            self._train(apply_mod.bits_for_scan(policy, self.params, self.cfg),
                        epochs * self.qat_steps_per_epoch)

    def float_loss(self) -> float:
        with self._span("evaluate"):
            return self._eval(apply_mod.bits_for_scan(BitPolicy.uniform(self._specs, 32),
                                                      self.params, self.cfg))

    def pretrain(self, steps: int) -> float:
        with self._span("pretrain", steps=steps):
            return self._train(apply_mod.bits_for_scan(BitPolicy.uniform(self._specs, 32),
                                                       self.params, self.cfg), steps)
