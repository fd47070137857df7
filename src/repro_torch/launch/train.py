"""End-to-end training driver: data pipeline -> QAT train loop ->
checkpoints, with fault tolerance (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --layers 2 --steps 8 --batch 8 --seq 128 --wbits 4 --ckpt build/ckpt

    # on the CPU, at reduced width (the plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \\
        --steps 20 --batch 8 --seq 32 --device cpu --ckpt /tmp/ckpt

``--d-model`` and ``--layers`` cut a configuration down; ``--wbits`` trains
with every quantizable weight fake-quantized at that width (the fake-quant
kernel and its straight-through backward on the card).  The loop's state is
``(params, opt_state)`` as in the JAX package, the optimizer's moments laid
out as the params' tree, so a checkpoint either trainer writes resumes in
the other.  ``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import BitPolicy
from repro_torch.data.pipeline import TokenTask, batch_on, global_batch
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.quant import apply as qapply
from repro_torch.quant.qat import make_lm_qat_step
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.resilience import StragglerMonitor
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainConfig, _rebuild

MOMENTS = ("m", "v")


def opt_state_tree(opt_state: dict, params) -> dict:
    """The optimizer state with its moment lists laid out as ``params``' tree
    (the same tensors), the JAX package's layout."""
    return {k: _rebuild(params, iter(v)) if k in MOMENTS else v for k, v in opt_state.items()}


def opt_state_lists(state: dict) -> dict:
    """The inverse: moments as lists in ``optimizer.leaves`` order."""
    return {k: opt_mod.leaves(v) if k in MOMENTS else v for k, v in state.items()}


def build(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model, d_ff=4 * args.d_model)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = registry.get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(args.seed), device=device)
    n_params = sum(x.numel() for x in opt_mod.leaves(params))
    print(f"arch={cfg.name} reduced={args.reduced} params={n_params/1e6:.1f}M")

    tcfg = TrainConfig(microbatches=args.microbatches,
                       optimizer=opt_mod.OptimizerConfig(lr=args.lr, warmup_steps=50))
    step_fn, _ = make_lm_qat_step(cfg, tcfg)
    opt_state = opt_state_tree(opt_mod.init(tcfg.optimizer, params), params)

    bits = None
    if args.wbits:
        specs = qapply.layer_specs(params, cfg)
        bits = qapply.bits_for_scan(BitPolicy.uniform(specs, args.wbits), params, cfg)

    task = TokenTask(vocab_size=cfg.vocab_size, seed=args.seed)
    shape = ShapeSpec("train", "train", args.seq, args.batch)

    def batch_fn(step):
        return batch_on(global_batch(task, cfg, shape, step), device)

    def loop_step(state, batch):
        params, opt_state = state
        params, flat, metrics = step_fn(params, opt_state_lists(opt_state), batch, bits)
        return (params, dict(opt_state, step=flat["step"])), metrics

    return cfg, task, loop_step, (params, opt_state), batch_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCH_MODULES), default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--wbits", type=int, default=0, help="uniform QAT bitwidth (0=float)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; 'cpu' runs the "
                         "plain versions of the kernels)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")

    cfg, task, loop_step, init_state, batch_fn = build(args)
    store = CheckpointStore(args.ckpt, keep=3)
    loop = TrainLoop(loop_step, init_state, batch_fn, store,
                     LoopConfig(args.steps, save_every=args.save_every),
                     monitor=StragglerMonitor())
    loop.run()
    for h in loop.history[:3] + loop.history[-3:]:
        print({k: round(v, 4) for k, v in h.items()})
    print(f"entropy floor of the task: {task.entropy_floor():.3f} "
          f"(loss should approach this)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
