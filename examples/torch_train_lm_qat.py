"""End-to-end training example on the PyTorch port: train a ~100M-parameter LM
with mixed-precision QAT, checkpoints and fault tolerance, for a few hundred
steps.

    PYTHONPATH=src python examples/torch_train_lm_qat.py [--steps 200] [--params-m 100] \\
        [--device cpu]

The twin of ``examples/train_lm_qat.py`` (the same flags and printed lines).
The model is a gemma-family decoder scaled to ~100M params; a simulated node
failure is injected mid-run and the loop recovers from the last checkpoint:
the loss curve continues exactly where it left off (stateless data
pipeline).  Runs on the GPU (the fake-quant kernel and its straight-through
backward); ``--device cpu`` runs the plain versions instead.  Without
``--device`` and without a card it raises.
"""
import argparse
import dataclasses
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import BitPolicy
from repro_torch.data.pipeline import TokenTask, batch_on, global_batch
from repro_torch.device import resolve_device
from repro_torch.launch.train import opt_state_lists, opt_state_tree
from repro_torch.models import registry
from repro_torch.quant import apply as qapply
from repro_torch.quant.qat import make_lm_qat_step
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.resilience import FailureInjector
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainConfig


def hundred_m_config(params_m: float = 100.0):
    """gemma-family decoder scaled to ~params_m million parameters."""
    base = get_config("gemma-2b")
    d = 640  # 12L x (attn 0.9M + geglu 4.9M) + 2x 20.5M embeddings ~ 111M
    cfg = dataclasses.replace(base, n_layers=12, d_model=d, n_heads=10, n_kv_heads=1,
                              head_dim=64, d_ff=4 * d, vocab_size=32_000)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--params-m", type=float, default=100.0)
    ap.add_argument("--wbits", type=int, default=8)
    ap.add_argument("--fail-at", type=int, default=120,
                    help="inject a simulated node failure at this step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = hundred_m_config(args.params_m)
    api = registry.get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    n = sum(x.numel() for x in opt_mod.leaves(params))
    print(f"model: {cfg.name}-scaled, {n / 1e6:.1f}M params, QAT W{args.wbits}A8")

    tcfg = TrainConfig(optimizer=opt_mod.OptimizerConfig(lr=6e-4, warmup_steps=40))
    step_fn, _ = make_lm_qat_step(cfg, tcfg)
    opt_state = opt_state_tree(opt_mod.init(tcfg.optimizer, params), params)
    bits = qapply.bits_for_scan(
        BitPolicy.uniform(qapply.layer_specs(params, cfg), args.wbits), params, cfg)

    task = TokenTask(vocab_size=cfg.vocab_size)
    shape = ShapeSpec("train", "train", args.seq, args.batch)

    def loop_step(state, batch):
        p, o = state
        p, flat, m = step_fn(p, opt_state_lists(o), batch, bits)
        return (p, dict(o, step=flat["step"])), m

    ckpt = tempfile.mkdtemp(prefix="repro_torch_100m_")
    loop = TrainLoop(
        loop_step, (params, opt_state),
        lambda s: batch_on(global_batch(task, cfg, shape, s), device),
        CheckpointStore(ckpt, keep=2),
        LoopConfig(args.steps, save_every=50, log_every=20),
        injector=FailureInjector(fail_at=(args.fail_at,)) if args.fail_at else None)
    loop.run()
    print(f"restarts survived: {loop.restarts}")
    for h in loop.history:
        print(f"  step {h['step']:>4}  loss {h['loss']:.4f}  lr {h['lr']:.2e}")
    print(f"task entropy floor: {task.entropy_floor():.3f}")
    return loop


if __name__ == "__main__":
    main()
