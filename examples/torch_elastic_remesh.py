"""Elastic-scaling walkthrough on the PyTorch port: lose 4 of 8 ranks
mid-training, re-plan the mesh, restore the checkpoint, and continue, with
no data lost or duplicated.

    PYTHONPATH=src python examples/torch_elastic_remesh.py [--device cpu]

The twin of ``examples/elastic_remesh.py``.  The example starts its own
ranks, as the reference boots its own device count: 8 processes on a
``(data=4, model=2)`` plan take 10 QAT steps of reduced gemma-2b, each data
rank on its slice of the global batch (``data.pipeline.host_batch``), the
gradients averaged over the data group before the update: the step the
reference's batch-sharded program computes.  Rank 0 saves a checkpoint;
then 4 ranks are lost, ``runtime.elastic.replan_after_failure`` re-plans to
``(2, 2)``, and a world of 4 processes restores it and takes 10 more steps
from ``extra["next_step"]``.  The gradient of step 0 is checked against the
single-process full-batch gradient.

The ranks talk over gloo.  With ``--device cpu`` everything stays on the
CPU; by default the model runs on the card, where the 8 ranks share one GPU,
which NCCL cannot serve (it places one rank on a device): gloo all-reduces
the CUDA tensors in place, and the example prints the backend.  A gloo that
cannot take a CUDA tensor raises.  Without ``--device`` and without a card it
raises.
"""
import argparse
import json
import multiprocessing
import pathlib
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch
import torch.distributed as dist

from repro_torch.checkpoint import store as ck
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import TokenTask, batch_on, global_batch, host_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import registry
from repro_torch.quant.qat import make_lm_qat_step
from repro_torch.runtime import elastic
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import value_and_grad

ARCH = "gemma-2b"
SHAPE = ShapeSpec("t", "train", 64, 8)
#: the data-parallel gradient against the full-batch one (f32, reduced model):
#: the same sum in another order
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _model(device: torch.device):
    cfg = get_config(ARCH).reduced()
    api = registry.get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    return cfg, api, params


def _all_reduce_mean(group, n: int):
    """``reduce_grads`` for the train step: the mean over the data ranks of
    the loss and of every gradient (one flat all-reduce)."""

    def reduce(loss, grads):
        flat = torch.cat([loss.reshape(1).float()] + [g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=group)
        flat = flat / n
        out, i = [], 1
        for g in grads:
            out.append(flat[i:i + g.numel()].reshape(g.shape).to(g.dtype))
            i += g.numel()
        return flat[0], out

    return reduce


def _rank_main(rank: int, plan, init: str, device_str: str, work: str, tag: str,
               n_steps: int, resume: bool) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=plan.n_devices)
    try:
        device = torch.device(device_str)
        if device.type == "cuda":
            torch.cuda.set_device(0)
        mesh = make_mesh_for(plan.shape, plan.axes, device_type="cpu")
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        group, n_data = mesh.get_group("data"), plan.shape[0]
        cfg, _, params = _model(device)
        captured = []
        reduce = _all_reduce_mean(group, n_data)

        def reduce_and_keep(loss, grads):
            loss, grads = reduce(loss, grads)
            if not captured:
                captured.append([g.cpu() for g in grads])
            return loss, grads

        step_fn, tcfg = make_lm_qat_step(cfg, reduce_grads=reduce_and_keep)
        opt_state = opt_mod.init(tcfg.optimizer, params)
        ckpt = str(pathlib.Path(work) / "ckpt")
        start = 0
        if resume:
            restored, extra = ck.restore(ckpt, {"params": params, "opt": opt_state})
            params, opt_state, start = restored["params"], restored["opt"], extra["next_step"]
        task = TokenTask(vocab_size=cfg.vocab_size)
        losses = []
        for step in range(start, start + n_steps):
            batch = batch_on(host_batch(task, cfg, SHAPE, step, coord["data"], n_data), device)
            params, opt_state, m = step_fn(params, opt_state, batch, None)
            losses.append(float(m["loss"]))
        if rank == 0:
            ck.save(ckpt, start + n_steps - 1, {"params": params, "opt": opt_state},
                    extra={"next_step": start + n_steps})
            torch.save(captured[0], pathlib.Path(work) / f"grads_{tag}.pt")
            (pathlib.Path(work) / f"result_{tag}.json").write_text(json.dumps({
                "start": start, "losses": losses,
                "backend": dist.get_backend()}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(plan, device: torch.device, work: str, tag: str, n_steps: int, resume: bool,
              timeout: float = 600.0) -> dict:
    """Start ``plan.n_devices`` rank processes, wait for them, and return rank
    0's result; every process is stopped before this returns."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{pathlib.Path(work) / f'store_{tag}'}"
    procs = [ctx.Process(target=_rank_main, args=(r, plan, init, str(device), work, tag,
                                                  n_steps, resume))
             for r in range(plan.n_devices)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks failed (rank, exit code): {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return json.loads((pathlib.Path(work) / f"result_{tag}.json").read_text())


def full_batch_grads(device: torch.device) -> list:
    """Step 0's gradient on the whole global batch in this one process."""
    cfg, api, params = _model(device)
    task = TokenTask(vocab_size=cfg.vocab_size)
    batch = batch_on(global_batch(task, cfg, SHAPE, 0), device)
    _, grads = value_and_grad(lambda p, b: api.loss(p, cfg, b, bits=None), params, batch)
    return [g.cpu() for g in grads]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default; raises without one)")
    ap.add_argument("--steps", type=int, default=10, help="steps before and after the loss")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="repro_elastic_")

    plan = elastic.plan_mesh(8, model=2)          # (data=4, model=2)
    print(f"initial mesh plan: {plan.shape} {plan.axes}")
    first = run_world(plan, device, work, "before", args.steps, resume=False)
    how = "CUDA tensors all-reduced in place" if device.type == "cuda" else "CPU tensors"
    print(f"backend: {first['backend']}, {plan.n_devices} ranks on {device.type} ({how})")
    print(f"step 0-{args.steps - 1} on {plan.shape}: loss={first['losses'][-1]:.4f} "
          f"(losses {', '.join(f'{x:.4f}' for x in first['losses'])})")

    dp = torch.load(pathlib.Path(work) / "grads_before.pt")
    full = full_batch_grads(device)
    diff = max(float((a - b).abs().max()) for a, b in zip(dp, full))
    for a, b in zip(dp, full):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    print(f"data-parallel gradient of step 0 = the full-batch gradient "
          f"(max abs diff {diff:.3e}, rtol {GRAD_RTOL}, atol {GRAD_ATOL})")

    # --- four ranks fail ---
    plan2 = elastic.replan_after_failure(plan, n_failed=4)
    print(f"4 devices lost -> replanned mesh: {plan2.shape} {plan2.axes}")
    second = run_world(plan2, device, work, "after", args.steps, resume=True)
    print(f"step {second['start']}-{second['start'] + args.steps - 1} on {plan2.shape}: "
          f"loss={second['losses'][-1]:.4f} — resumed cleanly at step {second['start']}")
    shutil.rmtree(work, ignore_errors=True)
    return {"plans": [plan.shape, plan2.shape], "first": first, "second": second,
            "grad_max_abs_diff": diff}


if __name__ == "__main__":
    main()
