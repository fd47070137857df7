"""Policy-search command: run the SigmaQuant controller under a hardware
Budget and emit a versioned ``PolicyArtifact`` (port of the weight phase of
``repro/launch/search.py``) — the hand-off ``launch/serve.py --policy`` and
``ServeEngine(artifact=)`` deploy.

    PYTHONPATH=src python -m repro_torch.launch.search --arch gemma-2b \\
        --limit size_mib=1600 --pretrain-steps 8 --phase2-iters 3 --out policy.json

    # on the CPU, at reduced width (the plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.search --arch gemma-2b --reduced \\
        --limit size_mib=0.25 --pretrain-steps 4 --phase2-iters 2 --device cpu \\
        --out policy.json

The model is pretrained in float (bits 32) on the synthetic token task, the
quality target is ``val loss <= float loss + slack``, and the two-phase
controller allocates per-layer weight bits with QAT (through the fake-quant
kernel and its straight-through backward on the card).  ``--device``
defaults to the card and raises without one.  Not ported yet (ROADMAP queue
1): the state phase (``--limit state_bytes``), ``--paged``, ``--draft``,
``--autotune-kernels``, ``--ckpt`` and ``--trace``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.controller import ControllerConfig, SigmaQuantController, SigmaQuantResult
from repro_torch.core.policy import COST_METRICS, Budget, PolicyArtifact
from repro_torch.cost import get_cost_model
from repro_torch.cost.base import NOT_PORTED, available_cost_models
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.obs import search as obs_search
from repro_torch.quant.env import LMQuantEnv


def budget_from_limits(acc_t: float, limits: dict[str, float], *,
                       acc_buffer: float = 0.03, buffer: float = 0.08) -> Budget:
    return Budget.of(acc_t, acc_buffer=acc_buffer, buffer=buffer, **limits)


def search_policy(env: LMQuantEnv, budget: Budget, *, config: ControllerConfig | None = None,
                  log=None, meta: dict | None = None, seed: int | None = None,
                  ) -> tuple[PolicyArtifact, SigmaQuantResult]:
    """Run the two-phase weight search and package the result as a v6
    ``PolicyArtifact`` with its provenance."""
    t0 = time.perf_counter()
    result = SigmaQuantController(env, budget, config, log=log, phase="weight").run()
    report = dict(env.costs(result.policy))
    meta = dict(meta or {}, success=result.success, abandoned=result.abandoned,
                acc=result.acc, mean_bits=result.policy.mean_bits())
    meta["search_wall_s"] = round(time.perf_counter() - t0, 3)
    provenance = obs_search.build_provenance(
        backend=env.cost_model.name, reports={"weight": result.search_report}, seed=seed,
        limits={it.metric: it.limit for it in budget.items},
        config=dataclasses.asdict(config or ControllerConfig()))
    artifact = PolicyArtifact.build(result.policy, backend=env.cost_model.name, report=report,
                                    budget=budget, provenance=provenance, meta=meta)
    return artifact, result


def _parse_limits(pairs: list[str]) -> dict[str, float]:
    limits = {}
    for p in pairs:
        metric, _, value = p.partition("=")
        if metric not in COST_METRICS or not value:
            raise SystemExit(f"--limit wants metric=value with metric in "
                             f"{COST_METRICS}, got {p!r}")
        limits[metric] = float(value)
    return limits


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCH_MODULES), default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--backend", choices=sorted(set(available_cost_models()) | set(NOT_PORTED)),
                    default="shift_add")
    ap.add_argument("--limit", action="append", default=[],
                    help="metric=value upper bound; repeatable (e.g. size_mib=0.5)")
    ap.add_argument("--loss-slack", type=float, default=0.10,
                    help="quality target: val loss <= float loss + slack")
    ap.add_argument("--pretrain-steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--phase2-iters", type=int, default=10)
    ap.add_argument("--out", default="policy_artifact.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; 'cpu' runs the "
                         "plain versions of the kernels)")
    return ap


def run(args: argparse.Namespace, *, log=print
        ) -> tuple[PolicyArtifact, SigmaQuantResult, LMQuantEnv]:
    """The search ``main`` runs: init, pretrain, float loss, controller.
    Returns the artifact, the controller's result and the env (whose params
    are the searched, QAT-trained weights)."""
    if not args.limit:
        raise SystemExit("pass at least one --limit metric=value")
    limits = _parse_limits(args.limit)
    if "state_bytes" in limits:
        raise NotImplementedError("the state phase (--limit state_bytes) is not ported yet "
                                  "(ROADMAP queue 1: kvcache/env.py)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = registry.get_api(cfg)
    cost_model = get_cost_model(args.backend)
    with obs_search.work_span("model_init", arch=cfg.name):
        params = api.init(cfg, torch.Generator(device=device).manual_seed(args.seed),
                          device=device)
    env = LMQuantEnv(params, cfg, ShapeSpec("search", "train", args.seq, args.batch),
                     cost_model=cost_model)
    log(f"pre-training {cfg.name} for {args.pretrain_steps} steps on {device} ...")
    env.pretrain(args.pretrain_steps)
    float_loss = env.float_loss()
    budget = budget_from_limits(-(float_loss + args.loss_slack), limits)
    log(f"float val loss {float_loss:.3f}; budget: "
        + ", ".join(f"{it.metric}<={it.limit:g}" for it in budget.items))
    artifact, result = search_policy(
        env, budget, config=ControllerConfig(phase2_max_iters=args.phase2_iters,
                                             phase1_qat_epochs=1, phase2_qat_epochs=1),
        log=log, meta={"arch": cfg.name, "backend": args.backend, "device": str(device)},
        seed=args.seed)
    return artifact, result, env


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    artifact, result, _ = run(args)
    artifact.save(args.out)
    print(f"policy artifact -> {args.out}  (success={result.success} "
          f"mean_bits={result.policy.mean_bits():.2f} backend={args.backend})")
    for metric, value in artifact.report.items():
        print(f"  {metric:>16} = {value:g}")
    return 0 if result.success else 1


if __name__ == "__main__":
    raise SystemExit(main())
