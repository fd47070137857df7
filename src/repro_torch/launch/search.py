"""Policy-search command: run the SigmaQuant controller under a hardware
Budget and emit a versioned ``PolicyArtifact`` (port of
``repro/launch/search.py``), the hand-off ``launch/serve.py --policy`` and
``ServeEngine(artifact=)`` deploy.

    PYTHONPATH=src python -m repro_torch.launch.search --arch gemma-2b \\
        --limit size_mib=1600 --pretrain-steps 8 --phase2-iters 3 --out policy.json

    # on the CPU, at reduced width (the plain versions of the kernels), with
    # the decode-state phase over a paged pool and the draft phase
    PYTHONPATH=src python -m repro_torch.launch.search --arch gemma-2b --reduced \\
        --limit size_mib=0.25 --limit state_bytes=28000 --paged --draft \\
        --pretrain-steps 4 --phase2-iters 2 --device cpu --out policy.json

The model is pretrained in float (bits 32) on the synthetic token task, the
quality target is ``val loss <= float loss + slack``, and the two-phase
controller allocates per-layer weight bits with QAT (through the fake-quant
kernel and its straight-through backward on the card).

A ``state_bytes`` limit adds the state phase: the same controller allocates
per-entry K/V cache bits, scored by one decode step on the quantized state
against the fp state (``kvcache.env.KVQuantEnv``); ``--paged`` prices the
state as a block pool and records its geometry in the artifact.  ``--draft``
adds the draft phase: a strictly cheaper draft weight policy for
self-speculation, scored by predicted acceptance (``spec.env.DraftQuantEnv``);
the artifact carries it and ``--speculate-k`` only where it is strictly
cheaper than the deployed policy.  ``--backend roofline`` prices each policy's
decode step (``--decode-batch`` sequences) on the H100 roofline.
``--trace OUT.json`` records a Chrome trace of the whole run (one root
``search/main`` window over the controller phases, their iterations and the
env work) and prints the share of the wall time attributed to env work;
``--ckpt DIR`` saves the searched params with the artifact as a checkpoint
step both packages restore.  ``--autotune-kernels`` (with a state phase)
times the fused decode step's bitwise-equal launches for every deployed
``(k_bits, v_bits)`` pair (``kernels/autotune.py``, ``--autotune-repeats``
calls a candidate) and records the winners in the artifact (v5), which the
engine replays.  ``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import store as ck
from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.controller import ControllerConfig, SigmaQuantController, SigmaQuantResult
from repro_torch.core.packing import VALID_BITS
from repro_torch.core.policy import COST_METRICS, Budget, PolicyArtifact
from repro_torch.cost import get_cost_model
from repro_torch.cost.base import available_cost_models
from repro_torch.device import resolve_device
from repro_torch.kvcache import DEFAULT_BLOCK, pool_blocks_for_budget, resolve_state_bits
from repro_torch.models import registry
from repro_torch.obs import search as obs_search
from repro_torch.obs import trace as obs_trace
from repro_torch.quant.env import LMQuantEnv


def budget_from_limits(acc_t: float, limits: dict[str, float], *,
                       acc_buffer: float = 0.03, buffer: float = 0.08) -> Budget:
    return Budget.of(acc_t, acc_buffer=acc_buffer, buffer=buffer, **limits)


def search_policy(env: LMQuantEnv, budget: Budget, *, config: ControllerConfig | None = None,
                  log=None, meta: dict | None = None, state_env=None,
                  state_budget: Budget | None = None,
                  state_config: ControllerConfig | None = None, pool: dict | None = None,
                  seed: int | None = None) -> tuple[PolicyArtifact, SigmaQuantResult]:
    """Run the two-phase search and package the result as a v6 ``PolicyArtifact``
    with its provenance.

    With ``state_env`` and ``state_budget`` (a ``kvcache.env.KVQuantEnv`` and a
    ``state_bytes`` budget) a second controller pass allocates the decode-state
    bits, versioned in the same artifact.  ``pool={"block": n}`` records a
    paged pool whose block count the searched state bits buy within the
    ``state_bytes`` limit (``kvcache.pool_blocks_for_budget``).
    """
    t0 = time.perf_counter()
    result = SigmaQuantController(env, budget, config, log=log, phase="weight").run()
    report = dict(env.costs(result.policy))
    meta = dict(meta or {}, success=result.success, abandoned=result.abandoned,
                acc=result.acc, mean_bits=result.policy.mean_bits())
    reports = {"weight": result.search_report}
    limits = {it.metric: it.limit for it in budget.items}
    state_policy = pool_geom = None
    if state_env is not None:
        if state_budget is None:
            raise ValueError("the state search needs a state_bytes budget")
        sres = SigmaQuantController(state_env, state_budget, state_config or config, log=log,
                                    phase="state").run()
        reports["state"] = sres.search_report
        limits.update({it.metric: it.limit for it in state_budget.items})
        state_policy = sres.policy
        report["state_bytes"] = float(state_env.costs(state_policy)["state_bytes"])
        meta.update(state_success=sres.success, state_acc=sres.acc,
                    state_mean_bits=state_policy.mean_bits(),
                    fp_state_bytes=state_env.fp_state_bytes())
        if pool is not None:
            cfg = state_env.cfg
            block = int(pool["block"])
            limit = next(it.limit for it in state_budget.items if it.metric == "state_bytes")
            pool_geom = {"block": block, "num_blocks": pool_blocks_for_budget(
                resolve_state_bits(state_policy, cfg), cfg.n_kv_heads, cfg.resolved_head_dim,
                block, limit)}
    meta["search_wall_s"] = round(time.perf_counter() - t0, 3)
    provenance = obs_search.build_provenance(
        backend=env.cost_model.name, reports=reports, seed=seed, limits=limits,
        config=dataclasses.asdict(config or ControllerConfig()))
    artifact = PolicyArtifact.build(result.policy, backend=env.cost_model.name, report=report,
                                    budget=budget, state_policy=state_policy, pool=pool_geom,
                                    provenance=provenance, meta=meta)
    return artifact, result


def search_draft_policy(params: dict, cfg, deployed_policy, *, metric: str, calib,
                        cost_model=None, impl: str = "auto", draft_frac: float = 0.6,
                        draft_accept: float = 0.6, config: ControllerConfig | None = None,
                        log=None):
    """Search the self-speculation draft policy of a deployed policy.

    The controller runs again over a ``spec.env.DraftQuantEnv``: quality is
    the predicted-acceptance proxy (``draft_accept`` the least), and the
    budget caps the draft's ``metric`` cost at ``draft_frac`` of the deployed
    policy's.  ``params`` is the train-layout float tree.  Returns
    ``(SigmaQuantResult, DraftQuantEnv, deployed_cost)``.
    """
    from repro_torch.spec.env import DraftQuantEnv

    api = registry.get_api(cfg)
    denv = DraftQuantEnv(params, api.unstack(params, cfg), cfg, deployed_policy, calib,
                         cost_model=cost_model, impl=impl)
    deployed_cost = float(denv.costs(deployed_policy)[metric])
    budget = Budget.of(draft_accept, acc_buffer=0.1, buffer=0.08,
                       **{metric: draft_frac * deployed_cost})
    # the draft's bit ladder lies strictly below the deployed maximum: the
    # controller starts one level under it and refines downward by the env's
    # probe; on the size metrics the result is strictly cheaper by construction
    dep_max = max(deployed_policy.bits.values())
    ladder = tuple(b for b in sorted(VALID_BITS) if b < dep_max) or (min(VALID_BITS),)
    cc = config or dataclasses.replace(state_controller_config(len(denv.layer_infos())),
                                       bit_set=ladder)
    result = SigmaQuantController(denv, budget, cc, log=log, phase="draft").run()
    return result, denv, deployed_cost


def attach_draft(artifact: PolicyArtifact, draft_policy, draft_k: int, *,
                 slots: int | None = None) -> PolicyArtifact:
    """A copy of ``artifact`` carrying a draft policy and K.

    A pooled artifact's pool grows by ``slots * ceil(K / block)`` burst-scratch
    blocks: a speculative burst writes up to K positions past the committed
    one and the engine's admission reserves that headroom, so a pool sized
    for the non-speculative demand alone would push the same traffic into
    backpressure.  The growth is recorded in ``meta``.
    """
    out = dataclasses.replace(artifact, draft_policy=draft_policy, draft_k=int(draft_k),
                              report=dict(artifact.report), meta=dict(artifact.meta))
    if artifact.pool is not None:
        if slots is None:
            raise ValueError("attach_draft on a pooled artifact needs the serving slot count "
                             "(burst-scratch headroom)")
        headroom = slots * -(-int(draft_k) // int(artifact.pool["block"]))
        out.pool = dict(artifact.pool, num_blocks=int(artifact.pool["num_blocks"]) + headroom)
        out.meta["draft_pool_headroom_blocks"] = headroom
    return out


def attach_kernel_configs(artifact: PolicyArtifact, cfg, *, block: int | None = None,
                          impl: str | None = None, repeats: int = 20,
                          device=None) -> PolicyArtifact:
    """Return a copy of ``artifact`` carrying autotuned kernel configs (v5).

    Runs the fused decode-step autotuner (``kernels.autotune``) over every
    distinct ``(k_bits, v_bits)`` pair the artifact's state policy deploys,
    at the geometry serving will use: ``cfg``'s KV heads and head_dim and
    the cache ``block`` (the artifact's pool block when paged, else the
    dense default).  ``impl`` None is what ``"auto"`` resolves to on
    ``device`` (None: the card).  Every candidate is bitwise equivalent, so
    this phase can only change speed, never tokens.
    """
    if artifact.state_policy is None:
        raise ValueError("kernel autotuning needs a state policy (the fused "
                         "decode step only exists for quantized caches)")
    from repro_torch.kernels import autotune

    paged = artifact.pool is not None
    if block is None:
        block = int(artifact.pool["block"]) if paged else DEFAULT_BLOCK
    impl = impl or autotune.resolved_backend_impl(device)
    state_bits = resolve_state_bits(artifact.state_policy, cfg)
    entries = autotune.autotune_state(state_bits, cfg.n_kv_heads, cfg.resolved_head_dim, block,
                                      paged=paged, impl=impl, repeats=repeats)
    out = dataclasses.replace(artifact, kernel_configs=entries, meta=dict(artifact.meta))
    out.meta["kernel_autotune_impl"] = entries[0]["key"]["impl"] if entries else impl
    return out


def state_controller_config(n_entries: int) -> ControllerConfig:
    """Controller budgets of the post-training state (and draft) phases.

    6 bits pack into the 8-bit container, so the first shrink wave (8 -> 6)
    cannot lower ``state_bytes``; patience scales with the entry count so the
    search outlasts that plateau and reaches the 4- and 2-bit moves that pay.
    """
    return ControllerConfig(phase2_max_iters=max(16, 4 * n_entries),
                            stagnation_patience=max(8, n_entries),
                            phase1_qat_epochs=0, phase2_qat_epochs=0)


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
    ap.add_argument("--backend", choices=available_cost_models(), default="shift_add")
    ap.add_argument("--limit", action="append", default=[],
                    help="metric=value upper bound; repeatable (e.g. size_mib=0.5)")
    ap.add_argument("--loss-slack", type=float, default=0.10,
                    help="quality target: val loss <= float loss + slack")
    ap.add_argument("--pretrain-steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--decode-batch", type=int, default=1,
                    help="roofline backend: sequences per decode step")
    ap.add_argument("--phase2-iters", type=int, default=10)
    ap.add_argument("--out", default="policy_artifact.json")
    ap.add_argument("--ckpt", default=None,
                    help="also save the params and the artifact as a checkpoint step here")
    ap.add_argument("--seed", type=int, default=0)
    # the decode-state (KV) phase, run when --limit state_bytes=... is given
    ap.add_argument("--slots", type=int, default=4,
                    help="serving slots the state budget prices (engine max_slots)")
    ap.add_argument("--kv-max-seq", type=int, default=64,
                    help="cache length the state budget prices (engine max_seq)")
    ap.add_argument("--kv-calib", type=int, default=4,
                    help="calibration prompts of the state statistics")
    ap.add_argument("--kv-calib-len", type=int, default=16)
    ap.add_argument("--state-tol", type=float, default=0.15,
                    help="tolerated relative logit error of the quantized state")
    ap.add_argument("--paged", action="store_true",
                    help="price and deploy the state as a paged block pool: the state_bytes "
                         "limit bounds allocated blocks and the artifact records the pool")
    ap.add_argument("--kv-allocated-tokens", type=int, default=None,
                    help="--paged: live KV tokens across slots the budget prices (default "
                         "slots * kv-max-seq, the dense worst case)")
    # the self-speculation draft phase, run with --draft
    ap.add_argument("--draft", action="store_true",
                    help="also search a strictly cheaper draft weight policy for predicted "
                         "acceptance; the artifact records it and K, and the engine "
                         "speculates from it")
    ap.add_argument("--draft-frac", type=float, default=0.6,
                    help="draft budget: fraction of the deployed policy's primary-metric "
                         "cost the draft may spend")
    ap.add_argument("--draft-accept", type=float, default=0.6,
                    help="least predicted first-token acceptance (one-step argmax agreement "
                         "of the draft with the deployed packing)")
    ap.add_argument("--draft-calib", type=int, default=16,
                    help="calibration prompts of the acceptance proxy")
    ap.add_argument("--speculate-k", type=int, default=3,
                    help="--draft: tokens the draft proposes a verify step (in the artifact)")
    ap.add_argument("--autotune-kernels", action="store_true",
                    help="time the bitwise-equivalent fused decode-step launches for every "
                         "deployed (k_bits, v_bits) pair and record the winners in the "
                         "artifact (v5) so serving replays them without re-search")
    ap.add_argument("--autotune-repeats", type=int, default=20,
                    help="--autotune-kernels: timing repetitions per candidate")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome/Perfetto trace of the whole search (controller "
                         "phases, iterations and env work spans) and print the wall-time "
                         "attribution")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; 'cpu' runs the "
                         "plain versions of the kernels)")
    return ap


def _state_phase(args, state_limit: float, cfg, api, env, cost_model, log):
    """The state phase's env, budget and controller config, and the pool request."""
    from repro_torch.kvcache.cache import resolve_block
    from repro_torch.kvcache.env import KVQuantEnv

    # the state phase calibrates on the float weights: the weight phase has
    # not run yet, so weight and state errors are measured apart (the
    # artifact deploys both).  A copy: the weight phase's QAT updates
    # env.params in place, which would move the state env's weights away
    # from its fp reference step
    serve_params = api.unstack(copy.deepcopy(env.params), cfg)
    calib = np.random.default_rng(args.seed).integers(1, cfg.vocab_size,
                                                      (args.kv_calib, args.kv_calib_len))
    allocated = pool_req = None
    if args.paged:
        if cfg.family not in ("dense", "moe", "vlm"):
            raise SystemExit(f"--paged covers the decoder families; {cfg.family!r} state "
                             f"cannot deploy a block pool")
        blk = resolve_block(args.kv_max_seq, DEFAULT_BLOCK)
        allocated = args.kv_allocated_tokens or args.slots * args.kv_max_seq
        allocated = -(-allocated // blk) * blk          # whole blocks
        pool_req = {"block": blk}
    state_env = KVQuantEnv(serve_params, cfg, calib, slots=args.slots, max_seq=args.kv_max_seq,
                           cost_model=cost_model, allocated_tokens=allocated)
    state_budget = Budget.of(-args.state_tol, acc_buffer=0.05, buffer=0.08,
                             state_bytes=state_limit)
    n = len(state_env.layer_infos())
    log(f"state budget: state_bytes<={state_limit:g} (fp32 cache "
        f"{state_env.fp_state_bytes():g} B, {n} KV entries"
        + (f", paged @ {allocated} allocated tokens" if args.paged else "") + ")")
    return state_env, state_budget, state_controller_config(n), pool_req


def _draft_phase(args, cfg, env, artifact, budget, log):
    """The draft phase: search, provenance, and the draft attached only where
    it is strictly cheaper than the deployed policy."""
    metric = budget.primary_metric
    calib = np.random.default_rng(args.seed + 1).integers(1, cfg.vocab_size,
                                                          (args.draft_calib, args.kv_calib_len))
    log(f"draft search: {metric} <= {args.draft_frac:g} x deployed, predicted acceptance >= "
        f"{args.draft_accept:g}")
    dres, denv, dep_cost = search_draft_policy(
        env.params, cfg, artifact.policy, metric=metric, calib=calib,
        cost_model=env.cost_model, draft_frac=args.draft_frac,
        draft_accept=args.draft_accept, log=log)
    draft_cost = float(env.costs(dres.policy)[metric])
    if dres.search_report is not None and artifact.provenance is not None:
        # a new mapping, not a mutation: attach_draft copies the artifact
        # shallowly, which would share the inner "phases" dict
        artifact.provenance = dict(
            artifact.provenance,
            phases=dict(artifact.provenance.get("phases", {}),
                        draft=obs_search.phase_provenance(dres.search_report)))
    if dres.success and draft_cost < dep_cost:
        # the invariant the engine's speculation rests on: a draft rides the
        # artifact only when strictly cheaper under the chosen metric
        artifact = attach_draft(artifact, dres.policy, args.speculate_k, slots=args.slots)
        artifact.report[f"draft_{metric}"] = draft_cost
        artifact.meta.update(draft_success=True, draft_agreement=denv.agreement(dres.policy),
                             draft_divergence=denv.divergence(dres.policy),
                             draft_mean_bits=dres.policy.mean_bits(),
                             draft_k=args.speculate_k)
    else:
        artifact.meta.update(draft_success=False)
        log(f"draft search failed ({metric} {draft_cost:g} vs deployed {dep_cost:g}, "
            f"success={dres.success}); artifact carries no draft policy")
    return artifact, dres, denv


def run(args: argparse.Namespace, *, log=print
        ) -> tuple[PolicyArtifact, SigmaQuantResult, LMQuantEnv, dict]:
    """The search ``main`` runs: init, pretrain, float loss, the weight
    phase, then the state phase (a ``state_bytes`` limit) and the draft phase
    (``--draft``).  Returns the
    artifact, the weight phase's result, the env (whose params are the
    searched, QAT-trained weights) and the later phases' envs and results
    (``"state_env"``, ``"draft_env"``, ``"draft_result"``, where they ran).
    Each phase's wall time and iterations are in
    ``artifact.provenance["phases"]``; ``phases["float_loss"]`` is the
    pretrained float model's validation loss."""
    if not args.limit:
        raise SystemExit("pass at least one --limit metric=value")
    limits = _parse_limits(args.limit)
    state_limit = limits.pop("state_bytes", None)
    if not limits:
        raise SystemExit("pass at least one weight-side --limit (e.g. size_mib=...): "
                         "state_bytes only bounds the decode state")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = registry.get_api(cfg)
    cm_kwargs = {"batch": args.decode_batch} if args.backend == "roofline" else {}
    cost_model = get_cost_model(args.backend, **cm_kwargs)
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
    state_env = state_budget = state_cc = pool_req = None
    phases: dict = {"float_loss": float_loss}
    if state_limit is not None:
        state_env, state_budget, state_cc, pool_req = _state_phase(args, state_limit, cfg, api,
                                                                   env, cost_model, log)
        phases["state_env"] = state_env
    artifact, result = search_policy(
        env, budget, config=ControllerConfig(phase2_max_iters=args.phase2_iters,
                                             phase1_qat_epochs=1, phase2_qat_epochs=1),
        log=log, meta={"arch": cfg.name, "backend": args.backend, "device": str(device)},
        state_env=state_env, state_budget=state_budget, state_config=state_cc, pool=pool_req,
        seed=args.seed)
    if args.draft:
        artifact, phases["draft_result"], phases["draft_env"] = _draft_phase(
            args, cfg, env, artifact, budget, log)
    return artifact, result, env, phases


def _save_trace(path: str, t0: float) -> None:
    """One root window over the whole run (pretraining, calibration prefills,
    every controller phase), so the attribution's denominator is the search's
    full wall time; then save, validate and print the attribution."""
    tracer = obs_trace.get_tracer()
    tracer.complete("search/main", ts=t0, dur=time.perf_counter() - t0,
                    cat=obs_search.PHASE_CAT, track=obs_search.TRACK)
    srep = obs_search.search_trace_report(tracer.events())
    doc = tracer.save(path, process_name="sigmaquant-search")
    obs_trace.validate_chrome_trace(doc)
    print(f"search trace -> {path}  ({len(doc['traceEvents'])} events, "
          f"{srep['attributed_fraction']:.1%} of {srep['total_s']:.2f}s attributed to env work)")


def _autotune_phase(args, artifact: PolicyArtifact, log=print) -> PolicyArtifact:
    """``--autotune-kernels``: the winners of every deployed bit pair's
    candidates ride the artifact."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    log("autotuning fused decode-step kernels ...")
    artifact = attach_kernel_configs(artifact, cfg, repeats=args.autotune_repeats,
                                     device=args.device)
    for e in artifact.kernel_configs:
        k = e["key"]
        log(f"  {k['family']} k{k['k_bits']}/v{k['v_bits']} [{k['impl']}]: {e['config']} "
            f"({e['micros']:g} us, {e['candidates']} candidates)")
    return artifact


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.trace:
        obs_trace.enable()
    t0 = time.perf_counter()
    try:
        artifact, result, env, phases = run(args)
        if args.autotune_kernels:
            if artifact.state_policy is None:
                ap.error("--autotune-kernels needs a state phase (--limit state_bytes=...)")
            artifact = _autotune_phase(args, artifact)
        if args.trace:
            _save_trace(args.trace, t0)
    finally:
        if args.trace:
            obs_trace.disable()
    artifact.save(args.out)
    print(f"policy artifact -> {args.out}  (success={result.success} "
          f"mean_bits={result.policy.mean_bits():.2f} backend={args.backend})")
    if artifact.state_policy is not None:
        print(f"  state policy: mean_bits={artifact.state_policy.mean_bits():.2f} "
              f"state_bytes={artifact.report['state_bytes']:g} "
              f"(success={artifact.meta.get('state_success')})")
    if artifact.pool is not None:
        print(f"  paged pool: {artifact.pool['num_blocks']} blocks x "
              f"{artifact.pool['block']} positions")
    if artifact.draft_policy is not None:
        print(f"  draft policy: mean_bits={artifact.draft_policy.mean_bits():.2f} "
              f"K={artifact.draft_k} "
              f"predicted_acceptance={artifact.meta['draft_agreement']:.3f}")
    for metric, value in artifact.report.items():
        print(f"  {metric:>16} = {value:g}")
    if args.ckpt:
        ck.save(args.ckpt, args.pretrain_steps, env.params,
                extra={"float_loss": phases["float_loss"]}, artifact=artifact)
        print(f"checkpoint (+artifact) -> {args.ckpt}")
    return 0 if result.success else 1


if __name__ == "__main__":
    raise SystemExit(main())
