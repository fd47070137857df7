"""SigmaQuant's adaptability claim on the PyTorch port, end to end: search ONE
model under different hardware conditions and deploy every searched artifact
through the serving stack.

  1. memory-tight edge deployment: a weight-size budget priced on the
     paper's shift-add accelerator;
  2. latency-tight serving: a latency budget priced on the serving roofline
     (the H100 spec);
  3. KV-budgeted long-context serving: a joint weight-size + ``state_bytes``
     budget; the same two-phase controller also allocates per-layer K/V
     *cache* bitwidths, and the engine serves with the packed decode state.
     With ``--paged`` the state budget prices a paged block pool's ALLOCATED
     blocks instead of the dense ``(slots, max_seq)`` worst case: the
     artifact records the pool geometry the budget bought and the engine
     deploys block tables + on-demand allocation, serving the same requests
     on fewer state bytes.

With ``--speculate`` a 4th condition searches a strictly cheaper *draft*
re-packing of the condition-3 deployment and serves the same requests
self-speculatively: the artifact carries weights + state + pool + draft,
and the engine turns ``speculate=K`` on from it.

Each condition writes a versioned ``PolicyArtifact`` (the JAX package loads
them too); conditions 1-2 deploy through ``launch/serve.py --policy`` (the
CLI path), condition 3 also verifies the engine's packed state against the
artifact.

    PYTHONPATH=src python examples/torch_budget_search_serve.py [--tiny] [--paged] \\
        [--speculate] [--trace OUT.json] [--device cpu]

The twin of ``examples/budget_search_serve.py`` (the same flags and printed
lines).  ``--tiny`` shrinks the pretraining and search budgets for a smoke
run.  Runs on the GPU (the hand-written kernels); ``--device cpu`` runs the
plain versions instead.  Without ``--device`` and without a card it raises.
"""
import argparse
import copy
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.policy import BitPolicy, Budget
from repro_torch.cost import RooflineCostModel, ShiftAddCostModel
from repro_torch.device import resolve_device
from repro_torch.kvcache.env import KVQuantEnv
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.search import (attach_draft, search_draft_policy, search_policy,
                                       state_controller_config)
from repro_torch.models import registry
from repro_torch.quant import apply as qapply
from repro_torch.quant.env import LMQuantEnv
from repro_torch.serve.engine import ServeEngine


def make_env(cost_model, *, pretrain_steps, device, seed=0):
    cfg = get_config("gemma-2b").reduced()
    api = registry.get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    env = LMQuantEnv(params, cfg, ShapeSpec("t", "train", 64, 8), cost_model=cost_model)
    env.pretrain(pretrain_steps)
    return cfg, env


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test budgets")
    ap.add_argument("--paged", action="store_true",
                    help="condition 3 prices + deploys a paged KV block pool instead of "
                         "dense per-slot caches")
    ap.add_argument("--speculate", action="store_true",
                    help="condition 4: search a strictly-cheaper DRAFT policy for the "
                         "condition-3 artifact and serve the same requests "
                         "self-speculatively")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the condition-3 deployment as a Chrome/Perfetto trace: "
                         "open the file at https://ui.perfetto.dev for per-request "
                         "lifecycle lanes + step-phase spans")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dev_argv = ["--device", args.device] if args.device else []
    pretrain = 8 if args.tiny else 40
    iters = 4 if args.tiny else 10
    out_dir = tempfile.mkdtemp(prefix="sigmaquant_artifacts_")
    cc = ControllerConfig(phase1_max_iters=2, phase2_max_iters=iters,
                          phase1_qat_epochs=1, phase2_qat_epochs=1)

    # ---- condition 1: memory-tight edge deployment (shift-add backend) ----
    cfg, env = make_env(ShiftAddCostModel(), pretrain_steps=pretrain, device=device)
    acc_t = -(env.float_loss() + 0.10)
    ref = env.costs(BitPolicy.uniform(env.layer_infos(), 8))
    mem_budget = Budget.of(acc_t, acc_buffer=0.05, buffer=0.08,
                           size_mib=0.62 * ref["size_mib"])
    art_mem, res_mem = search_policy(env, mem_budget, config=cc,
                                     meta={"arch": cfg.name, "condition": "memory-tight"})
    mem_path = os.path.join(out_dir, "policy_memory_tight.json")
    art_mem.save(mem_path)
    print(f"[memory-tight/shift_add] success={res_mem.success} "
          f"mean_bits={art_mem.policy.mean_bits():.2f} "
          f"size={art_mem.report['size_mib']:.3f} MiB "
          f"(budget {mem_budget.items[0].limit:.3f}) -> {mem_path}")

    # ---- condition 2: latency-tight serving (roofline backend) ------------
    cfg, env = make_env(RooflineCostModel(batch=4), pretrain_steps=pretrain, device=device)
    acc_t = -(env.float_loss() + 0.10)
    ref = env.costs(BitPolicy.uniform(env.layer_infos(), 8))
    lat_budget = Budget.of(acc_t, acc_buffer=0.05, buffer=0.08,
                           latency_s=0.72 * ref["latency_s"])
    art_lat, res_lat = search_policy(env, lat_budget, config=cc,
                                     meta={"arch": cfg.name, "condition": "latency-tight"})
    lat_path = os.path.join(out_dir, "policy_latency_tight.json")
    art_lat.save(lat_path)
    print(f"[latency-tight/roofline] success={res_lat.success} "
          f"mean_bits={art_lat.policy.mean_bits():.2f} "
          f"latency={art_lat.report['latency_s']:.3e} s "
          f"(budget {lat_budget.items[0].limit:.3e}) -> {lat_path}")

    # ---- condition 3: KV-budgeted long-context serving ---------------------
    cfg, env = make_env(ShiftAddCostModel(), pretrain_steps=pretrain, device=device)
    acc_t = -(env.float_loss() + 0.10)
    ref = env.costs(BitPolicy.uniform(env.layer_infos(), 8))
    slots, max_seq = 4, 64
    # a copy, as the reference's immutable arrays are: the weight phase's QAT
    # updates env.params in place
    serve_params = registry.get_api(cfg).unstack(copy.deepcopy(env.params), cfg)
    calib = np.random.default_rng(0).integers(1, cfg.vocab_size, (4, 16))
    # --paged: the state budget prices a pool's allocated blocks (half the
    # dense worst case: the paging bet) and the artifact records the pool
    # geometry the budget buys
    allocated = slots * max_seq // 2 if args.paged else None
    kv_env = KVQuantEnv(serve_params, cfg, calib, slots=slots, max_seq=max_seq,
                        cost_model=ShiftAddCostModel(), allocated_tokens=allocated)
    ref_state = kv_env.costs(BitPolicy.uniform(kv_env.layer_infos(), 8))
    joint_budget = Budget.of(acc_t, acc_buffer=0.05, buffer=0.08,
                             size_mib=0.75 * ref["size_mib"])
    state_budget = Budget.of(-0.20, acc_buffer=0.05, buffer=0.08,
                             state_bytes=0.80 * ref_state["state_bytes"])
    art_kv, res_kv = search_policy(
        env, joint_budget, config=cc,
        state_env=kv_env, state_budget=state_budget,
        state_config=state_controller_config(len(kv_env.layer_infos())),
        pool={"block": 16} if args.paged else None,
        meta={"arch": cfg.name, "condition": "kv-budgeted"})
    kv_path = os.path.join(out_dir, "policy_kv_budgeted.json")
    art_kv.save(kv_path)
    sp_bits = sorted(set(art_kv.state_policy.bits.values()))
    print(f"[kv-budgeted/shift_add] success={res_kv.success} "
          f"state_success={art_kv.meta['state_success']} "
          f"state_bytes={art_kv.report['state_bytes']:g} "
          f"(fp32 {art_kv.meta['fp_state_bytes']:g}, "
          f"{art_kv.meta['fp_state_bytes'] / art_kv.report['state_bytes']:.1f}x "
          f"smaller) kv_bits={sp_bits} -> {kv_path}")

    # deploy condition 3 directly: packed weights + packed decode state,
    # verified both ways against the artifact (a pool geometry makes the
    # engine build block tables + on-demand allocation)
    qp = qapply.quantize_for_serve(serve_params, art_kv, cfg)
    if args.trace:
        from repro_torch.obs import trace as obs_trace
        obs_trace.enable()
    eng = ServeEngine(cfg, qp, max_slots=slots, max_seq=max_seq, artifact=art_kv,
                      device=device)
    outs = eng.generate([[5, 6, 7, 8], [1, 2, 9], [4, 4, 4, 4, 4]],
                        max_new_tokens=8)
    print(f"  served {len(outs)} requests on the quantized KV cache; "
          f"state_bits={eng.state_bits}")
    if args.trace:
        doc = obs_trace.get_tracer().save(args.trace)
        obs_trace.disable()
        rep = eng.trace_report()
        print(f"  traced: {len(doc['traceEvents'])} events -> {args.trace}; "
              f"step phases attributed "
              f"{rep['attributed_fraction'] * 100:.1f}% "
              f"(open at https://ui.perfetto.dev)")
    if args.paged:
        dense_eng = ServeEngine(cfg, qp, max_slots=slots, max_seq=max_seq,
                                state_bits=art_kv.state_policy, device=device)
        dense_bytes = dense_eng.state_container_bytes()
        print(f"  [paged] pool {art_kv.pool['num_blocks']} blocks x "
              f"{art_kv.pool['block']} positions; peak allocated "
              f"{eng.allocated_state_bytes()} B vs dense container "
              f"{dense_bytes} B "
              f"({dense_bytes / max(eng.allocated_state_bytes(), 1):.1f}x "
              f"less state memory for the same requests)")

    # ---- condition 4: self-speculative serving ------------------------------
    # the condition-3 artifact grows a searched DRAFT policy, a strictly
    # cheaper re-packing of the same weights whose argmax agrees with the
    # deployment, and the engine turns speculate=K on from it: the same
    # requests, the same (possibly paged, quantized) KV cache, fewer
    # full-policy weight passes per emitted token
    if args.speculate:
        calib = np.random.default_rng(1).integers(1, cfg.vocab_size, (8, 12))
        dres, denv, dep_cost = search_draft_policy(
            env.params, cfg, art_kv.policy, metric="size_mib", calib=calib,
            cost_model=ShiftAddCostModel(), draft_frac=0.8, draft_accept=0.4)
        draft_cost = denv.costs(dres.policy)["size_mib"]
        if not (dres.success and draft_cost < dep_cost):
            # the invariant launch/search.py enforces: a draft rides an
            # artifact only when strictly cheaper than the deployment
            raise SystemExit(
                f"[speculative] draft search failed (success={dres.success}, "
                f"{draft_cost:.3f} vs deployed {dep_cost:.3f} MiB)")
        art_spec = attach_draft(art_kv, dres.policy, 2, slots=slots)
        art_spec.meta.update(draft_success=True,
                             draft_agreement=denv.agreement(dres.policy))
        spec_path = os.path.join(out_dir, "policy_speculative.json")
        art_spec.save(spec_path)
        eng_spec = ServeEngine(cfg, qp, max_slots=slots, max_seq=max_seq,
                               artifact=art_spec, device=device)
        outs = eng_spec.generate([[5, 6, 7, 8], [1, 2, 9], [4, 4, 4, 4, 4]],
                                 max_new_tokens=8)
        st = eng_spec.stats()
        print(f"[speculative] draft mean_bits="
              f"{dres.policy.mean_bits():.2f} (deployed "
              f"{art_kv.policy.mean_bits():.2f}, size "
              f"{draft_cost:.3f} vs {dep_cost:.3f} MiB) "
              f"K={art_spec.draft_k}; served "
              f"{sum(len(o) for o in outs)} tokens in {st['decode_steps']} "
              f"verify steps, accept rate "
              f"{st['spec_accepted'] / max(st['spec_proposed'], 1):.2f} "
              f"-> {spec_path}")

    # ---- deploy conditions 1-2 through the serving CLI --------------------
    for path in (mem_path, lat_path):
        print(f"\n--- launch.serve --policy {os.path.basename(path)} ---")
        serve_mod.main(["--arch", "gemma-2b", "--reduced", "--policy", path,
                        "--requests", "4", "--max-new", "8", *dev_argv])
    return out_dir


if __name__ == "__main__":
    main()
