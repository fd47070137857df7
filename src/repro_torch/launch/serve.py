"""Serving command line of the port (``repro/launch/serve.py``): pack random weights
under a bit policy and run batched requests through ``ServeEngine``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --requests 8 --wbits mixed --device cpu

    # chunked prefill: prompts prefill in C-token pieces interleaved with
    # decode turns under a per-step token budget (same tokens)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --requests 8 --wbits mixed --prefill-chunk 4 --token-budget 12 --device cpu

    # deploy a PolicyArtifact: pack exactly its per-layer bitwidths (refusing
    # a foreign layer registry), build its quantized or paged cache, and
    # speculate with its draft policy when it carries one
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --policy policy_artifact.json --device cpu

    # record a Chrome/Perfetto trace of the run and print the step phases
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --requests 4 --trace out.json --device cpu

Weights come from a ``torch.Generator`` seeded with ``--seed``, so they are
not the JAX command's; the requests are (numpy, same seed).  Without
``--device`` the engine serves on the GPU and raises where there is none.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.core.policy import BitPolicy, PolicyArtifact
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import registry
from repro_torch.obs import trace as obs_trace
from repro_torch.quant import apply as qapply
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCH_MODULES), default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--wbits", default="float",
                    help="float | 2/4/6/8 | mixed | path/to/policy.json")
    ap.add_argument("--policy", default=None, metavar="ARTIFACT",
                    help="PolicyArtifact JSON; overrides --wbits")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="C",
                    help="chunked-prefill continuous batching: prefill prompts in C-token "
                         "pieces interleaved with decode turns")
    ap.add_argument("--token-budget", type=int, default=None, metavar="N",
                    help="per-step token budget shared by decode slots and prefill chunks "
                         "(default: slots + prefill-chunk); requires --prefill-chunk")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome/Perfetto trace of the whole serve run (open at "
                         "https://ui.perfetto.dev) and print the per-phase step decomposition")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.trace:
        obs_trace.enable()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = registry.get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(args.seed), device=device)

    # packed one stacked leaf at a time (pack_for_serve consumes the float
    # tree), so a large model's float and packed trees are never both whole
    artifact = None
    if args.policy is not None:
        specs = qapply.layer_specs(params, cfg)
        artifact = PolicyArtifact.load(args.policy)
        artifact.verify_layers(specs)  # refuse a foreign layer registry
        policy = artifact.policy
        sp = qapply.pack_for_serve(params, artifact, cfg)
        budget = ("; ".join(f"{it.metric}<={it.limit:g}" for it in artifact.budget.items)
                  if artifact.budget else "none")
        print(f"policy artifact {args.policy}: backend={artifact.backend} "
              f"budget=[{budget}] mean_bits={policy.mean_bits():.2f} "
              f"size={policy.model_size_mib():.2f} MiB")
        if artifact.state_policy is not None:
            print(f"  quantized KV state: mean_bits={artifact.state_policy.mean_bits():.2f} "
                  f"({len(artifact.state_policy.layers)} entries)")
        if artifact.draft_policy is not None:
            print(f"  self-speculative draft: K={artifact.draft_k} "
                  f"mean_bits={artifact.draft_policy.mean_bits():.2f}")
    elif args.wbits != "float":
        specs = qapply.layer_specs(params, cfg)
        if args.wbits.endswith(".json"):
            with open(args.wbits) as f:
                policy = BitPolicy.from_json(f.read())
        elif args.wbits == "mixed":
            policy = dryrun_policy(specs, "mixed")
        else:
            policy = BitPolicy.uniform(specs, int(args.wbits))
        sp = qapply.pack_for_serve(params, policy, cfg)
        print(f"quantized: mean_bits={policy.mean_bits():.2f} "
              f"size={policy.model_size_mib():.2f} MiB "
              f"(fp32 {sum(s.n_params for s in specs) * 4 / 2**20:.2f} MiB)")
    else:
        sp = api.unstack(params, cfg)
    del params

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab_size, rng.integers(2, 24)).tolist(),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(cfg, sp, max_slots=args.slots, max_seq=args.max_seq,
                      temperature=args.temperature, seed=args.seed, artifact=artifact,
                      prefill_chunk=args.prefill_chunk, step_token_budget=args.token_budget,
                      device=device)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    new_tokens = sum(len(v) for v in results.values())
    st = eng.stats()
    print(f"{len(results)} requests, {new_tokens} new tokens in {dt:.2f}s "
          f"({new_tokens / dt:.1f} tok/s); decode_steps={st['decode_steps']} "
          f"slot_efficiency={new_tokens / (st['decode_steps'] * args.slots):.2f} "
          f"step_median={(st['decode_step_median_s'] or 0.0) * 1e3:.1f}ms "
          f"stragglers={st['health']['straggler_flagged']}")
    if st["spec_steps"]:
        print(f"speculation: K={st['speculate_live_k']} rounds={st['spec_steps']} "
              f"accepted {st['spec_accepted']} of {st['spec_proposed']} drafted")
    for uid in sorted(results)[:4]:
        print(f"  req {uid}: {results[uid][:10]}")
    if args.trace:
        doc = obs_trace.get_tracer().save(args.trace)
        obs_trace.validate_chrome_trace(doc)
        obs_trace.disable()
        rep = eng.trace_report()
        print(f"trace: {len(doc['traceEvents'])} events -> {args.trace} "
              f"(open at https://ui.perfetto.dev)")
        print(f"step phases over {rep['steps']} turns "
              f"(attributed {rep['attributed_fraction'] * 100:.1f}%):")
        for name, ph in rep["phases"].items():
            print(f"  {name:<13} {ph['fraction_of_step'] * 100:5.1f}%  "
                  f"mean={ph['mean_us']:8.1f}us  p99={ph['p99_us']:8.1f}us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
