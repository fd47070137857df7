"""Serving example on the PyTorch port: SigmaQuant-compress an LM, then serve
batched requests through the continuous-batching engine and compare weight
bytes and token agreement against the float model.

    PYTHONPATH=src python examples/torch_serve_quantized.py [--device cpu]

The twin of ``examples/serve_quantized.py`` (the same steps and printed
lines).  Runs on the GPU (the hand-written kernels); ``--device cpu`` runs
the plain versions instead.  Without ``--device`` and without a card it
raises.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.controller import ControllerConfig, SigmaQuantController
from repro_torch.core.policy import Targets
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.quant import apply as qapply
from repro_torch.quant.env import LMQuantEnv
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("gemma-2b").reduced()
    api = registry.get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(0), device=device)

    # make the model worth serving: brief pre-train on the token task
    shape = ShapeSpec("t", "train", 64, 8)
    env = LMQuantEnv(params, cfg, shape)
    print("pre-training reduced gemma ...")
    env.pretrain(60)
    print(f"float val loss: {env.float_loss():.3f}")

    # SigmaQuant: quality within 0.1 nats of float, size <= 75% of INT8
    specs = env.layer_infos()
    int8_mib = sum(s.n_params for s in specs) / 2**20
    targets = Targets(acc_t=-(env.float_loss() + 0.10), res_t=0.75 * int8_mib,
                      acc_buffer=0.03, res_buffer=0.08)
    ctrl = SigmaQuantController(
        env, targets, ControllerConfig(phase1_max_iters=2, phase2_max_iters=10,
                                       phase1_qat_epochs=1, phase2_qat_epochs=1),
        log=print)
    result = ctrl.run()
    print(f"policy: mean_bits={result.policy.mean_bits():.2f} "
          f"size={result.resource:.3f} MiB (INT8 {int8_mib:.3f} MiB) "
          f"success={result.success}")

    # quantize for serving + run batched requests
    sp_float = api.unstack(env.params, cfg)
    sp_quant = qapply.quantize_for_serve(sp_float, result.policy, cfg)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(2, 16, 8)]
    out_f = ServeEngine(cfg, sp_float, max_slots=4, max_seq=128,
                        device=device).generate(prompts, 12)
    out_q = ServeEngine(cfg, sp_quant, max_slots=4, max_seq=128,
                        device=device).generate(prompts, 12)
    agree = np.mean([np.mean(np.asarray(a) == np.asarray(b))
                     for a, b in zip(out_f, out_q)])
    float_bytes = sum(s.n_params for s in specs) * 4
    quant_bytes = int(result.policy.container_bytes())
    print(f"served {len(prompts)} requests: float-vs-quant token agreement "
          f"{agree:.1%}; weight bytes {float_bytes / 2**20:.2f} MiB -> "
          f"{quant_bytes / 2**20:.2f} MiB (packed containers)")
    return out_f, out_q


if __name__ == "__main__":
    main()
