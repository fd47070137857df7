"""Quickstart on the PyTorch port: SigmaQuant end to end on a small CNN.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py`` (the same steps and printed lines):

1. Train a small ResNet on the synthetic image task (float baseline).
2. Run the SigmaQuant two-phase controller against user targets:
   accuracy >= float-2%, size <= 50% of the INT8 model.
3. Inspect the resulting per-layer bit allocation and the shift-add PPA.

Runs on the GPU (the fake-quant kernel in the QAT steps); ``--device cpu``
runs the plain versions instead.  Without ``--device`` and without a card
it raises.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import hardware
from repro_torch.core.controller import ControllerConfig, SigmaQuantController
from repro_torch.core.policy import BitPolicy, Targets
from repro_torch.data.images import ImageTask
from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.quant.env import CNNQuantEnv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. float baseline -----------------------------------------------------
    cfg = cnn.CNNConfig(stages=((16, 1), (32, 1), (64, 1)), n_classes=64)
    task = ImageTask(n_classes=64, noise=2.2, seed=1)
    params = cnn.init(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    env = CNNQuantEnv(params, cfg, task, steps_per_epoch=10)
    print("pre-training float model ...")
    env.pretrain(400)
    fp_acc = env.float_accuracy()
    int8 = BitPolicy.uniform(env.layer_infos(), 8)
    print(f"float acc={fp_acc:.3f}; INT8 size={int8.model_size_mib():.3f} MiB")

    # 2. SigmaQuant under hard constraints ---------------------------------
    targets = Targets(acc_t=fp_acc - 0.02, res_t=0.5 * int8.model_size_mib(),
                      acc_buffer=0.01, res_buffer=0.05)
    ctrl = SigmaQuantController(
        env, targets,
        ControllerConfig(phase1_max_iters=2, phase2_max_iters=8,
                         phase1_qat_epochs=2, phase2_qat_epochs=1),
        log=print)
    result = ctrl.run()

    # 3. report -------------------------------------------------------------
    print(f"\nfinal: acc={result.acc:.4f} (target >= {targets.acc_t:.4f}), "
          f"size={result.resource:.3f} MiB (target <= {targets.res_t:.3f}), "
          f"success={result.success}")
    print("per-layer bits:", result.policy.bits)
    rep = hardware.evaluate_policy(result.policy)
    print(f"shift-add MAC vs INT8 MAC: energy {rep.energy_saving():+.1%} saved, "
          f"latency x{rep.latency:.2f}, area {hardware.area_saving_vs_int8():+.1%} saved")
    return result


if __name__ == "__main__":
    main()
