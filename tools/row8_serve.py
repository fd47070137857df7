#!/usr/bin/env python3
"""Phase 8 (a) of chip_smoke.py on one tree: the f32 engine through row 8.

    python3 tools/row8_serve.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
builds its kernels there, then runs ``chip_smoke.serve_row8``: gemma-2b cut
to d_model 512 in f32, 8 requests on 4 slots, the engine with the fused
``wqkv`` (row 8 once a layer and decode step) against the same engine with
``fuse_projections=False``, streams and cache bytes compared, each engine's
median step and tok/s, and a profiled rerun's device time by kernel.  Two
trees are compared by running it on each, in turns, on one card.  Exits 2
without a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("row8_serve: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"{Path(__file__).name}: {src} holds no repro_torch", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import configs

    cs.log(f"== row 8 serving, {args.label} ({args.src}); {cs.smi_line()}")
    cs.serve_row8(torch, configs.get_config(cs.ARCH))
    return 0


if __name__ == "__main__":
    sys.exit(main())
