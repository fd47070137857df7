#!/usr/bin/env python3
"""Time the expert stack's GEMM (TPU kernel row 2e) of one tree.

    python3 tools/gemm_times.py [--src DIR] [--label NAME] [--cases g/16/4/bf16,...]
                                [--no-check]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
builds its kernels there, so that two trees can be timed in one session on
one card, in turns (parent, change, change, parent).  The cases are
chip_smoke.py's ``sweep_expert_gemm``, whose code this script runs:
deepseek-moe-16b's three expert linears of a layer (64 experts) at C 16,
128 and 1280 x 4 and 8 bits x bf16 and f32 x ("g/C/bits/dtype", default
``SWEEP_EXPERT_GEMM``); for each, summed over the three linears, the
kernel's device time back to back (``kernel``), ``torch.bmm``'s on the
dequantized bf16 stack (``bmm``), the bounds of the bytes and of the
operations and each linear's times, all in ms, in one JSON line beside the
card's name and power limit.  ``--no-check`` skips the comparison with the
plain version (for the timing-only trees of ``tools/gemm_variants.py``).
Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--cases", default="", help="comma-separated g/C/bits/dtype keys")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the comparison with the plain version (timing-only variants)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemm_times: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"{Path(__file__).name}: {src} holds no repro_torch", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke as cs

    cs.log = lambda *a: print(*a, file=sys.stderr, flush=True)   # the cases' lines aside
    cases = [c for c in args.cases.split(",") if c] or None
    times = cs.sweep_expert_gemm(torch, cases=cases, check=not args.no_check)
    print(json.dumps({"label": args.label, "src": args.src, "card": cs.smi_line(),
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
