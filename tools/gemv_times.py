#!/usr/bin/env python3
"""Time the quantized GEMV (TPU kernel row 1) and its expert stack (row 1e) of one tree.

    python3 tools/gemv_times.py [--src DIR] [--label NAME] [--cases 4/4/bf16,e/routed/4/bf16,...]
                                [--no-check] [--tiles 1,2,...]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
builds its kernels there, so that two trees can be timed in one session on
one card, in turns (parent, change, change, parent).  The cases are
chip_smoke.py phase 2's ``sweep_gemv``, whose code this script runs: one
gemma-2b layer's four fused linears (``LINEARS``) x M 1, 4, 8 x 4, 6, 8
bits, bf16 x, and f32 x at M 4; for each, summed over the four linears, the
kernel's device time back to back (``kernel``) and with L2 flushed before
every call (``cold``), torch.matmul on the dequantized weights the same two
ways (``lib``, ``lib_cold``), the bound and each linear's kernel time
back to back, all in ms, in one JSON line beside the card's name and
power limit; ``--cases`` keeps the named cases ("bits/M/dtype"), and
``--no-check`` skips the comparison with the plain version (for the
timing-only trees of ``tools/gemv_variants.py``).  The expert cases
("e/dense|routed/bits/dtype", default ``SWEEP_EXPERTS``) are ``sweep_experts``:
deepseek-moe-16b's three expert linears of a layer at the decode's C 8 on
dense x and on the routed buffer, device time back to back, both bounds
(``experts``); ``--tiles`` also times each linear at those tiles a CTA (a
tree whose expert wrapper takes ``launch=``).  Exits 2 without a CUDA device.
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
    ap.add_argument("--cases", default="", help="comma-separated bits/M/dtype keys")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the comparison with the plain version (timing-only variants)")
    ap.add_argument("--tiles", default="", help="comma-separated tiles a CTA for row 1e")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemv_times: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"{Path(__file__).name}: {src} holds no repro_torch", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke as cs

    cs.log = lambda *a: print(*a, file=sys.stderr, flush=True)   # the cases' lines aside
    cases = [c for c in args.cases.split(",") if c]
    flat = [c for c in cases if not c.startswith("e/")]
    stack = [c for c in cases if c.startswith("e/")]
    times = cs.sweep_gemv(torch, cases=flat, check=not args.no_check) if flat or not cases else {}
    experts = (cs.sweep_experts(torch, cases=stack, check=not args.no_check,
                                tiles=[int(t) for t in args.tiles.split(",") if t])
               if stack or not cases else {})
    print(json.dumps({"label": args.label, "src": args.src, "card": cs.smi_line(),
                      "times": times, "experts": experts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
