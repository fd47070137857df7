#!/usr/bin/env python3
"""The serving phases of one tree's ``chip_smoke.py`` (4, 5, 6, 8 (a), 13 (b)), timed.

    python3 tools/serve_times.py [--tree DIR] [--src DIR] [--label NAME] [--phases 4,5,6,8a,13b]

Imports ``chip_smoke`` and ``repro_torch`` from the checkout ``DIR`` (default:
this one; ``--src`` takes ``repro_torch`` from another tree's ``src``, so
that this checkout's phase runs on an older package), builds its kernels
there, runs the phases' own functions (``serve_bf16``, ``serve_paged``,
``serve_speculative``, ``serve_row8``, ``serve_moe``) with their checks,
and prints one JSON line: the card, and per engine the median decode step
(a round under speculation) and, where a phase profiles one engine, the
device's busy and wall milliseconds, as the phases log them; 13 (b) adds
row 1e's device ms a decode step and the live experts a decode-step MoE
call (``moe``).  Two trees are compared by running it on each, in turns,
on one card.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEP = re.compile(r"(?:ok \(([^)]*)\).*)?median (?:decode )?(?:step|round) ([0-9.]+) ms")
BUSY = re.compile(r"device busy ([0-9.]+) ms of ([0-9.]+) ms wall")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="a checkout holding chip_smoke.py and src")
    ap.add_argument("--src", default="", help="the src directory to import repro_torch from "
                    "(default: the tree's)")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--phases", default="4,5,6,8a")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_times: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    if not (tree / "chip_smoke.py").is_file() or not (tree / "src" / "repro_torch").is_dir():
        print(f"serve_times: {tree} holds no chip_smoke.py and src/repro_torch", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() if args.src else tree / "src"
    if not (src / "repro_torch").is_dir():
        print(f"serve_times: {src} holds no repro_torch", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(tree)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import _build

    lines = []
    cs.log = lambda *a: (lines.append(" ".join(map(str, a))), print(*a, flush=True))
    _build.lib()
    cfg = configs.get_config(cs.ARCH)
    out = {"label": args.label, "src": str(src), "card": cs.smi_line(), "steps_ms": {},
           "busy_ms": {}}
    phases = {"4": lambda: cs.serve_bf16(torch, cfg), "5": lambda: cs.serve_paged(torch, cfg),
              "6": lambda: cs.serve_speculative(torch, cfg, {}),
              "8a": lambda: cs.serve_row8(torch, cfg),
              "13b": lambda: cs.serve_moe(torch, configs.get_config(cs.MOE_ARCH))}
    for name in args.phases.split(","):
        start = len(lines)
        ran = phases[name]()
        if name == "13b":
            out["steps_ms"]["13b engine"] = ran["step_ms"]
            out["moe"] = {k: ran[k] for k in ("stack_gemv_ms", "live") if k in ran}
        for line in lines[start:]:
            if m := STEP.search(line):
                out["steps_ms"][f"{name} {m.group(1) or 'engine'}"] = float(m.group(2))
            elif m := BUSY.search(line):
                out["busy_ms"][f"{name} #{len(out['busy_ms'])}"] = [float(m.group(1)),
                                                                     float(m.group(2))]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
