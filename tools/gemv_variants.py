#!/usr/bin/env python3
"""Copies of ``src`` with the GEMV changed, for timing only.

    python3 tools/gemv_variants.py [--out DIR]
    python3 tools/gemv_times.py --src DIR/<name>/src --label <name> --no-check

Each variant is this checkout's ``src`` with a few lines of
``csrc/quant_gemv.cuh``, ``csrc/quant_gemv.cu`` or
``kernels/quant_gemv/kernel.py`` replaced (every edit must match, or the
script fails).  ``gemv_times.py`` builds and times it beside the unchanged
tree on the same card.  The variants that cut work out compute wrong
outputs; they say what that work costs, nothing more.

  tiles1     one tile of 128 channels a CTA at every N (w_gu: 2048 CTAs)
  tiles4     at most 4 tiles a CTA (w_gu: 512 CTAs)
  group2     two rounds a load group (kGemvGroup 2: twice the bytes in flight)
  group4     four rounds a load group
  occ3       three CTAs an SM (__launch_bounds__ min blocks 3: at most 85 registers)
  nocompute  no conversion and no mma (the loaded words are kept alive)
  noload     no weight bytes loaded (zeros)
  nostage    no x staged in shared memory
  nofold     the owner does not add the ranks' partials (stores and barrier kept)
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BODY = "repro_torch/csrc/quant_gemv.cuh"
KERNEL = "repro_torch/csrc/quant_gemv.cu"
PLAN = "repro_torch/kernels/quant_gemv/kernel.py"

VARIANTS = {
    "tiles1": [(PLAN, "\nMAX_TILES = 8\n", "\nMAX_TILES = 1\n")],
    "tiles4": [(PLAN, "\nMAX_TILES = 8\n", "\nMAX_TILES = 4\n")],
    "group2": [(BODY, "constexpr int kGemvGroup = 1;", "constexpr int kGemvGroup = 2;")],
    "group4": [(BODY, "constexpr int kGemvGroup = 1;", "constexpr int kGemvGroup = 4;")],
    "occ3": [(KERNEL, "__global__ void __launch_bounds__(kGemvThreads)\nquant_gemv_kernel(",
              "__global__ void __launch_bounds__(kGemvThreads, 3)\nquant_gemv_kernel(")],
    "nocompute": [(BODY, "      for (int p = 0; p < P; ++p) {",
                   "      acc[0][0] += (float)((ua[0] ^ ua[1] ^ ua[2] ^ ua[3] ^ ub[0] ^ ub[1] ^"
                   " ub[2] ^ ub[3]) & 1);\n      for (int p = 0; p < 0; ++p) {")],
    "noload": [(BODY, "  if (!live || off >= kp) return out;",
                "  if (live || !live) return out;")],
    "nostage": [(BODY, "  const int items = M * rounds * 16;",
                 "  const int items = 0 * M * rounds;")],
    "nofold": [(KERNEL, "for (int r = 0; r < splits; ++r) total",
                "for (int r = 0; r < 0; ++r) total")],
}


def make(out: Path) -> list[str]:
    shutil.rmtree(out, ignore_errors=True)
    for name, edits in VARIANTS.items():
        src = out / name / "src"
        shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns("__pycache__"))
        for rel, old, new in edits:
            path = src / rel
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not once in {rel}")
            path.write_text(text.replace(old, new))
    return sorted(VARIANTS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "gemv_variants"))
    args = ap.parse_args()
    print(" ".join(make(Path(args.out))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
