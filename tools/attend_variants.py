#!/usr/bin/env python3
"""Copies of ``src`` with the split attention body changed, for timing only.

    python3 tools/attend_variants.py [--out DIR]
    python3 tools/attend_times.py --src DIR/<name>/src --label <name>

Each variant is this checkout's ``src`` with a few lines of
``csrc/quant_kv.cuh`` or ``kernels/quant_kv/kernel.py`` replaced (every edit
must match, or the script fails).  ``attend_times.py`` builds and times it
beside the unchanged tree on the same card.  The variants that cut work out
compute wrong outputs; they say what that work costs, nothing more.

  chunk128   chunks of 128 positions (kChunk, CHUNK) instead of 64
  chunk32    chunks of 32: one tile a chunk, more chunks (rounds past 16)
  cluster8   at most 8 CTAs a (slot, kv head): a second round from 9 chunks
  nocompute  no scores and no probabilities times V (loads, softmax, fold kept)
  noload     no tile dequantized into shared memory (the loads go with it)
  nofold     the partials are not read across the cluster (syncs kept)
  norequant  the fused steps (rows 3 and 7) skip the touched block's
             requantization (the attention then reads a stale copy)
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BODY = "repro_torch/csrc/quant_kv.cuh"
DENSE_STEP = "repro_torch/csrc/quant_kv_decode_step.cu"
PAGED = "repro_torch/csrc/quant_kv_paged.cu"
PLAN = "repro_torch/kernels/quant_kv/kernel.py"

VARIANTS = {
    "chunk128": [(BODY, "constexpr int kChunk = 64;", "constexpr int kChunk = 128;"),
                 (PLAN, "\nCHUNK = 64\n", "\nCHUNK = 128\n")],
    "chunk32": [(BODY, "constexpr int kChunk = 64;", "constexpr int kChunk = 32;"),
                (PLAN, "\nCHUNK = 64\n", "\nCHUNK = 32\n")],
    "cluster8": [(PLAN, "\nMAX_CLUSTER = 16\n", "\nMAX_CLUSTER = 8\n")],
    "nocompute": [(BODY, "for (int i = threadIdx.x; i < g * kTile; i += blockDim.x) {",
                   "for (int i = threadIdx.x; i < 0; i += blockDim.x) {"),
                  (BODY, "for (int c = threadIdx.x; c < hd; c += blockDim.x) {",
                   "for (int c = threadIdx.x; c < 0; c += blockDim.x) {")],
    "noload": [(BODY, "    store_tile(krows, vrows, ks, vs, t0, S, block, bidx, regs);\n", "")],
    "nofold": [(BODY, "for (int j0 = 0; j0 < cnt; j0 += kFoldBatch) {",
                "for (int j0 = 0; j0 < 0; j0 += kFoldBatch) {")],
    "norequant": [(DENSE_STEP, "    requantize_kv(kp + ", "    if (0) requantize_kv(kp + "),
                  (PAGED, "    requantize_kv(reinterpret_cast",
                   "    if (0) requantize_kv(reinterpret_cast")],
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
    ap.add_argument("--out", default=str(ROOT / "build" / "attend_variants"))
    args = ap.parse_args()
    print(" ".join(make(Path(args.out))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
