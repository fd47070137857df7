#!/usr/bin/env python3
"""Copies of ``src`` with the expert stack's GEMM (row 2e) changed, for timing only.

    python3 tools/gemm_variants.py [--out DIR]
    python3 tools/gemm_times.py --src DIR/<name>/src --label <name> --no-check

Each variant is this checkout's ``src`` with a few lines of
``csrc/quant_matmul_experts.cu`` or ``kernels/quant_matmul/kernel.py``
replaced (every edit must match at least once, or the script fails).
``gemm_times.py`` builds and times it beside the unchanged tree on the same
card.  The variants that cut work out compute wrong outputs; they say what
that work costs, nothing more.

  arrive_all  every consumer thread arrives on the empty barriers, every
              producer thread on the full ones (256 arrivals a stage: the
              first design)
  nofold      one K range a tile: no wait for the MMAs at the ranges' ends
  narrow      tiles of 128 channels at every token tile (no 256-channel
              tiles at C <= 32)
  ring6       6 x stages and 4 weight chunks at 128 tokens (not 8 and 3)
  nt64        token tiles of at most 64 (C 128 and 1280 walk tiles of 64)
  noepi       no output stored (the sums are staged, nothing written)
  nocompute   no wgmma (the unpacked fragments are kept alive)
  nounpack    4 bits: the loaded words go to the wgmma as they are (no prmt,
              imad, lop3, hsub2)
  bare        nounpack and nocompute together: the rings, the loads and the
              bookkeeping alone
  noload      the producer waits for its slots but loads nothing (the full
              barriers get their arrivals without bytes)
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "repro_torch/csrc/quant_matmul_experts.cu"
PLAN = "repro_torch/kernels/quant_matmul/kernel.py"

VARIANTS = {
    "arrive_all": [
        (KERNEL, "  __syncwarp();\n  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);",
         "  mbar_arrive(bar);"),
        (KERNEL, "const int fills = vec ? 1 : 4;", "const int fills = vec ? 1 : 128;"),
        (KERNEL, "4 * kConsumers);", "128 * kConsumers);"),
    ],
    "nofold": [(KERNEL, "for (int r = 0; r < splits; ++r) {", "for (int r = 0; r < 1; ++r) {"),
               (KERNEL, "i1 = (r + 1) * nk / splits;", "i1 = nk;")],
    "narrow": [(KERNEL, "constexpr int blocks_of(int nt) { return nt <= 32 ? 2 : 1; }",
                "constexpr int blocks_of(int nt) { return 1; }"),
               (PLAN, "EXPERT_WIDE_TOKENS = 32", "EXPERT_WIDE_TOKENS = 0")],
    "ring6": [(KERNEL, "kStages = NT == 128 ? 8 :", "kStages = NT == 128 ? 6 :"),
              (KERNEL, "kWSlots = NT == 128 ? 3 : 4;", "kWSlots = NT == 128 ? 4 : 4;")],
    "nt64": [(PLAN, "EXPERT_TOKEN_TILES = (16, 32, 64, 128)", "EXPERT_TOKEN_TILES = (16, 32, 64)")],
    "noepi": [(KERNEL, "        if (tok >= M || n >= N) continue;", "        if (tok >= 0) continue;")],
    "nocompute": [(KERNEL,
                   "for (int b = 0; b < MB; ++b) wgmma_rs(acc[b], a[decltype(P)::value][b][j], "
                   "desc + 2 * j);",
                   "for (int b = 0; b < MB; ++b)\n"
                   "          acc[b][j] += __uint_as_float((a[decltype(P)::value][b][j][0] ^\n"
                   "                                        a[decltype(P)::value][b][j][3] ^"
                   " (uint32_t)desc) & 0x3FFFFFu);")],
    "nounpack": [(KERNEL, "        a[j][h] = levels4(prmt(w0, 0, 0x4440 | t));\n"
                          "        a[j][2 + h] = levels4(prmt(w1, 0, 0x4440 | t));",
                  "        a[j][h] = w0 ^ t;\n        a[j][2 + h] = w1;")],
    "noload": [
        (KERNEL, "            mbar_expect_tx(wfull + ws, L::kW);\n"
                 "            tma_load_3d(slot, &wmap, i / WK * kWChunk, tl.ch0, tl.ex, wfull + ws);",
         "            mbar_arrive(wfull + ws);"),
        (KERNEL, "          mbar_expect_tx(xfull + xs, L::kX);\n"
                 "          tma_load_3d(stage, &xmap, i * kBK, tl.tok0, tl.ex, xfull + xs);",
         "          mbar_arrive(xfull + xs);"),
    ],
}

VARIANTS["bare"] = VARIANTS["nounpack"] + VARIANTS["nocompute"]


def make(out: Path) -> list[str]:
    shutil.rmtree(out, ignore_errors=True)
    for name, edits in VARIANTS.items():
        src = out / name / "src"
        shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns("__pycache__"))
        for rel, old, new in edits:
            path = src / rel
            text = path.read_text()
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {rel}")
            path.write_text(text.replace(old, new))
    return sorted(VARIANTS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "gemm_variants"))
    args = ap.parse_args()
    print(" ".join(make(Path(args.out))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
