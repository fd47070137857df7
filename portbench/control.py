#!/usr/bin/env python3
"""Readings behind the limits of ``correct``, and the control's verdict.

    python3 portbench/control.py --workload dsmoe16b.decode64 --seeds 11,12,13 --seconds 30

For each seed, in one process: the cell's program served for ``--seconds``
at the cell's own load, then the plain reference over the sample of the
requests it finished (``check.sample_requests``).  Three things are judged
by the same comparison and the same ``limits/<cell>.json`` as a benchmark
run (``check.compare``): the tokens the program served; as the control, the
tokens the reference computed in fp8 puts first (the precision below the
configuration's bf16), which has to come out not correct; and, as a
witness, those of the reference with its linears in bf16.  Prints a JSON
line a seed.  The benchmark's runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def verdict(cell, served, logits, tokens) -> dict:
    from portbench import check

    compared, got = check.compare(cell, served, logits, tokens)
    got["correct"] = all(c["value"] <= c["limit"] for c in compared.values())
    got.update({k: c["value"] for k, c in compared.items()})
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="fp8,bf16",
                    help="stand-ins judged beside the program (comma-separated, may be empty)")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import cell as cell_mod
    from portbench import check, harness
    from portbench.reference.common import Numerics

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cell_mod.load(args.workload)
    modes = [m for m in args.modes.split(",") if m]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        served = harness.serve(cell, seed, args.seconds, False, t0)
        t1 = time.perf_counter()
        uids = check.sample_requests(served.rec, seed)
        logits = check.reference_logits(served, uids, Numerics("f32"), "cuda")
        out = {"workload": cell.name, "seed": seed,
               "program": verdict(cell, served, logits, served.rec.tokens)}
        t2 = time.perf_counter()
        for mode in modes:
            out[mode] = verdict(cell, served, logits,
                                check.stand_in_tokens(served, uids, mode, "cuda"))
        out.update(serve_s=round(t1 - t0, 3), reference_s=round(t2 - t1, 3),
                   requests=len(uids), finished=len(served.rec.finished()),
                   limits=cell.limits)
        print(json.dumps(out), flush=True)
        del served, logits
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
