"""Re-price saved dry-run traces without re-running them (the port's twin of
``repro/roofline/reprice.py``).

The dry-run saves each cell's op trace (``<out>/trace/<tag>.json.gz``, in
place of the reference's ``hlo/<tag>.hlo.gz``); this tool re-runs the cost
analysis over those traces and rewrites the roofline fields of the matching
JSON records, so accounting fixes iterate in seconds instead of a sweep.

    PYTHONPATH=src python -m repro_torch.roofline.reprice artifacts/dryrun
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES

from . import hlo_cost
from .model import model_flops, roofline_terms


def roofline_fields(cost: hlo_cost.Cost, cfg, shape, n_chips: int) -> dict:
    """The record's roofline fields from one device's cost (priced on
    ``H100_SXM``)."""
    terms = roofline_terms(cost.flops, cost.bytes, cost.coll_wire_bytes, n_chips)
    mf = model_flops(cfg, shape, train=(shape.kind == "train"))
    return {
        "hlo_flops": terms.flops, "hlo_bytes": terms.hbm_bytes,
        "per_device_flops": cost.flops, "per_device_bytes": cost.bytes,
        "collectives": {k: {"bytes": v, "count": cost.coll_count[k]}
                        for k, v in cost.coll_bytes.items()},
        "coll_wire_bytes": cost.coll_wire_bytes,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "bound_s": terms.bound_s, "model_flops": mf,
        "useful_flops_ratio": mf / terms.flops if terms.flops else 0.0,
        "roofline_fraction": terms.fraction_of_roofline(mf),
    }


def reprice_dir(out_dir: str) -> int:
    n = 0
    for jf in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(jf) as f:
            rec = json.load(f)
        tag = os.path.basename(jf).rsplit("_", 1)[0]  # strip _<scheme>.json
        tf = os.path.join(out_dir, "trace", tag + (f"_{rec['variant']}" if rec.get("variant")
                                                   else "") + ".json.gz")
        if not os.path.exists(tf):
            print(f"skip {os.path.basename(jf)} (no trace)")
            continue
        cost = hlo_cost.analyze(hlo_cost.Trace.load(tf))
        rec.update(roofline_fields(cost, get_config(rec["arch"]), SHAPES[rec["shape"]],
                                   rec["n_chips"]))
        with open(jf, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"repriced {n} records in {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(reprice_dir(sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun"))
