"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

    configs/<config>.json          sizes as run; names its bit policy file
    configs/<config>.policy.json   per-layer weight bits and K/V state bits
    traffic/<mix>.json             the mix's parameters (``traffic.py``)
    limits/<cell>.json             the numbers ``correct`` compares, with limits
    metrics/<metric>.py            a per-layer metric's reader
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    policy_json: str
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    centry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cpath = root / centry["file"]
    config = json.loads(cpath.read_text())
    policy_json = (cpath.parent / config["policy"]).read_text()
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, workload=w, config=config, policy_json=policy_json, mix=mix,
                limits=limits, end_to_end=e2e, per_layer=per_layer)
