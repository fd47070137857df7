"""BENCHMARK.json against the benchmark's contract, and the files it names."""
import json
import re

import pytest

from . import _paths  # noqa: F401
from portbench.cell import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for key, keys in allowed.items():
        names = [e["name"] for e in b[key]]
        assert len(names) == len(set(names))
        for e in b[key]:
            assert set(e) <= keys, (key, e)
            assert NAME.match(e["name"]), e["name"]
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert _line(m["layer"])
    for w in b["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])


def test_every_cell_reports_what_its_metrics_move():
    b = _bench()
    e2e_of = {w["name"]: {m["name"] for m in b["end_to_end"]
                          if w["name"] in m.get("workloads", [w["name"]])}
              for w in b["workloads"]}
    for cell, names in e2e_of.items():
        assert "setup_s" in names and len(names) >= 2, cell
        assert any(cell in m.get("workloads", [cell]) and m["moves"] in names
                   for m in b["per_layer"]), cell
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cell in m.get("workloads", e2e_of):
            assert m["moves"] in e2e_of[cell], (m["name"], cell)


def test_files_the_manifest_names_exist():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith("portbench/") and _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / c["file"]).parent.joinpath(conf["policy"]).is_file()
        assert conf["source"].startswith(c["source"])
    for w in b["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    for m in b["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


#: keys that set a width or the depth: the benchmark runs each as the program's
#: configuration has it (the vocabulary may only grow, to the published padding)
WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "head_dim", "n_experts",
          "n_shared_experts", "top_k", "ssm_state", "ssm_expand", "ssm_head_dim",
          "ssm_conv_width")


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-2.7b"])
def test_configurations_are_the_program_configs_uncut(name):
    import dataclasses

    from repro_torch.configs import get_config

    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    base = dataclasses.asdict(get_config(conf["arch"]))
    for k, v in conf["model"].items():
        assert k in base, k
        if k == "vocab_size":
            assert v >= base[k]
        elif k in WIDTHS:
            assert base[k] == v, k
    from repro_torch.core.policy import BitPolicy

    pol = BitPolicy.from_json((HERE / "configs" / conf["policy"]).read_text())
    states = {l.name: pol.bits[l.name] for l in pol.state_layers()}
    assert all(b == (8 if n.endswith(".k") else 4) for n, b in states.items())
    assert bool(states) == (conf["model"]["family"] != "ssm")
    assert {pol.bits[n] for n in ("embed", "lm_head")} == {8}
    assert set(conf["changed"]) == set(next(c for c in _bench()["configs"]
                                            if c["name"] == name)["reduced"])
