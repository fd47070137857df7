"""The port's op-level cost analysis (``repro_torch.roofline.hlo_cost``,
``extract``, ``reprice``), the twins of ``tests/test_hlo_cost.py`` and the
HLO cases of ``tests/test_roofline.py``: a trace of aten ops recorded by
``CostMode`` takes the place of the optimized HLO.

The matmul chain is held against the reference's ``hlo_cost.analyze`` of the
same JAX module (flops within 2 %; bytes differ by construction, eager
PyTorch fuses nothing, and the test records their ratio); loops unroll in
the trace, so a Python loop of matmuls counts each trip exactly; a slice
update touches only the slice; the collectives' wire factors and a
collective inside a loop run on a fake world (in a subprocess); and
``reprice_dir`` rewrites a record from its saved trace.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.roofline import hlo_cost as jcost
from repro_torch.roofline import extract, hlo_cost, reprice
from repro_torch.roofline.model import H100_SXM, roofline_terms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace(fn, *args):
    with hlo_cost.CostMode() as mode:
        fn(*args)
    return mode.trace


def test_matmul_chain_matches_the_references_hlo_count():
    def g(a, b):
        return jax.nn.relu(a @ b) @ b.T

    c = jax.jit(g).lower(jax.ShapeDtypeStruct((512, 1024), "float32"),
                         jax.ShapeDtypeStruct((1024, 2048), "float32")).compile()
    ref = jcost.analyze(c.as_text())
    a = torch.empty(512, 1024, device="meta")
    b = torch.empty(1024, 2048, device="meta")
    mine = hlo_cost.analyze(_trace(lambda x, y: torch.relu(x @ y) @ y.T, a, b))
    assert mine.flops == pytest.approx(ref.flops, rel=0.02)
    ratio = mine.bytes / ref.bytes
    print(f"matmul chain bytes, port/reference: {ratio:.3f}")
    # eager writes and re-reads the relu's input; XLA fuses the relu into the dot
    assert 1.0 <= ratio < 2.0


def test_python_loop_counts_every_trip():
    x = torch.empty(64, 64, device="meta")

    def f(c):
        for _ in range(18):
            c = x @ c
        return c

    assert hlo_cost.analyze(_trace(f, x)).flops == 18 * 2 * 64 ** 3


def test_nested_loops():
    xs = torch.empty(5, 7, 32, 32, device="meta")

    def f(c):
        for i in range(5):
            for j in range(7):
                c = xs[i, j] @ c
        return c

    trace = _trace(f, torch.empty(32, 32, device="meta"))
    assert hlo_cost.analyze(trace).flops == 5 * 7 * 2 * 32 ** 3
    assert sum(r["op"] == "aten.mm.default" for r in trace.records) == 35


def test_slice_update_touches_the_slice_not_the_buffer():
    buf = torch.empty(1 << 16, 64, device="meta")
    row = torch.empty(1, 64, device="meta")

    def f():
        buf[5:6].copy_(row)
        buf.index_put_((torch.tensor([7], device="meta"),), row)

    cost = hlo_cost.analyze(_trace(f))
    assert cost.bytes < 1 << 12          # far less than the 16 MiB buffer
    assert cost.flops == 0


def test_views_are_free_and_peak_counts_live_results():
    a = torch.empty(256, 256, device="meta")

    def f(x):
        y = x.reshape(-1).view(256, 256).t()   # views: no bytes
        z = torch.exp(y)                       # 256 KiB made
        return z * 2.0                         # 256 KiB more while z lives

    trace = _trace(f, a)
    views = [r for r in trace.records if r.get("view")]
    assert views and all(hlo_cost.op_cost(r).bytes == 0 for r in views)
    assert trace.peak_live_bytes == 2 * 256 * 256 * 4


_COLLECTIVES = r"""
import json, sys
sys.path.insert(0, "src")
import torch, torch.distributed as dist
from torch.distributed import _functional_collectives as fc
from repro_torch.launch.mesh import fake_world
from repro_torch.roofline import extract, hlo_cost
fake_world(4)
x = torch.empty(16, device="meta")
def done(t):
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t
with hlo_cost.CostMode() as mode:
    done(fc.all_reduce(x, "sum", dist.group.WORLD))
ar = hlo_cost.analyze(mode.trace)
y = torch.empty(2, 8, device="meta")
with hlo_cost.CostMode() as mode:
    for _ in range(12):
        done(fc.all_gather_tensor(y, 0, dist.group.WORLD))
loop = hlo_cost.analyze(mode.trace)
stats = extract.collective_bytes(mode.trace)
dist.destroy_process_group()
print("COLL " + json.dumps({"ar_bytes": ar.coll_bytes["all-reduce"], "ar_wire": ar.coll_wire_bytes,
      "ag_count": loop.coll_count["all-gather"], "ag_bytes": loop.coll_bytes["all-gather"],
      "stats": [stats.by_kind_count, stats.total_wire_bytes, stats.total_raw_bytes],
      "groups": sorted({r["group"] for r in mode.trace.records if r.get("coll")})}))
"""


def test_wire_factors_and_a_collective_in_a_loop_on_a_fake_world():
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(next(ln for ln in out.stdout.splitlines() if ln.startswith("COLL "))[5:])
    assert r["ar_bytes"] == 64 and r["ar_wire"] == 128          # all-reduce wire factor 2
    assert r["ag_count"] == 12 and r["ag_bytes"] == 12 * 8 * 8 * 4
    assert r["stats"] == [{"all-gather": 12}, 12 * 256.0, 12 * 256.0]
    assert r["groups"] == [4]


def test_reprice_dir_rewrites_a_record_from_its_trace(tmp_path):
    """A record whose roofline fields are stale gets them back from its trace."""
    x = torch.empty(128, 128, device="meta")
    trace = _trace(lambda a: (a @ a).sum(), x)
    trace.meta["argument_bytes"] = 128 * 128 * 4
    (tmp_path / "trace").mkdir()
    trace.save(str(tmp_path / "trace" / "gemma-2b_decode_32k_pod1.json.gz"))
    rec = {"arch": "gemma-2b", "shape": "decode_32k", "kind": "decode", "n_chips": 256,
           "variant": "", "per_device_flops": -1.0, "compute_s": -1.0}
    path = tmp_path / "gemma-2b_decode_32k_pod1_mixed.json"
    path.write_text(json.dumps(rec))
    (tmp_path / "orphan_pod1_mixed.json").write_text(json.dumps(dict(rec, arch="yi-6b")))
    assert reprice.reprice_dir(str(tmp_path)) == 0
    new = json.loads(path.read_text())
    flops = 2 * 128 ** 3 + 128 * 128
    assert new["per_device_flops"] == flops
    terms = roofline_terms(flops, new["per_device_bytes"], 0.0, 256, H100_SXM)
    assert new["compute_s"] == terms.compute_s and new["dominant"] == terms.dominant
    assert new["arch"] == "gemma-2b" and new["model_flops"] > 0
    loaded = hlo_cost.Trace.load(str(tmp_path / "trace" / "gemma-2b_decode_32k_pod1.json.gz"))
    assert loaded.records == trace.records
    summary = extract.cost_summary(loaded)
    assert summary["argument_bytes"] == 128 * 128 * 4
    assert summary["peak_bytes"] == summary["argument_bytes"] + loaded.peak_live_bytes
