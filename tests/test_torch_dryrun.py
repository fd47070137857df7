"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake (2, 4) world:
reduced gemma-2b's train, prefill (plain and sequence-parallel) and decode
cells complete with the reference's record keys; their per-device argument
bytes equal what the reference compiles for the same cells on 8 host
devices (exactly, less the two numbers the port keeps on the host: the
optimizer's step counter and the QAT bits); and their per-device flops,
split into dots and the rest, lie within 5 % of each cell's own measured
ratio to the reference's loop-aware HLO count (``EXPECTED``; the causes of
each gap are in ``PERF.md``); each train cell's dots are those of its step
without the recompute plus one grad-free forward of its loss (both sides
recompute each layer body and loss chunk in the backward).  The MoE
family's cells (deepseek-moe-16b's prefill, decode and train, llama4's
decode, and deepseek's train on the two-pod mesh) and whisper-tiny's
train cell are held the same way, and the MoE cells' collectives include
the reference's kinds but those DTensor does not emit for the same data
(``COLL_EXEMPT``).  Cells of other families
complete.  The port's cells and the JAX compile each run in a subprocess (a
fake process group and the host device count must not leak into other
tests), all started together."""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: per-device flops port / reference, (all, dots, the rest), as measured with
#: torch 2.13 on these cells.  Dots: the prefills' are the same ops; train's
#: are other partitionings of the same products; decode's replicated
#: ``w_down`` (both layers) and layer 1's ``wo`` run on a quarter of K on each
#: "model" rank under DTensor (partial sums, reduce-scattered) where XLA runs
#: them whole on every device, less layer 1's attention over the gathered
#: cache.  The rest: the port's unpack is three elementwise ops an element
#: (shift, and, sub) where the reference's is two (shift-left, arithmetic
#: shift-right); its ``gelu`` is one op where XLA expands the tanh form; and
#: in train XLA copies each fake-quantized weight's elementwise chain
#: (divide, round, clamp as maximum and minimum, multiply) into every fusion
#: that reads the weight, so the reference counts it two to four times where
#: the port computes it once or twice.  Both recompute each layer body and
#: each loss chunk in the backward (``jax.checkpoint``, ``torch.utils.
#: checkpoint``), so train's dots hold a second forward on both sides.
EXPECTED = {
    "train": (1.135, 1.200, 0.676),
    "prefill": (0.999, 1.000, 0.974),
    "prefill_sp": (1.020, 1.000, 1.153),
    "decode": (1.016, 0.843, 1.209),
}
#: the same ratios for the MoE and whisper cells (``PERF.md`` explains each
#: gap op by op).  Dots: the serving cells run the same expert GEMMs (the
#: stacks are whole, every rank runs every expert on its own tokens' buffer,
#: as XLA runs the reference's); in train both sides split the expert GEMMs
#: over all ranks (E over "model", the capacity or the channels over "data"),
#: and both recompute each layer body and each loss chunk in the backward.
EXPECTED_MORE = {
    "moe_prefill": (1.004, 1.000, 1.091),
    "moe_decode": (1.024, 0.997, 1.200),
    "moe_train": (1.024, 1.102, 0.680),
    "llama4_decode": (1.024, 0.997, 1.200),
    "whisper_train": (1.030, 1.060, 0.862),
    "moe_train_pod2": (0.969, 1.018, 0.602),
}
#: the train cells' dots without the port's recompute, against the
#: reference's dots: the port's dots are this times the reference's plus
#: one grad-free forward of the cell's loss, within ``FLOPS_REL_TOL`` (the
#: recompute stops before each region's last projection, whose output no
#: backward reads: w_down, out_proj)
DOTS_LESS_RECOMPUTE = {"train": 1.017, "moe_train": 0.858, "whisper_train": 0.828,
                       "moe_train_pod2": 0.781}
#: (arch, kind, batch, mesh) of each; the two-pod train cell takes a batch of 4
#: (the smoke batch of 2 does not divide over its 4 batch ranks, where the
#: full-size cells' batches do, and ``batch_spec`` then replicates it)
MORE_CELLS = {
    "moe_prefill": ("deepseek-moe-16b", "prefill", 2, ((2, 4), ("data", "model"))),
    "moe_decode": ("deepseek-moe-16b", "decode", 2, ((2, 4), ("data", "model"))),
    "moe_train": ("deepseek-moe-16b", "train", 2, ((2, 4), ("data", "model"))),
    "llama4_decode": ("llama4-maverick-400b-a17b", "decode", 2, ((2, 4), ("data", "model"))),
    "whisper_train": ("whisper-tiny", "train", 2, ((2, 4), ("data", "model"))),
    "moe_train_pod2": ("deepseek-moe-16b", "train", 4, ((2, 2, 2), ("pod", "data", "model"))),
}
#: kinds of the reference's collectives that DTensor does not emit for the same
#: data: XLA's collective-permutes (resharding between device orders; DTensor
#: has none), its all-to-alls (DTensor on a CPU mesh runs them as an
#: all-gather and a chunk), and the serving prefill's all-reduce of the sorted
#: expert ids (XLA gathers them from the batch shards; the port all-gathers
#: the routing ids whole first)
COLL_EXEMPT = {
    "moe_prefill": {"all-reduce"},
    "moe_decode": set(),
    "moe_train": {"collective-permute", "all-to-all"},
    "llama4_decode": set(),
    "moe_train_pod2": {"collective-permute", "all-to-all"},
}
#: each ratio within this share of its expected value, either way
FLOPS_REL_TOL = 0.05

#: the dots of one grad-free forward of a train cell's loss, on the cell's
#: mesh and arguments (what the backward's recompute reruns)
_FORWARD_DOTS = r"""
import torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.dist import sharding
from repro_torch.models import registry


def forward_dots(cfg, spec, mesh_shape):
    mesh = dryrun._cell_mesh(False, mesh_shape)
    _, (params, _, batch, bits) = dryrun.build_train(cfg, spec, mesh, microbatches=1)
    mode = hlo_cost.CostMode(device="meta")
    with (torch.no_grad(), sharding.activation_axes(mesh), implicit_replication(),
          dryrun._meta_equal(), mode):
        registry.get_api(cfg).loss(params, cfg, batch, bits=bits, impl="torch")
    return sum(hlo_cost.op_cost(r).flops for r in mode.trace.records
               if hlo_cost._base(r["op"]) in hlo_cost._DOTS)
"""

_PORT = r"""
import json, os, sys, tempfile
sys.path.insert(0, "src")
import torch.distributed as dist
from repro_torch.configs import get_config, smoke_shape
from repro_torch.launch import dryrun
from repro_torch.roofline import hlo_cost
""" + _FORWARD_DOTS + r"""
cfg = get_config("gemma-2b").reduced()
out = {}
with tempfile.TemporaryDirectory() as tmp:
    for name, kind, kw in (("train", "train", {"microbatches": 1}), ("prefill", "prefill", {}),
                           ("prefill_sp", "prefill", {"sp": True}), ("decode", "decode", {})):
        rec = dryrun.run_cell("gemma-2b", "smoke_" + kind, cfg=cfg, shape=smoke_shape(kind),
                              mesh_shape=((2, 4), ("data", "model")), verbose=False,
                              variant=name, save_trace_dir=tmp, **kw)
        trace = hlo_cost.Trace.load(os.path.join(tmp, f"gemma-2b_smoke_{kind}_pod1_{name}.json.gz"))
        rec["dot_flops"] = sum(hlo_cost.op_cost(r).flops for r in trace.records
                               if hlo_cost._base(r["op"]) in hlo_cost._DOTS)
        if kind == "train":
            rec["forward_dots"] = forward_dots(cfg, smoke_shape(kind), ((2, 4), ("data", "model")))
        out[name] = rec
dist.destroy_process_group()
print("RECORDS " + json.dumps(out))
"""

_JAX = r"""
import json, sys
sys.path.insert(0, "src")
from repro.launch import dryrun as jd   # sets the host device count before jax starts
import jax
from repro.configs import get_config, smoke_shape
from repro.dist import sharding
from repro.launch.mesh import make_mesh_for
from repro.roofline import hlo_cost


class DotsOnly(hlo_cost.HloCostAnalyzer):
    # the reference's count with the flops of every leaf op but dots zeroed
    def op_cost(self, op):
        c = super().op_cost(op)
        if op.opcode not in ("dot", "while", "fusion", "call", "async-start", "conditional"):
            c.flops = 0.0
        return c


class RecomputedDots(DotsOnly):
    # the dots of the forward the reference recomputes in its backward (the
    # jax.checkpoint on its layer bodies)
    def op_cost(self, op):
        c = super().op_cost(op)
        if op.opcode == "dot" and "rematted_computation" not in op.attrs:
            c.flops = 0.0
        return c


cfg = get_config("gemma-2b").reduced()
mesh = make_mesh_for((2, 4), ("data", "model"))
out = {}
for name, build, kind, kw in (("train", jd.build_train, "train", {"microbatches": 1}),
                              ("prefill", jd.build_prefill, "prefill", {}),
                              ("prefill_sp", jd.build_prefill, "prefill", {"sp": True}),
                              ("decode", jd.build_decode, "decode", {})):
    jitted, args = build(cfg, smoke_shape(kind), mesh, **kw)
    with mesh, sharding.activation_axes(mesh):
        c = jitted.lower(*args).compile()
    host = 0
    if kind == "train":   # the step counter and the bits tree: device scalars here
        host = args[1]["step"].size * 4 + sum(x.size * x.dtype.itemsize
                                              for x in jax.tree.leaves(args[3]))
    out[name] = {"flops": hlo_cost.analyze(c.as_text()).flops,
                 "dot_flops": DotsOnly(c.as_text()).entry_cost().flops,
                 "recomputed_dots": RecomputedDots(c.as_text()).entry_cost().flops,
                 "arg": int(c.memory_analysis().argument_size_in_bytes), "host": int(host)}
from repro.configs.base import ShapeSpec
for name, (arch, kind, batch, (shape, axes)) in MORE_CELLS.items():
    cell_mesh = make_mesh_for(shape, axes)
    spec = ShapeSpec("smoke_" + kind, kind, smoke_shape(kind).seq_len, batch)
    jitted, args = getattr(jd, "build_" + kind)(get_config(arch).reduced(), spec, cell_mesh,
                                                **({"microbatches": 1} if kind == "train" else {}))
    with cell_mesh, sharding.activation_axes(cell_mesh):
        c = jitted.lower(*args).compile()
    host = 0
    if kind == "train":
        host = args[1]["step"].size * 4 + sum(x.size * x.dtype.itemsize
                                              for x in jax.tree.leaves(args[3]))
    cost = hlo_cost.analyze(c.as_text())
    out[name] = {"flops": cost.flops, "dot_flops": DotsOnly(c.as_text()).entry_cost().flops,
                 "recomputed_dots": RecomputedDots(c.as_text()).entry_cost().flops,
                 "arg": int(c.memory_analysis().argument_size_in_bytes), "host": int(host),
                 "kinds": sorted(k for k, n in cost.coll_count.items() if n)}
print("REF " + json.dumps(out))
"""


def _reference_record_keys() -> set:
    """The keys of the record the reference's ``run_cell`` builds (read from
    its source: importing it would set this process's host device count)."""
    tree = ast.parse(open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "record"
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record literal in the reference's run_cell")


def _run(code: str, env_extra: dict):
    env = dict(os.environ, **env_extra)
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _payload(proc, tag: str) -> dict:
    out, err = proc.communicate(timeout=420)
    assert proc.returncode == 0, err[-4000:]
    line = next(ln for ln in out.splitlines() if ln.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


def _recompute_dots(name: str, rec: dict, ref: dict) -> None:
    """A train cell's dots: the step's without its recompute plus one
    grad-free forward of its loss; printed beside the reference's
    recomputed dots."""
    want = DOTS_LESS_RECOMPUTE[name] * ref["dot_flops"] + rec["forward_dots"]
    added = rec["dot_flops"] - DOTS_LESS_RECOMPUTE[name] * ref["dot_flops"]
    print(name, "dots", rec["dot_flops"], "against", want, "; the port's recompute adds",
          added, "(its grad-free forward", rec["forward_dots"], "), the reference's",
          ref["recomputed_dots"], "of", ref["dot_flops"])
    assert abs(rec["dot_flops"] / want - 1) <= FLOPS_REL_TOL, (name, rec["dot_flops"], want)


def test_reduced_gemma_cells_against_the_reference(runs):
    mine, theirs = runs["port"], runs["ref"]
    keys = _reference_record_keys()
    ratios = {}
    for name, rec in mine.items():
        assert keys <= set(rec), (name, keys - set(rec))
        assert rec["n_chips"] == 8 and rec["mesh"] == "2x4" and rec["hw"] == "h100_sxm"
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["arg_bytes_per_device"] == theirs[name]["arg"] - theirs[name]["host"], name
        assert rec["peak_bytes_per_device"] >= rec["arg_bytes_per_device"]
        ref = theirs[name]
        ratios[name] = (rec["per_device_flops"] / ref["flops"],
                        rec["dot_flops"] / ref["dot_flops"],
                        (rec["per_device_flops"] - rec["dot_flops"])
                        / (ref["flops"] - ref["dot_flops"]))
        for got, want in zip(ratios[name], EXPECTED[name]):
            assert abs(got / want - 1) <= FLOPS_REL_TOL, (name, ratios[name], EXPECTED[name])
    # the plain prefill replicates the sequence over "model"; sp splits it
    assert mine["prefill_sp"]["per_device_flops"] < 0.5 * mine["prefill"]["per_device_flops"]
    assert "all-gather" in mine["prefill_sp"]["collectives"]
    assert not mine["prefill"]["collectives"]
    _recompute_dots("train", mine["train"], theirs["train"])
    print("flops ratios port/reference:", json.dumps(ratios))


#: a port run over named cells (``CELLS``: name -> (arch, kind, batch, mesh)),
#: each reduced cell's record with its dot flops, or the op it failed at
_PORT_CELLS = r"""
import json, os, sys, tempfile
sys.path.insert(0, "src")
import torch.distributed as dist
from repro_torch.configs import get_config, smoke_shape
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.roofline import hlo_cost
""" + _FORWARD_DOTS + r"""
out = {}
with tempfile.TemporaryDirectory() as tmp:
    for name, (arch, kind, batch, mesh) in CELLS.items():
        spec = ShapeSpec("smoke_" + kind, kind, smoke_shape(kind).seq_len, batch)
        try:
            rec = dryrun.run_cell(arch, spec.name, cfg=get_config(arch).reduced(), shape=spec,
                                  mesh_shape=mesh, verbose=False, variant=name,
                                  save_trace_dir=tmp,
                                  **({"microbatches": 1} if kind == "train" else {}))
        except RuntimeError as e:
            out[name] = {"ok": False, "error": str(e).splitlines()[0]}
            continue
        pod = "pod2" if rec["multi_pod"] else "pod1"
        trace = hlo_cost.Trace.load(os.path.join(tmp, f"{arch}_{spec.name}_{pod}_{name}.json.gz"))
        rec["dot_flops"] = sum(hlo_cost.op_cost(r).flops for r in trace.records
                               if hlo_cost._base(r["op"]) in hlo_cost._DOTS)
        if kind == "train":
            rec["forward_dots"] = forward_dots(get_config(arch).reduced(), spec, mesh)
        out[name] = {"ok": True, **rec}
dist.destroy_process_group()
print(TAG + " " + json.dumps(out))
"""

#: the other families' cells, and the MoE serving cells (cheap) beside them
FAMILY_CELLS = {
    "zamba2-2.7b": ("zamba2-2.7b", "decode", 2, ((4, 2), ("data", "model"))),
    "qwen2-vl-2b": ("qwen2-vl-2b", "prefill", 2, ((2, 4), ("data", "model"))),
    "mamba2-2.7b": ("mamba2-2.7b", "train", 2, ((2, 2, 2), ("pod", "data", "model"))),
    "moe_prefill": MORE_CELLS["moe_prefill"],
    "moe_decode": MORE_CELLS["moe_decode"],
    "llama4_decode": MORE_CELLS["llama4_decode"],
}
#: the training cells, in a process of their own beside it
TRAIN_CELLS = {n: MORE_CELLS[n] for n in ("moe_train", "whisper_train", "moe_train_pod2")}


def _port_cells(cells: dict, tag: str):
    return _run(f"CELLS = {cells!r}\nTAG = {tag!r}\n" + _PORT_CELLS, {})


@pytest.fixture(scope="module")
def runs():
    """Every subprocess of this module, started together and read once."""
    procs = {"port": _run(_PORT, {}),
             "ref": _run(f"MORE_CELLS = {MORE_CELLS!r}\n" + _JAX, {"JAX_PLATFORMS": "cpu"}),
             "families": _port_cells(FAMILY_CELLS, "FAMILIES"),
             "train": _port_cells(TRAIN_CELLS, "TRAIN")}
    tags = {"port": "RECORDS", "ref": "REF", "families": "FAMILIES", "train": "TRAIN"}
    return {k: _payload(p, tags[k]) for k, p in procs.items()}


def test_other_families_cells_complete_or_name_their_op(runs):
    """zamba2's decode over a head-sharded KV cache (n_kv 2 over "model" 2:
    the new rows written shard-locally), qwen2-vl's M-RoPE prefill, mamba2's
    train step on a two-pod mesh, and deepseek-moe-16b's prefill (its
    dispatch global, its buffer shard-local) complete."""
    out = runs["families"]
    assert out["zamba2-2.7b"]["ok"] and out["zamba2-2.7b"]["mesh"] == "4x2"
    assert out["qwen2-vl-2b"]["ok"]
    assert out["mamba2-2.7b"]["ok"] and out["mamba2-2.7b"]["mesh"] == "2x2x2"
    assert out["moe_prefill"]["ok"], out["moe_prefill"]
    assert out["moe_prefill"]["arch"] == "deepseek-moe-16b"


@pytest.mark.parametrize("name", sorted(MORE_CELLS))
def test_reduced_moe_and_whisper_cells_against_the_reference(runs, name):
    """Per-device argument bytes exact (less the host-side step and bits),
    flops within 5 % of the cell's measured ratio, and the MoE cells'
    collectives of every kind the reference's have but the exempt ones."""
    rec = {**runs["families"], **runs["train"]}[name]
    ref = runs["ref"][name]
    assert rec["ok"], rec
    arch, kind, _, (shape, _) = MORE_CELLS[name]
    assert rec["arch"] == arch and rec["kind"] == kind
    assert rec["mesh"] == "x".join(map(str, shape)) and rec["n_chips"] == 8
    assert rec["arg_bytes_per_device"] == ref["arg"] - ref["host"], (name, rec, ref)
    assert rec["peak_bytes_per_device"] >= rec["arg_bytes_per_device"]
    ratios = (rec["per_device_flops"] / ref["flops"], rec["dot_flops"] / ref["dot_flops"],
              (rec["per_device_flops"] - rec["dot_flops"]) / (ref["flops"] - ref["dot_flops"]))
    print(name, "flops ratios port/reference:", ratios)
    if kind == "train":
        _recompute_dots(name, rec, ref)
    for got, want in zip(ratios, EXPECTED_MORE[name]):
        assert abs(got / want - 1) <= FLOPS_REL_TOL, (name, ratios, EXPECTED_MORE[name])
    if name in COLL_EXEMPT:
        missing = set(ref["kinds"]) - set(rec["collectives"]) - COLL_EXEMPT[name]
        assert not missing, (name, missing, ref["kinds"], sorted(rec["collectives"]))
        # the global dispatch: the routing ids are gathered whole on every rank
        assert "all-gather" in rec["collectives"], (name, rec["collectives"])
