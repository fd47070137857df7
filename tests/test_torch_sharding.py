"""The port's sharding rule engine (``repro_torch.dist.sharding``) against
``repro.dist.sharding``: every case of ``tests/test_sharding_rules.py`` on the
same fake mesh objects, then, for every architecture at full size with
abstract parameters (``jax.eval_shape`` of the reference's init against the
port's init on the ``meta`` device), the spec trees of ``params_specs`` (fsdp
on and off, ``fsdp_pod`` on and off), ``batch_specs``, ``decode_state_specs``
and ``optimizer.state_specs`` on meshes (16, 16), (2, 16, 16) and (2, 4),
leaf for leaf; gemma-2b's per-device argument bytes of its three cells; and
the placements ``to_named`` gives over a fake-world ``DeviceMesh`` (in a
subprocess, so no process group outlives the test)."""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import registry as jregistry
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.dist import sharding as sh
from repro_torch.launch import specs
from repro_torch.models import registry
from repro_torch.train import optimizer as opt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(configs.ARCH_MODULES)


@dataclasses.dataclass
class FakeMesh:
    """Only what the rule engine reads: axis_names + shape mapping."""
    axis_sizes: dict

    @property
    def axis_names(self):
        return tuple(self.axis_sizes)

    @property
    def shape(self):
        return self.axis_sizes


MESH = FakeMesh({"data": 16, "model": 16})
POD_MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
SMALL_MESH = FakeMesh({"data": 2, "model": 4})
MESHES = {"16x16": MESH, "2x16x16": POD_MESH, "2x4": SMALL_MESH}

# (function, args, kwargs, config name or None) — tests/test_sharding_rules.py's cases
RULE_CASES = {
    "heads_wq_qwen": ("_tp_heads_ok", ("wq", "@cfg", 16), {}, "qwen3-8b"),
    "heads_wk_qwen": ("_tp_heads_ok", ("wk", "@cfg", 16), {}, "qwen3-8b"),
    **{f"heads_{leaf}_whisper": ("_tp_heads_ok", (leaf, "@cfg", 16), {}, "whisper-tiny")
       for leaf in ("wq", "wk", "wv", "wo")},
    "wq_whisper": ("_weight_spec", ("wq", (384, 384), MESH),
                   dict(stacked=False, fsdp=True, fsdp_pod=False, cfg="@cfg"), "whisper-tiny"),
    "wq_qwen": ("_weight_spec", ("wq", (4096, 4096), MESH),
                dict(stacked=False, fsdp=True, fsdp_pod=False, cfg="@cfg"), "qwen3-8b"),
    "wq_no_cfg": ("_weight_spec", ("wq", (4096, 4096), MESH),
                  dict(stacked=False, fsdp=True, fsdp_pod=False), None),
    "vocab_indivisible": ("_weight_spec", ("lm_head", (384, 51865), MESH),
                          dict(stacked=False, fsdp=True, fsdp_pod=False), None),
    "mlp_shards": ("_weight_spec", ("w_gate", (2048, 16384), MESH),
                   dict(stacked=False, fsdp=True, fsdp_pod=False), None),
    "in_proj_never_tp": ("_weight_spec", ("in_proj", (2560, 10576), MESH),
                         dict(stacked=False, fsdp=True, fsdp_pod=False), None),
    "experts_ep": ("_weight_spec", ("w_gate", (64, 2048, 1408), MESH),
                   dict(stacked=False, fsdp=True, fsdp_pod=False), None),
    "fsdp_pod": ("_weight_spec", ("w_gate", (2048, 16384), POD_MESH),
                 dict(stacked=False, fsdp=True, fsdp_pod=True), None),
    "batch_pod_data": ("batch_spec", (POD_MESH, (256, 4096)), {}, None),
    "odd_batch": ("batch_spec", (MESH, (7, 128)), {}, None),
    "kv_seq": ("kv_cache_spec", (MESH, (128, 32768, 8, 128)), {}, None),
    "kv_heads": ("kv_cache_spec", (MESH, (128, 32768, 16, 128)), {}, None),
    "stacked": ("_weight_spec", ("wq", (18, 4096, 4096), MESH),
                dict(stacked=True, fsdp=True, fsdp_pod=False, cfg="@cfg"), "qwen3-8b"),
}


def _bind(x, cfg):
    return cfg if isinstance(x, str) and x == "@cfg" else x


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_cases_equal_the_reference(case):
    fn, args, kwargs, cfg_name = RULE_CASES[case]
    out = {}
    for mod, cfgs in ((sh, configs), (jsh, jconfigs)):
        cfg = cfgs.get_config(cfg_name) if cfg_name else None
        out[mod] = getattr(mod, fn)(*[_bind(a, cfg) for a in args],
                                    **{k: _bind(v, cfg) for k, v in kwargs.items()})
    mine, ref = out[sh], out[jsh]
    if isinstance(ref, bool):
        assert mine is ref
    else:
        assert isinstance(mine, sh.PartitionSpec) and tuple(mine) == tuple(ref), (mine, ref)


def test_rule_case_values():
    """The reference test's literal expectations hold for the port too."""
    P = sh.P
    assert sh.batch_spec(POD_MESH, (256, 4096)) == P(("pod", "data"), None)
    assert sh.kv_cache_spec(MESH, (128, 32768, 8, 128)) == P(("data",), ("model",), None, None)
    assert sh._weight_spec("in_proj", (2560, 10576), MESH, stacked=False, fsdp=True,
                           fsdp_pod=False)[1] is None


# ---------------------------------------------------------------------------
# whole trees, every architecture at full size
# ---------------------------------------------------------------------------


def _jkey(e) -> str:
    if isinstance(e, jax.tree_util.DictKey):
        return f"[{e.key!r}]"
    if isinstance(e, jax.tree_util.SequenceKey):
        return f"[{e.idx}]"
    return f".{e.name}"


def _tkey(e) -> str:
    if hasattr(e, "key"):
        return f"[{e.key!r}]"
    if hasattr(e, "idx"):
        return f"[{e.idx}]"
    return f".{e.name}"


def jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"".join(map(_jkey, p)): tuple(s) for p, s in flat}


def port_specs(tree) -> dict:
    out = {}

    def rec(path, s):
        assert isinstance(s, sh.PartitionSpec), (path, s)
        out["".join(map(_tkey, path))] = tuple(s)

    sh.map_with_path(rec, tree)
    return out


_PARAMS: dict = {}


def _params(arch):
    if arch not in _PARAMS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        japi = jregistry.get_api(jcfg)
        jp = jax.eval_shape(lambda k: japi.init(jcfg, k), jax.random.key(0))
        tp = registry.get_api(cfg).init(cfg, torch.Generator(), device="meta")
        _PARAMS[arch] = (cfg, jcfg, tp, jp)
    return _PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_trees_equal_the_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg, jcfg, tp, jp = _params(arch)
    for fsdp in (True, False):
        for fsdp_pod in (True, False):
            mine = sh.params_specs(tp, mesh, cfg, fsdp=fsdp, fsdp_pod=fsdp_pod)
            ref = jsh.params_specs(jp, mesh, jcfg, fsdp=fsdp, fsdp_pod=fsdp_pod)
            assert port_specs(mine) == jax_specs(ref), (fsdp, fsdp_pod)
    # the optimizer state: the port keeps the moments as lists in leaves order
    pspec = sh.params_specs(tp, mesh, cfg, fsdp=True, fsdp_pod=True)
    jpspec = jsh.params_specs(jp, mesh, jcfg, fsdp=True, fsdp_pod=True)
    ostate = opt.init(opt.OptimizerConfig(state_dtype="bfloat16"), tp)
    jostate = jax.eval_shape(lambda p: jopt.init(jopt.OptimizerConfig(), p), jp)
    mine, ref = opt.state_specs(ostate, pspec), jopt.state_specs(jostate, jpspec)
    assert set(mine) == set(ref) == {"step", "m", "v"} and tuple(mine["step"]) == tuple(ref["step"])
    for k in ("m", "v"):
        flat = jax.tree.leaves(ref[k], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [tuple(s) for s in mine[k]] == [tuple(s) for s in flat]
    # batches of every applicable shape, and the decode states
    for s in configs.applicable_shapes(cfg):
        js = jconfigs.SHAPES[s.name]
        fn = {"train": "train_batch", "prefill": "prefill_inputs", "decode": "decode_inputs"}[s.kind]
        inp, jinp = getattr(specs, fn)(cfg, s), getattr(jspecs, fn)(jcfg, js)
        if s.kind == "decode":
            assert port_specs(sh.decode_state_specs(inp["state"], mesh)) == jax_specs(
                jsh.decode_state_specs(jinp["state"], mesh))
            inp, jinp = inp["token"], jinp["token"]
        assert port_specs(sh.batch_specs(inp, mesh)) == jax_specs(jsh.batch_specs(jinp, mesh))


def _spec_bytes(tree, spec_tree, sizes, flatten) -> int:
    total = 0
    for x, s in zip(*flatten(tree, spec_tree)):
        n = math.prod(x.shape) * x.dtype.itemsize
        for entry in s:
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                n //= sizes[a]
        total += n
    return total


def test_gemma_cell_argument_bytes_equal_the_references_specs():
    """Per-device argument bytes of gemma-2b's train, prefill and decode
    cells (params, optimizer state, inputs) from the port's specs over its
    meta tensors equal those from the reference's specs over its abstract
    shapes, on the single-pod mesh."""
    from repro.launch import dryrun as jdry
    from repro.quant import apply as jqapply
    from repro_torch.launch import dryrun
    from repro_torch.quant import apply as qapply

    cfg, jcfg, tp, jp = _params("gemma-2b")
    sizes = {"data": 16, "model": 16}

    def jflat(tree, spec_tree):
        leaves = jax.tree.leaves(tree)
        specs_ = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return leaves, specs_

    def tflat(tree, spec_tree):
        pairs = []

        def rec(t, s):
            if isinstance(s, sh.PartitionSpec):
                if isinstance(t, torch.Tensor):
                    pairs.append((t, s))
                return
            if isinstance(t, dict):
                for k in t:
                    rec(t[k], s[k])
            elif isinstance(t, (list, tuple)):
                for a, b in zip(t, s):
                    rec(a, b)
            elif dataclasses.is_dataclass(t):
                for f in dataclasses.fields(t):
                    if isinstance(getattr(t, f.name), torch.Tensor):
                        rec(getattr(t, f.name), getattr(s, f.name))

        rec(tree, spec_tree)
        return [p[0] for p in pairs], [p[1] for p in pairs]

    # train: params + Adam state (bf16 moments, the dry-run's) + batch
    pspec = sh.params_specs(tp, MESH, cfg, fsdp=True, fsdp_pod=True)
    jpspec = jsh.params_specs(jp, MESH, jcfg, fsdp=True, fsdp_pod=True)
    ost = opt.init(opt.OptimizerConfig(state_dtype="bfloat16"), tp)
    jost = jax.eval_shape(lambda p: jopt.init(jopt.OptimizerConfig(state_dtype="bfloat16"), p), jp)
    ospec, jospec = opt.state_specs(ost, pspec), jopt.state_specs(jost, jpspec)
    shape, jshape = configs.SHAPES["train_4k"], jconfigs.SHAPES["train_4k"]
    batch, jbatch = specs.train_batch(cfg, shape), jspecs.train_batch(jcfg, jshape)
    mine = sum(_spec_bytes(t, s, sizes, tflat) for t, s in
               ((tp, pspec), ({"m": ost["m"], "v": ost["v"]}, {"m": ospec["m"], "v": ospec["v"]}),
                (batch, sh.batch_specs(batch, MESH))))
    ref = sum(_spec_bytes(t, s, sizes, jflat) for t, s in
              ((jp, jpspec), ({"m": jost["m"], "v": jost["v"]}, {"m": jospec["m"], "v": jospec["v"]}),
               (jbatch, jsh.batch_specs(jbatch, MESH))))
    assert mine == ref and mine > 0

    # serve cells: mixed-policy packed params (replicated) + inputs / state
    sp = dryrun._abstract_serve_params(
        cfg, dryrun.dryrun_policy(qapply.layer_specs(tp, cfg), "mixed"))
    jpolicy = jdry.dryrun_policy(jqapply.layer_specs(jp, jcfg), "mixed")
    jsp = jax.eval_shape(lambda p: jqapply.quantize_for_serve(
        jregistry.get_api(jcfg).unstack(p, jcfg), jpolicy, jcfg), jp)
    psp, jpsp = sh.params_specs(sp, MESH, cfg, fsdp=False), jsh.params_specs(jsp, MESH, jcfg,
                                                                            fsdp=False)
    p_bytes = _spec_bytes(sp, psp, sizes, tflat)
    assert p_bytes == _spec_bytes(jsp, jpsp, sizes, jflat)
    pre, jpre = specs.prefill_inputs(cfg, configs.SHAPES["prefill_32k"]), jspecs.prefill_inputs(
        jcfg, jconfigs.SHAPES["prefill_32k"])
    assert _spec_bytes(pre, sh.batch_specs(pre, MESH), sizes, tflat) == _spec_bytes(
        jpre, jsh.batch_specs(jpre, MESH), sizes, jflat)
    dec, jdec = specs.decode_inputs(cfg, configs.SHAPES["decode_32k"]), jspecs.decode_inputs(
        jcfg, jconfigs.SHAPES["decode_32k"])
    assert _spec_bytes(dec["state"], sh.decode_state_specs(dec["state"], MESH), sizes,
                       tflat) == _spec_bytes(jdec["state"], jsh.decode_state_specs(
                           jdec["state"], MESH), sizes, jflat)


_PLACEMENTS = r"""
import sys; sys.path.insert(0, "src")
import torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, DTensor
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as mesh_mod
import repro_torch.launch.dryrun  # noqa: F401  (importing starts no group)
assert not dist.is_initialized()
try:
    mesh_mod.make_mesh_for((2, 4), ("data", "model"))
except RuntimeError as e:
    assert "fake world" in str(e), e
else:
    raise AssertionError("a mesh without a world")
mesh_mod.fake_world(16)
mesh = mesh_mod.make_mesh_for((2, 2, 4), ("pod", "data", "model"))
P = sh.P
named = sh.to_named({"w": P(("pod", "data"), ("model",)), "b": P()}, mesh)
assert named["w"].placements == (Shard(0), Shard(0), Shard(1)), named["w"].placements
assert named["b"].placements == (Replicate(),) * 3
x = torch.empty(8, 12, device="meta")
d = sh.distribute({"w": x}, {"w": P(("pod", "data"), ("model",))}, mesh)["w"]
assert isinstance(d, DTensor) and d.to_local().shape == (2, 3) and d.shape == (8, 12)
# placed on the view with the batch axes as one dim, ranks in the same order
assert d.device_mesh.mesh_dim_names == ("pod_data", "model"), d.device_mesh
assert d.placements == (Shard(0), Shard(1)) and sh.placement_mesh(mesh) is d.device_mesh
assert d.device_mesh.mesh.flatten().tolist() == mesh.mesh.flatten().tolist()
try:
    sh.NamedSharding(d.device_mesh, P("data", None)).placements
except ValueError as e:
    assert "not whole dims" in str(e), e
else:
    raise AssertionError("'data' alone on the merged view")
with sh.activation_axes(mesh):
    r = sh.shard_batch_act(DTensor.from_local(torch.empty(8, 3, device="meta"), mesh,
                           [Replicate()] * 3, run_check=False))
    assert r.placements == (Shard(0), Shard(0), Replicate()), r.placements
    plain = torch.zeros(3)
    assert sh.shard_batch_act(plain) is plain
dist.destroy_process_group()
print("OK")
"""


def test_placements_over_a_fake_world_mesh():
    out = subprocess.run([sys.executable, "-c", _PLACEMENTS], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


def test_shard_batch_act_is_the_identity_without_a_scope():
    x = torch.randn(4, 3)
    assert sh.shard_batch_act(x) is x
    assert not sh._ACT_MESH
    with sh.activation_axes(MESH):
        assert sh.shard_batch_act(x) is x      # a plain tensor is never redistributed
    assert not sh._ACT_MESH
