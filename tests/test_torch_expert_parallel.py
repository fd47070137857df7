"""The MoE layer on DTensors (``dist/expert_parallel.py``) against the same
layer on plain tensors, on a real world of 4 gloo ranks as a (2, 2)
``("data", "model")`` mesh: the output and every gradient agree, with a router
skewed so that capacity drops assignments (the dispatch is global: a
per-shard capacity would drop others).  Three layouts: training's (FSDP
``d_in`` over "data", E over "model", 4-bit fake-quant), serving's (every
weight whole), and packed 4-bit stacks with E over "model".  The world lives
in a subprocess."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: max |DTensor - plain| over max |plain|, for the output and each gradient
REL_TOL = 2e-6

_WORLD = r"""
import json, os, sys, tempfile
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, init, out):
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.models import moe
    from repro_torch.quant.tensor import QuantizedTensor, quantize_tensor

    cfg = get_config("deepseek-moe-16b").reduced()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    p = moe.moe_init(g, cfg, device="cpu")
    x = torch.randn(4, 8, cfg.d_model, generator=g)
    # two experts favoured: capacity drops assignments of the crowded ones
    p["router"] = p["router"] + 0.4 * x.reshape(32, -1).mean(0)[:, None] * torch.tensor(
        [1.0, 0.75] + [0.0] * (cfg.n_experts - 2))
    c = moe.capacity(32, cfg)
    drops = int((~moe.dispatch(moe._route(p, x.reshape(32, -1), cfg)[2], cfg.n_experts, c)[4]).sum())
    results = {}
    for case in ("train", "serve", "packed"):
        pc = dict(p)
        bits = {"w_gate": 4, "w_up": 4, "w_down": 4} if case == "train" else None
        if case == "packed":
            pc.update({n: quantize_tensor(p[n], 4) for n in ("w_gate", "w_up", "w_down")})
        spec = sharding.params_specs({"layers": [{"mlp": pc}]}, mesh, cfg,
                                     fsdp=case == "train")["layers"][0]["mlp"]

        def place(v, s):
            if isinstance(v, QuantizedTensor):   # E over "model", the scale whole
                return QuantizedTensor(distribute_tensor(v.packed, mesh, [Replicate(), Shard(0)]),
                                       distribute_tensor(v.scale, mesh, [Replicate()] * 2),
                                       v.bits, v.shape)
            if isinstance(v, dict):
                return {kk: place(vv, s[kk]) for kk, vv in v.items()}
            return distribute_tensor(v, mesh, sharding.NamedSharding(mesh, s).placements
                                     ).requires_grad_(True)

        dp = {k: place(v, spec[k]) for k, v in pc.items()}
        dx = distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_(True)
        with sharding.activation_axes(mesh), implicit_replication():
            y = moe.moe_mlp(dp, dx, cfg, bits=bits, impl="torch")
            (y ** 2).sum().backward()

        def plain(v):
            if isinstance(v, dict):
                return {kk: plain(vv) for kk, vv in v.items()}
            return v if isinstance(v, QuantizedTensor) else v.clone().requires_grad_(True)

        pp = {k: plain(v) for k, v in pc.items()}
        xp = x.clone().requires_grad_(True)
        yp = moe.moe_mlp(pp, xp, cfg, bits=bits, impl="torch")
        (yp ** 2).sum().backward()

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        errs = {"y": rel(y.full_tensor(), yp), "dx": rel(dx.grad.full_tensor(), xp.grad),
                "router": rel(dp["router"].grad.full_tensor(), pp["router"].grad)}
        errs.update({"shared." + n: rel(dp["shared"][n].grad.full_tensor(), pp["shared"][n].grad)
                     for n in pp["shared"]})
        if case != "packed":
            errs.update({n: rel(dp[n].grad.full_tensor(), pp[n].grad)
                         for n in ("w_gate", "w_up", "w_down")})
        results[case] = errs
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"drops": drops, "cases": results}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "out.json")
    mp.spawn(run, args=(os.path.join(tmp, "init"), out), nprocs=4)
    print("WORLD " + open(out).read())
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    script = tmp_path_factory.mktemp("world") / "world.py"   # spawned ranks import it
    script.write_text(_WORLD)
    res = subprocess.run([sys.executable, str(script)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("WORLD "))
    return json.loads(line[len("WORLD "):])


def test_the_skewed_router_drops_assignments(world):
    assert world["drops"] > 0


@pytest.mark.parametrize("case", ("train", "serve", "packed"))
def test_dtensor_moe_equals_the_plain_layer(world, case):
    errs = world["cases"][case]
    assert {"y", "dx", "router"} <= set(errs)
    assert case == "packed" or {"w_gate", "w_up", "w_down"} <= set(errs)
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    assert not bad, (case, bad)
