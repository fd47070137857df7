"""The port's sequence-parallel prefill (``repro_torch.models.decoder.prefill_sp``)
against the reference's, as ``tests/test_sp_prefill.py`` runs it.

The reference runs ``prefill_sp`` on 4 host devices, mesh (2, 2) ("data",
"model"), in a JAX subprocess; the port runs it SPMD on a gloo world of 4
ranks (4 processes, each its own block), from the same weights carried
across with ``convert.params_from_numpy``: reduced gemma-2b, qwen3-8b and
deepseek-moe-16b in f32, B 4, S 64.  Logits match at atol = rtol = 3e-4 and
layer 0's K/V at atol 3e-5 (the reference test's tolerances).  The dense
families are also held against the port's own ``prefill`` (the MoE family
is not: its expert capacity is per shard).  Under ``CostMode`` on a fake
world of 4, each layer shows the two all-gathers of B_loc * S * n_kv * hd
elements that the reference's docstring counts.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma-2b", "qwen3-8b", "deepseek-moe-16b")

_JAX = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh_for
from repro.models import decoder
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for arch in sys.argv[3:]:
    r = inp[arch]
    cfg = get_config(arch).reduced()
    sp = jax.tree.map(jnp.asarray, r["params"])
    mesh = make_mesh_for((2, 2), ("data", "model"))
    with mesh:
        logits, caches = decoder.prefill_sp(sp, cfg, jnp.asarray(r["tokens"]), mesh=mesh)
    out[arch] = {"logits": np.asarray(logits), "k0": np.asarray(caches[0]["k"]),
                 "v0": np.asarray(caches[0]["v"])}
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX OK")
"""

_RANK = r"""
import pickle, sys
sys.path.insert(0, "src")
import torch, torch.distributed as dist
rank, path, init, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import decoder
ref = pickle.load(open(path, "rb"))
mesh = make_mesh_for((2, 2), ("data", "model"))
assert mesh.get_group("model").size() == 2
out = {}
for arch, r in ref.items():
    cfg = get_config(arch).reduced()
    params = params_from_numpy(r["params"], device="cpu")
    tokens = torch.from_numpy(np.asarray(r["tokens"]))
    logits, caches = decoder.prefill_sp(params, cfg, tokens, mesh=mesh)
    full = {"logits": logits.full_tensor().numpy(), "k0": caches[0]["k"].full_tensor().numpy(),
            "v0": caches[0]["v"].full_tensor().numpy(),
            "local_k0": tuple(caches[0]["k"].to_local().shape)}
    if cfg.family != "moe" and rank == 0:
        pl, pc = decoder.prefill(params, cfg, tokens)
        full.update(prefill_logits=pl.numpy(), prefill_k0=pc[0]["k"].numpy())
    out[arch] = full
if rank == 0:
    pickle.dump(out, open(dst, "wb"))
dist.destroy_process_group()
print("RANK OK")
""".replace("import torch,", "import numpy as np, torch,")

_COUNT = r"""
import json, sys
sys.path.insert(0, "src")
import torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh_for
from repro_torch.models import decoder
from repro_torch.quant.apply import layer_specs
from repro_torch.roofline import hlo_cost
fake_world(4)
mesh = make_mesh_for((2, 2), ("data", "model"))
res = {}
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    policy = dryrun.dryrun_policy(layer_specs(dryrun._abstract_params(cfg), cfg), "mixed")
    sp = dryrun._abstract_serve_params(cfg, policy)
    tokens = torch.empty((4, 64), dtype=torch.int32, device="meta")
    with hlo_cost.CostMode() as mode:
        decoder.prefill_sp(sp, cfg, tokens, mesh=mesh, impl="torch")
    gathers = [r for r in mode.trace.records if r.get("coll") == "all-gather"]
    res[arch] = {"sizes": [int(np.prod(r["out"][0][0])) for r in gathers],
                 "groups": [r["group"] for r in gathers], "layers": cfg.n_layers,
                 "expect": 2 * 64 * cfg.n_kv_heads * cfg.resolved_head_dim}
dist.destroy_process_group()
print("COUNT " + json.dumps(res))
""".replace("import torch,", "import numpy as np, torch,")


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu")


def _inputs() -> dict:
    """Each architecture's weights (the reference's init, unstacked) and
    tokens, as numpy: what both packages' runs start from."""
    import jax

    from repro.configs import get_config
    from repro.models import registry

    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        api = registry.get_api(cfg)
        sp = api.unstack(api.init(cfg, jax.random.key(0)), cfg)
        tokens = jax.random.randint(jax.random.key(1), (4, 64), 0, cfg.vocab_size)
        out[arch] = {"params": jax.tree.map(np.asarray, sp), "tokens": np.asarray(tokens)}
    return out


def _start(code: str, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)], cwd=ROOT, env=_env(),
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc: subprocess.Popen, marker: str) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and marker in out, err[-3000:]
    return out


def test_sp_prefill_matches_the_reference(tmp_path):
    inp, dst = tmp_path / "inputs.pkl", tmp_path / "port.pkl"
    pickle.dump(_inputs(), open(inp, "wb"))
    init = f"file://{tmp_path / 'store'}"
    # one JAX process an architecture (the MoE one compiles longest), the
    # port's four ranks and the fake-world count, side by side
    refs = {a: _start(_JAX, inp, tmp_path / f"ref_{a}.pkl", a) for a in ARCHS}
    count = _start(f"ARCHS = {ARCHS!r}\n" + _COUNT)
    ranks = [_start(_RANK, r, inp, init, dst) for r in range(4)]
    for p in [*refs.values(), *ranks]:
        _finish(p, "OK")
    ref = {a: pickle.load(open(tmp_path / f"ref_{a}.pkl", "rb"))[a] for a in ARCHS}
    mine = pickle.load(open(dst, "rb"))
    for arch in ARCHS:
        r, m = ref[arch], mine[arch]
        np.testing.assert_allclose(m["logits"], r["logits"], atol=3e-4, rtol=3e-4,
                                   err_msg=arch)
        np.testing.assert_allclose(m["k0"], r["k0"], atol=3e-5, err_msg=arch)
        np.testing.assert_allclose(m["v0"], r["v0"], atol=3e-5, err_msg=arch)
        assert m["local_k0"][:2] == (2, 32), m["local_k0"]      # (B/2, S/2): sequence-sharded
        if "prefill_logits" in m:
            np.testing.assert_allclose(m["logits"], m["prefill_logits"], atol=3e-4, rtol=3e-4,
                                       err_msg=arch)
            np.testing.assert_allclose(m["k0"], m["prefill_k0"], atol=3e-5, err_msg=arch)
    assert {a for a in ARCHS if "prefill_logits" in mine[a]} == {"gemma-2b", "qwen3-8b"}

    out = _finish(count, "COUNT ")
    res = json.loads(next(ln for ln in out.splitlines() if ln.startswith("COUNT "))[6:])
    for arch, r in res.items():
        per_layer = [s for s in r["sizes"] if s == r["expect"]]
        assert len(per_layer) == 2 * r["layers"], (arch, r)
        assert all(g == 2 for g in r["groups"]), r
