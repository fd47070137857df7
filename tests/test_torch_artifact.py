"""Port parity of policy artifacts and their deployment checks.

Artifacts v1-v6 written by the JAX package load in the port with equal
fields and hashes, and the port's load in the JAX package; both write the
same JSON text.  Malformed artifacts and provenance are refused with the
JAX package's message.  ``verify_packed_bits``, ``verify_state_bits`` and
``quantize_for_serve(artifact)`` agree with the JAX package on reduced
gemma-2b, and the port's ``launch/serve.py --policy --device cpu`` serves a
JAX-written artifact.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import policy as jpol
from repro.kvcache import policy as jkvpol
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.kvcache import policy as tkvpol
from repro_torch.kvcache import state_layer_infos
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.quant import apply as tapply
from repro_torch.serve.lifecycle import ShedPolicy

torch.set_num_threads(2)

SLOTS, SEQ = 3, 64
PROV = {"schema": 1, "backend": "shift_add", "seed": 0, "limits": {"size_mib": 0.5},
        "config": {"phase2_max_iters": 10},
        "phases": {"weight": {"iterations": 7, "digest": "ab12cd34ef56ab78", "success": True}}}
KERNEL_CONFIGS = [{"key": {"family": "decode_step", "k_bits": 8, "v_bits": 4, "heads": 2,
                           "head_dim": 32, "block": 16, "impl": "xla"},
                   "config": {"place": "select", "attend": "substitute"}, "micros": 12.5,
                   "candidates": 4}]


def _jax(p):
    """A port policy as the JAX package's, through its JSON."""
    return None if p is None else jpol.BitPolicy.from_json(p.to_json())


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdecoder.init(jcfg, jax.random.key(6))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    specs = tapply.layer_specs(tp, tcfg)
    policy = dryrun_policy(specs, "mixed")
    infos = state_layer_infos(tcfg, SLOTS, SEQ)
    state = tpol.BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                             for l in infos})
    draft = tpol.BitPolicy.from_bits(specs, {s.name: 2 if "mlp" in s.name else 4
                                             for s in specs})
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, specs=specs, policy=policy, state=state,
                draft=draft)


def _build_kw(m, pkg):
    """The full v6 argument set, as ``pkg``'s types."""
    conv = (lambda p: p) if pkg is tpol else _jax
    budget = pkg.Budget(acc_t=0.9, items=(pkg.BudgetItem("size_mib", 0.5, 0.08),
                                          pkg.BudgetItem("state_bytes", 9000.0, strict=False)))
    return dict(backend="roofline", report={"size_mib": 0.25, "state_bytes": 8192.0},
                budget=budget, state_policy=conv(m["state"]),
                pool={"block": 16, "num_blocks": 12}, draft_policy=conv(m["draft"]), draft_k=3,
                kernel_configs=KERNEL_CONFIGS, provenance=PROV, meta={"arch": "gemma-2b"})


def _at_version(text: str, version: int) -> str:
    """A v6 artifact's JSON cut down to an older layout (the fields that
    version did not have removed)."""
    doc = json.loads(text)
    doc["artifact_version"] = version
    drop = {5: ["provenance"], 4: ["kernel_configs"], 3: ["draft_policy", "draft_k"],
            2: ["pool"], 1: ["state_policy", "state_registry_hash"]}
    for v, keys in drop.items():
        if version <= v:
            for key in keys:
                del doc[key]
    return json.dumps(doc, indent=2)


def _fields(art) -> dict:
    def pol(p):
        return None if p is None else json.loads(p.to_json())

    return {"policy": pol(art.policy), "registry_hash": art.registry_hash,
            "backend": art.backend, "report": art.report,
            "budget": art.budget.to_dict() if art.budget else None,
            "state_policy": pol(art.state_policy),
            "state_registry_hash": art.state_registry_hash, "pool": art.pool,
            "draft_policy": pol(art.draft_policy), "draft_k": art.draft_k,
            "kernel_configs": art.kernel_configs, "provenance": art.provenance,
            "meta": art.meta, "version": art.version}


def test_both_packages_build_the_same_artifact_text(model):
    jart = jpol.PolicyArtifact.build(_jax(model["policy"]), **_build_kw(model, jpol))
    tart = tpol.PolicyArtifact.build(model["policy"], **_build_kw(model, tpol))
    assert tart.to_json() == jart.to_json()
    assert tart.registry_hash == jpol.layer_registry_hash(_jax(model["policy"]).layers)
    assert tpol.ARTIFACT_VERSION == jpol.ARTIFACT_VERSION == 6
    assert tpol.READABLE_ARTIFACT_VERSIONS == jpol.READABLE_ARTIFACT_VERSIONS
    assert tpol.COST_METRICS == jpol.COST_METRICS


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5, 6])
def test_artifact_versions_cross_between_packages(model, version, tmp_path):
    jart = jpol.PolicyArtifact.build(_jax(model["policy"]), **_build_kw(model, jpol))
    text = _at_version(jart.to_json(), version)
    # written by the JAX package, read by the port (through a file)
    path = tmp_path / "art.json"
    path.write_text(text)
    tart = tpol.PolicyArtifact.load(str(path))
    want = jpol.PolicyArtifact.from_json(text)
    assert _fields(tart) == _fields(want)
    assert tart.version == version
    # written by the port, read by the JAX package
    back = jpol.PolicyArtifact.load(tart.save(str(tmp_path / "back.json")))
    assert _fields(back) == _fields(tart)
    assert tart.to_json() == want.to_json()


def test_budget_and_targets_agree(model):
    tb = tpol.Budget.of(0.9, size_mib=4, latency_s=2e-3)
    jb = jpol.Budget.of(0.9, size_mib=4, latency_s=2e-3)
    assert tb.to_dict() == jb.to_dict()
    costs = {"size_mib": 5.0, "latency_s": 1e-3}
    assert tb.violations(costs) == jb.violations(costs)
    assert tb.worst(costs) == jb.worst(costs)
    assert tb.badness(0.8, costs) == jb.badness(0.8, costs)
    assert tb.res_ok(costs, buffered=True) == jb.res_ok(costs, buffered=True)
    assert (tpol.Targets(0.9, 3.0).to_budget().to_dict()
            == jpol.Targets(0.9, 3.0).to_budget().to_dict())
    assert model["policy"].model_size_mib() == _jax(model["policy"]).model_size_mib()


def _raises_alike(jfn, tfn):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as jerr:
        jfn()
    with pytest.raises(Exception) as terr:
        tfn()
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


@pytest.mark.parametrize("mutate", [
    lambda p: "not-a-mapping",
    lambda p: {k: v for k, v in p.items() if k != "phases"},
    lambda p: dict(p, phases=[1, 2]),
    lambda p: dict(p, phases={"weight": "nope"}),
    lambda p: dict(p, phases={"weight": {"iterations": -1, "digest": "ab"}}),
    lambda p: dict(p, phases={"weight": {"iterations": True, "digest": "ab"}}),
    lambda p: dict(p, phases={"weight": {"iterations": 3, "digest": ""}}),
], ids=["mapping", "phases_missing", "phases_list", "record", "iterations", "bool_iterations",
        "digest"])
def test_malformed_provenance_refused_alike(model, mutate):
    bad = mutate(dict(PROV))
    msg = _raises_alike(lambda: jpol.PolicyArtifact.build(_jax(model["policy"]), provenance=bad),
                        lambda: tpol.PolicyArtifact.build(model["policy"], provenance=bad))
    assert "provenance" in msg
    doc = json.loads(tpol.PolicyArtifact.build(model["policy"], provenance=PROV).to_json())
    doc["provenance"] = bad
    _raises_alike(lambda: jpol.PolicyArtifact.from_json(json.dumps(doc)),
                  lambda: tpol.PolicyArtifact.from_json(json.dumps(doc)))


@pytest.mark.parametrize("case", ["version", "pool_keys", "pool_without_state", "k_alone",
                                  "draft_alone", "draft_registry", "kernel_configs",
                                  "unknown_metric"])
def test_malformed_artifacts_refused_alike(model, case):
    other = (tpol.LayerInfo("other.w", (8, 8), macs=1),)

    def make(pkg):
        conv = (lambda p: p) if pkg is tpol else _jax
        pol, state = conv(model["policy"]), conv(model["state"])
        if case == "version":
            doc = json.loads(pkg.PolicyArtifact.build(pol).to_json())
            doc["artifact_version"] = 7
            return lambda: pkg.PolicyArtifact.from_json(json.dumps(doc))
        if case == "pool_keys":
            return lambda: pkg.PolicyArtifact.build(pol, state_policy=state, pool={"block": 16})
        if case == "pool_without_state":
            return lambda: pkg.PolicyArtifact.build(pol, pool={"block": 16, "num_blocks": 4})
        if case == "k_alone":
            return lambda: pkg.PolicyArtifact.build(pol, draft_k=2)
        if case == "draft_alone":
            return lambda: pkg.PolicyArtifact.build(pol, draft_policy=pol)
        if case == "draft_registry":
            foreign = conv(tpol.BitPolicy.uniform(other, 2))
            return lambda: pkg.PolicyArtifact.build(pol, draft_policy=foreign, draft_k=2)
        if case == "kernel_configs":
            return lambda: pkg.PolicyArtifact.build(pol, kernel_configs=[{"key": {}}])
        return lambda: pkg.Budget.of(0.9, watts=3)

    _raises_alike(make(jpol), make(tpol))


def test_verify_layers_and_state_layers_refuse_a_foreign_registry(model):
    tart = tpol.PolicyArtifact.build(model["policy"], state_policy=model["state"])
    jart = jpol.PolicyArtifact.from_json(tart.to_json())
    tart.verify_layers(model["specs"])
    jart.verify_layers(_jax(model["policy"]).layers)
    tart.verify_state_layers(model["state"].layers)
    cut = model["specs"][1:]
    _raises_alike(lambda: jart.verify_layers(_jax(tpol.BitPolicy.uniform(cut, 4)).layers),
                  lambda: tart.verify_layers(cut))
    wide = state_layer_infos(model["tcfg"], SLOTS + 1, SEQ)
    _raises_alike(lambda: jart.verify_state_layers(_jax(tpol.BitPolicy.uniform(wide, 4)).layers),
                  lambda: tart.verify_state_layers(wide))
    bare = tpol.PolicyArtifact.build(model["policy"])
    _raises_alike(lambda: jpol.PolicyArtifact.from_json(bare.to_json()).verify_state_layers(()),
                  lambda: bare.verify_state_layers(()))
    # the surface hash ignores slots and max_seq, not the head geometry
    assert (tkvpol.state_surface_hash(wide) == tkvpol.state_surface_hash(model["state"].layers)
            == jkvpol.state_surface_hash(_jax(tpol.BitPolicy.uniform(wide, 4)).layers))


def _serve_trees(m, policy):
    """The JAX serve tree packed under ``policy`` and its port twin."""
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(m["jp"], m["jcfg"]),
                                       _jax(policy), m["jcfg"])
    return jserve, params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")


def test_quantize_for_serve_takes_an_artifact(model):
    tart = tpol.PolicyArtifact.build(model["policy"], draft_policy=model["draft"], draft_k=2)
    got = tapply.quantize_for_serve(tdecoder.unstack_layers(model["tp"], model["tcfg"]), tart,
                                    model["tcfg"])
    jserve, want = _serve_trees(model, model["policy"])
    leaves = [(p, leaf) for p, leaf in tapply._walk(got) if hasattr(leaf, "packed")]
    assert len(leaves) == len(model["specs"])
    flat_want = dict(tapply._walk(want))
    for path, leaf in leaves:
        ref = flat_want[path]
        assert leaf.bits == ref.bits and leaf.shape == ref.shape
        assert torch.equal(leaf.packed, ref.packed), path
        assert torch.equal(leaf.scale, ref.scale), path
    assert tapply.packed_policy_bits(got) == japply.packed_policy_bits(jserve)


def test_verify_packed_bits_agrees_with_jax(model):
    tart = tpol.PolicyArtifact.build(model["policy"])
    jart = jpol.PolicyArtifact.from_json(tart.to_json())
    jserve, tserve = _serve_trees(model, model["policy"])
    tapply.verify_packed_bits(tserve, tart)
    japply.verify_packed_bits(jserve, jart)
    tapply.verify_packed_bits(tapply.fuse_projections(tserve), tart)   # fused leaves expand
    # packed at other widths
    j8, t8 = _serve_trees(model, tpol.BitPolicy.uniform(model["specs"], 8))
    msg = _raises_alike(lambda: japply.verify_packed_bits(j8, jart),
                        lambda: tapply.verify_packed_bits(t8, tart))
    assert "disagree" in msg
    # never packed (a float tree)
    jfp = jdecoder.unstack_layers(model["jp"], model["jcfg"])
    tfp = tdecoder.unstack_layers(model["tp"], model["tcfg"])
    msg = _raises_alike(lambda: japply.verify_packed_bits(jfp, jart),
                        lambda: tapply.verify_packed_bits(tfp, tart))
    assert "not packed" in msg


def test_verify_state_bits_agrees_with_jax(model):
    tcfg, jcfg = model["tcfg"], model["jcfg"]
    tart = tpol.PolicyArtifact.build(model["policy"], state_policy=model["state"])
    jart = jpol.PolicyArtifact.from_json(tart.to_json())
    bits = tkvpol.resolve_state_bits(tart, tcfg)
    assert bits == jkvpol.resolve_state_bits(jart, jcfg)
    surface = state_layer_infos(tcfg, SLOTS + 1, 2 * SEQ)       # another geometry passes
    jsurface = jkvpol.state_layer_infos(jcfg, SLOTS + 1, 2 * SEQ)

    def states(bits_, **kw):
        return (jdecoder.init_cache(jcfg, SLOTS, SEQ, state_bits=bits_, **kw),
                tdecoder.init_cache(tcfg, SLOTS, SEQ, state_bits=bits_, device="cpu", **kw))

    for kw in ({}, {"paged": True}):
        jst, tst = states(bits, **kw)
        tkvpol.verify_state_bits(tst, tart, surface=surface)
        jkvpol.verify_state_bits(jst, jart, surface=jsurface)
        jst, tst = states([(4, 4)] * tcfg.n_layers, **kw)
        _raises_alike(lambda: jkvpol.verify_state_bits(jst, jart),
                      lambda: tkvpol.verify_state_bits(tst, tart))
    jst, tst = states(None)                                      # an fp cache
    _raises_alike(lambda: jkvpol.verify_state_bits(jst, jart),
                  lambda: tkvpol.verify_state_bits(tst, tart))
    bare = tpol.PolicyArtifact.build(model["policy"])
    jst, tst = states(bits)
    _raises_alike(lambda: jkvpol.verify_state_bits(jst, jpol.PolicyArtifact.from_json(
                      bare.to_json())),
                  lambda: tkvpol.verify_state_bits(tst, bare))
    # a state policy searched on another head geometry
    odd = (tpol.LayerInfo("layer000.state.k", (SLOTS, SEQ, 3, 32), 0, "state"),)
    _raises_alike(lambda: jkvpol.verify_state_bits(jst, jart, surface=_jax(
                      tpol.BitPolicy.uniform(odd, 8)).layers),
                  lambda: tkvpol.verify_state_bits(tst, tart, surface=odd))


def test_serve_cli_deploys_a_jax_written_artifact(model, tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --policy`` on an artifact the JAX
    package wrote (weight, state and draft policies, pool geometry).

    The printed ``speculation: K=`` is the live K after the run; the CLI's
    engine runs under a shed policy whose straggler shed (which reads the
    host clock) cannot fire, so the load on the machine cannot lower it."""
    engine_cls = tserve_cli.ServeEngine

    def steady_engine(*args, **kwargs):
        return engine_cls(*args, **kwargs, shed=ShedPolicy(straggler_sheds_spec=False))

    monkeypatch.setattr(tserve_cli, "ServeEngine", steady_engine)
    kw = _build_kw(model, jpol)
    kw.update(draft_k=2, kernel_configs=None, pool={"block": 16, "num_blocks": 20})
    jart = jpol.PolicyArtifact.build(_jax(model["policy"]), **kw)
    path = jart.save(str(tmp_path / "policy.json"))
    assert tserve_cli.main(["--arch", "gemma-2b", "--reduced", "--policy", path, "--requests",
                            "3", "--max-new", "5", "--slots", "2", "--max-seq", "64",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"policy artifact {path}: backend=roofline" in out
    assert "quantized KV state: mean_bits=6.00" in out
    assert "self-speculative draft: K=2" in out
    assert "3 requests, 15 new tokens" in out
    assert "speculation: K=2" in out
    # a foreign registry is refused before anything is served
    small = tpol.PolicyArtifact.build(tpol.BitPolicy.uniform(model["specs"][1:], 4))
    with pytest.raises(ValueError, match="layer-registry hash mismatch"):
        tserve_cli.main(["--reduced", "--policy", small.save(str(tmp_path / "x.json")),
                         "--device", "cpu"])
