"""Port parity of the fused decode-step autotuner (``kernels/autotune.py``), the
engine's replay of an artifact's ``kernel_configs`` and the search's
``--autotune-kernels``.

The JAX package (``repro.kernels.autotune``, its engine's
``_install_kernel_configs``, ``launch.search.attach_kernel_configs``) is the
reference.  Keys, candidate lists, refusals and artifact tables are compared
with it directly; every "torch" candidate is held bit for bit to the
sequential append -> attention composition and to the reference's own
``quant_kv_decode_step_ref`` under the same config (bytes exact, outputs at
rel 1e-5) on the same numpy-seeded inputs, dense and paged; the engine cases
(twins of ``tests/test_kvcache.py::TestEngineKernelConfigs``) run reduced
gemma-2b's port engine beside the JAX engine on the same weights, with and
without a table, and compare greedy tokens and refusal messages.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.store import ArtifactError as JArtifactError
from repro.core import policy as jpol
from repro.kernels import autotune as jautotune
from repro.kernels.quant_kv import ref as jref
from repro.kvcache import cache as jcache
from repro.kvcache import state_layer_infos as jstate_layer_infos
from repro.kvcache import paged as jpaged
from repro.models import registry as jregistry
from repro.quant import apply as japply
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import ArtifactError
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.kernels import autotune
from repro_torch.kernels.quant_kv import ops as kv_ops
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import paged as tpaged
from repro_torch.launch import search as tsearch
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.lifecycle import ShedPolicy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_table():
    """Each case starts and ends with no installed table in either package."""
    autotune.set_active_configs(None)
    jautotune.set_active_configs(None)
    yield
    autotune.set_active_configs(None)
    jautotune.set_active_configs(None)


# ---------------------------------------------------------------------------
# keys, candidates, the registry
# ---------------------------------------------------------------------------


def test_kernel_key_round_trip_and_unknown_family():
    d = {"family": "decode_step_paged", "k_bits": 8, "v_bits": 4, "heads": 2, "head_dim": 32,
         "block": 16, "impl": "cuda"}
    key = autotune.KernelKey.from_dict(d)
    assert key.to_dict() == d == jautotune.KernelKey.from_dict(d).to_dict()
    assert autotune.KernelKey.from_dict(json.loads(json.dumps(key.to_dict()))) == key
    bad = dict(d, family="attention")
    with pytest.raises(ValueError) as t_err:
        autotune.KernelKey.from_dict(bad)
    with pytest.raises(ValueError) as j_err:
        jautotune.KernelKey.from_dict(bad)
    assert str(t_err.value) == str(j_err.value) == "unknown kernel family 'attention'"


@pytest.mark.parametrize("family", ("decode_step", "decode_step_paged"))
def test_torch_candidates_are_the_references_xla_list(family):
    kw = dict(family=family, k_bits=4, v_bits=2, heads=2, head_dim=16, block=8)
    assert (autotune.enumerate_candidates(autotune.KernelKey(impl="torch", **kw))
            == jautotune.enumerate_candidates(jautotune.KernelKey(impl="xla", **kw)))


@pytest.mark.parametrize("family", ("decode_step", "decode_step_paged"))
@pytest.mark.parametrize("block", (16, 48, 128))
def test_cuda_candidate_is_the_kernels_own_launch(family, block):
    """One CUDA candidate, as the reference's Pallas kernel has one, carrying
    both of the reference's knob keys; the reference's impls are not timed."""
    key = autotune.KernelKey(family=family, k_bits=8, v_bits=4, heads=1, head_dim=256,
                             block=block, impl="cuda")
    got = autotune.enumerate_candidates(key)
    assert got == [{"place": "kernel", "attend": "cluster"}]
    jautotune.validate_configs([{"key": key.to_dict(), "config": got[0]}], heads=1,
                               head_dim=256, block=block, bit_pairs=set())
    for impl in ("xla", "pallas", "interpret"):
        with pytest.raises(ValueError, match="the port times impls"):
            autotune.enumerate_candidates(dataclasses.replace(key, impl=impl))


def test_keys_for_state_order_and_dedup():
    pairs = [(8, 4), (4, 4), (8, 4), (2, 8), (4, 4), (8, 8)]
    for paged in (False, True):
        got = autotune.keys_for_state(pairs, 2, 32, 16, paged=paged, impl="torch")
        want = jautotune.keys_for_state(pairs, 2, 32, 16, paged=paged, impl="torch")
        assert [k.to_dict() for k in got] == [k.to_dict() for k in want]
        assert [(k.k_bits, k.v_bits) for k in got] == [(8, 4), (4, 4), (2, 8), (8, 8)]
        assert {k.family for k in got} == {"decode_step_paged" if paged else "decode_step"}


def test_registry_installs_and_clears():
    entries = [{"key": {"family": "decode_step", "k_bits": 8, "v_bits": 4, "heads": 1,
                        "head_dim": 256, "block": 16, "impl": "cuda"},
                "config": {"place": "kernel", "attend": "cluster"}},
               {"key": {"family": "decode_step", "k_bits": 4, "v_bits": 4, "heads": 1,
                        "head_dim": 256, "block": 16, "impl": "xla"},
                "config": {"place": "dus", "attend": "reunpack"}}]
    assert autotune.lookup("decode_step", 8, 4, 1, 256, 16, "cuda") is None
    autotune.set_active_configs(entries)
    assert autotune.active_configs() == {autotune.KernelKey.from_dict(e["key"]): e["config"]
                                         for e in entries}
    assert autotune.lookup("decode_step", 8, 4, 1, 256, 16, "cuda") == entries[0]["config"]
    # the reference's impl installs and never matches a port call
    assert autotune.lookup("decode_step", 4, 4, 1, 256, 16, "torch") is None
    autotune.set_active_configs(None)
    assert not autotune.active_configs()
    assert autotune.lookup("decode_step", 8, 4, 1, 256, 16, "cuda") is None


# ---------------------------------------------------------------------------
# every candidate, bit for bit (the twin of tests/test_kernel_parity.py:186-215)
# ---------------------------------------------------------------------------

B, S, H, HD, BLOCK, HQ = 3, 32, 2, 16, 8, 4
LENS = (12, 7, 3)


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, max(LENS), H, HD)).astype(np.float32)
    v = rng.normal(size=(B, max(LENS), H, HD)).astype(np.float32)
    return k, v


def _step_inputs():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    rng = np.random.default_rng(1)
    kn = rng.normal(size=(B, 1, H, HD)).astype(np.float32)
    vn = rng.normal(size=(B, 1, H, HD)).astype(np.float32)
    return q, kn, vn


def _dense(bits):
    k, v = _rows()
    jl = jcache.insert_rows(jcache.init_kv_layer(B, S, H, HD, k_bits=bits, v_bits=bits,
                                                 block=BLOCK),
                            jnp.arange(B), jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENS))

    def port():
        tl = tcache.init_kv_layer(B, S, H, HD, k_bits=bits, v_bits=bits, block=BLOCK,
                                  device="cpu")
        return tcache.insert_rows(tl, torch.arange(B), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.tensor(LENS))
    return jl, port


def _paged(bits):
    """The reference test's pool: each slot's blocks mapped in order, then
    slot 1 idled (its table row -1, every write to the trash block)."""
    k, v = _rows()
    nblk = 3 * (S // BLOCK)
    pool = jpaged.BlockPool(nblk)
    npb = -(-max(LENS) // BLOCK)
    table = np.full((B, S // BLOCK), -1, np.int32)
    rows = np.full((B, npb), -1, np.int32)
    for b, length in enumerate(LENS):
        for j in range(-(-(length + 1) // BLOCK)):  # cover the append at pos=len
            table[b, j] = pool.alloc()
            if j < npb:
                rows[b, j] = table[b, j]
    idle = table.copy()
    idle[1, :] = -1
    jl = jpaged.with_table(jpaged.init_paged_layer(nblk, B, S, H, HD, k_bits=bits, v_bits=bits,
                                                   block=BLOCK), table)
    jl = jpaged.insert_prefill_rows(jl, rows, jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENS))
    jl = jpaged.with_table(jl, jnp.asarray(idle))

    def port():
        tl = tpaged.init_paged_layer(nblk, B, S, H, HD, k_bits=bits, v_bits=bits, block=BLOCK,
                                     device="cpu")
        tpaged.with_table(tl, table)
        tpaged.insert_prefill_rows(tl, rows, torch.from_numpy(k), torch.from_numpy(v),
                                   valid_len=torch.tensor(LENS))
        return tpaged.with_table(tl, idle)
    return jl, port


def _assert_same_bytes(tl, jl, what):
    for f in ("k_packed", "v_packed", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("family", ("decode_step", "decode_step_paged"))
def test_every_torch_candidate_is_the_sequential_composition_and_the_reference(family, bits):
    paged = family == "decode_step_paged"
    jl, port = (_paged if paged else _dense)(bits)
    q, kn, vn = _step_inputs()
    pos = np.asarray(LENS, np.int32)
    valid = np.arange(S)[None, :] <= pos[:, None]
    t = {name: torch.from_numpy(a) for name, a in
         (("q", q), ("kn", kn), ("vn", vn), ("pos", pos), ("valid", valid))}
    seq = kv_ops.quant_kv_append(port(), t["pos"], t["kn"], t["vn"], impl="torch")
    o_seq = kv_ops.quant_kv_attention(t["q"], seq, t["valid"], impl="torch",
                                      out_dtype=torch.float32)
    jfn = jref.quant_kv_decode_step_paged_ref if paged else jref.quant_kv_decode_step_ref
    key = autotune.KernelKey(family=family, k_bits=bits, v_bits=bits, heads=H, head_dim=HD,
                             block=BLOCK, impl="torch")
    for cfg in [None, *autotune.enumerate_candidates(key)]:
        o, new = kv_ops.quant_kv_decode_step(t["q"], port(), t["pos"], t["kn"], t["vn"],
                                             t["valid"], impl="torch", out_dtype=torch.float32,
                                             config=cfg)
        assert torch.equal(o, o_seq), cfg
        _assert_same_bytes(new, seq, f"{cfg} vs the sequential composition")
        jo, jnew = jfn(jnp.asarray(q), jl, jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn),
                       jnp.asarray(valid), out_dtype=jnp.float32, config=cfg)
        _assert_same_bytes(new, jnew, f"{cfg} vs the reference")
        err = float(np.max(np.abs(o.numpy() - np.asarray(jo))) / np.max(np.abs(np.asarray(jo))))
        assert err <= 1e-5, (cfg, err)


def test_installed_table_reaches_the_plain_step(monkeypatch):
    """A call without ``config`` runs the installed entry of its own geometry
    and impl, and the default where there is none."""
    seen = []
    real = kv_ops.quant_kv_decode_step_ref

    def spy(*a, config=None, **kw):
        seen.append(config)
        return real(*a, config=config, **kw)

    monkeypatch.setattr(kv_ops, "quant_kv_decode_step_ref", spy)
    _, port = _dense(4)
    q, kn, vn = _step_inputs()
    pos = torch.tensor(LENS)
    valid = torch.arange(S)[None, :] <= pos[:, None]
    cfg = {"place": "dus", "attend": "reunpack"}
    mk = dict(family="decode_step", k_bits=4, v_bits=4, heads=H, head_dim=HD, block=BLOCK)
    autotune.set_active_configs([{"key": dict(mk, impl="torch"), "config": cfg}])
    kv_ops.quant_kv_decode_step(torch.from_numpy(q), port(), pos, torch.from_numpy(kn),
                                torch.from_numpy(vn), valid)
    autotune.set_active_configs([{"key": dict(mk, impl="xla"), "config": cfg}])
    kv_ops.quant_kv_decode_step(torch.from_numpy(q), port(), pos, torch.from_numpy(kn),
                                torch.from_numpy(vn), valid)
    assert seen == [cfg, None]


def test_autotune_key_on_the_cpu_times_every_candidate():
    from repro_torch.obs import trace as obs_trace

    key = autotune.KernelKey(family="decode_step_paged", k_bits=4, v_bits=8, heads=1,
                             head_dim=32, block=8, impl="torch")
    obs_trace.enable()
    try:
        res = autotune.autotune_key(key, batch=2, blocks=4, repeats=1)
        evs = obs_trace.get_tracer().events()
    finally:
        obs_trace.disable()
    assert res["key"] == key.to_dict() and res["candidates"] == 2
    assert res["config"] in autotune.enumerate_candidates(key) and res["micros"] > 0
    cands = [e for e in evs if e[1] == "autotune_candidate"]
    assert len(cands) == 2


# ---------------------------------------------------------------------------
# the engine's replay (twins of tests/test_kvcache.py::TestEngineKernelConfigs)
# ---------------------------------------------------------------------------

SLOTS, SEQ = 2, 64
PROMPTS = [[5, 6, 7], [1, 2]]


def _entry(cfg, *, heads=None, impl="xla", config=None, bits=4):
    return {"key": {"family": "decode_step", "k_bits": bits, "v_bits": bits,
                    "heads": heads or cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
                    "block": 16, "impl": impl},
            "config": config or {"place": "dus", "attend": "reunpack"},
            "micros": 1.0, "candidates": 4}


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    api = jregistry.get_api(jcfg)
    jp = api.init(jcfg, jax.random.key(0))
    jpolicy = jpol.BitPolicy.uniform(japply.layer_specs(jp, jcfg), 8)
    jsp = api.unstack(jp, jcfg)
    jstate = jpol.BitPolicy.uniform(jstate_layer_infos(jcfg, SLOTS, SEQ), 4)
    jqp = japply.quantize_for_serve(jsp, jpolicy, jcfg)
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp), device="cpu")
    policy = tpol.BitPolicy.from_json(jpolicy.to_json())
    state = tpol.BitPolicy.from_json(jstate.to_json())
    jart = jpol.PolicyArtifact.build(jpolicy, backend="shift_add", state_policy=jstate,
                                     kernel_configs=[_entry(jcfg)])
    jautotune.set_active_configs(None)
    try:
        want = JServeEngine(jcfg, jqp, max_slots=SLOTS, max_seq=SEQ,
                            artifact=jart).generate(PROMPTS, max_new_tokens=3)
    finally:
        jautotune.set_active_configs(None)
    return dict(jcfg=jcfg, tcfg=tcfg, jqp=jqp, tqp=tqp, policy=policy, state=state,
                jpolicy=jpolicy, jstate=jstate, jart=jart, want=want)


def _engine(m, art, **kw):
    return ServeEngine(m["tcfg"], m["tqp"], max_slots=SLOTS, max_seq=SEQ, artifact=art,
                       shed=ShedPolicy(straggler_sheds_spec=False), device="cpu", **kw)


def test_engine_installs_and_replays_configs(setup, monkeypatch):
    m = setup
    seen = []
    real = kv_ops.quant_kv_decode_step_ref

    def spy(*a, config=None, **kw):
        seen.append(config)
        return real(*a, config=config, **kw)

    monkeypatch.setattr(kv_ops, "quant_kv_decode_step_ref", spy)
    entry = _entry(m["tcfg"], impl="torch")
    art = tpol.PolicyArtifact.build(m["policy"], backend="shift_add",
                                    state_policy=m["state"], kernel_configs=[entry])
    eng = _engine(m, art)
    key = autotune.KernelKey.from_dict(entry["key"])
    assert autotune.active_configs()[key] == entry["config"]
    with_cfg = eng.generate(PROMPTS, max_new_tokens=3)
    assert seen and all(c == entry["config"] for c in seen)
    autotune.set_active_configs(None)
    plain = ServeEngine(m["tcfg"], m["tqp"], max_slots=SLOTS, max_seq=SEQ,
                        state_bits=m["state"], device="cpu").generate(PROMPTS, max_new_tokens=3)
    # every tuned launch is bitwise equivalent: the JAX engine's tokens with
    # its table, and the port's without one
    assert with_cfg == plain == m["want"]


def test_jax_written_table_deploys_on_the_port_unchanged(setup, tmp_path, monkeypatch):
    """An "xla" table validates, installs and never matches a port call."""
    m = setup
    seen = []
    real = kv_ops.quant_kv_decode_step_ref
    monkeypatch.setattr(kv_ops, "quant_kv_decode_step_ref",
                        lambda *a, config=None, **kw: seen.append(config) or real(
                            *a, config=config, **kw))
    path = tmp_path / "jax_v5.json"
    m["jart"].save(str(path))
    art = tpol.PolicyArtifact.load(str(path))
    assert art.version == 6 and art.kernel_configs == m["jart"].kernel_configs
    eng = _engine(m, art)
    assert len(autotune.active_configs()) == 1
    assert eng.generate(PROMPTS, max_new_tokens=3) == m["want"]
    assert seen and all(c is None for c in seen)


def _refusals(m, t_art, j_art):
    with pytest.raises(ArtifactError) as t_err:
        _engine(m, t_art)
    with pytest.raises(JArtifactError) as j_err:
        JServeEngine(m["jcfg"], m["jqp"], max_slots=SLOTS, max_seq=SEQ, artifact=j_art)
    assert str(t_err.value) == str(j_err.value)
    assert not autotune.active_configs() and not jautotune.active_configs()
    return str(t_err.value)


def test_mismatched_geometry_refused(setup):
    m = setup
    entries = [_entry(m["tcfg"], heads=m["tcfg"].n_kv_heads + 1)]
    msg = _refusals(m, tpol.PolicyArtifact.build(m["policy"], backend="shift_add",
                                                 state_policy=m["state"],
                                                 kernel_configs=entries),
                    jpol.PolicyArtifact.build(m["jpolicy"], backend="shift_add",
                                              state_policy=m["jstate"], kernel_configs=entries))
    assert "tuned for geometry" in msg


def test_configs_without_quantized_state_refused(setup):
    m = setup
    entries = [_entry(m["tcfg"])]
    msg = _refusals(m, tpol.PolicyArtifact.build(m["policy"], backend="shift_add",
                                                 kernel_configs=entries),
                    jpol.PolicyArtifact.build(m["jpolicy"], backend="shift_add",
                                              kernel_configs=entries))
    assert "float decode state" in msg


def test_missing_knobs_refused_alike(setup):
    m = setup
    entry = _entry(m["tcfg"])
    entry["config"] = {"place": "dus"}
    msg = _refusals(m, tpol.PolicyArtifact.build(m["policy"], backend="shift_add",
                                                 state_policy=m["state"],
                                                 kernel_configs=[entry]),
                    jpol.PolicyArtifact.build(m["jpolicy"], backend="shift_add",
                                              state_policy=m["jstate"],
                                              kernel_configs=[entry]))
    assert "missing knobs ['attend']" in msg


def test_extra_bit_pair_keys_tolerated(setup):
    m = setup
    entries = [_entry(m["tcfg"], impl="torch"), _entry(m["tcfg"], impl="torch", bits=2)]
    art = tpol.PolicyArtifact.build(m["policy"], backend="shift_add", state_policy=m["state"],
                                    kernel_configs=entries)
    eng = _engine(m, art)
    assert len(autotune.active_configs()) == 2
    assert eng.generate(PROMPTS, max_new_tokens=3) == m["want"]


# ---------------------------------------------------------------------------
# the search side
# ---------------------------------------------------------------------------


def test_attach_kernel_configs_needs_state_policy(setup):
    with pytest.raises(ValueError, match="needs a state policy"):
        tsearch.attach_kernel_configs(tpol.PolicyArtifact.build(setup["policy"]), cfg=None)


def test_port_written_table_loads_and_validates_in_the_jax_package(setup, tmp_path):
    m = setup
    art = tpol.PolicyArtifact.build(m["policy"], backend="shift_add", state_policy=m["state"],
                                    pool={"block": 16, "num_blocks": 12})
    out = tsearch.attach_kernel_configs(art, m["tcfg"], repeats=1, device="cpu")
    assert out.meta["kernel_autotune_impl"] == "torch" and art.kernel_configs is None
    (entry,) = out.kernel_configs
    assert entry["key"] == {"family": "decode_step_paged", "k_bits": 4, "v_bits": 4,
                            "heads": m["tcfg"].n_kv_heads,
                            "head_dim": m["tcfg"].resolved_head_dim, "block": 16,
                            "impl": "torch"}
    assert entry["candidates"] == 2
    # a CUDA table beside it: both keys the reference's validation requires
    cuda = dict(entry, key=dict(entry["key"], impl="cuda"),
                config={"place": "kernel", "attend": "cluster"})
    path = tmp_path / "port_v5.json"
    dataclasses.replace(out, kernel_configs=[entry, cuda]).save(str(path))
    back = jpol.PolicyArtifact.load(str(path))
    assert back.version == 6 and back.kernel_configs == [entry, cuda]
    jautotune.validate_configs(back.kernel_configs, heads=m["jcfg"].n_kv_heads,
                               head_dim=m["jcfg"].resolved_head_dim, block=16,
                               bit_pairs={(4, 4)})


SEARCH = ["--arch", "gemma-2b", "--reduced", "--limit", "size_mib=0.25", "--pretrain-steps",
          "2", "--phase2-iters", "1", "--device", "cpu", "--autotune-kernels",
          "--autotune-repeats", "1"]


def test_search_cli_autotune_kernels(tmp_path, capsys):
    from repro_torch.kvcache import resolve_state_bits

    out = tmp_path / "p.json"
    with pytest.raises(SystemExit) as e:
        tsearch.main([*SEARCH, "--out", str(out)])
    assert e.value.code == 2
    assert "--autotune-kernels needs a state phase" in capsys.readouterr().err
    assert not out.exists()
    tsearch.main([*SEARCH, "--limit", "state_bytes=24000", "--out", str(out)])
    text = capsys.readouterr().out
    assert "autotuning fused decode-step kernels ..." in text
    art = tpol.PolicyArtifact.load(str(out))
    pairs = {tuple(p) for p in resolve_state_bits(art.state_policy,
                                                  tconfigs.get_config("gemma-2b").reduced())}
    assert art.kernel_configs and {(e["key"]["k_bits"], e["key"]["v_bits"])
                                   for e in art.kernel_configs} == pairs
    assert all(e["key"]["impl"] == "torch" and e["candidates"] == 4
               for e in art.kernel_configs)
    assert art.meta["kernel_autotune_impl"] == "torch"
    jautotune.validate_configs(jpol.PolicyArtifact.load(str(out)).kernel_configs, heads=1,
                               head_dim=art.kernel_configs[0]["key"]["head_dim"], block=16,
                               bit_pairs=pairs)

