"""Port parity of the hybrid family's serving and search, on the CPU.

Reduced zamba2-2.7b (6 Mamba2 layers, the shared attention every 2: three
KV entries ``shared_attn.app000-002``) with the JAX package's weights
carried over by ``convert``.  The greedy streams of ``ServeEngine`` equal
the JAX engine's on an fp state, an 8-bit state and a mixed K 8 / V 4
state (the Mamba states stay fp), whole and chunked (the twin of
``tests/test_scheduler.py::test_recurrent_families_identical[hybrid,
hybrid-q]``: the chunked engine recomputes the prefix, as the family has
no ``prefill_chunk``), and under a window that bites.  Speculation is
refused, a length-1 prompt decodes as on a fresh engine, and
``state_container_bytes`` (every leaf of the ``{"mamba", "attn"}`` state)
equals the JAX engine's, while neither engine's ``measured_costs`` carries
``state_bytes`` (the reference's ``_quant_state`` reads only list states).
``search_policy``'s weight and state phases on shared batches take the JAX
search's decisions; the serve, search and train command lines run the
family, and the search refuses ``--paged`` as the JAX command does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.quant.env as jenv
from repro import configs as jconfigs
from repro.configs.base import ShapeSpec as JShape
from repro.core import policy as jpol
from repro.core.controller import ControllerConfig as JCC
from repro.kvcache.env import KVQuantEnv as JKV
from repro.launch import search as jsearch
from repro.models import registry as jreg
from repro.quant import apply as japply
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeSpec as TShape
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core.controller import ControllerConfig as TCC
from repro_torch.kvcache import QuantizedKVLayer
from repro_torch.kvcache import policy as tkvp
from repro_torch.kvcache.env import KVQuantEnv as TKV
from repro_torch.launch import search as tsearch
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import registry
from repro_torch.quant import apply as tapply
from repro_torch.quant.env import LMQuantEnv as TLM
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.lifecycle import ShedPolicy

torch.set_num_threads(2)

ARCH = "zamba2-2.7b"
MAX_NEW = 8
PROMPTS = {
    0: [9] * 11,
    1: [2, 3, 4],
    2: [5, 6, 7, 8, 1, 2, 3],
    3: [7],
    4: [5, 6, 7, 9, 4],
    5: list(range(1, 32)),
}
ENGINE_KW = dict(max_slots=2, max_seq=64, prefill_pad=8, debug_invariants=True)
#: the state of each case: fp, 8 bits, and K 8 / V 4 a shared-attention entry
STATES = {"fp": None, "q8": 8, "k8v4": "k8v4"}


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    api = jreg.get_api(jcfg)
    jp = api.init(jcfg, jax.random.key(0))
    jsp = api.unstack(jp, jcfg)
    specs = tapply.layer_specs(_port(jp), tcfg)
    policy = dryrun_policy(specs, "mixed")
    jpacked = japply.quantize_for_serve(jsp, jpol.BitPolicy.from_json(policy.to_json()), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, fp=(jsp, _port(jsp)),
                packed=(jpacked, _port(jpacked)))


def _state(spec, pol):
    """An engine's ``state_bits``: K 8 / V 4 as a state BitPolicy of either package."""
    if spec != "k8v4":
        return spec
    infos = tkvp.state_layer_infos(tconfigs.get_config(ARCH).reduced(), 2, 64)
    policy = tpol.BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                              for l in infos})
    return policy if pol is tpol else jpol.BitPolicy.from_json(policy.to_json())


def _requests(cls):
    return [cls(uid=u, prompt=list(p), max_new_tokens=MAX_NEW) for u, p in PROMPTS.items()]


def _engines(models, weights, state, **kw):
    jsp, tsp = models[weights]
    ours = ServeEngine(models["tcfg"], tsp, state_bits=_state(STATES[state], tpol),
                       shed=ShedPolicy(straggler_sheds_spec=False), device="cpu",
                       **ENGINE_KW, **kw)
    theirs = JServeEngine(models["jcfg"], jsp, state_bits=_state(STATES[state], jpol),
                          qimpl="xla", **ENGINE_KW, **kw)
    return ours, theirs


@pytest.mark.parametrize("weights,state", [("fp", "fp"), ("packed", "q8"), ("packed", "k8v4")])
def test_greedy_streams_and_state_bytes_equal_jax(models, weights, state):
    ours, theirs = _engines(models, weights, state)
    out = ours.run(_requests(Request))
    assert out == theirs.run(_requests(JRequest))
    assert ours.state_bits == theirs.state_bits
    if STATES[state] is None:
        assert ours.state_bits == {}
    else:
        assert sorted({n.rsplit(".", 2)[0] for n in ours.state_bits}) == [
            "shared_attn.app000", "shared_attn.app001", "shared_attn.app002"]
        assert all(isinstance(a, QuantizedKVLayer) for a in ours.state["attn"])
    assert ours.state_container_bytes() == theirs.state_container_bytes()
    assert set(ours.state) == {"mamba", "attn"}
    assert "state_bytes" not in ours.measured_costs()
    assert "state_bytes" not in theirs.measured_costs()


def test_a_window_that_bites_gives_the_jax_streams(models):
    """``attn_window`` 8 on prompts up to 31 tokens and 8 new ones."""
    jsp, tsp = models["packed"]
    jcfg = dataclasses.replace(models["jcfg"], attn_window=8)
    tcfg = dataclasses.replace(models["tcfg"], attn_window=8)
    out = ServeEngine(tcfg, tsp, state_bits=8, device="cpu", **ENGINE_KW).run(
        _requests(Request))
    assert out == JServeEngine(jcfg, jsp, state_bits=8, qimpl="xla",
                               **ENGINE_KW).run(_requests(JRequest))
    full = ServeEngine(models["tcfg"], tsp, state_bits=8, device="cpu", **ENGINE_KW).run(
        _requests(Request))
    assert full[5] != out[5]           # 31 prompt tokens: the window bites


def _assert_budget_invariants(eng):
    recs = eng._scheduler.records
    assert recs, "scheduler never planned a turn"
    budget = eng._scheduler.cfg.step_token_budget
    for r in recs:
        assert r.decode_tokens + r.chunk_tokens + r.finish_tokens <= budget, r
        assert r.chunk_tokens <= budget - r.decode_tokens, r
    stalled = [r for r in recs if r.n_prefilling and not r.chunk_tokens
               and budget - r.decode_tokens >= eng.prefill_chunk + 1]
    assert not stalled, stalled


@pytest.mark.parametrize("family,chunk", [("hybrid", 1), ("hybrid", 64), ("hybrid-q", 4)])
def test_recurrent_families_identical(models, family, chunk):
    """The prefix-recompute chunking gives the whole-prompt streams and the
    JAX chunked engine's streams and planner records (``hybrid-q``: an
    8-bit state)."""
    jsp, tsp = models["fp"]
    extra = {"state_bits": 8} if family == "hybrid-q" else {}
    ref = ServeEngine(models["tcfg"], tsp, device="cpu", **ENGINE_KW, **extra).run(
        _requests(Request))
    eng = ServeEngine(models["tcfg"], tsp, prefill_chunk=chunk, device="cpu", **ENGINE_KW,
                      **extra)
    out = eng.run(_requests(Request))
    assert out == ref
    _assert_budget_invariants(eng)
    assert eng.stats()["prefill_chunks"] > 0 and not eng._chunk_head
    jeng = JServeEngine(models["jcfg"], jsp, prefill_chunk=chunk, qimpl="xla", **ENGINE_KW,
                        **extra)
    assert jeng.run(_requests(JRequest)) == out
    assert [(r.decode_tokens, r.chunk_tokens, r.finish_tokens) for r in eng._scheduler.records] \
        == [(r.decode_tokens, r.chunk_tokens, r.finish_tokens) for r in jeng._scheduler.records]


def test_hybrid_cannot_speculate(models):
    with pytest.raises(NotImplementedError, match="cannot self-speculate"):
        ServeEngine(models["tcfg"], models["fp"][1], max_slots=2, max_seq=48, speculate=2,
                    draft_policy=4, device="cpu")
    api = registry.get_api(models["tcfg"])
    assert api.decode_verify is None and api.prefill_chunk is None
    assert api.init_prefill_scratch is None


@pytest.mark.parametrize("bits", (None, 8))
def test_a_length1_prompt_decodes_as_on_a_fresh_engine(models, bits):
    """One slot: a 20-token request, then a 1-token one in the slot it left.
    The Mamba rows reset; the attention rows are masked by position."""
    _, tsp = models["packed"]
    kw = dict(max_slots=1, max_seq=64, state_bits=bits, device="cpu")
    fresh = ServeEngine(models["tcfg"], tsp, **kw).generate([[42]], max_new_tokens=6)
    eng = ServeEngine(models["tcfg"], tsp, **kw)
    first, second = eng.generate([list(range(3, 23)), [42]], max_new_tokens=6)
    assert second == fresh[0]
    eng2 = ServeEngine(models["tcfg"], tsp, **kw)
    eng2._reset_recurrent_rows = lambda slot_id: None
    assert eng2.generate([list(range(3, 23)), [42]], max_new_tokens=6)[1] != fresh[0]


def test_search_policy_takes_the_jax_decisions(models, monkeypatch):
    """The weight phase (no QAT, two refinement rounds) then the state phase
    over the three shared-attention entries, on shared batches and the same
    calibration prompts: the same bits, reports and controller histories."""
    jcfg, tcfg, jp = models["jcfg"], models["tcfg"], models["jp"]
    batch = lambda step: np.random.default_rng([9, step]).integers(0, 512, (2, 17))  # noqa: E731
    monkeypatch.setattr(jenv, "global_batch", lambda task, cfg, shape, step: {
        "tokens": jnp.asarray(batch(step)[:, :-1]), "labels": jnp.asarray(batch(step)[:, 1:])})
    lm_j = jenv.LMQuantEnv(jp, jcfg, JShape("s", "train", 16, 2))
    lm_t = TLM(_port(jp), tcfg, TShape("s", "train", 16, 2),
               batches=lambda task, cfg, shape, step: {"tokens": batch(step)[:, :-1],
                                                       "labels": batch(step)[:, 1:]})
    calib = np.random.default_rng(0).integers(1, tcfg.vocab_size, (4, 16))
    # the JAX env's prefill and decode step, jitted (the same functions; the
    # env runs them op by op, at tens of seconds on the CPU)
    api = jreg.get_api(jcfg)
    jitted = dataclasses.replace(
        api, prefill=jax.jit(api.prefill, static_argnums=(1,), static_argnames=("qimpl",)),
        decode_step=jax.jit(api.decode_step, static_argnums=(1,), static_argnames=("qimpl",)))
    monkeypatch.setattr(jreg, "get_api", lambda cfg: jitted)
    kj = JKV(api.unstack(jp, jcfg), jcfg, calib, slots=4, max_seq=64, qimpl="xla")
    kt = TKV(registry.get_api(tcfg).unstack(_port(jp), tcfg), tcfg, calib, slots=4,
             max_seq=64)
    assert [l.name for l in kt.layer_infos()] == [l.name for l in kj.layer_infos()]
    assert len(kt.layer_infos()) == 6
    n = len(kt.layer_infos())
    limit = 0.7 * kt.costs(tpol.BitPolicy.uniform(kt.layer_infos(), 8))["state_bytes"]
    cc = dict(phase2_max_iters=2, phase1_qat_epochs=0, phase2_qat_epochs=0)
    out = {}
    for key, mod, lm, kv, pol, CC in (("jax", jsearch, lm_j, kj, jpol, JCC),
                                      ("port", tsearch, lm_t, kt, tpol, TCC)):
        fl = lm.float_loss()
        out[key] = mod.search_policy(
            lm, mod.budget_from_limits(-(fl + 0.1), {"size_mib": 0.2}), config=CC(**cc),
            state_env=kv, seed=0,
            state_budget=pol.Budget.of(-0.15, acc_buffer=0.05, buffer=0.08, state_bytes=limit),
            state_config=mod.state_controller_config(n))
    (ja, jr), (ta, tr) = out["jax"], out["port"]
    assert tr.policy.bits == jr.policy.bits
    assert ta.state_policy.bits == ja.state_policy.bits
    assert ta.report["state_bytes"] == ja.report["state_bytes"]
    assert ta.meta["state_success"] == ja.meta["state_success"]
    tp_, jp_ = ta.provenance["phases"], ja.provenance["phases"]
    for ph in ("weight", "state"):
        assert [(h["step"], h["zone"], h["note"]) for h in tp_[ph]["history"]] == \
            [(h["step"], h["zone"], h["note"]) for h in jp_[ph]["history"]]


def test_serve_search_and_train_cli_run_the_hybrid_family(tmp_path, capsys):
    assert tserve_cli.main(["--arch", ARCH, "--reduced", "--requests", "4", "--max-new", "5",
                            "--wbits", "mixed", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 requests, 20 new tokens" in out and "quantized: mean_bits=" in out
    art = tmp_path / "policy.json"
    rc = tsearch.main(["--arch", ARCH, "--reduced", "--limit", "size_mib=0.2", "--limit",
                       "state_bytes=24000", "--seq", "16", "--batch", "2", "--pretrain-steps",
                       "2", "--phase2-iters", "1", "--kv-calib", "2", "--kv-calib-len", "8",
                       "--device", "cpu", "--out", str(art)])
    assert rc in (0, 1)
    printed = capsys.readouterr().out
    assert "state budget: state_bytes<=24000" in printed and "3 KV entries" not in printed
    artifact = tpol.PolicyArtifact.load(str(art))
    assert sorted(artifact.state_policy.bits) == sorted(
        f"shared_attn.app{j:03d}.state.{s}" for j in range(3) for s in "kv")
    assert tserve_cli.main(["--arch", ARCH, "--reduced", "--policy", str(art), "--requests", "2",
                            "--max-new", "3", "--device", "cpu"]) == 0
    assert "quantized KV state" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--paged covers the decoder families"):
        tsearch.main(["--arch", ARCH, "--reduced", "--limit", "size_mib=0.2", "--limit",
                      "state_bytes=1000", "--pretrain-steps", "0", "--paged", "--device", "cpu",
                      "--out", str(tmp_path / "x.json")])
    assert ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq",
                        "16", "--wbits", "4", "--device", "cpu", "--ckpt", str(tmp_path / "ck"),
                        "--save-every", "2"]) == 0
    assert f"arch={ARCH} reduced=True" in capsys.readouterr().out
