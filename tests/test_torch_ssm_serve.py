"""Port parity of the SSM family's serving: the engine's recurrent path, on the CPU.

Reduced mamba2-2.7b with the JAX package's weights (carried by ``convert``),
fp and packed under ``dryrun_policy("mixed")``.  Twins of
``tests/test_serve_engine.py::test_ssm_engine``,
``tests/test_scheduler.py::test_recurrent_families_identical[ssm]`` (the
chunked engine recomputes the prefix, since the family has no
``prefill_chunk``; its streams equal the whole-prompt engine's and the JAX
chunked engine's, under the same budget invariants) and
``tests/test_spec_decode.py::test_ssm_cannot_speculate``.  A length-1
prompt runs no prefill, so the engine zeroes its slot's recurrent rows: it
decodes as on a fresh engine although a longer request just left the slot,
and the rows of KV containers are left alone.  The serve and search command
lines run the family and refuse its KV-state options as the JAX package's.
"""
import jax
import numpy as np
import pytest
import torch

from repro import kvcache as jkv
from repro.configs import mamba2_2p7b as jmamba
from repro.core.policy import BitPolicy as JBitPolicy
from repro.kvcache import policy as jkvp
from repro.models import registry as jregistry
from repro.quant import apply as japply
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kvcache as tkv
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.kvcache import QuantizedKVLayer
from repro_torch.kvcache import policy as tkvp
from repro_torch.launch import search as tsearch
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import registry
from repro_torch.quant import apply as tapply
from repro_torch.serve import Request, ServeEngine
from repro_torch.spec.env import DraftQuantEnv

torch.set_num_threads(2)

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


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = jmamba.CONFIG.reduced()
    api = jregistry.get_api(jcfg)
    jp = api.init(jcfg, jax.random.key(0))
    jsp = api.unstack(jp, jcfg)
    tcfg = tconfigs.get_config("mamba2-2.7b").reduced()
    specs = tapply.layer_specs(_port(jp), tcfg)
    policy = dryrun_policy(specs, "mixed")
    jpacked = japply.quantize_for_serve(jsp, JBitPolicy.from_json(policy.to_json()), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, fp=(jsp, _port(jsp)), packed=(jpacked, _port(jpacked)))


def _requests(cls):
    return [cls(uid=u, prompt=list(p), max_new_tokens=MAX_NEW) for u, p in PROMPTS.items()]


def test_ssm_engine(models):
    jsp, tsp = models["fp"]
    eng = ServeEngine(models["tcfg"], tsp, max_slots=2, max_seq=64, device="cpu")
    outs = eng.generate([[3, 1, 4], [1, 5]], max_new_tokens=4)
    assert all(len(o) == 4 for o in outs)
    assert outs == JServeEngine(models["jcfg"], jsp, max_slots=2, max_seq=64,
                                qimpl="xla").generate([[3, 1, 4], [1, 5]], max_new_tokens=4)
    api = registry.get_api(models["tcfg"])
    assert api.decode_verify is None and api.prefill_chunk is None
    assert api.init_prefill_scratch is None
    st = eng.state
    assert [set(layer) for layer in st] == [{"conv", "ssm"}] * models["tcfg"].n_layers
    assert eng.state_container_bytes() == sum(t.numel() * 4 for layer in st
                                              for t in layer.values())
    with pytest.raises(ValueError, match="no quantizable KV state"):
        ServeEngine(models["tcfg"], tsp, max_slots=2, max_seq=64, state_bits=8, device="cpu")


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


@pytest.mark.parametrize("chunk", (1, 4, 64))
@pytest.mark.parametrize("weights", ("fp", "packed"))
def test_recurrent_family_streams_identical(models, weights, chunk):
    """The prefix-recompute chunking gives the whole-prompt streams and the
    JAX chunked engine's streams and planner records."""
    jsp, tsp = models[weights]
    ref = ServeEngine(models["tcfg"], tsp, device="cpu", **ENGINE_KW).run(_requests(Request))
    eng = ServeEngine(models["tcfg"], tsp, prefill_chunk=chunk, device="cpu", **ENGINE_KW)
    out = eng.run(_requests(Request))
    assert out == ref
    _assert_budget_invariants(eng)
    assert eng.stats()["prefill_chunks"] > 0 and not eng._chunk_head
    jeng = JServeEngine(models["jcfg"], jsp, prefill_chunk=chunk, qimpl="xla", **ENGINE_KW)
    assert jeng.run(_requests(JRequest)) == out
    assert [(r.decode_tokens, r.chunk_tokens, r.finish_tokens) for r in eng._scheduler.records] \
        == [(r.decode_tokens, r.chunk_tokens, r.finish_tokens) for r in jeng._scheduler.records]


def test_ssm_cannot_speculate(models):
    with pytest.raises(NotImplementedError, match="cannot self-speculate"):
        ServeEngine(models["tcfg"], models["fp"][1], max_slots=2, max_seq=48, speculate=2,
                    draft_policy=4, device="cpu")
    tcfg = models["tcfg"]
    params = registry.get_api(tcfg).init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    specs = tapply.layer_specs(params, tcfg)
    with pytest.raises(ValueError, match="cannot self-speculate"):
        DraftQuantEnv(params, registry.get_api(tcfg).unstack(params, tcfg), tcfg,
                      BitPolicy.uniform(specs, 8), np.ones((1, 4), np.int64))


@pytest.mark.parametrize("weights", ("fp", "packed"))
def test_a_length1_prompt_decodes_as_on_a_fresh_engine(models, weights):
    """One slot: a 20-token request, then a 1-token one in the slot it left.
    Without the reset the second decodes from the first's final state."""
    _, tsp = models[weights]
    kw = dict(max_slots=1, max_seq=64, device="cpu")
    fresh = ServeEngine(models["tcfg"], tsp, **kw).generate([[42]], max_new_tokens=6)
    eng = ServeEngine(models["tcfg"], tsp, **kw)
    first, second = eng.generate([list(range(3, 23)), [42]], max_new_tokens=6)
    assert second == fresh[0]
    # and the reset is what does it: skip it and the stream moves
    eng2 = ServeEngine(models["tcfg"], tsp, **kw)
    eng2._reset_recurrent_rows = lambda slot_id: None
    assert eng2.generate([list(range(3, 23)), [42]], max_new_tokens=6)[1] != fresh[0]


def test_reset_zeroes_one_row_and_leaves_kv_containers_alone(models):
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    api = registry.get_api(tcfg)
    sp = api.unstack(api.init(tcfg, torch.Generator().manual_seed(0), device="cpu"), tcfg)
    eng = ServeEngine(tcfg, sp, max_slots=3, max_seq=32, state_bits=8, device="cpu")
    for layer in eng.state:
        assert isinstance(layer, QuantizedKVLayer)
        layer.k_packed.fill_(3)
    eng._reset_recurrent_rows(1)
    assert all(bool((layer.k_packed == 3).all()) for layer in eng.state)
    ssm = ServeEngine(models["tcfg"], models["fp"][1], max_slots=3, max_seq=32, device="cpu")
    for layer in ssm.state:
        for t in layer.values():
            t.fill_(1.0)
    ssm._reset_recurrent_rows(1)
    for layer in ssm.state:
        for t in layer.values():
            assert not t[1].any() and bool((t[0] == 1).all()) and bool((t[2] == 1).all())


def test_serve_and_search_cli_run_the_ssm_family(tmp_path, capsys):
    assert tserve_cli.main(["--arch", "mamba2-2.7b", "--reduced", "--requests", "4",
                            "--max-new", "5", "--wbits", "mixed", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 requests, 20 new tokens" in out and "quantized: mean_bits=" in out
    art = tmp_path / "policy.json"
    rc = tsearch.main(["--arch", "mamba2-2.7b", "--reduced", "--limit", "size_mib=0.2",
                       "--seq", "32", "--batch", "2", "--pretrain-steps", "2",
                       "--phase2-iters", "1", "--device", "cpu", "--out", str(art)])
    assert rc in (0, 1)
    assert tserve_cli.main(["--arch", "mamba2-2.7b", "--reduced", "--policy", str(art),
                            "--requests", "2", "--max-new", "3", "--device", "cpu"]) == 0
    assert "artifact" in capsys.readouterr().out
    base = ["--arch", "mamba2-2.7b", "--reduced", "--limit", "size_mib=0.2", "--limit",
            "state_bytes=1000", "--pretrain-steps", "0", "--device", "cpu", "--out",
            str(tmp_path / "x.json")]
    with pytest.raises(SystemExit, match="--paged covers the decoder families"):
        tsearch.main(base + ["--paged"])
    with pytest.raises(ValueError, match="no quantizable KV state"):
        tsearch.main(base)


def test_state_walkers_take_the_recurrent_state(models):
    """``insert_state_rows`` writes a prefill's ``{"conv", "ssm"}`` rows into
    their slots as the JAX walker does (bit for bit on the same rows), and
    the KV-state walkers find no entry in it."""
    jsp, tsp = models["fp"]
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    toks = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 0, 0, 0, 0]], np.int32)
    lengths = np.asarray([8, 4], np.int32)
    _, jnew = jregistry.get_api(jcfg).prefill(jsp, jcfg, tokens=jax.numpy.asarray(toks),
                                              lengths=jax.numpy.asarray(lengths))
    tnew = _port(jnew)
    ids = [2, 0]
    jst = jkv.insert_state_rows(jregistry.get_api(jcfg).init_decode_state(jcfg, 3, 32),
                                jax.numpy.asarray(ids), jnew, jax.numpy.asarray(lengths))
    tst = tkv.insert_state_rows(registry.get_api(tcfg).init_decode_state(tcfg, 3, 32,
                                                                           device="cpu"),
                                ids, tnew, torch.from_numpy(lengths))
    for t, j in zip(tst, jst):
        for k in ("conv", "ssm"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
            assert not t[k][1].any()
    assert tkvp.extract_kv_entries(tst) == [] == jkvp.extract_kv_entries(jst)
    assert tkvp.packed_state_bits(tst) == {} == jkvp.packed_state_bits(jst)
    assert tkvp.kv_entry_names(tcfg) == [] == jkvp.kv_entry_names(jcfg)
