"""Port parity of the serving engine: continuous batching over a packed mixed-bit cache.

Reduced gemma-2b under ``dryrun_policy("mixed")`` weights and a state
``BitPolicy`` of K 8 / V 4 bits, 4 slots, 6 requests of 2-20 tokens: more
requests than slots, so admission refills freed slots.  The JAX engine runs
``qimpl="xla"``, the port's engine its plain versions on the CPU, both on
the same weights; greedy token streams must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.kvcache import state_layer_infos
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.quant import apply as tapply
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

SLOTS, SEQ, NEW = 4, 64, 8
PROMPT_LENS = (2, 20, 7, 13, 5, 16)


def _setup():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdecoder.init(jcfg, jax.random.key(2))
    specs = tapply.layer_specs(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
                               tcfg)
    policy = dryrun_policy(specs, "mixed")
    jserve = japply.quantize_for_serve(jdecoder.unstack_layers(jp, jcfg),
                                       JBitPolicy.from_json(policy.to_json()), jcfg)
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    infos = state_layer_infos(tcfg, SLOTS, SEQ)
    state = BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                        for l in infos})
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, tcfg.vocab_size, size=n).tolist() for n in PROMPT_LENS]
    return jcfg, tcfg, jserve, tserve, state, prompts


def test_greedy_streams_match_jax_engine():
    jcfg, tcfg, jserve, tserve, state, prompts = _setup()
    jeng = JServeEngine(jcfg, jserve, max_slots=SLOTS, max_seq=SEQ, qimpl="xla",
                        state_bits=JBitPolicy.from_json(state.to_json()))
    want = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=NEW)
                     for i, p in enumerate(prompts)])
    kernels.reset_counts()
    eng = ServeEngine(tcfg, tserve, max_slots=SLOTS, max_seq=SEQ, state_bits=state,
                      device="cpu")
    assert eng.state_bits == dict(jeng.state_bits)
    assert eng.packed_bits == dict(jeng.packed_bits)
    got = eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW)
                   for i, p in enumerate(prompts)])
    assert got == want
    assert all(len(v) == NEW for v in got.values())
    st = eng.stats()
    assert st["completed"] == len(prompts)
    assert st["prefill_tokens"] == sum(n - 1 for n in PROMPT_LENS)
    assert st["decode_steps"] == jeng.stats()["decode_steps"]
    # every decode step runs 4 GEMVs and one decode step per layer; every
    # admission 4 GEMMs per layer (never a launch: these are CPU tensors)
    assert st["plain_calls"]["quant_gemv"] == 4 * tcfg.n_layers * st["decode_steps"]
    assert st["plain_calls"]["quant_kv_decode_step"] == tcfg.n_layers * st["decode_steps"]
    assert st["plain_calls"]["quant_matmul"] % (4 * tcfg.n_layers) == 0
    assert sum(st["launches"].values()) == 0
    assert eng.state_container_bytes() == jeng.state_container_bytes()
    assert eng.weight_container_bytes() == jeng.weight_container_bytes()


def test_eos_and_generate():
    _, tcfg, _, tserve, state, prompts = _setup()
    eng = ServeEngine(tcfg, tserve, max_slots=2, max_seq=SEQ, state_bits=state, device="cpu")
    first = eng.generate(prompts[:3], max_new_tokens=4)
    assert [len(t) for t in first] == [4, 4, 4]
    stop = first[1][1]
    out = eng.run([Request(uid=0, prompt=prompts[1], max_new_tokens=6, eos_id=stop)])
    assert out[0] == first[1][:first[1].index(stop) + 1]


def test_temperature_sampling_gives_valid_streams():
    _, tcfg, _, tserve, state, prompts = _setup()
    eng = ServeEngine(tcfg, tserve, max_slots=SLOTS, max_seq=SEQ, state_bits=state,
                      temperature=0.8, top_k=40, top_p=0.9, seed=5, device="cpu")
    out = eng.generate(prompts, max_new_tokens=NEW)
    assert [len(t) for t in out] == [NEW] * len(prompts)
    assert all(0 <= t < tcfg.vocab_size for toks in out for t in toks)
    again = ServeEngine(tcfg, tserve, max_slots=SLOTS, max_seq=SEQ, state_bits=state,
                        temperature=0.8, top_k=40, top_p=0.9, seed=5, device="cpu")
    assert again.generate(prompts, max_new_tokens=NEW) == out     # same seed, same draws


def test_engine_refuses_bad_input():
    _, tcfg, _, tserve, state, _ = _setup()
    eng = ServeEngine(tcfg, tserve, max_slots=2, max_seq=32, state_bits=state, device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        eng.run([Request(uid=0, prompt=list(range(1, 33)))])
    with pytest.raises(ValueError, match="params lie on"):
        ServeEngine(tcfg, tserve, device="meta")
