"""Port parity of the MoE family end to end: the decoder's paths and the engine.

Reduced deepseek-moe-16b (2 layers, 8 experts, top-2, one shared expert)
under ``dryrun_policy("mixed")`` weights, packed and fused, and a K 8 / V 4
state.  The JAX package runs ``qimpl="xla"``, the port its plain versions on
the CPU, on the same weights (``convert.params_from_numpy``): logits to rel
1e-4, packed state bytes equal for the same K/V rows (and near, level by
level, for each package's own rows), and the engines' greedy streams and
counters equal in four modes (dense, paged over a small pool, speculative
K 2 from a 4-bit draft, chunked); reduced llama4 (top-1) dense.  Every
engine gets ``ShedPolicy(straggler_sheds_spec=False)``: the straggler shed
reads the host clock.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.kvcache import cache as jcache
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.lifecycle import ShedPolicy as JShedPolicy
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core import packing as tpacking
from repro_torch.core.policy import BitPolicy
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import state_layer_infos
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.quant import apply as tapply
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.lifecycle import ShedPolicy

torch.set_num_threads(2)

B, P, SEQ, STEPS = 2, 16, 64, 3
LENS = np.asarray([16, 11], np.int32)
FIELDS = ("k_packed", "k_scale", "v_packed", "v_scale")
SHED = ShedPolicy(straggler_sheds_spec=False)
JSHED = JShedPolicy(straggler_sheds_spec=False)

_jprefill = jax.jit(jdecoder.prefill, static_argnums=(1,), static_argnames=("qimpl",))
_jdecode = jax.jit(jdecoder.decode_step, static_argnums=(1,), static_argnames=("qimpl",))
_jchunk = jax.jit(jdecoder.prefill_chunk, static_argnums=(1,), static_argnames=("qimpl",))


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _served(arch: str, seed: int):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = jdecoder.init(jcfg, jax.random.key(seed))
    specs = tapply.layer_specs(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
                               tcfg)
    policy = dryrun_policy(specs, "mixed")
    jserve = japply.fuse_projections(japply.quantize_for_serve(
        jdecoder.unstack_layers(jp, jcfg), JBitPolicy.from_json(policy.to_json()), jcfg))
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jserve=jserve, tserve=tserve, specs=specs)


@pytest.fixture(scope="module")
def served():
    return _served("deepseek-moe-16b", 4)


def _same_state(tst, jst):
    for t, j in zip(tst, jst):
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)


def _near_state(tst, jst):
    """Caches written from K/V rows that agree to rel 1e-6 (their projections
    sum in another order): scales within rel 1e-6, levels within one step at
    no more than 0.1 % of entries (a value at a rounding edge)."""
    for t, j in zip(tst, jst):
        for side, bits in (("k", t.k_bits), ("v", t.v_bits)):
            np.testing.assert_allclose(getattr(t, f"{side}_scale").numpy(),
                                       np.asarray(getattr(j, f"{side}_scale")), rtol=1e-6, atol=0)
            lev = tpacking.unpack(getattr(t, f"{side}_packed"), bits, t.head_dim)
            jlev = tpacking.unpack(torch.from_numpy(np.array(getattr(j, f"{side}_packed"))),
                                   bits, t.head_dim)
            assert int((lev - jlev).abs().max()) <= 1
            assert float((lev != jlev).float().mean()) <= 1e-3


def test_registry_serves_the_moe_family(served):
    api = registry.get_api(served["tcfg"])
    assert api.decode_verify is tdecoder.decode_verify and api.prefill is tdecoder.prefill
    mlp = served["tserve"]["layers"][1]["mlp"]
    assert mlp["w_gate"].packed.ndim == 3 and "w_gu" in mlp["shared"]
    assert mlp["router"].dtype == torch.float32
    # every family of the JAX registry is served since the hybrid and
    # encoder-decoder families were ported
    from repro_torch.models import encdec as tencdec
    from repro_torch.models import hybrid as thybrid
    for fam, mod in (("hybrid", thybrid), ("encdec", tencdec), ("audio", tencdec)):
        api = registry.get_api(type("C", (), {"family": fam})())
        assert api.prefill is mod.prefill and api.decode_step is mod.decode_step
        assert api.decode_verify is None


def test_decoder_paths_match_jax(served):
    """prefill (with lengths), the insert into a K 8 / V 4 cache, decode
    steps and a verify burst: logits to rel 1e-4; the insert of the same rows
    gives the JAX package's bytes, and the caches the two packages write
    from their own rows agree as ``_near_state`` says."""
    jcfg, tcfg, jserve, tserve = (served[k] for k in ("jcfg", "tcfg", "jserve", "tserve"))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, P)).astype(np.int32)
    toks[1, LENS[1]:] = 0                                   # right padding
    jlog, jkv = _jprefill(jserve, jcfg, jnp.asarray(toks), qimpl="xla",
                          lengths=jnp.asarray(LENS))
    kernels.reset_counts()
    tlog, tkv = tdecoder.prefill(tserve, tcfg, torch.from_numpy(toks),
                                 lengths=torch.from_numpy(LENS))
    assert _rel(tlog.numpy(), jlog) <= 1e-4
    for j, t in zip(jkv, tkv):
        assert _rel(t["k"].numpy(), j["k"]) <= 1e-4 and _rel(t["v"].numpy(), j["v"]) <= 1e-4
    # B * P = 32 tokens: capacity 16, the GEMM's expert stack, 3 calls a layer
    assert tmoe.capacity(B * P, tcfg) == 16
    assert kernels.PLAIN_CALLS["quant_matmul_experts"] == 3 * tcfg.n_layers

    bits = [(8, 4)] * tcfg.n_layers
    jst = jcache.insert_state_rows(jdecoder.init_cache(jcfg, B, SEQ, state_bits=bits),
                                   jnp.arange(B), jkv, jnp.asarray(LENS))

    def tinsert(kv):
        return tcache.insert_state_rows(tdecoder.init_cache(tcfg, B, SEQ, state_bits=bits,
                                                            device="cpu"),
                                        torch.arange(B), kv, torch.from_numpy(LENS))

    _same_state(tinsert([{n: torch.from_numpy(np.array(j[n])) for n in ("k", "v")}
                         for j in jkv]), jst)
    tst = tinsert(tkv)
    _near_state(tst, jst)
    nxt = rng.integers(0, tcfg.vocab_size, size=(STEPS, B, 1)).astype(np.int32)
    kernels.reset_counts()
    for step in range(STEPS):
        pos = LENS + step
        jlog, jst = _jdecode(jserve, jcfg, jst, jnp.asarray(nxt[step]), jnp.asarray(pos),
                             qimpl="xla")
        tlog, tst = tdecoder.decode_step(tserve, tcfg, tst, torch.from_numpy(nxt[step]),
                                         torch.from_numpy(pos))
        assert _rel(tlog.numpy(), jlog) <= 1e-4, step
    _near_state(tst, jst)
    # 2 tokens a step: capacity 8, the GEMV's expert stack
    assert kernels.PLAIN_CALLS["quant_gemv_experts"] == 3 * tcfg.n_layers * STEPS
    assert kernels.PLAIN_CALLS["quant_matmul_experts"] == 0
    burst = rng.integers(0, tcfg.vocab_size, size=(B, 3)).astype(np.int32)
    pos = LENS + STEPS
    jlog, jst, jburst = jdecoder.decode_verify(jserve, jcfg, jst, jnp.asarray(burst),
                                               jnp.asarray(pos), qimpl="xla")
    tlog, tst, tburst = tdecoder.decode_verify(tserve, tcfg, tst, torch.from_numpy(burst),
                                               torch.from_numpy(pos))
    assert tlog.shape == (B, 3, tcfg.vocab_size) and _rel(tlog.numpy(), jlog) <= 1e-4
    for (tk, tv), (jk, jv) in zip(tburst, jburst):
        assert _rel(tk.numpy(), jk) <= 1e-4 and _rel(tv.numpy(), jv) <= 1e-4
    _near_state(tst, jst)


def test_prefill_chunk_matches_jax(served):
    jcfg, tcfg, jserve, tserve = (served[k] for k in ("jcfg", "tcfg", "jserve", "tserve"))
    toks = np.random.default_rng(8).integers(1, tcfg.vocab_size, size=(1, 20)).astype(np.int32)
    jscr = jdecoder.init_prefill_scratch(jcfg, 32)
    tscr = tdecoder.init_prefill_scratch(tcfg, 32, device="cpu")
    for off in range(0, 20, 8):
        jscr = _jchunk(jserve, jcfg, jscr, jnp.asarray(toks[:, off:off + 8]), off, qimpl="xla")
        tscr = tdecoder.prefill_chunk(tserve, tcfg, tscr, torch.from_numpy(toks[:, off:off + 8]),
                                      off)
    for j, t in zip(jscr, tscr):
        assert _rel(t["k"].numpy(), j["k"]) <= 1e-4 and _rel(t["v"].numpy(), j["v"]) <= 1e-4


def test_padded_prefill_moves_moe_outputs_in_the_reference(served):
    """Pad tokens route and take expert capacity in the reference, so a
    prompt's prefill depends on what it is batched with: 16 copies of one
    token overflow two experts' capacity alone (t 16, C 8) and fit beside a
    padded second row (t 32, C 16).  The port does the same."""
    jcfg, tcfg, jserve, tserve = (served[k] for k in ("jcfg", "tcfg", "jserve", "tserve"))
    one = np.full((1, P), 9, np.int32)
    two = np.concatenate([one, np.zeros((1, P), np.int32)])
    lens = np.asarray([P, 1], np.int32)
    jalone = _jprefill(jserve, jcfg, jnp.asarray(one), qimpl="xla", lengths=jnp.asarray(lens[:1]))
    jbatch = _jprefill(jserve, jcfg, jnp.asarray(two), qimpl="xla", lengths=jnp.asarray(lens))
    talone = tdecoder.prefill(tserve, tcfg, torch.from_numpy(one), lengths=torch.from_numpy(
        lens[:1]))
    tbatch = tdecoder.prefill(tserve, tcfg, torch.from_numpy(two), lengths=torch.from_numpy(lens))
    assert _rel(jalone[0], jbatch[0][:1]) > 1e-3              # the reference's difference
    assert _rel(talone[0].numpy(), jalone[0]) <= 1e-4
    assert _rel(tbatch[0].numpy(), jbatch[0]) <= 1e-4


MODES = {
    "dense": {},
    "paged": {"paged": True, "pool_blocks": 12},
    "speculative": {"speculate": 2, "draft_policy": 4},
    "chunked": {"prefill_chunk": 4},
}
SLOTS, NEW = 3, 8
PROMPT_LENS = (2, 20, 7, 13, 5, 16)


def _engines(served, **kw):
    state = BitPolicy.from_bits(state_layer_infos(served["tcfg"], SLOTS, SEQ),
                                {l.name: 8 if l.name.endswith(".k") else 4
                                 for l in state_layer_infos(served["tcfg"], SLOTS, SEQ)})
    args = dict(max_slots=SLOTS, max_seq=SEQ, prefill_pad=8, **kw)
    jeng = JServeEngine(served["jcfg"], served["jserve"], qimpl="xla", shed=JSHED,
                        state_bits=JBitPolicy.from_json(state.to_json()), **args)
    eng = ServeEngine(served["tcfg"], served["tserve"], state_bits=state, shed=SHED,
                      device="cpu", **args)
    return jeng, eng


def _prompts(tcfg):
    rng = np.random.default_rng(11)
    return [rng.integers(1, tcfg.vocab_size, size=n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_and_counters_match_jax(served, mode):
    jeng, eng = _engines(served, **MODES[mode])
    prompts = _prompts(served["tcfg"])
    want = jeng.generate(prompts, max_new_tokens=NEW)
    kernels.reset_counts()
    assert eng.generate(prompts, max_new_tokens=NEW) == want
    st, jst = eng.stats(), jeng.stats()
    for key in ("decode_steps", "prefill_tokens", "completed", "spec_steps", "spec_proposed",
                "spec_accepted"):
        assert st[key] == jst[key], key
    assert eng.weight_container_bytes() == jeng.weight_container_bytes()
    if mode == "speculative":
        assert st["spec_steps"] > 0 and st["speculate_live_k"] == 2
        assert st["draft_bits"] == dict(jeng.draft_bits)
    if mode == "paged":
        assert eng.pool.peak_allocated == jeng.pool.peak_allocated
        assert eng.pool.allocated == eng.pool.reserved == 0
    # one expert call a linear for all experts: 3 a layer a pass
    calls = st["plain_calls"]
    assert (calls["quant_gemv_experts"] + calls["quant_matmul_experts"]) % (
        3 * served["tcfg"].n_layers) == 0 and calls["quant_gemv_experts"] > 0
    assert sum(st["launches"].values()) == 0


def test_llama4_dense_engine_matches_jax():
    served = _served("llama4-maverick-400b-a17b", 5)
    assert served["tcfg"].top_k == 1
    jeng, eng = _engines(served)
    prompts = _prompts(served["tcfg"])
    assert eng.generate(prompts, max_new_tokens=NEW) == jeng.generate(prompts, max_new_tokens=NEW)
    assert eng.stats()["decode_steps"] == jeng.stats()["decode_steps"]


def test_serve_cli_runs_the_moe_family(capsys):
    assert tserve_cli.main(["--arch", "deepseek-moe-16b", "--reduced", "--requests", "3",
                            "--max-new", "4", "--wbits", "mixed", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 new tokens" in out and "quantized: mean_bits=" in out
