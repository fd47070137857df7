"""Port parity of the dense decoder: prefill and decode over a packed mixed-bit cache.

The JAX package's weights (``dryrun_policy("mixed")``, packed and fused)
cross into the port through ``convert.params_from_numpy``; the JAX side runs
``qimpl="xla"``, the port its plain versions on the CPU.  f32 on reduced
configs (2 layers): logits agree to rel 1e-4.  Cache bytes are not compared
here: a K value a ulp away from a rounding tie may move one level between
the two (their projections sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kvcache import cache as jcache
from repro.models import decoder as jdecoder
from repro.quant import apply as japply
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.kvcache import cache as tcache
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import decoder as tdecoder
from repro_torch.quant import apply as tapply

torch.set_num_threads(2)

B, P, SEQ, STEPS = 2, 12, 64, 4
LENS = np.asarray([12, 9], np.int32)
STATE_BITS = [(8, 4), (4, 2)]        # per layer (k_bits, v_bits)


# jitted as the JAX engine runs them: eager op-by-op dispatch is several times slower
_jprefill = jax.jit(jdecoder.prefill, static_argnums=(1,), static_argnames=("qimpl",))
_jdecode = jax.jit(jdecoder.decode_step, static_argnums=(1,), static_argnames=("qimpl",))


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _serve_params(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = jdecoder.init(jcfg, jax.random.key(1))
    specs = tapply.layer_specs(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
                               tcfg)
    policy = dryrun_policy(specs, "mixed")
    jserve = japply.fuse_projections(japply.quantize_for_serve(
        jdecoder.unstack_layers(jp, jcfg),
        japply.BitPolicy.from_json(policy.to_json()), jcfg))
    tserve = params_from_numpy(jax.tree.map(np.asarray, jserve), device="cpu")
    return jcfg, tcfg, jserve, tserve


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_prefill_and_decode_logits_match_jax(arch):
    jcfg, tcfg, jserve, tserve = _serve_params(arch)
    assert "wqkv" in tserve["layers"][1]["attn"] and "w_gu" in tserve["layers"][1]["mlp"]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, P)).astype(np.int32)
    toks[1, LENS[1]:] = 0                                   # right padding
    nxt = rng.integers(0, tcfg.vocab_size, size=(STEPS, B, 1)).astype(np.int32)

    jlog, jkv = _jprefill(jserve, jcfg, jnp.asarray(toks), qimpl="xla")
    kernels.reset_counts()
    tlog, tkv = tdecoder.prefill(tserve, tcfg, torch.from_numpy(toks))
    assert tlog.shape == (B, 1, tcfg.vocab_size)
    assert _rel(tlog.numpy(), jlog) <= 1e-4
    for j, t in zip(jkv, tkv):
        assert _rel(t["k"].numpy(), j["k"]) <= 1e-4 and _rel(t["v"].numpy(), j["v"]) <= 1e-4

    jst = jdecoder.init_cache(jcfg, B, SEQ, state_bits=STATE_BITS)
    jst = jcache.insert_state_rows(jst, jnp.arange(B), jkv, jnp.asarray(LENS))
    tst = tdecoder.init_cache(tcfg, B, SEQ, state_bits=STATE_BITS, device="cpu")
    tst = tcache.insert_state_rows(tst, torch.arange(B), tkv, torch.from_numpy(LENS))
    for j, t in zip(jst, tst):
        assert (t.k_bits, t.v_bits, t.block, t.shape) == (j.k_bits, j.v_bits, j.block, j.shape)

    for step in range(STEPS):
        pos = LENS + step
        jlog, jst = _jdecode(jserve, jcfg, jst, jnp.asarray(nxt[step]), jnp.asarray(pos),
                             qimpl="xla")
        tlog, tst = tdecoder.decode_step(tserve, tcfg, tst, torch.from_numpy(nxt[step]),
                                         torch.from_numpy(pos))
        assert tlog.shape == (B, 1, tcfg.vocab_size)
        assert _rel(tlog.numpy(), jlog) <= 1e-4, step
    per_pass = 4 * tcfg.n_layers                            # wqkv, wo, w_gu, w_down
    head = 0 if tcfg.tie_embeddings else 1                  # an untied packed lm_head
    assert kernels.PLAIN_CALLS["quant_matmul"] == per_pass  # prefill: M = B * P > 8
    assert kernels.PLAIN_CALLS["quant_gemv"] == (STEPS + 1) * head + STEPS * per_pass
    assert kernels.PLAIN_CALLS["quant_kv_decode_step"] == STEPS * tcfg.n_layers
    assert sum(kernels.LAUNCHES.values()) == 0


def test_fp_cache_decode_matches_jax():
    jcfg, tcfg, jserve, tserve = _serve_params("gemma-2b")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, size=(B, P)).astype(np.int32)
    _, jkv = _jprefill(jserve, jcfg, jnp.asarray(toks), qimpl="xla")
    _, tkv = tdecoder.prefill(tserve, tcfg, torch.from_numpy(toks), logits=False)
    jst = jcache.insert_state_rows(jdecoder.init_cache(jcfg, B, SEQ, jnp.float32),
                                   jnp.arange(B), jkv, jnp.asarray(LENS))
    tst = tcache.insert_state_rows(tdecoder.init_cache(tcfg, B, SEQ, torch.float32,
                                                       device="cpu"),
                                   torch.arange(B), tkv, torch.from_numpy(LENS))
    tok = np.asarray([[5], [9]], np.int32)
    jlog, _ = _jdecode(jserve, jcfg, jst, jnp.asarray(tok), jnp.asarray(LENS), qimpl="xla")
    tlog, _ = tdecoder.decode_step(tserve, tcfg, tst, torch.from_numpy(tok),
                                   torch.from_numpy(LENS))
    assert _rel(tlog.numpy(), jlog) <= 1e-4


def test_init_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("gemma-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdecoder.init(cfg)
    params = tdecoder.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["layers"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                                    cfg.n_heads * cfg.resolved_head_dim)
    policy = BitPolicy.uniform(tapply.layer_specs(params, cfg), 4)
    serve = tapply.quantize_for_serve(tdecoder.unstack_layers(params, cfg), policy, cfg)
    assert tapply.packed_policy_bits(serve) == policy.bits
