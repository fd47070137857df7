"""Port parity of the flash attention path (prompts and QAT sequences above 2048).

The same seeded numpy inputs go through the JAX package's ``_flash_attention``
(and ``jax.grad``) and the port's (and ``torch.autograd``), in one process.
The cases are the twins of ``tests/test_flash_vjp.py`` and the flash cases of
``tests/test_attention.py``.  Tolerances: the JAX tests' own, 3e-5 on the
forward in f32 and 3 x that on dq, dk, dv (the two packages sum the same f32
products in other orders); in bf16 storage 2e-2, a few bf16 steps, since
``p`` and ``ds`` are rounded to bf16 before their products and a sum an ulp
away from a rounding edge moves one of them by a whole step.

Then the model on reduced gemma-2b in f32 at S = 2112 (the padded length of
a 2100-token prompt): ``decoder.prefill`` logits and caches against the JAX
``prefill`` (rel 1e-4, as ``tests/test_torch_decoder.py``), the greedy
streams of a 2100-token prompt through both engines and through the port's
chunked admission (equal), and one ``lm_loss`` gradient against ``jax.grad``
(rel 1e-4 on the loss and on every leaf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.models import decoder as jdecoder
from repro.models import layers as jlayers
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy
from repro_torch.kvcache import state_layer_infos
from repro_torch.models import decoder as tdecoder
from repro_torch.models import layers as tlayers
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

ATOL = 3e-5
BF16_TOL = 2e-2


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _inputs(seed, b, sq, skv, nkv, g, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nkv * g, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32))


def _jax_flash(q, k, v, nkv, dtype=jnp.float32, **kw):
    q, k, v = (jnp.asarray(a, dtype) for a in (q, k, v))
    f = lambda q, k, v: jlayers._flash_attention(q, k, v, nkv, **kw)
    out = f(q, k, v)
    grads = jax.grad(lambda q, k, v: (f(q, k, v).astype(jnp.float32).sum() * 1e-2),
                     argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def _torch_flash(q, k, v, nkv, dtype=torch.float32, fn=None, **kw):
    fn = fn or tlayers._flash_attention
    q, k, v = (torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v))
    out = fn(q, k, v, nkv, **kw)
    (out.float().sum() * 1e-2).backward()
    return [a.detach().float().numpy() for a in (out, q.grad, k.grad, v.grad)]


def _check(b, sq, skv, nkv, g, hd, causal, window, qc=32, kc=32, seed=0):
    q, k, v = _inputs(seed or sq * skv + nkv, b, sq, skv, nkv, g, hd)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    want = _jax_flash(q, k, v, nkv, **kw)
    got = _torch_flash(q, k, v, nkv, **kw)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=ATOL)
    for a, b_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b_, atol=3 * ATOL, rtol=3 * ATOL)
    # and the port's flash against its own direct path
    direct = _torch_flash(q, k, v, nkv, fn=tlayers._direct_attention, causal=causal,
                          window=window)
    np.testing.assert_allclose(got[0], direct[0], atol=ATOL, rtol=ATOL)
    for a, b_ in zip(got[1:], direct[1:]):
        np.testing.assert_allclose(a, b_, atol=3 * ATOL, rtol=3 * ATOL)


# -- the twins of tests/test_flash_vjp.py ---------------------------------------


@pytest.mark.parametrize("case", [
    (2, 64, 64, 2, 2, 16, True, 0),          # causal
    (1, 96, 96, 3, 1, 8, True, 32),          # windowed
    (2, 32, 128, 2, 2, 16, False, 0),        # cross attention (skv > sq)
    (2, 64, 64, 1, 4, 16, True, 0),          # MQA
    (1, 48, 80, 2, 2, 8, True, 0),           # causal with q the trailing window of the keys
], ids=["causal", "windowed", "cross", "mqa", "causal_trailing"])
def test_flash_forward_and_grads_match_jax(case):
    _check(*case)


@pytest.mark.parametrize("sq,nkv,g,hd,causal", [
    (32, 1, 1, 8, True), (48, 2, 3, 16, False), (64, 3, 2, 8, True), (48, 1, 3, 16, True),
    (32, 2, 1, 16, False), (64, 1, 2, 8, False)])
def test_flash_property_shapes_match_jax(sq, nkv, g, hd, causal):
    _check(1, sq, sq, nkv, g, hd, causal, 0, qc=16, kc=16, seed=sq + 7 * nkv + g)


def test_flash_q_offset_matches_jax_and_a_slice_of_the_full():
    q, k, v = _inputs(7, 1, 32, 128, 2, 2, 16)
    kw = dict(causal=True, q_chunk=16, kv_chunk=32, q_offset=32)
    want = _jax_flash(q, k, v, 2, **kw)
    got = _torch_flash(q, k, v, 2, **kw)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=ATOL)
    for a, b_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b_, atol=3 * ATOL, rtol=3 * ATOL)
    full_q = torch.zeros((1, 128, 4, 16))
    full_q[:, 32:64] = torch.tensor(q)
    ref = tlayers._direct_attention(full_q, torch.tensor(k), torch.tensor(v), 2,
                                    causal=True)[:, 32:64]
    np.testing.assert_allclose(got[0], ref.numpy(), atol=2e-5)


def test_flash_bf16_storage_matches_jax():
    """bf16 q, k, v with f32 accumulation: the port against the JAX flash path
    in bf16 (``BF16_TOL``), and within bf16 tolerance of the f32 result."""
    q, k, v = _inputs(3, 2, 64, 64, 2, 2, 16)
    kw = dict(causal=True, q_chunk=32, kv_chunk=32)
    want = _jax_flash(q, k, v, 2, dtype=jnp.bfloat16, **kw)
    got = _torch_flash(q, k, v, 2, dtype=torch.bfloat16, **kw)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, b_, atol=BF16_TOL, rtol=BF16_TOL)
    hi = _torch_flash(q, k, v, 2, **kw)
    np.testing.assert_allclose(got[0], hi[0], atol=3e-2, rtol=3e-2)


# -- the flash cases of tests/test_attention.py ----------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_matches_direct_and_jax(causal, window):
    _check(2, 64, 64, 2, 2, 16, causal, window, qc=16, kc=16, seed=1)


def test_flash_uneven_chunks_and_mqa():
    _check(1, 128, 128, 1, 8, 8, True, 0, qc=32, kc=64, seed=2)


def test_flash_chunks_are_the_references_divisors():
    assert tlayers._largest_divisor_leq(2112, tlayers.Q_CHUNK) == 352
    assert tlayers._largest_divisor_leq(2112, tlayers.KV_CHUNK) == 704
    for n in (1, 7, 96, 2049, 4096):
        for t in (16, 512, 1024):
            assert (tlayers._largest_divisor_leq(n, t)
                    == jlayers._largest_divisor_leq(n, t))


def test_attention_takes_the_flash_path_above_the_threshold(monkeypatch):
    """``layers.attention`` above ``FLASH_THRESHOLD`` (and only there, and
    never for one query) runs ``_flash_attention``, as the reference does."""
    cfg = tconfigs.get_config("gemma-2b").reduced()
    p = tlayers.attention_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    calls = []
    real = tlayers._flash_attention
    monkeypatch.setattr(tlayers, "_flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw))
    monkeypatch.setattr(tlayers, "FLASH_THRESHOLD", 16)
    for s in (16, 24):
        x = torch.randn((1, s, cfg.d_model), generator=torch.Generator().manual_seed(s))
        out = tlayers.attention(p, x, cfg, tlayers.position_ids(1, s, device="cpu"))
        assert out.shape == (1, s, cfg.d_model)
    assert calls == [24]


# -- reduced gemma-2b above 2048 --------------------------------------------------

LONG = 2100                  # prompt tokens; the engines pad the head to 2112
SEQ = 2176                   # max_seq: the prompt, 8 new tokens and block slack
NEW = 8


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jp = jdecoder.init(jcfg, jax.random.key(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_prefill_above_the_threshold_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    jserve, tserve = jdecoder.unstack_layers(jp, jcfg), tdecoder.unstack_layers(tp, tcfg)
    s = 2112
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (1, s)).astype(np.int32)
    jlog, jkv = jax.jit(jdecoder.prefill, static_argnums=(1,))(jserve, jcfg,
                                                                 jnp.asarray(toks))
    tlog, tkv = tdecoder.prefill(tserve, tcfg, torch.from_numpy(toks))
    assert tlog.shape == (1, 1, tcfg.vocab_size)
    assert _rel(tlog.numpy(), jlog) <= 1e-4
    for j, t in zip(jkv, tkv):
        assert _rel(t["k"].numpy(), j["k"]) <= 1e-4 and _rel(t["v"].numpy(), j["v"]) <= 1e-4


def test_long_prompt_streams_match_jax_and_chunked_admission(model):
    """A 2100-token prompt beside two short ones, K 8 / V 4 state: the port's
    whole-prompt engine (flash prefill at 2112) emits the JAX engine's greedy
    streams, and its 256-token chunked admission emits the same."""
    jcfg, tcfg, jp, tp = model
    jserve, tserve = jdecoder.unstack_layers(jp, jcfg), tdecoder.unstack_layers(tp, tcfg)
    infos = state_layer_infos(tcfg, 3, SEQ)
    state = BitPolicy.from_bits(infos, {l.name: 8 if l.name.endswith(".k") else 4
                                        for l in infos})
    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in (LONG, 17, 33)]
    jeng = JServeEngine(jcfg, jserve, max_slots=3, max_seq=SEQ, qimpl="xla",
                        state_bits=JBitPolicy.from_json(state.to_json()))
    want = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=NEW)
                     for i, p in enumerate(prompts)])
    outs = {}
    for key, kw in (("whole", {}), ("chunked", dict(prefill_chunk=256))):
        eng = ServeEngine(tcfg, tserve, max_slots=3, max_seq=SEQ, state_bits=state,
                          device="cpu", **kw)
        outs[key] = eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW)
                             for i, p in enumerate(prompts)])
    assert outs["whole"] == want
    assert outs["chunked"] == want
    assert all(len(v) == NEW for v in want.values())


def test_lm_loss_gradient_above_the_threshold_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    s = 2112
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tcfg.vocab_size, (1, s)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (1, s)).astype(np.int32)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jdecoder.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                                   loss_chunk=1056)))(jp)
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    loss = tdecoder.lm_loss(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(labels),
                            loss_chunk=1056)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert _rel(loss.detach().numpy(), jloss) <= 1e-4
    tgrad, tdef = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.grad.numpy(), tp))
    jleaves, jdef = jax.tree.flatten(jgrad)
    assert tdef.num_leaves == jdef.num_leaves
    for (path, t), j in zip(tgrad, jleaves):
        assert t.shape == j.shape, path
        assert _rel(t, j) <= 1e-4, (path, _rel(t, j))
