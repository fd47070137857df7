"""Port parity of the hybrid family's model (``models/hybrid.py``), on the CPU.

Reduced zamba2-2.7b (6 Mamba2 layers, the shared attention + SwiGLU block
every 2, so 3 applications; 4 heads of 32 on 2 KV heads) with the JAX
package's weights carried over by ``convert``, f32, numpy-seeded inputs.
Each entry point against its JAX twin within rel 1e-5 (the ``_rel`` of
``tests/test_kernel_parity.py``): ``forward`` and ``loss`` at mixed bits,
the gradient of every leaf (the shared block's summed over its three
applications; the Mamba leaves' within 1e-4, as the SSM twin holds them),
one AdamW QAT step from shared params and moments (the Mamba leaves again
within 1e-4);
``prefill`` with ``lengths`` and ``decode_step`` on fp and K 8 / V 4 caches,
also with ``attn_window`` cut to 8 and decoding to position 20, so that the
window bites (the same inserted rows give the JAX package's bytes).  Twins
of ``tests/test_kvcache.py::TestStatePolicy::test_hybrid_state_layer_names``,
``::test_hybrid_quantized_attn_cache``, ``TestPaddedPrefillState[hybrid]``
and ``tests/test_paged_kvcache.py::test_hybrid_paged_rejected``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import BitPolicy as JBitPolicy
from repro.kvcache import cache as jcache
from repro.kvcache import policy as jkvp
from repro.models import hybrid as jh
from repro.models import registry as jreg
from repro.quant import apply as japply
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import optimizer as jopt
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, to_tensor
from repro_torch.core.policy import BitPolicy
from repro_torch.kvcache import QuantizedKVLayer
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import policy as tkvp
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import hybrid as th
from repro_torch.models import registry as treg
from repro_torch.quant import apply as tapply
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig as TTrainConfig
from repro_torch.train.train_step import make_train_step as tmake_train_step
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(2)

ARCH = "zamba2-2.7b"
B, P, SEQ = 2, 16, 32
LENS = np.asarray([16, 11], np.int32)
FIELDS = ("k_packed", "k_scale", "v_packed", "v_scale")

_jprefill = jax.jit(jh.prefill, static_argnums=(1,), static_argnames=("qimpl",))
_jdecode = jax.jit(jh.decode_step, static_argnums=(1,), static_argnames=("qimpl",))


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _mixed(specs, seed: int):
    rng = np.random.default_rng(seed)
    tp = BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8])) for s in specs})
    return tp, JBitPolicy.from_json(tp.to_json())


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jp = jh.init(jcfg, jax.random.key(1))
    return jcfg, tcfg, jp, _port(jp)


@pytest.fixture(scope="module")
def served(model):
    jcfg, tcfg, jp, tp = model
    policy = dryrun_policy(tapply.layer_specs(tp, tcfg), "mixed")
    jserve = japply.quantize_for_serve(jh.unstack_layers(jp, jcfg),
                                       JBitPolicy.from_json(policy.to_json()), jcfg)
    return jserve, _port(jserve)


def test_init_and_the_registry_match_jax(model):
    jcfg, tcfg, jp, _ = model
    mine = th.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(mine)[0]}
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat.keys() == jflat.keys()
    for k, a in jflat.items():
        assert tuple(flat[k].shape) == a.shape and str(flat[k].dtype) == f"torch.{a.dtype}", k
    assert th.n_attn_applications(tcfg) == jh.n_attn_applications(jcfg) == 3
    assert th.n_attn_applications(dataclasses.replace(tcfg, n_layers=7)) == 4
    api = treg.get_api(tcfg)
    assert api.init is th.init and api.prefill is th.prefill and api.decode_step is th.decode_step
    assert api.decode_verify is None and api.prefill_chunk is None
    names = [s.name for s in tapply.layer_specs(mine, tcfg)]
    assert names == [s.name for s in japply.layer_specs(jp, jcfg)]
    assert "shared_attn.attn.wq" in names and "shared_attn.mlp.w_down" in names


def test_forward_loss_and_gradients_match_jax(model):
    """Mixed 2-8 bits: the hidden state, the loss and the gradient of every
    leaf; the shared block's is the sum over its applications in both."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    lab = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    tpol, jpol = _mixed(tapply.layer_specs(tp, tcfg), 3)
    jb, tb = japply.bits_for_scan(jpol, jp, jcfg), tapply.bits_for_scan(tpol, tp, tcfg)
    assert set(tb["shared_attn"]) == {"attn", "mlp"}
    jhid = jax.jit(lambda p, t, b: jh.forward(p, jcfg, t, bits=b, qimpl="xla"))(
        jp, jnp.asarray(toks), jb)
    thid = th.forward(tp, tcfg, _t(toks), bits=tb)
    assert _rel(thid.detach().numpy(), jhid) <= 1e-5
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lab)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b, bb: jreg.get_api(jcfg).loss(p, jcfg, b, bits=bb)))(jp, batch, jb)
    tl, tg = value_and_grad(lambda p, b: treg.get_api(tcfg).loss(p, tcfg, b, bits=tb), tp,
                            {"tokens": _t(toks).long(), "labels": _t(lab).long()})
    assert _rel(tl, jl) <= 1e-5
    shared = 0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        key = jax.tree_util.keystr(path)
        shared += "shared_attn" in key
        # the Mamba leaves within 1e-4, as tests/test_torch_mamba2.py holds
        # them (the scan's decay gradients); the shared block's within 1e-5
        assert _rel(b, a) <= (1e-5 if "shared_attn" in key else 1e-4), key
    assert shared == 9          # wq, wk, wv, wo, w_gate, w_up, w_down, ln1, ln2


def test_the_shared_gradient_sums_its_applications(model):
    """The one shared parameter set against three private copies of it, one
    an application: the shared leaf's gradient is the copies' sum.  The
    backward recomputes each application from the same input, which gets
    the same copy again."""
    _, tcfg, _, tp = model
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 16)))
    w = tp["shared_attn"]["attn"]["wo"].detach().clone().requires_grad_()
    copies = [w.detach().clone().requires_grad_() for _ in range(3)]
    grads = []
    for leaves in ([w] * 3, copies):
        it, seen = iter(leaves), []
        real = th._apply_shared

        def one_copy(sp, x, cfg, positions, **kw):
            leaf = next((c for y, c in seen if y is x), None)
            if leaf is None:
                leaf = next(it)
                seen.append((x, leaf))
            sp = dict(sp, attn=dict(sp["attn"], wo=leaf))
            return real(sp, x, cfg, positions, **kw)

        th._apply_shared = one_copy
        try:
            th.forward(tp, tcfg, toks).square().sum().backward()
        finally:
            th._apply_shared = real
        grads.append([t.grad for t in dict.fromkeys(leaves)])
    (summed,), per_app = grads
    torch.testing.assert_close(summed, sum(per_app), rtol=1e-5, atol=1e-6)
    assert all(float(g.abs().max()) > 0 for g in per_app)


def test_qat_step_matches_jax_from_shared_state(model):
    """Params, moments, loss and gradient norm of one AdamW QAT step."""
    jcfg, tcfg, jp, tp = model
    tp = _port(jp)                 # a copy: the step updates the leaves in place
    tpolicy, jpolicy = _mixed(tapply.layer_specs(tp, tcfg), 1)
    rng = np.random.default_rng(13)
    batches = []
    for _ in range(2):
        s = rng.integers(0, tcfg.vocab_size, (B, P + 1))
        batches.append({"tokens": s[:, :-1].astype(np.int32), "labels": s[:, 1:].astype(np.int32)})
    ocfg = dict(lr=1e-3, warmup_steps=1)
    jstep = jmake_train_step(jcfg, JTrainConfig(optimizer=jopt.OptimizerConfig(**ocfg)),
                             lambda p, b, bits: jreg.get_api(jcfg).loss(p, jcfg, b, bits=bits))
    tstep = tmake_train_step(tcfg, TTrainConfig(optimizer=topt.OptimizerConfig(**ocfg)),
                             lambda p, b, bits: treg.get_api(tcfg).loss(p, tcfg, b, bits=bits))
    jst = jopt.init(jopt.OptimizerConfig(**ocfg), jp)
    tst = topt.init(topt.OptimizerConfig(**ocfg), tp)
    jb = japply.bits_for_scan(jpolicy, jp, jcfg)
    # a step in: both packages' moments come from the JAX step
    jp1, jst, _ = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batches[0].items()}, jb)
    for dst, src in zip(topt.leaves(tp), jax.tree.leaves(jp1)):
        dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    for key in ("m", "v"):
        for dst, src in zip(tst[key], jax.tree.leaves(jst[key])):
            dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    tst["step"] = int(jst["step"])
    jp2, jst2, jm = jstep(jp1, jst, {k: jnp.asarray(v) for k, v in batches[1].items()}, jb)
    tp2, tst2, tm = tstep(tp, tst, {k: torch.as_tensor(v).long() for k, v in batches[1].items()},
                          tapply.bits_for_scan(tpolicy, tp, tcfg))
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jp2)[0]]
    # the Mamba leaves within 1e-4: their gradients part at about 1e-5 (the
    # scan's decay leaves, as in tests/test_torch_mamba2.py), and Adam's
    # division by sqrt(v) magnifies that where a gradient is near 0; every
    # other leaf, the shared block's included, within 1e-5
    tol = [1e-4 if p.startswith("['layers']") else 1e-5 for p in paths]
    jleaves = jax.tree.leaves(jp2)
    assert len(jleaves) == len(topt.leaves(tp2)) == len(paths)
    for a, b, lim, p in zip(jleaves, topt.leaves(tp2), tol, paths):
        assert b.shape == a.shape and _rel(b, a) <= lim, p
    for key in ("m", "v"):
        for a, b, lim, p in zip(jax.tree.leaves(jst2[key]), tst2[key], tol, paths):
            assert _rel(b, a) <= lim, (key, p)


def _same_rows(tst, jst):
    for t, j in zip(tst, jst):
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)


@pytest.mark.parametrize("window", (None, 8), ids=("window4096", "window8"))
@pytest.mark.parametrize("cache", ("fp", "k8v4"))
def test_prefill_and_decode_steps_match_jax(model, served, cache, window):
    """A right-padded prefill, its insert into the decode state and 8 decode
    steps (positions 16-23 and 11-18): logits rel 1e-5 at every step; the
    Mamba states rel 1e-5; on a K 8 / V 4 state the JAX prefill's rows
    insert to the JAX package's bytes.  Under a window of 8 the first slot's
    keys below position 9 leave its window by the second step."""
    jcfg, tcfg, _, _ = model
    jserve, tserve = served
    if window is not None:
        jcfg = dataclasses.replace(jcfg, attn_window=window)
        tcfg = dataclasses.replace(tcfg, attn_window=window)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, P)).astype(np.int32)
    toks[1, LENS[1]:] = 0
    jlog, jnew = _jprefill(jserve, jcfg, jnp.asarray(toks), qimpl="xla",
                           lengths=jnp.asarray(LENS))
    tlog, tnew = th.prefill(tserve, tcfg, _t(toks), lengths=_t(LENS))
    assert _rel(tlog.numpy(), jlog) <= 1e-5
    for t, j in zip(tnew["attn"], jnew["attn"]):
        assert _rel(t["k"].numpy(), j["k"]) <= 1e-5 and _rel(t["v"].numpy(), j["v"]) <= 1e-5
    bits = [(8, 4)] * 3 if cache == "k8v4" else None
    jst = jcache.insert_state_rows(jh.init_decode_state(jcfg, B, SEQ, jnp.float32,
                                                        state_bits=bits),
                                   jnp.arange(B), jnew, jnp.asarray(LENS))

    def tinsert(new):
        return tcache.insert_state_rows(th.init_decode_state(tcfg, B, SEQ, torch.float32,
                                                             state_bits=bits, device="cpu"),
                                        torch.arange(B), new, _t(LENS))

    if bits is not None:
        _same_rows(tinsert(_port(jnew))["attn"], jst["attn"])
        assert all(isinstance(a, QuantizedKVLayer) for a in tinsert(tnew)["attn"])
    tst = tinsert(tnew)
    nxt = rng.integers(0, tcfg.vocab_size, size=(8, B, 1)).astype(np.int32)
    for step in range(8):
        pos = LENS + step
        jlog, jst = _jdecode(jserve, jcfg, jst, jnp.asarray(nxt[step]), jnp.asarray(pos),
                             qimpl="xla")
        tlog, tst = th.decode_step(tserve, tcfg, tst, _t(nxt[step]), _t(pos))
        assert _rel(tlog.numpy(), jlog) <= 1e-5, step
    for t, j in zip(tst["mamba"], jst["mamba"]):
        assert _rel(t["ssm"].numpy(), j["ssm"]) <= 1e-5
        assert _rel(t["conv"].numpy(), j["conv"]) <= 1e-5


def test_the_window_bites_at_decode(model, served):
    """Under a window of 8 a decode step's logits do not move when the K/V
    rows older than the window change, and they do move without the window."""
    _, tcfg, _, _ = model
    _, tserve = served
    win = dataclasses.replace(tcfg, attn_window=8)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, tcfg.vocab_size, (1, 16)))
    out = {}
    for name, cfg in (("window", win), ("full", tcfg)):
        _, new = th.prefill(tserve, cfg, toks)
        logits = []
        for poke in (False, True):
            st = tcache.insert_state_rows(th.init_decode_state(cfg, 1, SEQ, torch.float32,
                                                               device="cpu"),
                                          [0], new, torch.tensor([16]))
            if poke:                    # rows 0-8 lie outside position 16's window
                for a in st["attn"]:
                    a["k"][:, :9] = 3.0
                    a["v"][:, :9] = -2.0
            lg, _ = th.decode_step(tserve, cfg, st, toks[:, -1:], torch.tensor([16]))
            logits.append(lg)
        out[name] = logits
    assert torch.equal(*out["window"])
    assert not torch.equal(*out["full"])


def test_hybrid_state_layer_names(model):
    jcfg, tcfg, _, _ = model
    infos = tkvp.state_layer_infos(tcfg, 2, 32)
    names = [l.name for l in infos]
    assert all(n.startswith("shared_attn.app") for n in names)
    assert names == [l.name for l in jkvp.state_layer_infos(jcfg, 2, 32)]
    assert tkvp.kv_entry_names(tcfg) == jkvp.kv_entry_names(jcfg) == [
        "shared_attn.app000", "shared_attn.app001", "shared_attn.app002"]
    state = th.init_decode_state(tcfg, 2, 32, state_bits=[(8, 4), (4, 4), (8, 8)], device="cpu")
    entries = tkvp.extract_kv_entries(state)
    assert [n for n, _ in entries] == tkvp.kv_entry_names(tcfg)
    assert all(node is a for (_, node), a in zip(entries, state["attn"]))
    assert tkvp.packed_state_bits(state) == {
        "shared_attn.app000.state.k": 8, "shared_attn.app000.state.v": 4,
        "shared_attn.app001.state.k": 4, "shared_attn.app001.state.v": 4,
        "shared_attn.app002.state.k": 8, "shared_attn.app002.state.v": 8}
    assert tkvp.resolve_state_bits(4, tcfg) == [(4, 4)] * 3
    with pytest.raises(ValueError, match="3 shared-attention applications"):
        th.init_decode_state(tcfg, 2, 32, state_bits=[(8, 8)], device="cpu")


def test_hybrid_quantized_attn_cache(model):
    jcfg, tcfg, jp, tp = model
    sp = th.unstack_layers(tp, tcfg)
    eng = ServeEngine(tcfg, sp, max_slots=2, max_seq=64, state_bits=8, device="cpu")
    outs = eng.generate([[3, 1, 4, 1, 5], [2, 7]], max_new_tokens=4)
    assert all(len(o) == 4 for o in outs)
    assert all(n.startswith("shared_attn.app") for n in eng.state_bits)
    jeng = JServeEngine(jcfg, jh.unstack_layers(jp, jcfg), max_slots=2, max_seq=64,
                        state_bits=8, qimpl="xla")
    assert jeng.generate([[3, 1, 4, 1, 5], [2, 7]], max_new_tokens=4) == outs
    assert eng.state_bits == jeng.state_bits


class TestPaddedPrefillState:
    """The recurrent decode state must not depend on the pad length."""

    def test_padded_state_equals_exact_state(self, model):
        _, tcfg, _, tp = model
        api = treg.get_api(tcfg)
        sp = api.unstack(tp, tcfg)
        prompt = [3, 1, 4, 1, 5]
        _, st_pad = api.prefill(sp, tcfg, torch.tensor([prompt + [0] * 11]),
                                lengths=torch.tensor([len(prompt)]))
        _, st_exact = api.prefill(sp, tcfg, torch.tensor([prompt]))
        for a, b in zip(st_pad["mamba"], st_exact["mamba"]):
            np.testing.assert_allclose(a["ssm"].numpy(), b["ssm"].numpy(), rtol=1e-4, atol=2e-4)
            np.testing.assert_allclose(a["conv"].numpy(), b["conv"].numpy(), rtol=1e-4,
                                       atol=2e-4)

    def test_engine_generation_pad_invariant(self, model):
        _, tcfg, _, tp = model
        sp = th.unstack_layers(tp, tcfg)
        prompts = [[3, 1, 4, 1, 5, 9, 2], [7, 7]]
        out_a = ServeEngine(tcfg, sp, max_slots=2, max_seq=64, prefill_pad=4,
                            device="cpu").generate(prompts, 5)
        out_b = ServeEngine(tcfg, sp, max_slots=2, max_seq=64, prefill_pad=16,
                            device="cpu").generate(prompts, 5)
        assert out_a == out_b


def test_hybrid_paged_rejected(model):
    _, tcfg, _, tp = model
    sp = th.unstack_layers(tp, tcfg)
    with pytest.raises(NotImplementedError, match="hybrid"):
        ServeEngine(tcfg, sp, max_slots=2, max_seq=64, state_bits=8, paged=True, device="cpu")
