"""Port parity of the encoder-decoder family (``models/encdec.py``, whisper-tiny), on the CPU.

Reduced whisper-tiny (2 encoder and 2 decoder layers, d 128, 4 heads of
32 on 2 KV heads, LayerNorm, GELU, 16 frames) with the JAX package's weights carried over
by ``convert``, f32, numpy-seeded inputs; the JAX side runs ``qimpl="xla"``.
Tolerances: ``layernorm`` forward and the gradients of x, scale and bias
within rel 1e-5; ``sinusoid`` within rel 1e-6 (the power matches XLA's bit
for bit; ``sin`` / ``cos`` leave one f32 ulp on about 5 % of entries at
1500 x 384); ``cross_kv`` and ``attention(kv=)`` on float, packed and fused
trees, ``encode``, ``decode_train``, ``loss``, every gradient and one AdamW
QAT step from shared params and moments at mixed bits within rel 1e-5 (the
step's LayerNorm leaves within 5e-5: Adam magnifies the parting of a
gradient entry near 0);
``prefill(tokens, frames)`` then 8 greedy ``decode_step`` tokens identical,
logits within rel 1e-5, and ``prepare_decode``'s cross K/V equal to
``prefill``'s.  The twin of ``tests/test_quant_apply.py``'s ``whisper``
cases (names, weights, bits trees, packed bytes), ``global_batch``'s frames,
``ServeEngine``'s refusal, and the train and search command lines.
"""
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
from repro.launch import search as jsearch
from repro.models import encdec as je
from repro.models import layers as jl
from repro.models import registry as jreg
from repro.quant import apply as japply
from repro.train import optimizer as jopt
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeSpec as TShape
from repro_torch.convert import params_from_numpy, to_tensor
from repro_torch.core import policy as tpol
from repro_torch.core.controller import ControllerConfig as TCC
from repro_torch.data.pipeline import TokenTask, global_batch
from repro_torch.launch import search as tsearch
from repro_torch.launch import train as ttrain
from repro_torch.launch.dryrun import dryrun_policy
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models import registry as treg
from repro_torch.quant import apply as tapply
from repro_torch.quant.env import LMQuantEnv as TLM
from repro_torch.quant.tensor import QuantizedTensor
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig as TTrainConfig
from repro_torch.train.train_step import make_train_step as tmake_train_step
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(2)

ARCH = "whisper-tiny"
B, S = 2, 12

_jprefill = jax.jit(je.prefill, static_argnums=(1,), static_argnames=("qimpl",))
_jdecode = jax.jit(je.decode_step, static_argnums=(1,), static_argnames=("qimpl",))


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
    tp = tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8])) for s in specs})
    return tp, jpol.BitPolicy.from_json(tp.to_json())


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    s = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"frames": (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.02
                       ).astype(np.float32),
            "tokens": s[:, :-1].astype(np.int32), "labels": s[:, 1:].astype(np.int32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) if k == "frames" else _t(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jp = je.init(jcfg, jax.random.key(2))
    return jcfg, tcfg, jp, _port(jp)


@pytest.fixture(scope="module")
def served(model):
    """Packed under ``dryrun_policy("mixed")``, then the projections fused
    (``wqkv`` in the self- and the cross-attention where the bits agree)."""
    jcfg, tcfg, jp, tp = model
    policy = dryrun_policy(tapply.layer_specs(tp, tcfg), "mixed")
    jserve = japply.fuse_projections(japply.quantize_for_serve(
        je.unstack_layers(jp, jcfg), jpol.BitPolicy.from_json(policy.to_json()), jcfg))
    return jserve, _port(jserve)


def test_layernorm_forward_and_backward_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 384)) * 2 + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(384)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(384)).astype(np.float32)}
    g = rng.standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda x_, p_: jl.layernorm(p_, x_), jnp.asarray(x),
                      jax.tree.map(jnp.asarray, p))
    jdx, jdp = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    ty = tl.layernorm(tp, tx)
    ty.backward(_t(g))
    assert _rel(ty.detach().numpy(), jy) <= 1e-5
    assert _rel(tx.grad.numpy(), jdx) <= 1e-5
    for k in ("scale", "bias"):
        assert _rel(tp[k].grad.numpy(), jdp[k]) <= 1e-5
    assert tl.norm(p={k: _t(v) for k, v in p.items()}, x=_t(x), kind="layernorm").shape == x.shape
    ln = tl.norm_init(8, "layernorm", lead=(3,), device="cpu")
    assert set(ln) == {"scale", "bias"} and ln["scale"].shape == (3, 8)
    assert not ln["bias"].any() and bool((ln["scale"] == 1).all())
    assert tl.norm_init(8, "rmsnorm", device="cpu").shape == (8,)


@pytest.mark.parametrize("seq,d,offset", [(1500, 384, 0), (16, 128, 0), (1, 384, 37)])
def test_sinusoid_matches_jax(seq, d, offset):
    out = te.sinusoid(seq, d, offset).numpy()
    ref = np.asarray(je.sinusoid(seq, d, offset))
    assert out.shape == ref.shape == (seq, d)
    assert _rel(out, ref) <= 1e-6
    assert np.abs(out - ref).max() <= 6e-8        # one ulp near 1, where they differ


@pytest.mark.parametrize("tree", ("float", "packed", "fused"))
def test_cross_kv_and_attention_with_kv_match_jax(model, served, tree):
    jcfg, tcfg, jp, tp = model
    if tree == "float":
        jlp = jax.tree.map(lambda a: a[0], jp["dec_layers"])["cross_attn"]
        tlp = {k: v[0] for k, v in tp["dec_layers"]["cross_attn"].items()}
    else:
        jserve, tserve = served
        if tree == "packed":
            jserve = japply.quantize_for_serve(
                je.unstack_layers(jp, jcfg), jpol.BitPolicy.uniform(
                    japply.layer_specs(jp, jcfg), 4), jcfg)
            tserve = _port(jserve)
        jlp, tlp = jserve["dec_layers"][1]["cross_attn"], tserve["dec_layers"][1]["cross_attn"]
        assert ("wqkv" in tlp) == (tree == "fused") and isinstance(tlp["wo"], QuantizedTensor)
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((B, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 5, tcfg.d_model)).astype(np.float32)
    jk, jv = jl.cross_kv(jlp, jnp.asarray(ctx), jcfg, qimpl="xla")
    tk, tv = tl.cross_kv(tlp, _t(ctx), tcfg)
    assert tk.shape == (B, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    assert _rel(tk.numpy(), jk) <= 1e-5 and _rel(tv.numpy(), jv) <= 1e-5
    pos = jl.position_ids(B, 5, "none")
    jo = jl.attention(jlp, jnp.asarray(x), jcfg, pos, causal=False, kv=(jk, jv), qimpl="xla")
    to = tl.attention(tlp, _t(x), tcfg, _t(pos), causal=False, kv=(tk, tv))
    assert _rel(to.numpy(), jo) <= 1e-5
    q = tl._q_proj(tlp, _t(x), tcfg)
    assert q.shape == (B, 5, tcfg.n_heads * tcfg.resolved_head_dim)


def test_init_and_the_registry_match_jax(model):
    jcfg, tcfg, jp, _ = model
    mine = te.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(mine)[0]}
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat.keys() == jflat.keys()
    for k, a in jflat.items():
        assert tuple(flat[k].shape) == a.shape and str(flat[k].dtype) == f"torch.{a.dtype}", k
    for fam in ("encdec", "audio"):
        api = treg.get_api(type("C", (), {"family": fam})())
        assert api.prefill is te.prefill and api.loss is te.loss and api.decode_verify is None
    api = treg.get_api(tcfg)
    state = api.init_decode_state(tcfg, 2, 24, torch.float32, device="cpu")
    assert [tuple(c["k"].shape) for c in state["self"]] == [(2, 24, 2, 32)] * 2
    assert [tuple(c["v"].shape) for c in state["cross"]] == [(2, 16, 2, 32)] * 2
    for kw in ({"state_bits": 8}, {"paged": True}):
        with pytest.raises(ValueError, match="no engine-managed KV state"):
            api.init_decode_state(tcfg, 2, 24, device="cpu", **kw)


def test_encode_decode_train_loss_and_gradients_match_jax(model):
    jcfg, tcfg, jp, tp = model
    tpolicy, jpolicy = _mixed(tapply.layer_specs(tp, tcfg), 3)
    jbits, tbits = japply.bits_for_scan(jpolicy, jp, jcfg), tapply.bits_for_scan(tpolicy, tp, tcfg)
    assert set(tbits) == {"embed", "lm_head", "enc_layers", "dec_layers"}
    batch = _batch(tcfg, 5)
    jenc = je.encode(jp, jcfg, jnp.asarray(batch["frames"]), bits=jbits, qimpl="xla")
    tenc = te.encode(tp, tcfg, _t(batch["frames"]), bits=tbits)
    assert _rel(tenc.detach().numpy(), jenc) <= 1e-5
    jhid = je.decode_train(jp, jcfg, jnp.asarray(batch["tokens"]), jenc, bits=jbits, qimpl="xla")
    thid = te.decode_train(tp, tcfg, _t(batch["tokens"]).long(), tenc, bits=tbits)
    assert _rel(thid.detach().numpy(), jhid) <= 1e-5
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b, bb: jreg.get_api(jcfg).loss(p, jcfg, b, bits=bb)))(jp, _jb(batch), jbits)
    tloss, tg = value_and_grad(lambda p, b: treg.get_api(tcfg).loss(p, tcfg, b, bits=tbits),
                               tp, _tb(batch))
    assert _rel(tloss, jloss) <= 1e-5
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        assert _rel(b, a) <= 1e-5, jax.tree_util.keystr(path)


def test_qat_step_matches_jax_from_shared_state(model):
    """Params, moments, loss and gradient norm of one AdamW QAT step."""
    jcfg, tcfg, jp, _ = model
    tp = _port(jp)                 # a copy: the step updates the leaves in place
    tpolicy, jpolicy = _mixed(tapply.layer_specs(tp, tcfg), 1)
    ocfg = dict(lr=1e-3, warmup_steps=1)
    jstep = jmake_train_step(jcfg, JTrainConfig(optimizer=jopt.OptimizerConfig(**ocfg)),
                             lambda p, b, bits: jreg.get_api(jcfg).loss(p, jcfg, b, bits=bits))
    tstep = tmake_train_step(tcfg, TTrainConfig(optimizer=topt.OptimizerConfig(**ocfg)),
                             lambda p, b, bits: treg.get_api(tcfg).loss(p, tcfg, b, bits=bits))
    jst = jopt.init(jopt.OptimizerConfig(**ocfg), jp)
    tst = topt.init(topt.OptimizerConfig(**ocfg), tp)
    jbits = japply.bits_for_scan(jpolicy, jp, jcfg)
    # a step in: both packages' moments come from the JAX step
    jp1, jst, _ = jstep(jp, jst, _jb(_batch(tcfg, 6)), jbits)
    for dst, src in zip(topt.leaves(tp), jax.tree.leaves(jp1)):
        dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    for key in ("m", "v"):
        for dst, src in zip(tst[key], jax.tree.leaves(jst[key])):
            dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    tst["step"] = int(jst["step"])
    batch = _batch(tcfg, 7)
    jp2, jst2, jm = jstep(jp1, jst, _jb(batch), jbits)
    tp2, tst2, tm = tstep(tp, tst, _tb(batch), tapply.bits_for_scan(tpolicy, tp, tcfg))
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jp2)[0]]
    jleaves = jax.tree.leaves(jp2)
    assert len(jleaves) == len(topt.leaves(tp2)) == len(paths)
    # the LayerNorm leaves' updates within 5e-5: their gradients agree within
    # 1e-5 (the test above), but Adam's division by sqrt(v) magnifies the
    # parting of an entry whose gradient is near 0 (dec ln2's bias: 1.25e-5)
    tol = [5e-5 if "['ln" in p or "_norm']" in p else 1e-5 for p in paths]
    for a, b, lim, p in zip(jleaves, topt.leaves(tp2), tol, paths):
        assert b.shape == a.shape and _rel(b, a) <= lim, p
    for key in ("m", "v"):
        for a, b, p in zip(jax.tree.leaves(jst2[key]), tst2[key], paths):
            assert _rel(b, a) <= 1e-5, (key, p)


def test_prefill_and_greedy_decode_match_jax(model, served):
    """``prefill(tokens, frames)`` at B 2, its caches copied into a
    ``max_seq`` 24 state, then 8 greedy tokens at scalar positions through
    ``decode_step``: the same tokens, logits within rel 1e-5."""
    jcfg, tcfg, _, _ = model
    jserve, tserve = served
    rng = np.random.default_rng(8)
    frames = (rng.standard_normal((B, tcfg.encoder_seq, tcfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(1, tcfg.vocab_size, (B, 6)).astype(np.int32)
    jlog, jst = _jprefill(jserve, jcfg, jnp.asarray(toks), jnp.asarray(frames), qimpl="xla")
    tlog, tst = te.prefill(tserve, tcfg, _t(toks), _t(frames))
    assert _rel(tlog.numpy(), jlog) <= 1e-5
    tcross = te.prepare_decode(tserve, tcfg, _t(frames))
    for a, b, c in zip(tcross, tst["cross"], jst["cross"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
        assert _rel(a["k"].numpy(), c["k"]) <= 1e-5 and _rel(a["v"].numpy(), c["v"]) <= 1e-5
    jfull = je.init_cache(jcfg, B, 24, jnp.float32)
    jfull = {"self": [{n: f[n].at[:, :6].set(s[n]) for n in ("k", "v")}
                      for f, s in zip(jfull["self"], jst["self"])], "cross": jst["cross"]}
    tfull = te.init_cache(tcfg, B, 24, torch.float32, device="cpu")
    for f, s in zip(tfull["self"], tst["self"]):
        for n in ("k", "v"):
            f[n][:, :6] = s[n]
    tfull["cross"] = tst["cross"]
    jtok, ttok = jnp.argmax(jlog[:, -1], -1), tlog[:, -1].argmax(-1)
    jout, tout = [], []
    for pos in range(6, 14):
        assert np.array_equal(np.asarray(jtok), ttok.numpy()), pos
        jlog, jfull = _jdecode(jserve, jcfg, jfull, jtok[:, None], pos, qimpl="xla")
        tlog, tfull = te.decode_step(tserve, tcfg, tfull, ttok[:, None], pos)
        assert _rel(tlog.numpy(), jlog) <= 1e-5, pos
        jtok, ttok = jnp.argmax(jlog[:, -1], -1), tlog[:, -1].argmax(-1)
        jout.append(np.asarray(jtok))
        tout.append(ttok.numpy())
    assert np.array_equal(np.stack(jout), np.stack(tout))


class TestQuantApplyWhisper:
    """The twin of ``tests/test_quant_apply.py``'s ``whisper`` cases."""

    def test_specs_weights_and_bits_match_jax(self, model):
        jcfg, tcfg, jp, tp = model
        specs = tapply.layer_specs(tp, tcfg)
        assert [(s.name, s.shape, s.macs, s.kind) for s in specs] == \
            [(s.name, s.shape, s.macs, s.kind) for s in japply.layer_specs(jp, jcfg)]
        assert [s.name for s in specs] == sorted(s.name for s in specs)
        assert any(s.name.startswith("enc_layers.layer001.") for s in specs)
        assert any(s.name.endswith("cross_attn.wk") for s in specs)
        for s in specs:
            np.testing.assert_array_equal(tapply.get_weight(tp, s.name).numpy(),
                                          np.asarray(japply.get_weight(jp, s.name)))
        tpolicy, jpolicy = _mixed(specs, 0)
        tb = tapply.bits_for_scan(tpolicy, tp, tcfg)
        jb = dict(japply._walk(japply.bits_for_scan(jpolicy, jp, jcfg)))
        for path, want in jb.items():         # per-layer lists where JAX has (L,) arrays
            got = tb
            for k in path:
                got = got[k]
            assert np.asarray(got).tolist() == np.asarray(want).tolist(), path
        assert sum(len(np.atleast_1d(v)) for v in jb.values()) == len(specs)

    @pytest.mark.parametrize("bits", (2, 8))
    def test_packed_bytes_match_jax(self, model, bits):
        jcfg, tcfg, jp, tp = model
        specs = tapply.layer_specs(tp, tcfg)
        tq = tapply.quantize_for_serve(te.unstack_layers(tp, tcfg),
                                       tpol.BitPolicy.uniform(specs, bits), tcfg)
        jq = japply.quantize_for_serve(je.unstack_layers(jp, jcfg),
                                       jpol.BitPolicy.uniform(japply.layer_specs(jp, jcfg),
                                                              bits), jcfg)
        leaves = [(p, l) for p, l in tapply._walk(tq) if isinstance(l, QuantizedTensor)]
        assert len(leaves) == len(specs) and all(l.bits == bits for _, l in leaves)
        assert tapply.packed_policy_bits(tq) == {s.name: bits for s in specs}
        jleaves = {p: l for p, l in japply._walk(jq) if hasattr(l, "packed")}
        for p, leaf in leaves:
            np.testing.assert_array_equal(leaf.packed.numpy(), np.asarray(jleaves[p].packed))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jleaves[p].scale))
        packed = tapply.pack_for_serve(_port(jp), tpol.BitPolicy.uniform(specs, bits), tcfg)
        for (p, a), (_, b) in zip(tapply._walk(packed), tapply._walk(tq)):
            assert torch.equal(a.packed, b.packed) if isinstance(a, QuantizedTensor) \
                else torch.equal(a, b), p


def test_global_batch_carries_frames(model):
    _, tcfg, _, _ = model
    shape = TShape("t", "train", 32, 4)
    task = TokenTask(vocab_size=tcfg.vocab_size, seed=3)
    batch = global_batch(task, tcfg, shape, 5)
    assert list(batch) == ["frames", "tokens", "labels"]
    assert batch["frames"].shape == (4, tcfg.encoder_seq, tcfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert batch["tokens"].shape == batch["labels"].shape == (4, 32)
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    again = global_batch(task, tcfg, shape, 5)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    assert not torch.equal(batch["frames"], global_batch(task, tcfg, shape, 6)["frames"])
    big = global_batch(task, tcfg, TShape("t", "train", 8, 64), 0)["frames"]
    assert abs(float(big.mean())) < 1e-3 and abs(float(big.std()) - 0.02) < 1e-3
    jbatch = jenv.global_batch(jenv.TokenTask(vocab_size=tcfg.vocab_size, seed=3),
                               jconfigs.get_config(ARCH).reduced(), JShape("t", "train", 32, 4), 5)
    assert {k: tuple(v.shape) for k, v in jbatch.items()} == \
        {k: tuple(v.shape) for k, v in batch.items()}


def test_serve_engine_refuses_the_family(model):
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="enc-dec serving goes through"):
        ServeEngine(tcfg, te.unstack_layers(tp, tcfg), max_slots=2, max_seq=32, device="cpu")


def test_search_policy_takes_the_jax_decisions(model, monkeypatch):
    """The weight phase (one QAT epoch, two refinement rounds) on shared batches."""
    jcfg, tcfg, jp, _ = model
    batches = {}

    def batch(step):
        if step not in batches:
            batches[step] = _batch(tcfg, 100 + step)
        return batches[step]

    monkeypatch.setattr(jenv, "global_batch", lambda task, cfg, shape, step: _jb(batch(step)))
    je_ = jenv.LMQuantEnv(jp, jcfg, JShape("s", "train", S, B), qat_steps_per_epoch=1)
    te_ = TLM(_port(jp), tcfg, TShape("s", "train", S, B), qat_steps_per_epoch=1,
              batches=lambda task, cfg, shape, step: batch(step))
    cc = dict(phase2_max_iters=2, phase1_qat_epochs=1, phase2_qat_epochs=0)
    runs = []
    for env, mod, CC in ((je_, jsearch, JCC), (te_, tsearch, TCC)):
        fl = env.float_loss()
        budget = mod.budget_from_limits(-(fl + 0.1), {"size_mib": 0.6})
        runs.append((fl,) + mod.search_policy(env, budget, config=CC(**cc), seed=0))
    (jfl, ja, jr), (tfl, ta, tr) = runs
    assert _rel(tfl, jfl) <= 1e-5
    assert [(e.phase, e.step, e.bits, e.note) for e in tr.trace] == \
        [(e.phase, e.step, e.bits, e.note) for e in jr.trace]
    assert tr.policy.bits == jr.policy.bits
    assert ta.policy.to_json() == ja.policy.to_json() and ta.registry_hash == ja.registry_hash


def test_train_and_search_cli_run_the_family(tmp_path, capsys):
    assert ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq",
                        "16", "--wbits", "4", "--device", "cpu", "--ckpt", str(tmp_path / "ck"),
                        "--save-every", "2"]) == 0
    assert f"arch={ARCH} reduced=True" in capsys.readouterr().out
    art = tmp_path / "policy.json"
    rc = tsearch.main(["--arch", ARCH, "--reduced", "--limit", "size_mib=0.6", "--seq", "16",
                       "--batch", "2", "--pretrain-steps", "2", "--phase2-iters", "1",
                       "--device", "cpu", "--out", str(art)])
    assert rc in (0, 1)
    artifact = tpol.PolicyArtifact.load(str(art))
    assert artifact.state_policy is None
    assert any(n.startswith("dec_layers.layer001.cross_attn") for n in artifact.policy.bits)
    with pytest.raises(ValueError, match="no quantizable KV state"):
        tsearch.main(["--arch", ARCH, "--reduced", "--limit", "size_mib=0.6", "--limit",
                      "state_bytes=1000", "--pretrain-steps", "0", "--device", "cpu", "--out",
                      str(tmp_path / "x.json")])
