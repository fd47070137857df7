"""Port parity of the MoE family's QAT, trainer and search, on the CPU.

Reduced deepseek-moe-16b (2 layers, 8 experts, top-2, one shared expert)
with the JAX package's weights carried over by ``convert``, numpy batches
seeded by step and a mixed 2-8 bit policy: one QAT step from shared params
and moments gives every leaf within rel 1e-5 of the JAX step (the ``_rel``
of ``tests/test_kernel_parity.py``, the limit for one QAT step from shared
state); reduced llama4 (top-1) matches in every gradient but the router's,
which is zero up to rounding in both packages.  ``search_policy`` on shared
batches takes the JAX search's decisions; the search and training command
lines run the family.  The stacked experts' fake-quant takes the caller's
``impl``: on a CUDA tensor ``"auto"`` launches the kernel on the stack as a
``(-1, N)`` view, whose scale and STE mask are the reference's for a stack.
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
from repro.kernels.fake_quant import ops as jfq
from repro.launch import search as jsearch
from repro.models import decoder as jdec
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
from repro_torch.kernels.fake_quant import ops as tfq
from repro_torch.launch import search as tsearch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.quant import apply as tapply
from repro_torch.quant.env import LMQuantEnv as TEnv
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig as TTrainConfig
from repro_torch.train.train_step import make_train_step as tmake_train_step
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(2)

SEQ, BATCH = 16, 4
MOE = "deepseek-moe-16b"


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _np_batch(step: int, vocab: int = 512) -> dict:
    s = np.random.default_rng([13, step % 2**31]).integers(0, vocab, (BATCH, SEQ + 1))
    return {"tokens": s[:, :-1].astype(np.int32), "labels": s[:, 1:].astype(np.int32)}


def _model(arch: str, seed: int):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = jdec.init(jcfg, jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _mixed(specs, seed: int):
    rng = np.random.default_rng(seed)
    tp = tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8])) for s in specs})
    return tp, jpol.BitPolicy.from_json(tp.to_json())


def test_qat_step_matches_jax_from_shared_state():
    """Params, moments, loss and gradient norm of one AdamW QAT step; the
    stacked expert leaves are fake-quantized with one scale per output
    channel over the experts and K, as in the JAX package."""
    jcfg, tcfg, jp, tp = _model(MOE, 3)
    specs = tapply.layer_specs(tp, tcfg)
    assert any(s.kind == "expert" for s in specs)
    assert [s.name for s in specs] == [s.name for s in japply.layer_specs(jp, jcfg)]
    tpolicy, jpolicy = _mixed(specs, 1)
    batch = _np_batch(0)
    ocfg = dict(lr=1e-3, warmup_steps=1)
    jstep = jmake_train_step(jcfg, JTrainConfig(optimizer=jopt.OptimizerConfig(**ocfg)),
                             lambda p, b, bits: jreg.get_api(jcfg).loss(p, jcfg, b, bits=bits))
    tstep = tmake_train_step(tcfg, TTrainConfig(optimizer=topt.OptimizerConfig(**ocfg)),
                             lambda p, b, bits: treg.get_api(tcfg).loss(p, tcfg, b, bits=bits))
    jst = jopt.init(jopt.OptimizerConfig(**ocfg), jp)
    tst = topt.init(topt.OptimizerConfig(**ocfg), tp)
    # a step in: both packages' moments come from the JAX step
    jp, jst, _ = jstep(jp, jst, {k: jnp.asarray(v) for k, v in _np_batch(1).items()},
                       japply.bits_for_scan(jpolicy, jp, jcfg))
    for dst, src in zip(topt.leaves(tp), jax.tree.leaves(jp)):
        dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    for key in ("m", "v"):
        for dst, src in zip(tst[key], jax.tree.leaves(jst[key])):
            dst.copy_(to_tensor(np.asarray(src), device="cpu"))
    tst["step"] = int(jst["step"])
    jp2, jst2, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batch.items()},
                          japply.bits_for_scan(jpolicy, jp, jcfg))
    tp2, tst2, tm = tstep(tp, tst, {k: torch.as_tensor(v).long() for k, v in batch.items()},
                          tapply.bits_for_scan(tpolicy, tp, tcfg))
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    jleaves = jax.tree.leaves(jp2)
    assert len(jleaves) == len(topt.leaves(tp2))
    for a, b in zip(jleaves, topt.leaves(tp2)):
        assert b.shape == a.shape and _rel(b, a) <= 1e-5
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jst2[key]), tst2[key]):
            assert _rel(b, a) <= 1e-5


def test_top1_router_gets_no_gradient_in_either_package():
    """Reduced llama4 (top-1): the renormalized gate g / g is 1, so the
    router's gradient is zero up to rounding in both packages (4.2e-9 in the
    JAX package, 2.0e-9 in the port, against 7.6e-2 for ``wq``), and the two
    roundings differ (rel 0.98).  Every other leaf's QAT gradient agrees
    within rel 1e-5.  A step from shared moments then moves the router by
    Adam's normalization of that noise, so llama4 has no step-level twin
    (ROADMAP section 3)."""
    jcfg, tcfg, jp, tp = _model("llama4-maverick-400b-a17b", 3)
    tpolicy, jpolicy = _mixed(tapply.layer_specs(tp, tcfg), 1)
    batch = _np_batch(0)
    jb = japply.bits_for_scan(jpolicy, jp, jcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jreg.get_api(jcfg).loss(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, bits=jb)))(jp)
    tl, tg = value_and_grad(lambda p, b, bits: treg.get_api(tcfg).loss(p, tcfg, b, bits=bits),
                            tp, {k: torch.as_tensor(v).long() for k, v in batch.items()},
                            tapply.bits_for_scan(tpolicy, tp, tcfg))
    assert _rel(tl, jl) <= 1e-5
    top = max(float(np.abs(np.asarray(a)).max()) for a in jax.tree.leaves(jg))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        if "router" in jax.tree_util.keystr(path):
            assert float(np.abs(np.asarray(a)).max()) <= 1e-6 * top
            assert float(b.abs().max()) <= 1e-6 * top
        else:
            assert _rel(b, a) <= 1e-5, jax.tree_util.keystr(path)


def test_expert_weight_hands_the_callers_impl_to_fake_quant(monkeypatch):
    seen = []
    real = tmoe.fake_quant_ste

    def spy(w, bits, impl="auto"):
        seen.append((tuple(w.shape), impl))
        return real(w, bits, impl)

    monkeypatch.setattr(tmoe, "fake_quant_ste", spy)
    tcfg = tconfigs.get_config(MOE).reduced()
    p = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    x = torch.randn((2, 5, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    bits = {"w_gate": 4.0, "w_up": 6.0, "w_down": 2.0}
    for impl in ("auto", "torch"):
        seen.clear()
        tmoe.moe_mlp(p, x, tcfg, bits=bits, impl=impl)
        assert seen == [(tuple(p[n].shape), impl) for n in ("w_gate", "w_up", "w_down")]


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_a_stack_as_a_2d_view_keeps_the_references_scale_and_mask(bits):
    """What the kernel sees on the card: the ``(E, K, N)`` stack as an
    ``(E*K, N)`` view with the stack's ``(1, 1, N)`` scale (max over E and
    K).  Its forward equals the JAX fake-quant of the stack bit for bit, its
    STE mask the JAX one, and no 3-D stack takes the transposed branch."""
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((8, 24, 40)) * rng.uniform(0.1, 3.0, (8, 1, 40))).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_(True)
    scale = tfq.quantizer.weight_scale(tw.detach(), float(bits), channel_axis=-1)
    assert scale.shape == (1, 1, 40)
    np.testing.assert_array_equal(scale.reshape(-1).numpy(),
                                  np.max(np.abs(w), axis=(0, 1)) / tfq.quantizer.qmax(bits))
    view = tfq.fake_quant_ref(tw.detach().reshape(-1, 40), scale.reshape(1, 40), float(bits))
    jout, jvjp = jax.vjp(lambda a: jfq.fake_quant_ste(a, jnp.float32(bits), "xla"),
                         jnp.asarray(w))
    np.testing.assert_array_equal(view.reshape(w.shape).numpy(), np.asarray(jout))
    out = tfq.fake_quant_ste(tw, bits, "torch")
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jvjp(jnp.asarray(g))[0]))
    for t in (tw.detach(), tw.detach().transpose(1, 2), tw.detach().permute(2, 1, 0)):
        assert not tfq._transposed(t)


@pytest.fixture
def shared_batches(monkeypatch):
    monkeypatch.setattr(jenv, "global_batch", lambda task, cfg, shape, step: {
        k: jnp.asarray(v) for k, v in _np_batch(step).items()})
    return lambda task, cfg, shape, step: _np_batch(step)


def test_search_policy_takes_the_jax_decisions(shared_batches):
    jcfg, tcfg, jp, tp = _model(MOE, 0)
    je = jenv.LMQuantEnv(jp, jcfg, JShape("s", "train", SEQ, BATCH), qat_steps_per_epoch=2)
    te = TEnv(tp, tcfg, TShape("s", "train", SEQ, BATCH), qat_steps_per_epoch=2,
              batches=shared_batches)
    assert te.layer_infos() == tuple(tpol.LayerInfo(l.name, l.shape, l.macs, l.kind)
                                     for l in je.layer_infos())
    cc = dict(phase2_max_iters=2, phase1_qat_epochs=1, phase2_qat_epochs=1)
    runs = []
    for env, mod, CC in ((je, jsearch, JCC), (te, tsearch, TCC)):
        env.pretrain(2)
        fl = env.float_loss()
        budget = mod.budget_from_limits(-(fl + 0.1), {"size_mib": 0.5})
        runs.append((fl,) + mod.search_policy(env, budget, config=CC(**cc), seed=0))
    (jfl, ja, jr), (tfl, ta, tr) = runs
    assert _rel(tfl, jfl) <= 1e-5
    assert [(e.phase, e.step, e.bits, e.note) for e in tr.trace] == \
        [(e.phase, e.step, e.bits, e.note) for e in jr.trace]
    assert tr.policy.bits == jr.policy.bits and (tr.success, tr.abandoned) == (
        jr.success, jr.abandoned)
    assert ta.policy.to_json() == ja.policy.to_json() and ta.registry_hash == ja.registry_hash


def test_search_cli_runs_the_moe_family_and_the_port_serves_its_artifact(tmp_path, capsys):
    out = tmp_path / "policy.json"
    rc = tsearch.main(["--arch", MOE, "--reduced", "--limit", "size_mib=0.5",
                       "--limit", "state_bytes=30000", "--paged", "--seq", str(SEQ),
                       "--batch", str(BATCH), "--pretrain-steps", "2", "--phase2-iters", "1",
                       "--device", "cpu", "--out", str(out)])
    assert rc in (0, 1)
    printed = capsys.readouterr().out
    assert "state budget: state_bytes<=30000" in printed and "paged pool:" in printed
    art = tpol.PolicyArtifact.load(str(out))
    jart = jpol.PolicyArtifact.load(str(out))
    assert jart.policy.bits == art.policy.bits and art.state_policy is not None
    jcfg = jconfigs.get_config(MOE).reduced()
    jart.verify_layers(japply.layer_specs(jdec.init(jcfg, jax.random.key(0)), jcfg))
    assert any(n.endswith("mlp.w_gate") for n in art.policy.bits)
    assert tserve.main(["--arch", MOE, "--reduced", "--policy", str(out), "--requests", "2",
                        "--max-new", "3", "--device", "cpu"]) == 0
    assert "quantized KV state" in capsys.readouterr().out


def test_train_cli_runs_the_moe_family(tmp_path, capsys):
    assert ttrain.main(["--arch", MOE, "--reduced", "--steps", "3", "--batch", str(BATCH),
                        "--seq", str(SEQ), "--wbits", "4", "--device", "cpu",
                        "--ckpt", str(tmp_path / "ck"), "--save-every", "2"]) == 0
    out = capsys.readouterr().out
    assert f"arch={MOE} reduced=True" in out and "'loss':" in out
