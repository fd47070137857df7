"""Port parity of the paper's CNN path (``data/images``, ``models/cnn``, the
CNN half of ``quant/qat`` and ``quant/env``, ``checkpoint`` restore), on the CPU.

Both packages start from the committed ``artifacts/cnn_mini_s0`` checkpoint
(``resnet_mini``, 64 classes, the task of ``benchmarks/common.py``), and
both see the images the JAX task draws (``jax.random`` has no torch twin:
the port's own task shares only the distribution).  The checkpoints were
trained on prototypes drawn before JAX made threefry partitionable by
default; every test here draws under that scheme (``_checkpoint_scheme``),
where the mini checkpoint's float top-1 is the manifest's 0.9238 (0.0020
under the new scheme, the prototypes being others).  Tolerances, in the
``_rel`` of ``tests/test_kernel_parity.py``: the conv and the forward pass
rel 1e-5 in f32 (the two conv libraries sum in different orders); one QAT
step's loss 1e-5, each gradient 1e-4 against the JAX package's and 1e-5
against the port's own f64 evaluation (both packages measured within 3e-6
of it), each updated parameter 1e-5;
``sigmas`` 1e-6 and ``sensitivities`` 1e-5; top-1 accuracies equal; the
prototype upsampling 1e-6; the controller's decisions and restored arrays
exact.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jck
from repro.core import policy as jpol
from repro.core.controller import ControllerConfig as JCC
from repro.core.controller import SigmaQuantController as JController
from repro.data.images import ImageTask as JTask
from repro.models import cnn as jcnn
from repro.quant import qat as jqat
from repro.quant.env import CNNQuantEnv as JEnv
from repro.train import optimizer as jopt
from repro_torch import checkpoint as tck
from repro_torch.convert import params_from_numpy, to_tensor
from repro_torch.core import policy as tpol
from repro_torch.core.controller import ControllerConfig as TCC
from repro_torch.core.controller import SigmaQuantController as TController
from repro_torch.data.images import ImageTask as TTask
from repro_torch.data.images import upsample_linear
from repro_torch.models import cnn as tcnn
from repro_torch.quant import qat as tqat
from repro_torch.quant.env import CNNQuantEnv as TEnv
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(2)

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts")
#: benchmarks/common.py's task and stage menu
TASK = dict(n_classes=64, noise=2.2, seed=1)
STAGES = {"mini": ((16, 1), (32, 1), (64, 1)), "small": ((16, 2), (32, 2), (64, 2)),
          "wide": ((24, 2), (48, 2), (96, 2))}


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _cfgs(name: str):
    kw = dict(name=f"resnet_{name}", stages=STAGES[name], n_classes=TASK["n_classes"])
    return jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)


@pytest.fixture(autouse=True)
def _checkpoint_scheme():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(scope="module")
def mini():
    """(jcfg, tcfg, JAX params, port params) restored from the mini checkpoint."""
    jcfg, tcfg = _cfgs("mini")
    jp, _ = jck.restore(os.path.join(ART, "cnn_mini_s0"), _jlike(jcfg))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def jtask():
    return JTask(**TASK)


def _jlike(jcfg):
    """The JAX params' shapes and dtypes, without running the init eagerly."""
    return jax.eval_shape(lambda: jcnn.init(jcfg, jax.random.key(0)))


def _mixed(specs, seed: int):
    rng = np.random.default_rng(seed)
    tp = tpol.BitPolicy.from_bits(specs, {s.name: int(rng.choice([2, 4, 6, 8])) for s in specs})
    return tp, jpol.BitPolicy.from_json(tp.to_json())


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), device="cpu")


# ---------------------------------------------------------------------------
# the image task
# ---------------------------------------------------------------------------


def test_image_task_learnable_structure():
    task = TTask(n_classes=8, noise=0.1)
    imgs, labels = task.batch_at(0, 64)
    assert imgs.shape == (64, 16, 16, 3) and imgs.dtype == torch.float32
    protos = task._prototypes()
    d_true = ((imgs - protos[labels]) ** 2).sum(dim=(1, 2, 3))
    d_other = ((imgs - protos[(labels + 1) % 8]) ** 2).sum(dim=(1, 2, 3))
    assert float((d_true < d_other).float().mean()) > 0.95
    # a pure function of (seed, step); steps and the eval set are distinct draws
    again, _ = task.batch_at(0, 64)
    assert torch.equal(imgs, again)
    assert not torch.equal(imgs, task.batch_at(1, 64)[0])
    ev_imgs, ev_labels = task.eval_set(32)
    assert torch.equal(ev_imgs, task.eval_set(32)[0]) and int(ev_labels.max()) < 8


def test_prototype_upsampling_equals_jax_resize():
    coarse = np.random.default_rng(0).standard_normal((5, 4, 4, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(coarse), (5, 16, 16, 3), method="linear")
    got = upsample_linear(torch.from_numpy(coarse), 16)
    assert got.shape == (5, 16, 16, 3)
    assert _rel(got, want) <= 1e-6


def test_port_task_matches_the_reference_distribution(jtask):
    """Only the distribution is shared: per-pixel mean and spread of the
    images around their own prototype (the noise), and the class frequencies."""
    tt = TTask(**TASK)
    ti, tl = tt.batch_at(0, 2048)
    ji, jl = jtask.batch_at(0, 2048)
    for imgs, labels, protos in ((ti.numpy(), tl.numpy(), tt._prototypes().numpy()),
                                 (np.asarray(ji), np.asarray(jl), np.asarray(jtask._prototypes()))):
        unrolled = imgs - protos[labels]
        # the roll moves the prototype too, so the residual is noise plus a
        # prototype shift; its spread is bounded below by the noise
        assert abs(float(np.std(unrolled)) - 2.2) < 0.6
        assert np.bincount(labels, minlength=64).max() < 70
    assert abs(float(np.std(tt._prototypes().numpy())) - float(np.std(jtask._prototypes()))) < 0.4


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,k,stride", [(16, 3, 1), (16, 3, 2), (16, 1, 2), (15, 3, 2),
                                           (8, 3, 2)])
def test_same_padding_conv_equals_jax(size, k, stride):
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
    want = jcnn.conv(jnp.asarray(w), jnp.asarray(x), stride)
    got = tcnn.conv(_t(w), _t(x), stride)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_specs_and_weights_equal_jax(mini):
    jcfg, tcfg, jp, tp = mini
    js, ts = jcnn.quant_layer_specs(jp, jcfg), tcnn.quant_layer_specs(tp, tcfg)
    assert [(l.name, l.shape, l.macs, l.kind) for l in ts] == \
        [(l.name, l.shape, l.macs, l.kind) for l in js]
    assert tcnn.block_strides(tcfg) == jcnn.block_strides(jcfg) == (1, 2, 2)
    for s in ts:
        assert np.array_equal(tcnn.get_weight(tp, s.name).numpy(),
                              np.asarray(jcnn.get_weight(jp, s.name)))
    # a fresh init has the reference's structure and shapes
    fresh = tcnn.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, jp) == jax.tree.map(lambda t: tuple(t.shape), fresh)


@pytest.mark.parametrize("bits", ("none", "mixed"))
def test_forward_equals_jax(mini, jtask, bits):
    jcfg, tcfg, jp, tp = mini
    imgs, _ = jtask.batch_at(3, 16)
    jb = tb = None
    if bits == "mixed":
        tpolicy, jpolicy = _mixed(tcnn.quant_layer_specs(tp, tcfg), 1)
        jb, tb = jqat.cnn_bits_pytree(jpolicy), tqat.cnn_bits_pytree(tpolicy)
    want = jcnn.forward(jp, imgs, jcfg, bits=jb)
    got = tcnn.forward(tp, _t(imgs), tcfg, bits=tb)
    assert got.shape == (16, 64)
    assert _rel(got, want) <= 1e-5


def test_qat_step_equals_jax_from_shared_state(mini, jtask):
    jcfg, tcfg, jp, tp = mini
    tpolicy, jpolicy = _mixed(tcnn.quant_layer_specs(tp, tcfg), 2)
    imgs, labels = jtask.batch_at(5, 32)
    jstep, jocfg = jqat.make_cnn_qat_step(jcfg)
    tstep, tocfg = tqat.make_cnn_qat_step(tcfg)
    assert (tocfg.name, tocfg.lr, tocfg.warmup_steps, tocfg.decay_steps, tocfg.grad_clip) == \
        (jocfg.name, jocfg.lr, jocfg.warmup_steps, jocfg.decay_steps, jocfg.grad_clip)
    jb, tb = jqat.cnn_bits_pytree(jpolicy), tqat.cnn_bits_pytree(tpolicy)

    def jloss(p, bits):
        logits = jcnn.forward(p, imgs, jcfg, bits=bits)
        gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - gold)

    # bits enter as traced arguments, as in the JAX QAT step: closed over,
    # they would be constants, and XLA would fold q * (max|w| / q) back to
    # max|w| in the STE mask, which the JAX step does not
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    def tloss(p, b, bits):
        logits = tcnn.forward(p, b[0], tcfg, bits=bits)
        gold = torch.gather(logits, -1, b[1][:, None])[:, 0]
        return torch.mean(torch.logsumexp(logits, dim=-1) - gold)

    batch = (_t(imgs), _t(labels).long())
    tl, tg = value_and_grad(tloss, tp, batch, tb)
    p64 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float64)
    _, g64 = value_and_grad(tloss, p64, (batch[0].double(), batch[1]), tb)
    assert _rel(tl, jl) <= 1e-5
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b, c in zip(jleaves, tg, g64):
        assert tuple(b.shape) == a.shape
        assert _rel(b, a) <= 1e-4 and _rel(b, c) <= 1e-5
    # the whole step (SGD with momentum from zero state) on copies of the params
    tcopy = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jp2, _, jloss2 = jstep(jp, jopt.init(jocfg, jp), (imgs, labels), jb)
    tp2, tst, tloss2 = tstep(tcopy, topt.init(tocfg, tcopy), batch, tb)
    assert _rel(tloss2, jloss2) <= 1e-5 and tst["step"] == 1
    for a, b in zip(jax.tree.leaves(jp2), topt.leaves(tp2)):
        assert _rel(b, a) <= 1e-5


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ("mini", "small", "wide"))
def test_restore_equals_jax(name):
    jcfg, tcfg = _cfgs(name)
    root = os.path.join(ART, f"cnn_{name}_s0")
    assert tck.list_steps(root) == jck.list_steps(root) == [400]
    assert tck.latest_step(root) == 400
    jp, jextra = jck.restore(root, _jlike(jcfg))
    tp, textra = tck.restore(root, tcnn.init(tcfg, torch.Generator().manual_seed(0),
                                             device="cpu"))
    assert textra == jextra
    jl, tl = jax.tree.leaves(jp), topt.leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32 and np.array_equal(b.numpy(), np.asarray(a))
    assert tck.load_policy_artifact(root) is None is jck.load_policy_artifact(root)


def test_restore_checks_shapes_and_views_bf16_back(tmp_path):
    _, tcfg = _cfgs("mini")
    like = tcnn.init(dataclasses.replace(tcfg, n_classes=10), torch.Generator().manual_seed(0),
                     device="cpu")
    with pytest.raises(ValueError, match=r"\['fc'\]: shape"):
        tck.restore(os.path.join(ART, "cnn_mini_s0"), like)
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path), like)
    # a bf16 tree saved by the JAX package (a uint16 view) comes back as bf16
    tree = {"a": [jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3), jnp.bfloat16)],
            "b": jnp.ones((4,), jnp.float32)}
    jck.save(str(tmp_path), 7, tree)
    back, _ = tck.restore(str(tmp_path), {"a": [torch.zeros(2, 3, dtype=torch.bfloat16)],
                                          "b": torch.zeros(4)})
    assert back["a"][0].dtype == torch.bfloat16
    assert back["a"][0].float().tolist() == [[0, 1, 2], [3, 4, 5]]
    assert tck.keystr(("blocks", 0, "conv1")) == "['blocks'][0]['conv1']"


# ---------------------------------------------------------------------------
# CNNQuantEnv and the controller
# ---------------------------------------------------------------------------


def _envs(mini, jtask, **kw):
    jcfg, tcfg, jp, _ = mini
    je = JEnv(jp, jcfg, jtask, **kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    te = TEnv(tp, tcfg, TTask(**TASK), **kw,
              batches=lambda step, n: jtask.batch_at(step, n),
              eval_set=(je._eval_imgs, je._eval_labels))
    return je, te


def test_env_vectors_and_accuracy_equal_jax(mini, jtask):
    je, te = _envs(mini, jtask)
    assert [l.name for l in te.layer_infos()] == [l.name for l in je.layer_infos()]
    np.testing.assert_allclose(te.sigmas(), je.sigmas(), rtol=1e-6)
    tpolicy, jpolicy = _mixed(te.layer_infos(), 3)
    np.testing.assert_allclose(te.sensitivities(tpolicy), je.sensitivities(jpolicy), rtol=1e-5)
    assert te.float_accuracy() == je.float_accuracy()
    assert te.float_accuracy() == pytest.approx(0.923828125)      # the manifest's float_acc
    for b in (8, 4, 2):
        u = tpol.BitPolicy.uniform(te.layer_infos(), b)
        assert te.evaluate(u) == je.evaluate(jpol.BitPolicy.from_json(u.to_json()))
    assert te.evaluate(tpolicy) == je.evaluate(jpolicy)
    assert te.costs(tpolicy) == je.costs(jpolicy)
    assert te.eval_passes == 6 and te._data_step == 0


def test_controller_from_the_mini_checkpoint_takes_the_same_decisions(mini, jtask):
    """Table I's recipe (acc 0.88, size <= 0.55 x the int8 MiB, buffers 0.01
    and 0.10), cut to 2 phase-2 iterations and epochs of 2 QAT steps, run
    freely from the mini checkpoint.  Measured: every accuracy equal, the
    params within rel 1.2e-7 after the run's 4 QAT steps; limits one eval
    image (1/512) and rel 1e-5."""
    je, te = _envs(mini, jtask, steps_per_epoch=2)
    int8 = sum(s.n_params for s in te.layer_infos()) / 2**20
    jt = jpol.Targets(acc_t=0.88, res_t=0.55 * int8, acc_buffer=0.01, res_buffer=0.10)
    tt = tpol.Targets(acc_t=0.88, res_t=0.55 * int8, acc_buffer=0.01, res_buffer=0.10)
    cc = dict(phase1_max_iters=2, phase2_max_iters=2, phase1_qat_epochs=1, phase2_qat_epochs=1,
              stagnation_patience=4)
    jr = JController(je, jt, JCC(**cc)).run()
    tr = TController(te, tt, TCC(**cc)).run()
    jtrace = [(e.phase, e.step, e.bits, e.note) for e in jr.trace]
    ttrace = [(e.phase, e.step, e.bits, e.note) for e in tr.trace]
    assert ttrace == jtrace
    assert [e.zone for e in tr.trace] == [e.zone for e in jr.trace]
    assert tr.policy.bits == jr.policy.bits
    assert (tr.success, tr.abandoned) == (jr.success, jr.abandoned)
    for a, b in zip(jr.trace, tr.trace):
        assert abs(a.acc - b.acc) <= 1 / 512
    assert te._data_step == je._data_step == te.train_steps > 0
    for a, b in zip(jax.tree.leaves(je.params), topt.leaves(te.params)):
        assert _rel(b, a) <= 1e-5
