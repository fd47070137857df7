"""Port parity of the training driver (``launch/train.py``), on the CPU.

Both packages' ``launch.train.main`` run reduced gemma-2b (f32) with QAT at
4 bits from the same weights (the JAX package's seed-0 init, carried over by
``convert``) and the same batches (numpy, seeded by step, patched into both
drivers' ``global_batch``; the two token tasks draw from different
generators).  The first step's loss and gradient norm agree within rel 1e-5
and the following steps' losses within rel 1e-4 (QAT drifts apart in the
last bits: ROADMAP section 3, PR 14).  The two trainers write the same
checkpoint layout, ``(params, opt_state)`` with the moments laid out as the
params' tree: every leaf key is the same, so a checkpoint written by either
trainer resumes in the other, and the resumed state holds the saved bytes.
A run with a failure injected mid-way restores and replays to the clean
run's params and optimizer state byte for byte.
"""
import functools
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import decoder as jdec
from repro.runtime import loop as jloop
from repro_torch.checkpoint import store as tck
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.runtime import loop as tloop
from repro_torch.runtime.resilience import FailureInjector
from repro_torch.train import optimizer as topt

torch.set_num_threads(2)

SEQ, BATCH, STEPS = 16, 4, 4
ARGV = ["--arch", "gemma-2b", "--reduced", "--steps", str(STEPS), "--batch", str(BATCH),
        "--seq", str(SEQ), "--save-every", "2", "--wbits", "4", "--seed", "0"]


def _np_batch(step: int) -> dict:
    s = np.random.default_rng([11, step]).integers(0, 512, (BATCH, SEQ + 1))
    return {"tokens": s[:, :-1].astype(np.int32), "labels": s[:, 1:].astype(np.int32)}


def _jax_params():
    return jdec.init(jconfigs.get_config("gemma-2b").reduced(), jax.random.key(0))


_real_build = ttrain.build


def _shared_build(args):
    """The port's ``build`` with the JAX package's seed-0 weights copied in."""
    out = _real_build(args)
    src = params_from_numpy(jax.tree.map(np.asarray, _jax_params()), device="cpu")
    for a, b in zip(topt.leaves(out[3][0]), topt.leaves(src)):
        a.copy_(b)
    return out


def _recording(loop_cls, sink: list):
    class Recording(loop_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sink.append(self)

    return Recording


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each package's trainer CLI, every step logged."""
    root = tmp_path_factory.mktemp("train")
    loops = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "global_batch", lambda task, cfg, shape, step: {
            k: jax.numpy.asarray(v) for k, v in _np_batch(step).items()})
        mp.setattr(ttrain, "global_batch", lambda task, cfg, shape, step: _np_batch(step))
        mp.setattr(ttrain, "build", _shared_build)
        for mod, name in ((jtrain, "jax"), (ttrain, "torch")):
            mp.setattr(mod, "LoopConfig", functools.partial(
                jloop.LoopConfig if name == "jax" else tloop.LoopConfig, log_every=1))
            mp.setattr(mod, "TrainLoop", _recording(mod.TrainLoop, loops[name]))
        assert jtrain.main(ARGV + ["--ckpt", str(root / "jax")]) == 0
        assert ttrain.main(ARGV + ["--ckpt", str(root / "torch"), "--device", "cpu"]) == 0
    return SimpleNamespace(root=root, jax=loops["jax"][0], torch=loops["torch"][0])


def test_first_losses_equal_the_jax_trainer(runs):
    jh, th = runs.jax.history, runs.torch.history
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(STEPS))
    assert th[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    assert th[0]["grad_norm"] == pytest.approx(jh[0]["grad_norm"], rel=1e-5)
    for t, j in zip(th, jh):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:08d}", "MANIFEST.json")) as f:
        return json.load(f)


def test_both_trainers_write_the_same_layout(runs):
    assert tck.list_steps(str(runs.root / "torch")) == [1, 3]
    for step in (1, 3):
        t, j = _manifest(runs.root / "torch", step), _manifest(runs.root / "jax", step)
        assert t["leaves"] == j["leaves"]          # params and moments alike
        assert t["extra"] == j["extra"] == {"next_step": step + 1}
    assert "[1]['step']" in t["leaves"] and "[1]['m']['embed']" in t["leaves"]


def _state_bytes(state) -> list[bytes]:
    params, opt = state
    out = [np.asarray(x).tobytes() for x in topt.leaves(params)]
    out += [np.asarray(x).tobytes() for k in ("m", "v") for x in topt.leaves(opt[k])]
    return out + [int(opt["step"]).to_bytes(4, "little")]


def test_a_port_checkpoint_resumes_in_the_jax_trainer(runs):
    _, _, _, like, _ = jtrain.build(_jax_args())
    state, extra = jtrain.CheckpointStore(str(runs.root / "torch")).restore_latest(like)
    assert extra["next_step"] == STEPS and int(state[1]["step"]) == STEPS
    jp = jax.tree.map(np.asarray, state[0])
    for a, b in zip(jax.tree.leaves(jp), topt.leaves(runs.torch.state[0])):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    for k in ("m", "v"):
        for a, b in zip(jax.tree.leaves(state[1][k]), topt.leaves(runs.torch.state[1][k])):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_a_jax_checkpoint_resumes_in_the_port_trainer(runs):
    _, _, _, like, _ = ttrain.build(_port_args())
    state, extra = tck.restore(str(runs.root / "jax"), like)
    assert extra["next_step"] == STEPS and state[1]["step"] == STEPS
    jstate = runs.jax.state
    assert _state_bytes(state) == [np.asarray(x).tobytes() for x in jax.tree.leaves(jstate[0])] \
        + [np.asarray(x).tobytes() for k in ("m", "v") for x in jax.tree.leaves(jstate[1][k])] \
        + [int(jstate[1]["step"]).to_bytes(4, "little")]


def _jax_args():
    """The JAX driver's flags for ``ARGV`` (its parser lives in ``main``)."""
    captured = {}

    def fake_build(args):
        captured["args"] = args
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "build", fake_build)
        with pytest.raises(SystemExit):
            jtrain.main(ARGV)
    return captured["args"]


def _port_args():
    return ttrain.build_parser().parse_args(ARGV + ["--device", "cpu"])


def test_failure_mid_run_replays_byte_for_byte(tmp_path):
    """8 steps saved every 2: a failure at step 5 restores step 3 and replays."""
    args = _port_args()
    args.steps = 8

    def run(root, injector=None):
        _, _, step, state, batch_fn = ttrain.build(args)
        loop = tloop.TrainLoop(step, state, batch_fn, tck.CheckpointStore(str(root), keep=1),
                               tloop.LoopConfig(8, save_every=2), injector=injector)
        return loop, loop.run()

    _, clean = run(tmp_path / "clean")
    loop, faulty = run(tmp_path / "faulty", FailureInjector(fail_at=(5,)))
    assert loop.restarts == 1 and faulty[1]["step"] == clean[1]["step"] == 8
    assert _state_bytes(faulty) == _state_bytes(clean)
    assert tck.list_steps(str(tmp_path / "faulty")) == [7]


def test_trainer_without_device_raises_when_no_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "1", "--ckpt", str(tmp_path)])
    assert not os.path.exists(tmp_path / "step_00000000")
