"""Port parity of the checkpoint store, the train loop, the straggler
monitor and elastic planning (the twin of ``tests/test_checkpoint_runtime.py``),
on the CPU.

The store writes the JAX package's format (one npz shard keyed by JAX's key
paths, ``MANIFEST.json``, the artifact sidecar), so each package restores
what the other saved: leaves bit for bit (bf16 through its ``u2`` view,
packed weights with their bits and shape), manifests with the same leaf
index.  ``save_async`` copies every leaf before it returns: the port updates
params and moments in place, and a step taken right after the call leaves
the saved bytes as they were.  ``TrainLoop`` with an in-place step, a
failure injected mid-run and a restore ends byte for byte where the clean
run ends.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jck
from repro.core import policy as jpol
from repro.quant.tensor import quantize_tensor as jquantize
from repro.runtime import elastic as jelastic
from repro_torch.checkpoint import store as ck
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BitPolicy, LayerInfo, PolicyArtifact
from repro_torch.quant.tensor import quantize_tensor
from repro_torch.runtime import elastic
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.resilience import FailureInjector, SimulatedFailure, StragglerMonitor


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g), "b": torch.zeros((4,)),
            "nested": {"m": torch.ones((2, 2)) * seed}}


def _jtree(seed=0):
    return {"w": jnp.zeros((8, 4)), "b": jnp.zeros((4,)), "nested": {"m": jnp.zeros((2, 2))}}


class TestStore:
    def test_roundtrip(self, tmp_path):
        t = _tree(3)
        ck.save(str(tmp_path), 7, t)
        got, extra = ck.restore(str(tmp_path), _tree(0), step=7)
        assert torch.equal(got["w"], t["w"])
        assert torch.equal(got["nested"]["m"], torch.full((2, 2), 3.0))

    def test_quantized_tensor_leaves_roundtrip(self, tmp_path):
        qt = quantize_tensor(torch.randn((16, 8), generator=torch.Generator().manual_seed(0)), 4)
        ck.save(str(tmp_path), 0, {"qt": qt})
        got, _ = ck.restore(str(tmp_path), {"qt": qt}, step=0)
        assert got["qt"].bits == 4 and got["qt"].shape == (16, 8)
        assert torch.equal(got["qt"].packed, qt.packed) and torch.equal(got["qt"].scale, qt.scale)

    def test_latest_and_retention(self, tmp_path):
        for s in (1, 5, 9, 13):
            ck.save(str(tmp_path), s, _tree(), keep=2)
        assert ck.latest_step(str(tmp_path)) == 13
        assert ck.list_steps(str(tmp_path)) == [9, 13]

    def test_shape_mismatch_raises(self, tmp_path):
        ck.save(str(tmp_path), 0, {"w": torch.zeros((4,))})
        with pytest.raises(ValueError):
            ck.restore(str(tmp_path), {"w": torch.zeros((5,))}, step=0)

    def test_no_halfwritten_step_visible(self, tmp_path):
        """A crashed writer leaves only .tmp dirs: list_steps ignores them."""
        os.makedirs(tmp_path / ".tmp.step_00000003.0/")
        (tmp_path / ".tmp.step_00000003.0" / "garbage").write_text("x")
        assert ck.list_steps(str(tmp_path)) == []

    def test_async_store(self, tmp_path):
        s = ck.CheckpointStore(str(tmp_path), keep=2)
        s.save_async(0, _tree(1))
        s.save_async(1, _tree(2))
        s.wait()
        got, _ = s.restore_latest(_tree(0))
        assert torch.equal(got["nested"]["m"], torch.full((2, 2), 2.0))

    def test_async_save_snapshots_before_it_returns(self, tmp_path):
        """A step updating the tree in place right after ``save_async`` (as
        the port's optimizer does) leaves the saved bytes unchanged."""
        t = _tree(4)
        want = {k: v.clone() for k, v in (("w", t["w"]), ("m", t["nested"]["m"]))}
        s = ck.CheckpointStore(str(tmp_path))
        s.save_async(0, t)
        t["w"].add_(1.0)
        t["nested"]["m"].mul_(-3.0)
        s.wait()
        got, _ = ck.restore(str(tmp_path), _tree(0), step=0)
        assert torch.equal(got["w"], want["w"]) and torch.equal(got["nested"]["m"], want["m"])

    def test_async_error_surfaces_on_wait(self, tmp_path):
        (tmp_path / "file").write_text("not a directory")
        s = ck.CheckpointStore(str(tmp_path / "file"))
        s.save_async(0, _tree())
        with pytest.raises(OSError):
            s.wait()
        s.wait()                        # raised once, then clear

    def test_numbers_roundtrip(self, tmp_path):
        t = {"step": 12, "lr": 0.5, "w": torch.ones(3)}
        ck.save(str(tmp_path), 0, t)
        got, _ = ck.restore(str(tmp_path), {"step": 0, "lr": 0.0, "w": torch.zeros(3)})
        assert got["step"] == 12 and isinstance(got["step"], int) and got["lr"] == 0.5


# ---------------------------------------------------------------------------
# the other package
# ---------------------------------------------------------------------------


def _mixed_tree(seed: int):
    """A JAX tree (numpy) with f32, bf16, int and a packed leaf, and its port twin."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    jq = jquantize(jnp.asarray(w), 4)
    jt = {"layers": {"w": jnp.asarray(w), "h": jnp.asarray(w[:5]).astype(jnp.bfloat16)},
          "ids": [jnp.arange(5, dtype=jnp.int32), jnp.asarray(rng.standard_normal(3),
                                                              jnp.float32)],
          "q": jq, "step": jnp.asarray(7, jnp.int32)}
    tt = params_from_numpy(jax.tree.map(np.asarray, {k: v for k, v in jt.items() if k != "q"}),
                           device="cpu")
    tt["q"] = params_from_numpy({"packed": np.asarray(jq.packed), "scale": np.asarray(jq.scale),
                                 "bits": jq.bits, "shape": jq.shape}, device="cpu")
    tt["step"] = 7
    return jt, tt


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:08d}", "MANIFEST.json")) as f:
        return json.load(f)


def _bits(x) -> np.ndarray:
    """The bytes of a leaf of either package as a numpy array (bf16 as ``u2``)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tree_bytes_equal(t, j) -> None:
    assert t["step"] == int(j["step"])
    for a, b in ((t["layers"]["w"], j["layers"]["w"]), (t["layers"]["h"], j["layers"]["h"]),
                 (t["ids"][0], j["ids"][0]), (t["ids"][1], j["ids"][1]),
                 (t["q"].packed, j["q"].packed), (t["q"].scale, j["q"].scale)):
        assert np.array_equal(_bits(a), _bits(b))
    assert t["q"].bits == j["q"].bits and tuple(t["q"].shape) == tuple(j["q"].shape)


@pytest.mark.parametrize("seed", range(2))
def test_the_port_writes_what_jax_restores(tmp_path, seed):
    jt, tt = _mixed_tree(seed)
    ck.save(str(tmp_path / "t"), 3, tt, extra={"next_step": 4})
    jck.save(str(tmp_path / "j"), 3, jt, extra={"next_step": 4})
    assert _manifest(tmp_path / "t", 3) == _manifest(tmp_path / "j", 3)
    got, extra = jck.restore(str(tmp_path / "t"), jt)
    assert extra == {"next_step": 4}
    _tree_bytes_equal(tt, got)


@pytest.mark.parametrize("seed", range(2))
def test_jax_writes_what_the_port_restores(tmp_path, seed):
    jt, tt = _mixed_tree(seed)
    jck.save(str(tmp_path), 5, jt)
    like = {"layers": {k: torch.zeros_like(v) for k, v in tt["layers"].items()},
            "ids": [torch.zeros_like(v) for v in tt["ids"]], "q": tt["q"], "step": 0}
    got, _ = ck.restore(str(tmp_path), like)
    _tree_bytes_equal(got, jt)


def test_artifacts_cross_both_ways(tmp_path):
    art = _artifact()
    ck.save(str(tmp_path / "t"), 1, _tree(), artifact=art)
    back = jck.load_policy_artifact(str(tmp_path / "t"))
    assert back.to_json() == art.to_json()
    jck.save(str(tmp_path / "j"), 1, _jtree(), artifact=jpol.PolicyArtifact.from_json(
        art.to_json()))
    assert ck.load_policy_artifact(str(tmp_path / "j")).to_json() == art.to_json()
    for d in ("t", "j"):
        with open(tmp_path / d / "step_00000001" / ck.ARTIFACT_FILE) as f:
            assert f.read() == art.to_json()


# ---------------------------------------------------------------------------
# artifact hardening
# ---------------------------------------------------------------------------


def _artifact():
    layers = (LayerInfo("w", (8, 8), macs=64),)
    return PolicyArtifact.build(BitPolicy.uniform(layers, 4), backend="shift_add")


class TestArtifactHardening:
    """Corruption round trips: every failure names the file and the field."""

    def _save(self, tmp_path):
        art = _artifact()
        return art, ck.save(str(tmp_path), 3, _tree(), artifact=art)

    def _edit(self, d, fn):
        mpath = os.path.join(d, "MANIFEST.json")
        with open(mpath) as f:
            manifest = json.load(f)
        fn(manifest)
        with open(mpath, "w") as f:
            json.dump(manifest, f)

    def test_clean_roundtrip(self, tmp_path):
        art, _ = self._save(tmp_path)
        back = ck.load_policy_artifact(str(tmp_path))
        assert back.policy.bits == art.policy.bits
        assert back.registry_hash == art.registry_hash

    def test_step_without_artifact_is_none(self, tmp_path):
        ck.save(str(tmp_path), 0, _tree())
        assert ck.load_policy_artifact(str(tmp_path)) is None

    def test_truncated_manifest_names_the_file(self, tmp_path):
        _, d = self._save(tmp_path)
        mpath = os.path.join(d, "MANIFEST.json")
        with open(mpath) as f:
            text = f.read()
        with open(mpath, "w") as f:
            f.write(text[: len(text) // 2])
        with pytest.raises(ck.ArtifactError, match="MANIFEST.json.*truncated"):
            ck.load_policy_artifact(str(tmp_path))

    def test_missing_required_field_is_named(self, tmp_path):
        _, d = self._save(tmp_path)
        self._edit(d, lambda m: m["extra"][ck.ARTIFACT_KEY].pop("registry_hash"))
        with pytest.raises(ck.ArtifactError, match="'registry_hash'") as ei:
            ck.load_policy_artifact(str(tmp_path))
        assert "MANIFEST.json" in str(ei.value)

    def test_bad_version_field(self, tmp_path):
        _, d = self._save(tmp_path)
        self._edit(d, lambda m: m["extra"][ck.ARTIFACT_KEY].update(artifact_version=999))
        with pytest.raises(ck.ArtifactError, match="invalid policy artifact"):
            ck.load_policy_artifact(str(tmp_path))

    def test_extra_wrong_type(self, tmp_path):
        _, d = self._save(tmp_path)
        self._edit(d, lambda m: m.update(extra=["not", "a", "dict"]))
        with pytest.raises(ck.ArtifactError, match="expected an object"):
            ck.load_policy_artifact(str(tmp_path))

    def test_sidecar_fallback_when_manifest_lost_the_key(self, tmp_path):
        art, d = self._save(tmp_path)
        self._edit(d, lambda m: m["extra"].pop(ck.ARTIFACT_KEY))
        back = ck.load_policy_artifact(str(tmp_path))
        assert back is not None and back.policy.bits == art.policy.bits

    def test_corrupt_sidecar_names_the_sidecar(self, tmp_path):
        _, d = self._save(tmp_path)
        self._edit(d, lambda m: m["extra"].pop(ck.ARTIFACT_KEY))
        sidecar = os.path.join(d, ck.ARTIFACT_FILE)
        with open(sidecar) as f:
            text = f.read()
        with open(sidecar, "w") as f:
            f.write(text[: len(text) // 3])
        with pytest.raises(ck.ArtifactError, match="policy_artifact.json"):
            ck.load_policy_artifact(str(tmp_path))

    def test_artifact_error_is_exported(self):
        import repro_torch.checkpoint as ckpkg

        assert ckpkg.ArtifactError is ck.ArtifactError
        assert ckpkg.CheckpointStore is ck.CheckpointStore and ckpkg.save is ck.save
        assert issubclass(ck.ArtifactError, RuntimeError)


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------


def _counting_step(state, batch):
    """Deterministic toy step: state evolves as a function of (state, batch)."""
    new = {"x": state["x"] + torch.sum(batch), "n": state["n"] + 1}
    return new, {"loss": torch.sum(batch)}


def _inplace_step(state, batch):
    """The port's kind of step: the tensors are updated in place, the step
    count is a Python number."""
    state["x"].mul_(1.0001).add_(batch.mean())
    state["w"][0].sub_(0.01 * batch)
    state["step"] += 1
    return state, {"loss": batch.sum()}


def _batch_fn(step):
    return torch.tensor([step, step + 1], dtype=torch.float32)


class TestTrainLoop:
    def _mk(self, tmp_path, injector=None, total=20, save_every=5, inplace=False):
        store = ck.CheckpointStore(str(tmp_path), keep=3)
        if inplace:
            state = {"x": torch.full((3,), 0.5), "w": [torch.ones(2)], "step": 0}
            return TrainLoop(_inplace_step, state, _batch_fn, store,
                             LoopConfig(total, save_every=save_every), injector=injector)
        return TrainLoop(_counting_step, {"x": torch.zeros(()), "n": torch.zeros((), dtype=torch.int32)},
                         _batch_fn, store, LoopConfig(total, save_every=save_every),
                         injector=injector)

    def test_clean_run(self, tmp_path):
        assert int(self._mk(tmp_path).run()["n"]) == 20

    def test_failure_recovery_bitexact(self, tmp_path):
        clean = self._mk(tmp_path / "clean").run()
        faulty = self._mk(tmp_path / "faulty", FailureInjector(fail_at=(7, 13))).run()
        assert int(faulty["n"]) == int(clean["n"]) == 20
        assert float(faulty["x"]) == float(clean["x"])

    @pytest.mark.parametrize("fail_at", [(7,), (5, 11), (10, 19)])
    def test_in_place_step_recovers_byte_for_byte(self, tmp_path, fail_at):
        clean = self._mk(tmp_path / "clean", inplace=True).run()
        loop = self._mk(tmp_path / "faulty", FailureInjector(fail_at=fail_at), inplace=True)
        faulty = loop.run()
        assert loop.restarts == len(fail_at) and faulty["step"] == clean["step"] == 20
        assert faulty["x"].numpy().tobytes() == clean["x"].numpy().tobytes()
        assert faulty["w"][0].numpy().tobytes() == clean["w"][0].numpy().tobytes()

    def test_failure_before_the_first_save_replays_on_the_advanced_state(self, tmp_path):
        """As in the JAX package: with no checkpoint yet, a restart replays from
        step 0 on the state the failed run left (ROADMAP section 3), so the
        count ends past the step total, at the JAX loop's value."""
        from repro.checkpoint.store import CheckpointStore as JStore
        from repro.runtime.loop import LoopConfig as JLoopConfig
        from repro.runtime.loop import TrainLoop as JTrainLoop
        from repro.runtime.resilience import FailureInjector as JInjector

        final = self._mk(tmp_path / "t", FailureInjector(fail_at=(3,))).run()

        def jstep(state, batch):
            return {"x": state["x"] + jnp.sum(batch), "n": state["n"] + 1}, {"loss": jnp.sum(batch)}

        jfinal = JTrainLoop(jstep, {"x": jnp.zeros(()), "n": jnp.zeros((), jnp.int32)},
                            lambda s: jnp.asarray([s, s + 1], jnp.float32),
                            JStore(str(tmp_path / "j")), JLoopConfig(20, save_every=5),
                            injector=JInjector(fail_at=(3,))).run()
        assert int(final["n"]) == int(jfinal["n"]) == 23
        assert float(final["x"]) == float(jfinal["x"])

    def test_failure_during_save(self, tmp_path):
        loop = self._mk(tmp_path, FailureInjector(fail_at=(9,), kind="save"))
        assert int(loop.run()["n"]) == 20

    def test_restart_budget(self, tmp_path):
        class Always(FailureInjector):
            def check(self, step, site="step"):
                if site == "step":
                    raise SimulatedFailure("always")

        with pytest.raises(RuntimeError, match="restart budget"):
            self._mk(tmp_path, Always()).run()

    def test_resume_from_disk(self, tmp_path):
        """Stop after 10 steps; a fresh loop object resumes, not restarts."""
        self._mk(tmp_path, total=10, save_every=5).run()
        loop2 = self._mk(tmp_path, total=20, save_every=5)
        assert int(loop2.run()["n"]) == 20
        assert loop2.history[0]["step"] >= 9

    def test_jax_loop_resumes_a_port_checkpoint(self, tmp_path):
        """The port's loop saves 10 steps; the JAX loop resumes there."""
        from repro.checkpoint.store import CheckpointStore as JStore
        from repro.runtime.loop import LoopConfig as JLoopConfig
        from repro.runtime.loop import TrainLoop as JTrainLoop

        self._mk(tmp_path, total=10, save_every=5).run()

        def jstep(state, batch):
            return {"x": state["x"] + jnp.sum(batch), "n": state["n"] + 1}, {"loss": jnp.sum(batch)}

        jloop = JTrainLoop(jstep, {"x": jnp.zeros(()), "n": jnp.zeros((), jnp.int32)},
                           lambda s: jnp.asarray([s, s + 1], jnp.float32), JStore(str(tmp_path)),
                           JLoopConfig(20, save_every=5))
        final = jloop.run()
        assert int(final["n"]) == 20 and jloop.history[0]["step"] >= 9
        assert float(final["x"]) == float(self._mk(tmp_path / "ref").run()["x"])


class TestStraggler:
    def test_flags_slow_step(self):
        m = StragglerMonitor(threshold=3.0, warmup=3)
        for i in range(5):
            assert not m.observe(i, 1.0)
        assert m.observe(5, 10.0)
        assert m.flagged[0][0] == 5
        assert m.median() == 1.0        # a flagged step does not poison the median


class TestElastic:
    def test_plan(self):
        p = elastic.plan_mesh(256, model=16)
        assert p.shape == (16, 16) and p.n_devices == 256

    def test_multi_pod_plan(self):
        assert elastic.plan_mesh(512, model=16, pods=2).shape == (2, 16, 16)

    def test_shrink_after_failure(self):
        p = elastic.replan_after_failure(elastic.plan_mesh(256, model=16), n_failed=16)
        assert p.shape == (15, 16)

    def test_too_small_raises(self):
        with pytest.raises(ValueError):
            elastic.plan_mesh(8, model=16)

    def test_batch_for_plan(self):
        assert elastic.batch_for_plan(256, elastic.plan_mesh(240, model=16)) == 255

    @pytest.mark.parametrize("n,model,pods,failed", [(256, 16, 1, 16), (512, 16, 2, 40),
                                                     (96, 8, 3, 9), (64, 64, 1, 0)])
    def test_plans_equal_jax(self, n, model, pods, failed):
        t, j = elastic.plan_mesh(n, model=model, pods=pods), jelastic.plan_mesh(n, model=model,
                                                                               pods=pods)
        assert (t.shape, t.axes) == (j.shape, j.axes)
        t2, j2 = elastic.replan_after_failure(t, failed), jelastic.replan_after_failure(j, failed)
        assert (t2.shape, t2.axes) == (j2.shape, j2.axes)
        assert elastic.batch_for_plan(1000, t2) == jelastic.batch_for_plan(1000, j2)


def test_bf16_roundtrip(tmp_path):
    """bf16 leaves survive npz through the uint-view path, bit-exact."""
    t = {"w": (torch.arange(12).reshape(4, 3) * 0.37).to(torch.bfloat16)}
    ck.save(str(tmp_path), 0, t)
    got, _ = ck.restore(str(tmp_path), t, step=0)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
