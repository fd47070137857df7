"""Each plain reference against the port's plain CPU path, at the
configurations' reduced sizes (f32), through a whole run of the harness:
the closed loop, the recorded batches, the replay and the comparison."""
import pytest

from . import _small
from portbench import check


@pytest.mark.parametrize("name", ["dsmoe16b.decode64", "mamba2.chat64"])
def test_reference_agrees_with_the_port(name):
    served = _small.serve_small(name)
    b = served.batches
    assert b.decodes and b.admissions and not b.unmatched
    # the first turns step idle rows, and later ones re-admit freed slots
    assert any(uid is None for uid, _, _ in b.decodes[0].slots)
    assert len(served.rec.finished()) >= 8
    uids = check.sample_requests(served.rec, _small.SEED)
    assert len(uids) == min(check.SAMPLE, len(served.rec.finished()))
    with _small.one_thread():
        logits = check.reference_logits(served, uids, check.Numerics("f32"), "cpu")
    g = check.gaps(logits, served.rec.tokens)
    assert g.numel() == sum(len(served.rec.tokens[u]) for u in uids)
    assert float(g.max()) <= 1e-4


def test_the_moe_replay_drops_what_the_port_drops():
    from portbench.reference import moe

    served = _small.serve_small("dsmoe16b.decode64")
    rec = served.rec
    with _small.one_thread():
        res = moe.replay(_small.SEED, served.model, served.bits, served.batches, rec.jobs,
                         sorted(rec.finished()), check.Numerics("f32"), "cpu")
    assert res["dropped"] > 0        # the lowered capacity factor drops assignments


def test_the_batches_are_read_from_the_calls_not_from_a_rule(monkeypatch):
    """The engine admitting one request a prefill call, and not the whole
    turn's in one, still replays to the same tokens: the reference reads
    the batches the engine made."""
    from repro_torch.serve import engine

    orig = engine.ServeEngine.__init__

    def one_by_one(self, *a, **kw):
        orig(self, *a, **kw)
        self.batch_admission = False

    monkeypatch.setattr(engine.ServeEngine, "__init__", one_by_one)
    result, notes = _small.run_small("dsmoe16b.decode64")
    assert result["correct"] is True, notes
    assert result["checks"]["unmatched_rows"]["value"] == 0
