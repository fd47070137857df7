"""A run whose timed path is broken underneath comes out not correct: a
token altered where it is produced, and a decode step that returns its state
unchanged.  The harness's look for a card is skipped; the rest of a run is
the benchmark's (the closed loop, the metrics, the check, the cell's limits)."""
import copy

import pytest

from . import _small


def _alter_tokens(monkeypatch):
    from repro_torch.serve import engine

    orig = engine.ServeEngine._decode

    def decode(self, tokens_h, pos_h, inject=None):
        toks, bad = orig(self, tokens_h, pos_h, inject)
        return (toks + 1) % self.cfg.vocab_size, bad

    monkeypatch.setattr(engine.ServeEngine, "_decode", decode)


def _state_unchanged(monkeypatch):
    from repro_torch.serve import engine

    orig = engine.ServeEngine._decode

    def decode(self, tokens_h, pos_h, inject=None):
        before = copy.deepcopy(self.state)
        out = orig(self, tokens_h, pos_h, inject)
        self.state = before
        return out

    monkeypatch.setattr(engine.ServeEngine, "_decode", decode)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged],
                         ids=["token_altered", "state_unchanged"])
@pytest.mark.parametrize("name", ["dsmoe16b.decode64", "mamba2.chat64"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, notes = _small.run_small(name)
    assert result["correct"] is False, notes
    assert result["checks"]["far_share"]["value"] > result["checks"]["far_share"]["limit"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", ["dsmoe16b.decode64", "mamba2.chat64"])
def test_a_sound_run_is_correct(name, trace):
    result, notes = _small.run_small(name, trace=trace)
    assert result["correct"] is True, notes
    cell = _small.small_cell(name)
    if trace:
        # no device trace on the CPU: the readers of the engine's spans and
        # of the client's record report, the device's readers stay silent
        assert set(result["metrics"]) == {"host_ms_per_turn", "admission_ms",
                                          "ttft_p95_ms.host", "itl_p95_ms.host"}
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert {"output_tok_s", "setup_s"} <= set(result["metrics"])
