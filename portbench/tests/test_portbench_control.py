"""The control: the plain reference put in the program's place in fp8, the
precision below the configurations' bf16, judged by the harness's own
comparison (``check.compare``) at a size a test run holds.  The reduced
models' logits lie closer together than the full ones', so the gap counted
far is 0.02 here.  The program at the reduced sizes runs in f32, the
reference's own arithmetic, and reads 0; the control reads 0.29-0.39 on
dsmoe16b and 0.06-0.09 on mamba2 (three seeds, 36 turns), so it comes out
not correct under a limit of 0.01 set between the two, where the program
comes out correct.  The readings at the cells' own size, judged
under the cells' own limits, are in PERF.md."""
import dataclasses

import pytest

from . import _small
from portbench import check

SMALL_GAP = 0.02
SMALL_LIMIT = 0.01


@pytest.mark.parametrize("name", ["dsmoe16b.decode64", "mamba2.chat64"])
def test_the_fp8_control_fails_where_the_program_passes(name):
    cell = _small.small_cell(name)
    cell = dataclasses.replace(cell, limits={"far_gap": SMALL_GAP, "limits": {"far_share": SMALL_LIMIT}})
    served = _small.serve_small(name, turns=36)
    uids = check.sample_requests(served.rec, served.seed)
    with _small.one_thread():
        logits = check.reference_logits(served, uids, check.Numerics("f32"), "cpu")
        control = check.stand_in_tokens(served, uids, "fp8", "cpu")
    program, got = check.compare(cell, served, logits, served.rec.tokens)
    assert all(c["value"] <= c["limit"] for c in program.values()), program
    assert got["max_gap"] <= 1e-4
    compared, _ = check.compare(cell, served, logits, control)
    assert compared["far_share"]["value"] > compared["far_share"]["limit"]
