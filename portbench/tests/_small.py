"""A cell cut to CPU size for the tests: the family's reduced configuration
(the MoE layer's capacity factor lowered, so that assignments drop), eight
clients on eight slots, short prompts and answers, the first answers spread
so that completions do not come in lockstep.  The window is counted in
loop turns, and torch runs on one thread, so that a run does the same work
however busy the machine is (the test suite runs in parallel workers)."""
import contextlib
import dataclasses
import time

import torch

from . import _paths  # noqa: F401
from portbench import cell as cell_mod
from portbench import harness

SEED = 2**33 + 5
TURNS = 24


def small_cell(name: str):
    c = cell_mod.load(name)
    mix = dict(c.mix, clients=8, slots=8, max_seq=256, join_per_turn=2, open_after_turns=6,
               pool=64, prompt={"dist": "lognormal", "median": 40, "sigma": 0.5, "min": 8,
                                "max": 120},
               output={"dist": "uniform", "min": 4, "max": 24},
               first_output={"dist": "uniform", "min": 1, "max": 24})
    return dataclasses.replace(c, mix=mix)


def reduced(cfg):
    r = cfg.reduced()
    return dataclasses.replace(r, moe_capacity_factor=0.5) if r.family == "moe" else r


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def serve_small(name: str, turns: int = TURNS, seed: int = SEED):
    with one_thread():
        return harness.serve(small_cell(name), seed, 3600.0, False, time.perf_counter(),
                             device="cpu", cfg_hook=reduced, window_turns=turns)


def run_small(name: str, turns: int = TURNS, seed: int = SEED, trace: bool = False):
    with one_thread():
        return harness.run_cell(small_cell(name), seed, 3600.0, trace, time.perf_counter(),
                                device="cpu", cfg_hook=reduced, window_turns=turns)
