"""The one traffic generator: a mix file's parameters and a seed -> requests.

A mix (``traffic/<mix>.json``) fixes a closed loop: ``clients`` users, each
sending its next request when its last one completes.  Prompt and output
lengths come from fixed tables of ``pool`` entries, the quantiles of the
mix's distributions at ``(i + 0.5) / pool``; the seed only permutes the
tables and draws the prompts' token ids.  So every seed offers the same
sizes in another order, and the work of a run does not move with the seed.
Where the mix has ``first_output``, each client's first request takes its
output length from it (spread evenly over its range), so that completions
do not come in lockstep.

Keys of a mix file:
    clients, slots, max_seq     the closed loop and the engine's geometry
    join_per_turn               clients that send their first request at each
                                of the first loop turns
    open_after_turns            the loop turn at which the measured window opens
    pool                        entries in each length table
    prompt, output, first_output (optional)
        {"dist": "lognormal", "median" or "mean", "sigma", "min", "max"} or
        {"dist": "uniform", "min", "max"} (whole numbers, both ends included)
    source, assumed             where the lengths come from, in words
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np


def quantile_table(spec: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of ``spec``, clipped to its range."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(u)
            sigma = float(spec["sigma"])
            median = (float(spec["median"]) if "median" in spec
                      else float(spec["mean"]) * math.exp(-0.5 * sigma * sigma))
            v = round(median * math.exp(sigma * z))
        elif spec["dist"] == "uniform":
            v = lo + math.floor(u * (hi - lo + 1))
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(max(int(v), lo), hi))
    return out


@dataclasses.dataclass
class Job:
    """One request as the client sends it."""
    index: int          # order in the run's request sequence
    client: int
    prompt: list[int]
    max_new_tokens: int


class Traffic:
    """The run's request sequence, drawn lazily: ``next(client)`` gives a
    client its next request.  The i-th request of a run is the same for a
    given seed whichever client asks for it."""

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.mix = mix
        self.clients = int(mix["clients"])
        self.vocab_size = int(vocab_size)
        pool = int(mix["pool"])
        self._rng = np.random.default_rng(int(seed))
        self._prompt_table = quantile_table(mix["prompt"], pool)
        self._output_table = quantile_table(mix["output"], pool)
        self._first = None
        if "first_output" in mix:
            first = quantile_table(mix["first_output"], self.clients)
            self._first = [first[i] for i in self._rng.permutation(self.clients)]
        self._prompts: list[int] = []
        self._outputs: list[int] = []
        self.sent = 0
        self._first_sent = 0

    def _refill(self) -> None:
        self._prompts += [self._prompt_table[i]
                          for i in self._rng.permutation(len(self._prompt_table))]
        self._outputs += [self._output_table[i]
                          for i in self._rng.permutation(len(self._output_table))]

    def next(self, client: int, first: bool = False) -> Job:
        if not self._prompts:
            self._refill()
        length = self._prompts.pop(0)
        out = self._outputs.pop(0)
        if first and self._first is not None:
            out = self._first[self._first_sent]
            self._first_sent += 1
        prompt = self._rng.integers(1, self.vocab_size, length).tolist()
        job = Job(index=self.sent, client=client, prompt=prompt, max_new_tokens=int(out))
        self.sent += 1
        return job
