"""The traffic generator: the seed orders the same sizes, and fixes the tokens."""
import json
import math
from collections import Counter

from . import _paths  # noqa: F401
from portbench import traffic
from portbench.cell import HERE


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _draw(mix, seed, n):
    t = traffic.Traffic(mix, seed, 1000)
    return [t.next(i % mix["clients"], first=i < mix["clients"]) for i in range(n)]


def test_same_seed_same_requests():
    mix = _mix("chat64")
    a, b = _draw(mix, 2**33 + 17, 200), _draw(mix, 2**33 + 17, 200)
    assert [(j.prompt, j.max_new_tokens) for j in a] == [(j.prompt, j.max_new_tokens) for j in b]


def test_seeds_permute_one_table_of_sizes():
    mix = _mix("chat64")
    n = mix["pool"]
    a, b = _draw(mix, 1, n), _draw(mix, 2, n)
    assert Counter(len(j.prompt) for j in a) == Counter(len(j.prompt) for j in b)
    assert Counter(j.max_new_tokens for j in a) == Counter(j.max_new_tokens for j in b)
    assert [len(j.prompt) for j in a] != [len(j.prompt) for j in b]
    assert a[0].prompt != b[0].prompt


def test_first_outputs_spread_over_their_range():
    mix = dict(_mix("chat64"), first_output={"dist": "uniform", "min": 1, "max": 256})
    a = _draw(mix, 1, mix["clients"])
    firsts = sorted(j.max_new_tokens for j in a)
    assert firsts[0] <= 4 and firsts[-1] >= 252


def test_tables_follow_the_mix():
    mix = _mix("chat64")
    prompts = traffic.quantile_table(mix["prompt"], mix["pool"])
    outputs = traffic.quantile_table(mix["output"], mix["pool"])
    for table, spec in ((prompts, mix["prompt"]), (outputs, mix["output"])):
        assert min(table) >= spec["min"] and max(table) <= spec["max"]
        # the lognormal's median, exp(-sigma^2 / 2) of its mean
        median = spec["mean"] * math.exp(-spec["sigma"] ** 2 / 2)
        assert abs(sorted(table)[len(table) // 2] - median) <= 1
    assert max(prompts) == mix["prompt"]["max"] and max(outputs) == mix["output"]["max"]
    assert mix["prompt"]["max"] + mix["output"]["max"] <= mix["max_seq"]
