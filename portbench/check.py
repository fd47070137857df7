"""Whether what the timed path served is right, judged by the plain reference.

Once the window has closed and the program is freed, a sample of the
requests the run finished, drawn from the seed with the longest among them,
is run through the plain reference of the configuration's family, teacher
forced on the tokens the program served.  At every served token the gap is
the amount by which the token's reference logit lies below the reference's
best logit there: greedy decoding served the best token of its own logits,
so a sound program serves tokens the reference ranks first or nearly so.

``limits/<cell>.json`` names the gap ``far_gap`` and the numbers compared,
each with its limit: ``far_share``, the share of served tokens more than
``far_gap`` below the reference's best.  The widest gap and the mean gap
are reported beside them.  Every run also compares ``unmatched_rows``, the
rows of the engine's calls that carry no request and the served tokens that
no call produced (``batches.py``), with the limit 0.  ``PERF.md`` gives the readings each limit was set
from, and why the widest gap is not compared.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference.common import Numerics

SAMPLE = 16


def sample_requests(rec, seed: int, k: int = SAMPLE) -> list[int]:
    """``k`` finished requests drawn from the seed, the longest served one among them."""
    done = sorted(rec.finished())
    if not done:
        return []
    longest = max(done, key=lambda u: (len(rec.tokens[u]), -u))
    rest = [u for u in done if u != longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return sorted([longest] + [rest[i] for i in pick])


def reference_logits(served, uids: list[int], num: Numerics, device) -> dict:
    """Logits (n, V) at every served token of ``uids``, from the plain
    reference of the configuration's family, ``reference/<family>.py``."""
    m = served.model
    try:
        ref = importlib.import_module(f"portbench.reference.{m['family']}")
    except ModuleNotFoundError:
        raise NotImplementedError(f"no plain reference for family {m['family']!r}") from None
    return ref.served_logits(served.seed, m, served.bits, served.batches, served.rec, uids, num,
                             device)


def gaps(logits: dict, tokens: dict) -> torch.Tensor:
    """Best logit less the served token's, at every served token."""
    out = []
    for u, lg in logits.items():
        served = torch.tensor(tokens[u][:lg.shape[0]], device=lg.device)
        out.append(lg.max(dim=-1).values - lg.gather(1, served[:, None])[:, 0])
    return torch.cat(out)


def readings(g: torch.Tensor, far_gap: float) -> dict:
    """The numbers a run's gaps give: the widest, the mean, and the share of
    served tokens more than ``far_gap`` below the reference's best."""
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "far_share": float((g > far_gap).to(torch.float32).mean())}


def compare(cell, served, logits: dict, tokens: dict) -> tuple[dict, dict]:
    """(the numbers ``limits/<cell>.json`` compares, each with its limit;
    the others, for the record) of ``tokens`` judged by the f32 reference's
    ``logits``."""
    compared = {"unmatched_rows": {"value": len(served.batches.unmatched), "limit": 0}}
    got = readings(gaps(logits, tokens), cell.limits["far_gap"])
    got["positions"] = sum(lg.shape[0] for lg in logits.values())
    compared.update({k: {"value": got.pop(k), "limit": float(v)}
                     for k, v in cell.limits["limits"].items()})
    return compared, got


def check(cell, served, *, device="cuda") -> tuple[dict, dict]:
    """``compare`` of the tokens the program served, over the sample."""
    uids = sample_requests(served.rec, served.seed)
    if not uids:
        return {"unmatched_rows": {"value": len(served.batches.unmatched), "limit": 0},
                "finished_sample": {"value": 1, "limit": 0}}, {}
    try:
        logits = reference_logits(served, uids, Numerics("f32"), device)
    except AssertionError as e:          # a batch the reference cannot replay
        return {"unmatched_rows": {"value": len(served.batches.unmatched), "limit": 0},
                "replayed": {"value": 1, "limit": 0}}, {"replay_error": str(e)}
    return compare(cell, served, logits, served.rec.tokens)


def stand_in_tokens(served, uids: list[int], mode: str, device) -> dict:
    """The tokens the plain reference computed in ``mode`` (``"fp8"``, the
    control; ``"bf16"``) puts first at each position of the same prompts
    and served tokens: what it would serve in the program's place."""
    low = reference_logits(served, uids, Numerics(mode), device)
    return {u: low[u].argmax(dim=-1).tolist() for u in uids}
