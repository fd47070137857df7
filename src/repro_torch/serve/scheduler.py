"""Chunked-prefill scheduling under a per-step token budget (a copy of
``repro/serve/scheduler.py``).

The engine's whole-prompt admission prefills every queued prompt in one padded
``(n_free, pad)`` call, so one long prompt stalls every decoding slot for a
full quadratic-attention prefill.  With ``prefill_chunk=C`` the engine
instead admits long prompts in the PREFILLING state and asks this scheduler,
once per loop turn, which prefilling slots may run one ``<= C``-token chunk
this turn.  The contract:

  * **Budget**: ``decode_tokens + chunk_tokens + finish_tokens <=
    step_token_budget`` every turn.  Decode slots are charged one token
    each (a speculative burst is one weight pass — the budget meters
    dispatch work, not emitted tokens); a chunk is charged its real token
    count ``n = min(C, remaining)``; a chunk that COMPLETES its prompt is
    charged one extra token (``finish_tokens``) because the engine runs the
    finished slot's first decode the same turn — the insert and the slot's
    entry into the lockstep dispatch must be atomic, or an idle-slot write
    could requantize real cache rows in between.
  * **Decode never starves**: the scheduler only ever allocates the budget
    LEFT OVER after every active decode slot is charged — decode runs every
    turn regardless of prefill backlog (starvation bound: 0 turns).
  * **Prefill never starves**: construction requires
    ``step_token_budget >= max_slots + prefill_chunk``, so even a full
    decode house leaves room for one full chunk; round-robin rotation
    guarantees every prefilling slot chunks at least once per
    ``len(prefilling)`` turns.
  * Chunks are all-or-nothing: a slot chunks only if its whole next chunk
    fits the remaining quota, so every non-final chunk is exactly ``C``
    tokens (one chunk shape per prompt).

Every ``plan()`` call appends a :class:`SchedRecord`, which is the
accounting surface the scheduler tests check the invariants on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static chunked-prefill knobs (validated against the slot count)."""

    prefill_chunk: int
    step_token_budget: int

    def validate(self, max_slots: int) -> None:
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{self.prefill_chunk}")
        floor = max_slots + self.prefill_chunk
        if self.step_token_budget < floor:
            raise ValueError(
                f"step_token_budget={self.step_token_budget} cannot fit a "
                f"full decode house plus one chunk (need >= max_slots + "
                f"prefill_chunk = {max_slots} + {self.prefill_chunk} = "
                f"{floor}); a long prompt could starve forever")


@dataclasses.dataclass(frozen=True)
class SchedRecord:
    """One loop turn's token accounting (the invariant-test surface)."""

    step: int
    decode_tokens: int        # active decode slots charged this turn
    chunk_tokens: int         # prefill tokens granted this turn
    finish_tokens: int        # same-turn first-decode charges (one per
                              # prompt whose final chunk lands this turn)
    n_prefilling: int         # prefilling slots that wanted a chunk
    budget: int


class ChunkScheduler:
    """Round-robin chunk planner over the prefilling slots (host logic only).

    Stateless but for the rotation pointer and the accounting log — the
    engine owns all request/slot/block state; this class only answers
    "who chunks this turn, and by how much".
    """

    def __init__(self, cfg: SchedulerConfig, max_slots: int):
        cfg.validate(max_slots)
        self.cfg = cfg
        self._rr = 0
        self.records: list[SchedRecord] = []

    def plan(self, step: int, n_decode: int,
             prefilling: list[tuple[int, int]]) -> list[tuple[int, int]]:
        """-> ``[(slot_id, n_tokens)]`` chunks to run this turn.

        ``prefilling``: ``(slot_id, remaining_head_tokens)`` per slot still
        mid-prefill; ``n_decode``: decode slots stepping this turn (charged
        first — decode never waits on prefill).
        """
        quota = max(0, self.cfg.step_token_budget - n_decode)
        plan: list[tuple[int, int]] = []
        finish = 0
        if prefilling:
            start = self._rr % len(prefilling)
            order = prefilling[start:] + prefilling[:start]
            for slot_id, remaining in order:
                n = min(self.cfg.prefill_chunk, remaining)
                cost = n + (n == remaining)   # final chunk: +1 same-turn decode
                if 0 < n and cost <= quota:
                    plan.append((slot_id, n))
                    finish += n == remaining
                    quota -= cost
            self._rr += 1
        self.records.append(SchedRecord(
            step=step, decode_tokens=n_decode,
            chunk_tokens=sum(n for _, n in plan), finish_tokens=finish,
            n_prefilling=len(prefilling), budget=self.cfg.step_token_budget))
        return plan
