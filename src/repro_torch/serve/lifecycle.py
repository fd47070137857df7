"""Request lifecycle + graceful-degradation policy for the serve path (a copy of
``repro/serve/lifecycle.py``).

Production traffic needs the full lattice of request fates::

    QUEUED -> PREFILL -> DECODE -> DONE
       |         |          |---> FAILED      (non-finite logits, append fault)
       |         |          |---> CANCELLED   (explicit engine.cancel)
       |         |          |---> TIMED_OUT   (deadline / TTFT budget)
       |         |          '---> QUEUED      (preempted under pool pressure)
       |         '--> QUEUED                  (admission rejected: pool full,
       |                                       or preempted mid-chunk)
       '--> CANCELLED | TIMED_OUT             (never admitted)

Under chunked prefill (``serve/scheduler.py``) PREFILL is not one atomic turn: the
request stays in PREFILL across every budgeted chunk, ``prefill_progress``
counting the head tokens landed so far, and every PREFILL edge above is
valid *between chunks* — cancel/deadline/preemption mid-chunk free the
partial scratch, blocks and reservations through the same exactly-once
finalization as any resident request.

``RequestLifecycle`` is the per-request record: every transition is
validated against the edges above and timestamped, terminal states are
absorbing (a second finalization raises ``LifecycleError`` — the
"free exactly once" contract the engine's slot/block/reservation
accounting rides on), and preemption snapshots the generated prefix in
``resume_tokens`` so the re-queued request replays it through the normal
prefill/shared-prefix machinery.

``ShedPolicy`` configures the tiered degradation ladder the JAX engine
walks under pool pressure instead of waiting indefinitely (the port's
engine keeps it as data; the ladder itself is not ported yet):

  tier 0          full service (configured speculation K)
  tier 1..n-1     speculation shed K -> K//2 -> ... -> off; each step
                  releases the draft bursts' per-slot block-headroom
                  reservations back to the pool
  preemption      the lowest-priority resident request (strictly below the
                  best waiting request's priority — equal priorities never
                  thrash) is preempted: progress snapshotted, resources
                  freed, request re-enters QUEUED

When pressure clears the engine climbs back down one tier per pressure-free
turn, re-securing the speculation headroom reservations before re-raising K
(never strand an admitted request).
"""
from __future__ import annotations

import dataclasses
import enum


class LifecycleError(RuntimeError):
    """An illegal lifecycle transition (incl. double-finalization)."""


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"


TERMINAL_STATES = frozenset({RequestState.DONE, RequestState.FAILED,
                             RequestState.CANCELLED, RequestState.TIMED_OUT})

_LEGAL: dict[RequestState, frozenset[RequestState]] = {
    RequestState.QUEUED: frozenset({RequestState.PREFILL, RequestState.CANCELLED,
                                    RequestState.TIMED_OUT}),
    RequestState.PREFILL: frozenset({RequestState.DECODE, RequestState.QUEUED,
                                     RequestState.FAILED, RequestState.CANCELLED,
                                     RequestState.TIMED_OUT}),
    RequestState.DECODE: frozenset({RequestState.DONE, RequestState.FAILED,
                                    RequestState.CANCELLED, RequestState.TIMED_OUT,
                                    RequestState.QUEUED}),
}


@dataclasses.dataclass
class RequestLifecycle:
    """Per-request lifecycle record (timestamps are ``time.monotonic``)."""

    uid: int
    priority: int = 0
    deadline_s: float | None = None       # end-to-end budget from enqueue
    ttft_budget_s: float | None = None    # first-token budget from enqueue
    state: RequestState = RequestState.QUEUED
    enqueued_t: float = 0.0
    admitted_t: float | None = None
    first_token_t: float | None = None
    finished_t: float | None = None
    preemptions: int = 0
    #: chunked prefill: head tokens prefilled so far — the
    #: PREFILLING(progress) notion; stays 0 for whole-prompt admissions and
    #: resets with the request if a preemption sends it back to QUEUED
    prefill_progress: int = 0
    #: tokens generated before the most recent preemption; the resumed
    #: request replays them as prompt suffix, and the final stream is
    #: ``resume_tokens + generated``
    resume_tokens: list[int] = dataclasses.field(default_factory=list)
    #: final token stream (set at finalization, partial for non-DONE ends)
    tokens: list[int] = dataclasses.field(default_factory=list)
    diagnostic: str = ""
    history: list[tuple[str, float]] = dataclasses.field(default_factory=list)
    #: optional ``fn(lifecycle, old_state, new_state, now, diagnostic)``
    #: called after every validated transition — the serve engine hangs its
    #: observation off this hook so it keys off the SAME transitions the
    #: resource accounting does
    observer: object = dataclasses.field(default=None, repr=False,
                                         compare=False)

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def transition(self, new: RequestState, now: float,
                   diagnostic: str = "") -> None:
        if self.terminal:
            raise LifecycleError(
                f"request {self.uid} already finalized as {self.state.value}; "
                f"refusing second transition to {new.value}")
        if new not in _LEGAL[self.state]:
            raise LifecycleError(
                f"request {self.uid}: illegal transition "
                f"{self.state.value} -> {new.value}")
        old = self.state
        self.state = new
        self.history.append((new.value, now))
        if diagnostic:
            self.diagnostic = diagnostic
        if new is RequestState.PREFILL:
            self.admitted_t = now
        elif new in TERMINAL_STATES:
            self.finished_t = now
        if self.observer is not None:
            self.observer(self, old, new, now, diagnostic)

    def expired(self, now: float) -> str | None:
        """Which budget (if any) this request has blown at ``now``."""
        if self.terminal:
            return None
        waited = now - self.enqueued_t
        if self.deadline_s is not None and waited > self.deadline_s:
            return "deadline"
        if (self.ttft_budget_s is not None and self.first_token_t is None
                and waited > self.ttft_budget_s):
            return "ttft"
        return None

    def ttft(self) -> float | None:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.enqueued_t

    def ttlt(self) -> float | None:
        """Time to last token (end-to-end latency from enqueue)."""
        if self.finished_t is None:
            return None
        return self.finished_t - self.enqueued_t


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Tiered graceful-degradation config (see module docstring).

    ``straggler_sheds_spec`` lets a flagged slow step shed one speculation
    tier (never below K=1 on the latency signal alone — only real pool
    pressure turns speculation fully off), giving degradation decisions the
    latency signal the ``StragglerMonitor`` produces.
    """

    spec_tiers: bool = True        # shed K -> K//2 -> ... -> 0 under pressure
    preempt: bool = True           # priority-gated preemption as the last tier
    straggler_sheds_spec: bool = True
    restore: bool = True           # climb back down when pressure clears


def spec_ladder(k: int) -> list[int]:
    """Degradation ladder for a configured burst K: [K, K//2, ..., 1, 0]."""
    out = []
    while k > 0:
        out.append(k)
        k //= 2
    out.append(0)
    return out
