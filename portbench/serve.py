"""The system under test, driven as users drive it: packed weights under the
configuration's bit policy, ``ServeEngine`` and a closed loop of clients.

The loop runs in one ``ServeEngine.run(step_hook=...)`` call.  Clients join
during set-up; the window opens at a fixed loop turn and closes at the first
turn that starts ``seconds`` after it (or, where ``window_turns`` is given,
that many turns after it), where every live request is cancelled so that the
run ends.  A traced run records the device over the window's
last ``profile_seconds``.  Tokens come back through ``submit(on_token=)``; the
time to first token through ``lifecycles[uid]``.
"""
from __future__ import annotations

import dataclasses
import time

from .traffic import Job, Traffic


@dataclasses.dataclass
class Record:
    """What the loop saw: the requests, when each was sent, every token
    with its time and loop turn, and the turn boundaries."""
    jobs: dict[int, Job] = dataclasses.field(default_factory=dict)
    sent_turn: dict[int, int] = dataclasses.field(default_factory=dict)
    sent_t: dict[int, float] = dataclasses.field(default_factory=dict)
    tokens: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    token_t: dict[int, list[float]] = dataclasses.field(default_factory=dict)
    commits: list[list[int]] = dataclasses.field(default_factory=list)   # uids by turn
    turn_t: list[float] = dataclasses.field(default_factory=list)        # hook times
    turn_open: int | None = None
    turn_profile: int | None = None      # first turn of the device trace, if any
    turn_close: int | None = None
    t_open: float | None = None
    t_close: float | None = None
    t_close_mono: float | None = None

    def finished(self) -> list[int]:
        return [u for u, j in self.jobs.items() if len(self.tokens[u]) >= j.max_new_tokens]


class ClosedLoop:
    """The step hook and the token callback of one run."""

    def __init__(self, engine, traffic: Traffic, mix: dict, seconds: float, *,
                 capture=None, profile_seconds: float = 0.0, window_turns: int | None = None):
        self.eng = engine
        self.traffic = traffic
        self.clients = int(mix["clients"])
        self.join = int(mix["join_per_turn"])
        self.open_after = int(mix["open_after_turns"])
        self.seconds = float(seconds)
        self.window_turns = window_turns
        self.capture = capture
        self.profile_seconds = min(float(profile_seconds), self.seconds / 3)
        self.rec = Record()
        self._live: dict[int, int] = {}          # uid -> client
        self._done: list[int] = []               # clients whose request completed
        self.turn = -1                           # the hook's first call is turn 0
        self._joined = 0

    # -- the client side ------------------------------------------------------
    def _send(self, client: int, first: bool) -> None:
        job = self.traffic.next(client, first=first)
        from repro_torch.serve.engine import Request

        uid = job.index
        rec = self.rec
        rec.jobs[uid] = job
        rec.tokens[uid] = []
        rec.token_t[uid] = []
        rec.sent_turn[uid] = max(self.turn, 0)
        rec.sent_t[uid] = time.perf_counter()
        self._live[uid] = client
        self.eng.submit(Request(uid=uid, prompt=job.prompt, max_new_tokens=job.max_new_tokens),
                        on_token=self.on_token)

    def _join_next(self) -> None:
        for c in range(self._joined, min(self._joined + self.join, self.clients)):
            self._send(c, first=True)
        self._joined = min(self._joined + self.join, self.clients)

    def on_token(self, uid: int, tok: int) -> None:
        rec = self.rec
        rec.tokens[uid].append(int(tok))
        rec.token_t[uid].append(time.perf_counter())
        rec.commits[-1].append(uid)
        if len(rec.tokens[uid]) >= rec.jobs[uid].max_new_tokens:
            self._done.append(self._live.pop(uid))

    def hook(self, eng, step) -> None:
        """Once a loop turn, before its admission: open or close the window,
        start or stop the profiler, let clients join, send the next request
        of every client whose last one completed."""
        self.turn += 1
        turn = self.turn
        rec = self.rec
        now = time.perf_counter()
        rec.turn_t.append(now)
        rec.commits.append([])
        if rec.t_open is None and turn == self.open_after:
            rec.t_open, rec.turn_open = now, turn
        if (self.capture is not None and self.profile_seconds and rec.turn_profile is None
                and rec.t_open is not None
                and now - rec.t_open >= self.seconds - self.profile_seconds):
            # the device trace covers the window's last turns, so that reading
            # it back disturbs no measured turn
            rec.turn_profile = turn
            self.capture.start()
        if rec.t_open is not None and (now - rec.t_open >= self.seconds
                                       if self.window_turns is None
                                       else turn - rec.turn_open >= self.window_turns):
            rec.t_close, rec.turn_close = now, turn
            rec.t_close_mono = time.monotonic()
            if self.capture is not None and self.capture.running:
                self.capture.stop()
            for uid in list(self._live):
                eng.cancel(uid)
            return
        if turn and self._joined < self.clients:
            self._join_next()
        for c in self._done:
            self._send(c, first=False)
        self._done = []

    def run(self) -> Record:
        """The whole loop, set-up's turns and the window, in one ``run`` call."""
        self._join_next()                         # turn 0's clients
        self.eng.run(step_hook=self.hook)
        return self.rec
