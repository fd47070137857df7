"""Low-overhead event/span tracer with Chrome/Perfetto export (a copy of
``repro/obs/trace.py``).

Design constraints, in priority order:

1. **Disabled must be free.**  The serve loop calls ``tracer.span(...)``
   several times per decode step; when tracing is off every call returns
   the same pre-allocated :data:`NOOP_SPAN` singleton and records nothing —
   no event object, no clock read, no dict.
2. **Enabled must be cheap.**  A recorded span is one ``perf_counter()``
   read on entry, one on exit, and one tuple append; export formatting is
   deferred to :meth:`Tracer.chrome_trace`.
3. **One clock.**  All timestamps are ``time.perf_counter()`` seconds
   (monotonic); export converts to the microseconds Perfetto expects,
   rebased to the tracer's enable time so traces start near zero.

Tracks (Perfetto "threads") are plain strings — ``"engine"`` for the serve
loop's step-phase spans, ``"req/<uid>"`` for per-request lifecycle spans,
``"kernel"`` for kernel events — mapped to stable integer ``tid``s at
record time and named via ``thread_name`` metadata on export.

The process-wide default tracer (:func:`get_tracer`) is what the serve
engine, the search and the launchers share, so one ``enable()`` makes the
search's spans and live decode steps land in the same trace file.
"""
from __future__ import annotations

import json
import time
from typing import Any


class _NoopSpan:
    """The disabled fast path: a context manager that does nothing.

    A single module-level instance is returned by every ``span()`` call on
    a disabled tracer, so tracing-off costs one attribute check and zero
    allocations per call site.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kw) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _Span:
    """A live span: times its ``with`` body and records one "X" event."""

    __slots__ = ("_tracer", "name", "cat", "track", "args", "_hist", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str,
                 hist, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self._hist = hist

    def annotate(self, **kw) -> None:
        if self.args is None:
            self.args = {}
        self.args.update(kw)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        self._tracer._events.append(
            ("X", self.name, self.cat, self.track, self.t0, dur, self.args))
        if self._hist is not None:
            self._hist.observe(dur)
        return False


class Tracer:
    """Process-wide span/event recorder with Perfetto export.

    Events are stored as tuples ``(ph, name, cat, track, ts, dur, args)``
    with ``ts``/``dur`` in perf_counter seconds; ``ph`` follows the Chrome
    ``trace_event`` phase letters ("X" complete span, "i" instant,
    "C" counter).
    """

    def __init__(self):
        self.enabled = False
        self._events: list[tuple] = []
        self._t0 = 0.0

    # -- lifecycle ---------------------------------------------------------
    def enable(self, *, clear: bool = True) -> None:
        if clear:
            self.clear()
        if not self._events:
            self._t0 = time.perf_counter()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._events = []
        self._t0 = time.perf_counter()

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, *, cat: str = "span", track: str = "engine",
             hist=None, args: dict | None = None):
        """Context manager timing its body.  ``hist`` (an
        ``obs.metrics.Histogram``) additionally receives the duration in
        seconds on exit, so trace events and metrics stay in lock-step."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, track, hist, args)

    def complete(self, name: str, *, ts: float, dur: float, cat: str = "span",
                 track: str = "engine", args: dict | None = None) -> None:
        """Record an already-timed span (explicit start + duration)."""
        if not self.enabled:
            return
        self._events.append(("X", name, cat, track, ts, dur, args))

    def instant(self, name: str, *, cat: str = "event", track: str = "engine",
                args: dict | None = None, ts: float | None = None) -> None:
        if not self.enabled:
            return
        self._events.append(
            ("i", name, cat, track,
             time.perf_counter() if ts is None else ts, None, args))

    def counter(self, name: str, value: float, *, track: str = "counters",
                ts: float | None = None) -> None:
        """Record a Perfetto counter sample (rendered as a value track)."""
        if not self.enabled:
            return
        self._events.append(
            ("C", name, "counter", track,
             time.perf_counter() if ts is None else ts, None,
             {name: value}))

    def events(self) -> list[tuple]:
        return list(self._events)

    # -- export ------------------------------------------------------------
    def chrome_trace(self, *, pid: int = 0,
                     process_name: str = "sigmaquant-serve") -> dict:
        """Chrome/Perfetto ``trace_event`` JSON document.

        Open the saved file at https://ui.perfetto.dev (or
        ``chrome://tracing``): each track becomes a named thread lane, "X"
        spans nest by interval containment, instants render as markers and
        "C" events as counter plots.
        """
        tids: dict[str, int] = {}
        out: list[dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]

        def tid(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids) + 1
                out.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tids[track], "args": {"name": track}})
            return tids[track]

        t0 = self._t0
        for ph, name, cat, track, ts, dur, args in self._events:
            ev: dict[str, Any] = {
                "ph": ph, "name": name, "cat": cat, "pid": pid,
                "tid": tid(track), "ts": round((ts - t0) * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def save(self, path: str, **kw) -> dict:
        doc = self.chrome_trace(**kw)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


#: Chrome trace_event phases this module emits (M = track metadata).
_PHASES = frozenset("XiCM")


def validate_chrome_trace(doc: dict) -> None:
    """Schema check for an exported trace; raises ``ValueError`` on the
    first violation.  Used by the tests and cheap enough to run after
    every ``--trace`` export."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must be a dict with 'traceEvents'")
    for i, ev in enumerate(doc["traceEvents"]):
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing required key {key!r}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if ev["ph"] in ("X", "i", "C"):
            if "ts" not in ev:
                raise ValueError(f"event {i} ({ev['name']!r}) missing ts")
            if ev["ts"] < 0:
                raise ValueError(f"event {i} ({ev['name']!r}) has ts < 0")
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(
                    f"event {i} ({ev['name']!r}) missing/negative dur")
    json.dumps(doc)  # must be serializable as-is


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every subsystem shares."""
    return _TRACER


def enable(*, clear: bool = True) -> Tracer:
    _TRACER.enable(clear=clear)
    return _TRACER


def disable() -> None:
    _TRACER.disable()


def is_enabled() -> bool:
    return _TRACER.enabled
