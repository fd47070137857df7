"""Low-overhead process-wide span/event tracer (port of ``repro/obs/trace.py``).

Disabled, every ``span()`` returns the shared :data:`NOOP_SPAN` and records
nothing; enabled, a span is two ``perf_counter()`` reads and one tuple
append.  Events are ``(ph, name, cat, track, ts, dur, args)`` tuples with
``ts``/``dur`` in ``perf_counter`` seconds and ``ph`` the Chrome
``trace_event`` phase letter ("X" complete span, "i" instant, "C" counter).
The Chrome/Perfetto export (``--trace``) is not ported yet.
"""
from __future__ import annotations

import time


class _NoopSpan:
    """The disabled fast path: a context manager that does nothing."""

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

    __slots__ = ("_tracer", "name", "cat", "track", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args

    def annotate(self, **kw) -> None:
        if self.args is None:
            self.args = {}
        self.args.update(kw)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        self._tracer._events.append(("X", self.name, self.cat, self.track, self.t0, dur,
                                     self.args))
        return False


class Tracer:
    """Process-wide span/event recorder."""

    def __init__(self):
        self.enabled = False
        self._events: list[tuple] = []

    def enable(self, *, clear: bool = True) -> None:
        if clear:
            self._events = []
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def span(self, name: str, *, cat: str = "span", track: str = "engine",
             args: dict | None = None):
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, track, args)

    def complete(self, name: str, *, ts: float, dur: float, cat: str = "span",
                 track: str = "engine", args: dict | None = None) -> None:
        """Record an already-timed span (explicit start + duration)."""
        if self.enabled:
            self._events.append(("X", name, cat, track, ts, dur, args))

    def instant(self, name: str, *, cat: str = "event", track: str = "engine",
                args: dict | None = None, ts: float | None = None) -> None:
        if self.enabled:
            self._events.append(("i", name, cat, track,
                                 time.perf_counter() if ts is None else ts, None, args))

    def counter(self, name: str, value: float, *, track: str = "counters",
                ts: float | None = None) -> None:
        if self.enabled:
            self._events.append(("C", name, "counter", track,
                                 time.perf_counter() if ts is None else ts, None,
                                 {name: value}))

    def events(self) -> list[tuple]:
        return list(self._events)


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
