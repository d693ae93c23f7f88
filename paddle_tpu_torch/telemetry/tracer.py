"""Host-side span tracer (port of ``telemetry/tracer.py``): a bounded
ring of timed spans.

Where the registry answers "how many / how fast on average", spans
answer "what was this thread doing at t". Each span carries name,
category, wall duration (``time.perf_counter_ns``), the recording
thread id and an optional step number, and exports as Chrome
``chrome://tracing`` "X" events (``exporters.chrome_trace``).

The ring is bounded (``FLAGS_telemetry_spans_max``, resized on the next
record after a ``set_flags``): a long-running job keeps the newest N
spans and counts the dropped ones. ``span()`` is a guarded no-op while
``FLAGS_telemetry`` is off: no timestamps taken, nothing retained.
Pure stdlib.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from ..flags import flag_value
from .registry import enabled, histogram

__all__ = ["SpanTracer", "tracer", "span", "timed", "record_span",
           "snapshot_spans", "drain_spans", "reset_spans"]


class SpanTracer:
    """Process-global bounded span ring."""

    def __init__(self, capacity: int | None = None):
        # remember the FLAG value separately from the ring capacity: a
        # later set_flags change resizes the ring on the next record,
        # while an explicit reset(capacity=N) (tests, tools) holds
        # until the flag actually changes again
        self._flag_cap = max(1, int(flag_value("telemetry_spans_max")))
        if capacity is None:
            capacity = self._flag_cap
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self.dropped = 0   # spans evicted by the ring bound

    def record(self, name: str, start_ns: int, end_ns: int, *,
               cat: str = "UserDefined", step: int | None = None,
               args: dict | None = None) -> None:
        ev = {
            "name": name,
            "ts": start_ns / 1e3,            # chrome trace microseconds
            "dur": max(0.0, (end_ns - start_ns) / 1e3),
            "cat": cat,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        extra = dict(args or {})
        if step is not None:
            extra["step"] = int(step)
        if extra:
            ev["args"] = extra
        cap = max(1, int(flag_value("telemetry_spans_max")))
        with self._lock:
            if cap != self._flag_cap:
                # the flag is settable at runtime (set_flags): honor a
                # resize on the next record, newest spans preserved
                self._flag_cap = cap
                self._ring = deque(self._ring, maxlen=cap)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def drain(self) -> list[dict]:
        with self._lock:
            out = [dict(ev) for ev in self._ring]
            self._ring.clear()
            return out

    def reset(self, capacity: int | None = None) -> None:
        flag_cap = max(1, int(flag_value("telemetry_spans_max")))
        if capacity is None:
            capacity = flag_cap
        with self._lock:
            self._flag_cap = flag_cap
            self._ring = deque(maxlen=max(1, int(capacity)))
            self.dropped = 0


_TRACER = SpanTracer()


def tracer() -> SpanTracer:
    return _TRACER


def record_span(name: str, start_ns: int, end_ns: int, *,
                cat: str = "UserDefined", step: int | None = None,
                args: dict | None = None) -> None:
    """Record an already-timed span (callers that own their clock, e.g.
    the comm watchdog). Guarded no-op while telemetry is off."""
    if not enabled():
        return
    _TRACER.record(name, start_ns, end_ns, cat=cat, step=step, args=args)


@contextlib.contextmanager
def span(name: str, *, cat: str = "UserDefined", step: int | None = None,
         **attrs):
    """Time the enclosed block into the span ring.

        with telemetry.span("serving/engine_step", step=n):
            ...

    Span names are LITERAL: dynamic context goes in ``step`` or
    keyword attrs, which land in the chrome event's ``args``.
    """
    if not enabled():
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        _TRACER.record(name, t0, time.perf_counter_ns(), cat=cat,
                       step=step, args=attrs or None)


@contextlib.contextmanager
def timed(name: str, metric: str, *, cat: str = "UserDefined",
          step: int | None = None, labels: dict | None = None):
    """span() + duration observed into histogram ``metric`` (seconds),
    with one clock read at each end."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        end = time.perf_counter_ns()
        _TRACER.record(name, t0, end, cat=cat, step=step)
        histogram(metric, labels).observe((end - t0) / 1e9)


def snapshot_spans() -> list[dict]:
    return _TRACER.snapshot()


def drain_spans() -> list[dict]:
    return _TRACER.drain()


def reset_spans(capacity: int | None = None) -> None:
    _TRACER.reset(capacity)
