"""Serving robustness vocabulary (port of ``serving/robustness.py``:
the part the scheduler and engine need).

- Terminal reasons: every request leaves the engine with exactly one
  ``Sequence.outcome``. This slice produces only ``ok``; the others
  belong to deadlines, cancellation, shedding and quarantine, which
  port later.
- :func:`now_s` is the one wall-clock read of serving code.
- :func:`note_event` records a request's lifecycle events on its
  bounded ``Sequence.events`` timeline.
"""

from __future__ import annotations

import time

OK = "ok"
EXPIRED = "expired"
CANCELLED = "cancelled"
SHED = "shed"
FAILED = "failed"
TERMINAL_REASONS = (OK, EXPIRED, CANCELLED, SHED, FAILED)

# events kept per request; the terminal event always finds room
REQUEST_EVENTS_MAX = 64


def now_s() -> float:
    """The one sanctioned wall-clock read for serving code
    (``time.monotonic``: deadlines and step timers survive clock
    slews)."""
    return time.monotonic()


def note_event(seq, kind: str, **attrs) -> None:
    """Append one lifecycle event (arrival, prefill_chunk, first_token,
    preempted, terminal, ...) to ``seq.events``. The first
    ``REQUEST_EVENTS_MAX - 1`` events and the terminal one are kept;
    events in between are counted in ``seq.events_dropped``."""
    if kind == "terminal" or len(seq.events) < REQUEST_EVENTS_MAX - 1:
        seq.events.append({"t_s": attrs.pop("t_s", now_s()), "kind": kind,
                           **attrs})
    else:
        seq.events_dropped += 1
