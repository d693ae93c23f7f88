"""Per-request lifecycle timelines (port of ``telemetry/requests.py``):
a bounded process-wide request log.

Aggregates answer "how is the engine doing"; this module answers "what
happened to request 17". Every serving request records a short ordered
event timeline (arrival, admitted, each prefill chunk, first token,
every retry, preemption or expiry, the terminal outcome, a handoff in or
out) twice: on the ``Sequence`` itself (bounded by
``FLAGS_telemetry_request_events_max``) and here, so the timeline
survives the Sequence leaving the engine and rides along in
``snapshot_doc()`` and the chrome trace's per-request rows.

Bounds:

- at most ``FLAGS_telemetry_requests_max`` timelines are kept, the
  oldest-started evicted first;
- each timeline holds at most ``FLAGS_telemetry_request_events_max``
  events. The FIRST events are kept and the final slot is reserved for
  the terminal event, so a timeline always tells how the request ended;
  what is squeezed out in between is counted in ``dropped``.

Pure stdlib. The recording call site (``serving/robustness.note_event``)
is gated on ``FLAGS_telemetry``: with it off nothing is retained here.

Event shape (plain JSON scalars only): ``{"t_s": <monotonic seconds>,
"kind": <str>, ...attrs}``; ``t_s`` is ``robustness.now_s`` time, the
clock of every serving deadline.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..flags import flag_value

__all__ = ["RequestLog", "request_log", "begin_request",
           "record_request_event", "snapshot_requests", "request_timeline",
           "reset_requests", "bounded_event_append",
           "format_request_timeline", "TERMINAL_EVENT"]

# the one event kind whose slot is always reserved (see module doc)
TERMINAL_EVENT = "terminal"


def bounded_event_append(events: list, ev: dict, cap: int,
                         final: bool = False) -> bool:
    """Append ``ev`` to ``events`` under the timeline bound. The first
    ``cap - 1`` events are kept verbatim; the last slot is reserved for
    the terminal event (``final=True``), which replaces whatever sits
    there if the timeline already overflowed. Returns False when the
    event was dropped instead (callers count it)."""
    cap = max(2, int(cap))
    if final:
        if len(events) >= cap:
            events[-1] = ev
        else:
            events.append(ev)
        return True
    if len(events) < cap - 1:
        events.append(ev)
        return True
    return False


class RequestLog:
    """Process-global bounded map of request id -> event timeline."""

    def __init__(self):
        self._lock = threading.Lock()
        # rid -> {"events": [...], "dropped": int}; insertion order is
        # begin() order, so popitem(last=False) evicts the oldest
        self._timelines: "OrderedDict[int, dict]" = OrderedDict()
        self.evicted = 0

    def begin(self, rid: int) -> None:
        """Open a fresh timeline for ``rid``. A new request with a
        reused id (a fresh engine in the same process) supersedes the
        old timeline rather than interleaving with it."""
        rid = int(rid)
        max_req = max(1, int(flag_value("telemetry_requests_max")))
        with self._lock:
            self._timelines.pop(rid, None)
            while len(self._timelines) >= max_req:
                self._timelines.popitem(last=False)
                self.evicted += 1
            self._timelines[rid] = {"events": [], "dropped": 0}

    def event(self, rid: int, ev: dict, final: bool = False) -> None:
        cap = int(flag_value("telemetry_request_events_max"))
        with self._lock:
            entry = self._timelines.get(int(rid))
            if entry is None:
                return                     # evicted or never begun
            if not bounded_event_append(entry["events"], ev, cap, final):
                entry["dropped"] += 1

    def timeline(self, rid: int) -> dict | None:
        with self._lock:
            entry = self._timelines.get(int(rid))
            if entry is None:
                return None
            return {"events": [dict(e) for e in entry["events"]],
                    "dropped": entry["dropped"]}

    def snapshot(self) -> dict:
        """{str(rid): {"events": [...], "dropped": n}} — string keys so
        the document survives a JSON round-trip unchanged."""
        with self._lock:
            return {str(rid): {"events": [dict(e) for e in ent["events"]],
                               "dropped": ent["dropped"]}
                    for rid, ent in self._timelines.items()}

    def reset(self) -> None:
        with self._lock:
            self._timelines.clear()
            self.evicted = 0


_LOG = RequestLog()


def request_log() -> RequestLog:
    return _LOG


def begin_request(rid: int) -> None:
    """Open a timeline (caller has already checked ``enabled()`` — the
    serving recording path guards once per event batch, not here, so a
    disabled run never takes the lock)."""
    _LOG.begin(rid)


def record_request_event(rid: int, ev: dict, final: bool = False) -> None:
    _LOG.event(rid, ev, final)


def snapshot_requests() -> dict:
    return _LOG.snapshot()


def request_timeline(rid: int) -> dict | None:
    return _LOG.timeline(rid)


def reset_requests() -> None:
    _LOG.reset()


def format_request_timeline(rid, entry: dict) -> str:
    """Textual timeline for one request. Times are shown relative to
    the first event, so the monotonic clock's origin never matters."""
    events = list((entry or {}).get("events", []))
    lines = [f"request {rid}: {len(events)} event(s), "
             f"{int((entry or {}).get('dropped', 0))} dropped"]
    if not events:
        return "\n".join(lines)
    t0 = float(events[0].get("t_s", 0.0))
    for ev in events:
        dt = float(ev.get("t_s", t0)) - t0
        attrs = {k: v for k, v in ev.items() if k not in ("t_s", "kind")}
        body = "  ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(f"  +{dt * 1000.0:10.3f} ms  "
                     f"{ev.get('kind', '?'):<14} {body}".rstrip())
    return "\n".join(lines)
