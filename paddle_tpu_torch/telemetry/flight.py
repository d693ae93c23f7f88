"""Flight recorder (port of ``telemetry/flight.py``): a bounded ring of
per-step digests that dumps one self-contained JSON postmortem on
failure events.

Every engine step appends one small plain-JSON digest (plan shape,
occupancy, queue depth, duration, failed phases) to a bounded ring
(``FLAGS_telemetry_flight_steps``). On the events that end an interval
worth investigating (serving lifecycle DEGRADED entry, a step-failure
quarantine, a hung-step report, ``engine.drain()`` completing),
``dump()`` freezes ONE document: the digests, the caller's ``health()``,
the metrics snapshot, the recent spans and the per-request timelines.
With ``FLAGS_telemetry_flight_dir`` set the document is written
atomically to ``flight-NNN-<trigger>.json`` there; either way the newest
dump per trigger stays readable in memory
(``flight().dump_for(trigger)``).

Pure stdlib, bounded memory, and a guarded no-op while
``FLAGS_telemetry`` is off: no digests retained, no dumps written.
The document's schema name is the JAX package's, so either package's
tools read the other's dumps.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque

from ..flags import flag_value
from .registry import counter, enabled
from .registry import snapshot as metrics_snapshot
from .requests import snapshot_requests
from .tracer import snapshot_spans

__all__ = ["FlightRecorder", "flight", "record_flight_step",
           "dump_flight", "reset_flight", "format_flight"]

SCHEMA = "paddle_tpu.telemetry.flight/1"


class FlightRecorder:
    """Process-global bounded digest ring + dump-on-event machinery."""

    def __init__(self, capacity: int | None = None):
        # flag value remembered separately from the ring capacity so a
        # runtime set_flags resize is honored on the next record while
        # an explicit reset(capacity=N) holds until the flag changes —
        # the same live-resize contract as the span ring
        self._flag_cap = max(1, int(flag_value("telemetry_flight_steps")))
        if capacity is None:
            capacity = self._flag_cap
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self.dropped = 0              # digests evicted by the ring bound
        self.dumps = 0                # dump() calls that produced a doc
        self.last_dump: dict | None = None
        self.last_dump_path: str | None = None
        # newest dump per trigger: the trigger vocabulary is fixed and
        # tiny (degraded/quarantine/hung_step/drain), so this is bounded
        # by construction
        self._by_trigger: dict[str, dict] = {}

    def record(self, digest: dict) -> None:
        cap = max(1, int(flag_value("telemetry_flight_steps")))
        with self._lock:
            if cap != self._flag_cap:
                self._flag_cap = cap
                # a live shrink evicts the oldest digests exactly like
                # ring pressure does — they count as dropped too
                self.dropped += max(0, len(self._ring) - cap)
                self._ring = deque(self._ring, maxlen=cap)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(dict(digest))

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(d) for d in self._ring]

    def dump_for(self, trigger: str) -> dict | None:
        with self._lock:
            return self._by_trigger.get(trigger)

    def dump(self, trigger: str, health: dict | None = None,
             extra: dict | None = None) -> dict:
        """Freeze one postmortem document NOW. The caller supplies its
        own ``health()`` snapshot (the recorder is subsystem-agnostic);
        ``extra`` carries trigger context (quarantined rids, the error,
        drain counts). Returns the document; also writes it under
        ``FLAGS_telemetry_flight_dir`` when configured."""
        doc = {
            "schema": SCHEMA,
            "trigger": trigger,
            "pid": os.getpid(),
            "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            "health": health,
            "extra": extra,
            "digests": self.snapshot(),
            "metrics": metrics_snapshot(),
            "spans": snapshot_spans(),
            "requests": snapshot_requests(),
        }
        with self._lock:
            self.dumps += 1
            seq = self.dumps
            self.last_dump = doc
            self._by_trigger[trigger] = doc
        out_dir = str(flag_value("telemetry_flight_dir"))
        if out_dir:
            path = os.path.join(out_dir, f"flight-{seq:03d}-{trigger}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                os.makedirs(out_dir, exist_ok=True)
                with open(tmp, "w") as f:
                    # default=str for the same reason as the periodic
                    # exporter: health/extra values are caller-supplied
                    json.dump(doc, f, indent=1, default=str)
                os.replace(tmp, path)
                with self._lock:
                    self.last_dump_path = path
            except Exception as e:
                # a failed postmortem write (disk full, bad dir) must
                # never turn the failure being recorded into a crash
                from ..distributed.watchdog import report_degraded
                report_degraded("telemetry.flight.write", e)
        counter("telemetry_flight_dumps_total",
                labels={"trigger": trigger}).inc()
        return doc

    def reset(self, capacity: int | None = None) -> None:
        flag_cap = max(1, int(flag_value("telemetry_flight_steps")))
        if capacity is None:
            capacity = flag_cap
        with self._lock:
            self._flag_cap = flag_cap
            self._ring = deque(maxlen=max(1, int(capacity)))
            self.dropped = 0
            self.dumps = 0
            self.last_dump = None
            self.last_dump_path = None
            self._by_trigger.clear()


_FLIGHT = FlightRecorder()


def flight() -> FlightRecorder:
    return _FLIGHT


def record_flight_step(**digest) -> None:
    """Append one per-step digest (plain JSON scalars/lists only).
    Guarded no-op while telemetry is off."""
    if not enabled():
        return
    _FLIGHT.record(digest)


def dump_flight(trigger: str, health: dict | None = None,
                extra: dict | None = None) -> dict | None:
    """Auto-dump entry point for the failure hooks. Guarded no-op
    while telemetry is off (returns None)."""
    if not enabled():
        return None
    return _FLIGHT.dump(trigger, health=health, extra=extra)


def reset_flight(capacity: int | None = None) -> None:
    _FLIGHT.reset(capacity)


def format_flight(digests: list[dict]) -> str:
    """Textual digest table. The columns are the union of what the
    serving engine and the JAX package's resilient runner record; absent
    fields render blank."""
    lines = [f"{len(digests)} step digest(s)",
             f"{'step':>6} {'src':<6} {'pre':>4} {'dec':>4} {'preem':>5} "
             f"{'queue':>5} {'occ':>5} {'pool':>5} {'ms':>9}  failures"]
    for d in digests:
        dur = d.get("dur_s")
        occ = d.get("occupancy")
        pool = d.get("pool_util")
        fails = d.get("failures") or d.get("kind") or ""
        if isinstance(fails, (list, tuple)):
            fails = ",".join(str(f) for f in fails)
        if d.get("replica") is not None:
            # fleet heal events (kind=respawn/rejoin) carry the slot
            # they concern: a postmortem shows WHICH replica's timeline
            # this is
            fails = f"{fails} replica={d['replica']}".strip()
        lines.append(
            f"{d.get('step', ''):>6} {str(d.get('src', 'serve')):<6} "
            f"{d.get('prefill', ''):>4} {d.get('decode', ''):>4} "
            f"{d.get('preempted', ''):>5} {d.get('queue_depth', ''):>5} "
            f"{'' if occ is None else format(occ, '.2f'):>5} "
            f"{'' if pool is None else format(pool, '.2f'):>5} "
            f"{'' if dur is None else format(dur * 1e3, '.3f'):>9}  "
            f"{fails}".rstrip())
    return "\n".join(lines)
