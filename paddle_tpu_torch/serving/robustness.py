"""SLO guardrails for the serving engine (port of
``serving/robustness.py``): deadlines, load shedding, step-failure
isolation and the engine lifecycle state machine.

- **Terminal reasons**: every request leaves the engine with exactly one
  ``Sequence.outcome`` of ``ok | expired | cancelled | shed | failed``
  (``finish_reason`` keeps the finer ``eos``/``length`` for ``ok``).
  ``shed`` never becomes a Sequence: it is refused at ``add_request``
  with :class:`RequestRejected`.
- **Deadlines and cancellation**: ``add_request(..., deadline_s=N)``
  arms a deadline N seconds from arrival (a back-dated ``arrival_s``
  counts); :func:`sweep_deadlines` finishes expired sequences with
  ``expired`` at the top of every step, waiting, mid-prefill or
  mid-decode. ``engine.cancel`` finishes one at once with ``cancelled``.
- **Bounded admission and shedding**: :class:`AdmissionController`
  refuses at ``add_request`` a full waiting queue
  (``FLAGS_serving_max_queue``) or an estimated queue delay (an EWMA of
  recent throughput against the queued token backlog) that already
  exceeds the request's deadline. A host-resident prefix prices between
  a device hit and a cold prompt (:meth:`AdmissionController.priced_tokens`).
- **Step-failure isolation**: :func:`handle_step_failure` quarantines
  only the sequences of the FAILING plan component: each gets
  ``FLAGS_serving_step_retries`` recompute replays (the scheduler's
  preemption-by-recompute rewind) before it finishes ``failed``; all
  others keep serving. A planning blip (an injected
  ``serving.pool_alloc`` fault) costs one empty step and is retried.
- **Lifecycle**: ``SERVING -> DEGRADED -> DRAINING -> STOPPED``
  (:class:`Lifecycle`). Step failures and hung steps mark the engine
  DEGRADED, and ``RECOVERY_CLEAN_STEPS`` clean steps bring it back;
  ``engine.drain()`` goes through DRAINING (no admissions, in-flight
  work runs out under a deadline, stragglers ``cancelled``) to STOPPED.
  The current state is exported as one-hot ``serving_health_state``
  telemetry gauges.
- **Fleet**: the roles (``PREFILL_ROLE``/``DECODE_ROLE``/``BOTH_ROLE``)
  and ``JOINING`` are the fleet's (``serving/fleet/``); its replicas
  thread the ``serving.fleet.*`` fault sites through
  :func:`fault_point` like the engine's.
- **Observability**: every lifecycle event of a request goes onto its
  bounded timeline and the process request log (:func:`note_event`), a
  quarantine, a first DEGRADED entry and a hung step each freeze one
  flight-recorder postmortem (:func:`dump_step_failure`,
  ``telemetry.dump_flight``), and every recoverable failure is reported
  through ``distributed/watchdog.report_degraded`` (logged once per site
  and exception type, counted each time in
  ``watchdog_degraded_total{site}``). All of it is a guarded no-op while
  ``FLAGS_telemetry`` is off, except the log line.

:func:`now_s` is the one wall-clock read of serving code.

Failure-recovery limit: the injection sites (``serving.prefill``,
``serving.decode``, ``serving.sample``, ``serving.pool_alloc``,
``serving.host_tier.restore``, ``serving.spec.propose``,
``serving.spec.verify``) all fire OUTSIDE the device step, so the pool
buffers are intact when recovery runs. The engine catches only the
reference's exception types at the reference's places. A real CUDA error
inside a step is sticky: the replay fails again, the retry budget turns
that into quarantine, and the engine must be drained and rebuilt; the
port does not pretend to recover from one.
"""

from __future__ import annotations

import time

from .. import telemetry
from ..distributed.fault import fault_point
from ..distributed.watchdog import report_degraded
from ..flags import flag_value

__all__ = [
    "OK", "EXPIRED", "CANCELLED", "SHED", "FAILED", "TERMINAL_REASONS",
    "SERVING", "DEGRADED", "DRAINING", "STOPPED", "ENGINE_STATES",
    "JOINING", "REPLICA_STATES",
    "PREFILL_ROLE", "DECODE_ROLE", "BOTH_ROLE", "ROLES",
    "RECOVERY_CLEAN_STEPS", "AdmissionController", "Lifecycle",
    "RequestRejected", "SampleFailures", "check_hung_step",
    "dump_step_failure", "fault_point", "handle_schedule_failure",
    "handle_step_failure", "note_event", "now_s", "sweep_deadlines",
]

# -- terminal reasons ---------------------------------------------------------
# every request leaves the engine with exactly one of these on
# Sequence.outcome (shed is counted in metrics only: a shed request is
# refused before a Sequence exists)
OK = "ok"
EXPIRED = "expired"
CANCELLED = "cancelled"
SHED = "shed"
FAILED = "failed"
TERMINAL_REASONS = (OK, EXPIRED, CANCELLED, SHED, FAILED)

# -- engine lifecycle states --------------------------------------------------
SERVING = "serving"
DEGRADED = "degraded"
DRAINING = "draining"
STOPPED = "stopped"
ENGINE_STATES = (SERVING, DEGRADED, DRAINING, STOPPED)

# a replica's probation state (serving/fleet/router.py); an engine is
# never JOINING
JOINING = "joining"
REPLICA_STATES = ENGINE_STATES + (JOINING,)

# -- replica roles (disaggregated prefill/decode serving) ---------------------
PREFILL_ROLE = "prefill"
DECODE_ROLE = "decode"
BOTH_ROLE = "both"
ROLES = (PREFILL_ROLE, DECODE_ROLE, BOTH_ROLE)

_ALLOWED_TRANSITIONS = {
    SERVING: (DEGRADED, DRAINING, STOPPED),
    DEGRADED: (SERVING, DRAINING, STOPPED),
    DRAINING: (STOPPED,),
    STOPPED: (),
}

# consecutive clean steps (no failure, no hung-step trip) before a
# DEGRADED engine reports SERVING again
RECOVERY_CLEAN_STEPS = 8


def now_s() -> float:
    """The one sanctioned wall-clock read for serving code
    (``time.monotonic``: deadlines, drain budgets and step timers
    survive clock slews)."""
    return time.monotonic()


def note_event(seq, kind: str, **attrs) -> None:
    """Record one lifecycle event (arrival, admitted, prefill_chunk,
    first_token, preempted, retry, quarantined, terminal, handoff_in,
    handoff_out, ...) on the Sequence's bounded timeline AND the process
    request log (``telemetry/requests.py``), so the timeline survives
    the Sequence leaving the engine. Both keep the first
    ``FLAGS_telemetry_request_events_max - 1`` events and the terminal
    one; ``seq.events_dropped`` counts the rest.

    A guarded no-op while ``FLAGS_telemetry`` is off: no clock read,
    nothing retained. ``t_s`` defaults to ``now_s()``; pass it to
    back-date (the arrival event uses the request's ``arrival_s``)."""
    if not telemetry.enabled():
        return
    ev = {"t_s": now_s(), "kind": kind}
    ev.update(attrs)
    cap = int(flag_value("telemetry_request_events_max"))
    final = kind == "terminal"
    if not telemetry.bounded_event_append(seq.events, ev, cap, final):
        seq.events_dropped += 1
    telemetry.record_request_event(seq.req_id, ev, final)


class SampleFailures(Exception):
    """Raised by the engine's emit loop when HOST-SIDE sampling failed
    for individual rows of an otherwise successful dispatch. Carries
    ``failures`` as (seq, exc) pairs so recovery blames exactly the
    failing rows: rows that already emitted keep their tokens and are
    never charged a retry."""

    def __init__(self, failures):
        super().__init__(f"{len(failures)} row(s) failed host-side "
                         f"sampling")
        self.failures = list(failures)


def _report_degraded(site: str, exc: Exception) -> None:
    """The serving paths' report of a recoverable failure, through
    ``distributed/watchdog.report_degraded``: logged once per (site,
    exception type), counted every time. Tests patch this function to
    count reports."""
    report_degraded(site, exc)


class RequestRejected(ValueError):
    """Admission refused: the request is SHED, never admitted.

    A ValueError, so callers that treated impossible requests as
    ValueError keep working; ``cause`` says why (``max_context`` /
    ``queue_full`` / ``est_delay`` / ``draining``) and ``reason`` is
    always the terminal reason ``shed``."""

    reason = SHED

    def __init__(self, cause: str, msg: str):
        super().__init__(msg)
        self.cause = cause


class Lifecycle:
    """SERVING -> DEGRADED -> DRAINING -> STOPPED, exported as one-hot
    ``serving_health_state`` gauges on every transition.

    DEGRADED is the only reversible state: step failures and hung steps
    enter it, ``RECOVERY_CLEAN_STEPS`` consecutive clean steps leave it.
    DRAINING and STOPPED are one-way: a draining engine never accepts
    work again (build a new engine instead)."""

    __slots__ = ("state", "since_s", "degraded_reason", "_clean_steps")

    def __init__(self):
        self.state = SERVING
        self.since_s = now_s()
        self.degraded_reason: str | None = None
        self._clean_steps = 0
        self._export()

    def to(self, new_state: str) -> None:
        """Transition, enforcing the state machine. Same-state is a
        no-op; an illegal edge is a caller bug and raises."""
        if new_state == self.state:
            return
        if new_state not in _ALLOWED_TRANSITIONS[self.state]:
            raise RuntimeError(
                f"illegal serving lifecycle transition "
                f"{self.state} -> {new_state}")
        self.state = new_state
        self.since_s = now_s()
        self._export()

    def mark_degraded(self, reason: str) -> bool:
        """A failure or hung step was observed: reset the clean-step run
        and (from SERVING) enter DEGRADED. DRAINING and STOPPED keep
        their state but still record the reason for ``health()``.
        Returns True when this call ENTERED the DEGRADED state."""
        self.degraded_reason = reason
        self._clean_steps = 0
        if self.state == SERVING:
            self.to(DEGRADED)
            return True
        return False

    def note_clean_step(self) -> None:
        if self.state != DEGRADED:
            return
        self._clean_steps += 1
        if self._clean_steps >= RECOVERY_CLEAN_STEPS:
            self.degraded_reason = None
            self.to(SERVING)

    def _export(self) -> None:
        # one-hot gauges over REPLICA_STATES, so {state="joining"}
        # always exists (0 for an engine)
        for s in REPLICA_STATES:
            telemetry.gauge("serving_health_state",
                            labels={"state": s}).set(
                                1.0 if s == self.state else 0.0)


class AdmissionController:
    """Bounded admission: queue cap + estimated-queue-delay shedding.

    The throughput estimate is an EWMA of tokens of model work per
    second over recent engine steps; the queued backlog is the exact
    token count the waiting queue still needs (remaining prefill +
    remaining decode). A cold controller (no sample yet) never
    delay-sheds: the first requests must be allowed to teach it."""

    _EWMA_ALPHA = 0.2

    __slots__ = ("_tok_per_s",)

    def __init__(self):
        self._tok_per_s = 0.0     # 0 = no sample yet

    def note_step(self, tokens: int, dur_s: float) -> None:
        if dur_s <= 0.0 or tokens <= 0:
            # an EMPTY step says nothing about throughput; idle ticks
            # would decay the estimate toward 0 and over-shed
            return
        rate = tokens / dur_s
        if self._tok_per_s <= 0.0:
            self._tok_per_s = rate
        else:
            a = self._EWMA_ALPHA
            self._tok_per_s = (1.0 - a) * self._tok_per_s + a * rate

    def seed(self, tok_per_s: float) -> None:
        """Prime a COLD estimator with a measured rate (the readiness
        probe's timed decode dispatch). A warmed estimator keeps its own
        samples: seeding never overwrites real step evidence."""
        if tok_per_s > 0.0 and self._tok_per_s <= 0.0:
            self._tok_per_s = float(tok_per_s)

    def backlog_tokens(self, scheduler) -> int:
        # a waiting sequence that acquired a cached prefix starts its
        # ctx past it, so a cache hit never inflates the estimate
        return sum((s.prefill_target - s.ctx)
                   + (s.max_new_tokens - len(s.output))
                   for s in scheduler.waiting)

    def estimated_delay_s(self, scheduler) -> float:
        """Seconds of already-queued work ahead of a new arrival; 0.0
        while the estimator is cold."""
        if self._tok_per_s <= 0.0:
            return 0.0
        return self.backlog_tokens(scheduler) / self._tok_per_s

    def priced_tokens(self, prompt_tokens: int, max_new: int,
                      dev_hit: int, host_hit: int = 0) -> float:
        """Admission price of a request in tokens of model work, tier
        aware: a device-resident prefix token is free (a refcount bump),
        a cold token costs 1.0 (prefill), and a HOST-resident token
        costs ``FLAGS_serving_host_tier_restore_frac`` (clamped to
        [0, 1]): the restore takes free blocks and copy bandwidth, so it
        prices strictly between the two. Feed the result to
        :meth:`check`'s ``own_tokens``."""
        frac = min(max(float(flag_value(
            "serving_host_tier_restore_frac")), 0.0), 1.0)
        cold = max(prompt_tokens - dev_hit - host_hit, 0)
        return cold + float(max_new) + host_hit * frac

    def check(self, metrics, scheduler, deadline_s,
              own_tokens: float = 0) -> None:
        """Shed (raise RequestRejected) or return. Called by
        ``add_request`` BEFORE a Sequence is created. ``own_tokens`` is
        the arrival's own remaining work (:meth:`priced_tokens`)."""
        max_queue = int(flag_value("serving_max_queue"))
        if max_queue > 0 and len(scheduler.waiting) >= max_queue:
            metrics.on_shed("queue_full")
            raise RequestRejected(
                "queue_full",
                f"waiting queue is full ({len(scheduler.waiting)} >= "
                f"FLAGS_serving_max_queue={max_queue}); shedding at "
                f"admission instead of growing the deque")
        if deadline_s is not None:
            est = self.estimated_delay_s(scheduler)
            if self._tok_per_s > 0.0 and own_tokens > 0:
                est += own_tokens / self._tok_per_s
            if est > float(deadline_s):
                metrics.on_shed("est_delay")
                raise RequestRejected(
                    "est_delay",
                    f"estimated queue delay {est:.3f}s already exceeds "
                    f"the request deadline {float(deadline_s):.3f}s: "
                    f"it would expire before its first token")


# -- per-step robustness hooks (called by ServingEngine.step) -----------------

def sweep_deadlines(engine, now: float, finished: list) -> None:
    """Finish every in-flight sequence whose deadline has passed with
    terminal reason ``expired``, waiting, mid-prefill and mid-decode
    alike (blocks freed; the caller gets the partial output)."""
    expired = [s for s in engine.requests.values()
               if s.deadline_s is not None and now >= s.deadline_s]
    for seq in expired:
        engine._finish_terminal(seq, EXPIRED, finished)


def dump_step_failure(engine, phase: str, error_repr: str,
                      quarantined: list, entered: bool) -> None:
    """One postmortem per failing plan component: a QUARANTINE (some
    sequence used up its retries) freezes a flight dump naming ALL the
    quarantined request ids; otherwise the first entry into DEGRADED
    freezes one for the degradation itself. Inert while telemetry is
    off."""
    if quarantined:
        telemetry.dump_flight(
            "quarantine", health=engine.health(),
            extra={"phase": phase, "quarantined": quarantined,
                   "error": error_repr})
    elif entered:
        telemetry.dump_flight(
            "degraded", health=engine.health(),
            extra={"phase": phase, "error": error_repr})


def handle_step_failure(engine, seqs, phase: str, exc: Exception,
                        finished: list, dump: bool = True):
    """Quarantine-or-replay for the sequences of a failing plan
    component (``phase`` is ``prefill`` or ``decode``; ``sample``
    failures surface through whichever phase was emitting).

    Each sequence gets ``FLAGS_serving_step_retries`` recompute attempts
    over its lifetime: within budget it re-enters the waiting queue
    through the scheduler's recompute replay, beyond it it finishes with
    terminal reason ``failed``. Sequences that already finished during
    the partial step keep their valid tokens.

    A caller that splits one component into per-row calls (the engine's
    ``SampleFailures`` path) passes ``dump=False`` and dumps once itself
    with the rows' request ids together. Returns ``(entered_degraded,
    quarantined_rids)`` for that."""
    _report_degraded(f"serving.step.{phase}", exc)
    engine.metrics.on_step_failure(phase)
    entered = engine.lifecycle.mark_degraded(f"step_failure:{phase}")
    allowed = int(flag_value("serving_step_retries"))
    quarantined: list[int] = []
    for seq in seqs:
        if seq.is_finished:
            continue
        seq.retries += 1
        if seq.retries > allowed:
            note_event(seq, "quarantined", phase=phase, retries=seq.retries)
            engine._finish_terminal(seq, FAILED, finished)
            quarantined.append(seq.req_id)
        else:
            note_event(seq, "retry", phase=phase, attempt=seq.retries)
            engine.scheduler.recompute(seq)
            # the rewind freed (and may reallocate) the sequence's
            # blocks: any draft-model K/V high-water for them is stale
            engine._spec_forget(seq)
    if dump:
        dump_step_failure(engine, phase, repr(exc), quarantined, entered)
    return entered, quarantined


def handle_schedule_failure(engine, exc: Exception) -> None:
    """A failure while PLANNING (an injected ``serving.pool_alloc``
    blip): no plan component exists to blame, so no sequence is charged
    a retry; the step yields nothing and planning runs again next step.
    Victims preempted while planning are back in the waiting queue."""
    _report_degraded("serving.schedule", exc)
    engine.metrics.on_step_failure("schedule")
    if engine.lifecycle.mark_degraded("schedule_failure"):
        telemetry.dump_flight(
            "degraded", health=engine.health(),
            extra={"phase": "schedule", "error": repr(exc)})


def check_hung_step(engine, dur_s: float) -> bool:
    """Hung-step detector, after the fact: a step longer than
    ``FLAGS_serving_hung_step_s`` (0 disables) is reported and marks the
    engine DEGRADED. Returns True when it tripped (the step is then not
    clean)."""
    thr = float(flag_value("serving_hung_step_s"))
    if thr <= 0.0 or dur_s < thr:
        return False
    engine.metrics.on_hung_step()
    _report_degraded(
        "serving.hung_step",
        RuntimeError(f"engine step took {dur_s:.4f}s (threshold "
                     f"{thr}s): device wedged or host starved"))
    # one dump per DEGRADED entry: a chronically slow engine trips the
    # detector every step, and a postmortem per step would add files and
    # host work to an engine already struggling
    if engine.lifecycle.mark_degraded("hung_step"):
        telemetry.dump_flight(
            "hung_step", health=engine.health(),
            extra={"dur_s": dur_s, "threshold_s": thr})
    return True
