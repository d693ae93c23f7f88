"""Health-aware request router over N serving-engine replicas (port of
``serving/fleet/router.py``).

One engine serves one host; heavy traffic needs a FLEET. This module
is the layer above the engine: a router that spreads an arrival stream
over replicas using each replica's own health signals, and keeps every
accepted request alive through replica death. Replicas are in-process
objects here: on one card they share the model's weights and each owns
its KV pool, and every replica's dispatches launch K5 and K6 as a
single engine's do. A replica per process publishes the same health
snapshots over a store (``ServingEngine.enable_fleet_publish`` →
``telemetry.collect_fleet``, read by :func:`views_from_fleet_doc`), so
the policy inputs are identical either way.

Routing policy (:func:`choose_replica` — a PURE function over
:class:`ReplicaView` rows, unit-testable without an engine):

- only SERVING replicas are eligible: DEGRADED replicas receive
  nothing (they are recovering — new load resets their clean-step
  run), DRAINING/STOPPED/dead replicas are out of rotation. No
  eligible replica raises :class:`RequestRejected` with cause
  ``draining`` (every replica draining/stopped/dead) or ``degraded``
  (the survivors are all mid-recovery).
- **cache affinity** beats least-delay only when the prompt's prefix
  is actually resident: the replica whose prefix index already holds
  the longest prefix (``KVBlockPool.peek_prefix`` pricing, at least
  ``FLAGS_serving_fleet_affinity_min_tokens`` tokens) gets the
  request — the whole point of the prefix cache is that the
  resident replica serves it for a fraction of the prefill.
- **least estimated delay** otherwise: the replica with the smallest
  ``estimated_queue_delay_s`` (the admission estimator each
  replica publishes in ``health()``), ties broken by waiting-queue
  depth then replica id — a burst landing on a cold fleet therefore
  round-robins by queue depth instead of piling onto replica 0.

Requeue without loss: when a replica dies mid-request (an exception
escaping ``EngineReplica.step`` — the engine's own step-failure
recovery handles everything it can, so what escapes IS death), the
router freezes a flight-recorder postmortem naming the dead replica's
in-flight request ids, then re-admits each from its PROMPT onto a
surviving replica (policy ``reroute``). Re-admission builds a fresh
Sequence with the same sampling params and per-request seed, so the
replay re-derives the identical token stream — outputs stay
bit-identical to a fault-free run, the engine's replay invariant
lifted to fleet level.
Requests that cannot be placed immediately (the survivor is DEGRADED
or momentarily full) wait in a router-side backlog retried every
step.

Self-healing: constructed with an ``engine_factory`` (the same
callable a caller builds its replicas with), the router RESURRECTS
dead replicas instead of serving
short-handed forever. A death schedules a respawn after a capped
exponential backoff (``FLAGS_serving_fleet_respawn_*``); the fresh
replica enters a JOINING probation state — stepped in lockstep but
ineligible in ``choose_replica`` — until it completes
``FLAGS_serving_fleet_join_steps`` clean steps plus one readiness
probe (``ServingEngine.readiness_probe``: a scratch prefill+decode
round-trip that doubles as warm-up), then flips to SERVING
and rejoins rotation with a cold prefix index (affinity routing
re-warms it naturally). Losing EVERY replica parks the fleet rather
than raising: the backlog persists, deadline-carrying requests
expire terminally through the backlog-termination path, and the
first completed respawn heals the fleet — ``run()``/``drain()`` make
progress throughout. Only a fleet that can never heal (no factory,
or ``FLAGS_serving_fleet_respawn_max`` exhausted) still raises.

Hung replicas: a step that BLOCKS (instead of raising) would wedge
the lockstep loop, so with a step budget armed
(``FLAGS_serving_fleet_step_timeout_s``, derived from
``FLAGS_serving_hung_step_s`` when unset) each replica steps on its
own worker thread and the router collects results under the budget.
A step still running past it is abandoned on its thread and the
replica is marked dead with ``cause=hang`` (the chaos site
``serving.fleet.replica_hang`` + a ``sleep=`` rule proves it);
survivors keep stepping and the slot respawns like any other death.

Elasticity: ``enable_autoscale()`` arms a per-step control loop that
samples fleet-wide load (shed deltas, queued-token backlog, mean
SERVING occupancy) into a rolling window and asks the PURE policy in
:mod:`.autoscaler` (``decide``) whether to resize, under cooldown and
``FLAGS_serving_fleet_min/max_replicas`` bounds. Scale-UP is a respawn
with zero burned attempts (factory → JOINING probation → readiness
probe, so warm-up never lands in TTFT); scale-DOWN flips the
least-loaded replica to ``retiring`` — its engine enters DRAINING,
in-flight work runs to completion under the drain timeout, deadline
stragglers re-place on survivors through the reroute path (bitwise-
identical outputs), then the slot leaves the fleet. A retiring
replica that dies or hangs mid-drain goes through the NORMAL death
path but retires instead of respawning; a scale-down racing a pending
respawn cancels the respawn. Scale events ride the flight digest ring
(``src=fleet kind=scale_up|scale_down|scale_retire`` with the policy
input snapshot) and count into
``serving_fleet_scale_events_total{direction=}`` /
``serving_fleet_target_replicas``.

Disaggregation: replicas carry a ``role`` (``prefill`` / ``decode`` /
``both``, the default — see :mod:`.disagg`). With any role-split
replica present the router admits new work (and reroutes, which
replay from the prompt) onto prefill-capable replicas only
(``choose_replica(..., role=...)``), and a
:class:`~.disagg.HandoffCoordinator` runs after every step to move
first-token requests — paged KV blocks, sampler rng state and all —
onto decode-capable replicas through a write-ahead handoff ledger.
All-``both`` fleets never construct a coordinator and route
byte-identically to the pre-disaggregation router.

Routed counts land in ``serving_fleet_routed_total{policy=affinity|
least_delay|reroute}``; replica deaths in
``serving_fleet_deaths_total`` (hangs also in
``serving_fleet_hangs_total``), respawns in
``serving_fleet_respawns_total``, and the ``serving_fleet_live_
replicas`` / ``serving_fleet_joining_replicas`` gauges track the
heal.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from collections import deque, namedtuple

from ... import telemetry
from ...flags import flag_value
from ..kv_pool import PoolOOM
from .autoscaler import DOWN, UP, LoadWindow, decide as scale_decide
from ..robustness import (BOTH_ROLE, CANCELLED, DECODE_ROLE, DEGRADED,
                          DRAINING, EXPIRED, FAILED, JOINING,
                          PREFILL_ROLE, SERVING, STOPPED,
                          RequestRejected, fault_point, now_s)
from ..scheduler import FINISHED, Sequence

__all__ = [
    "AFFINITY", "LEAST_DELAY", "REROUTE", "ROUTE_POLICIES", "DEAD",
    "JOINING", "ReplicaHung",
    "ReplicaView", "RoutingDecision", "choose_replica",
    "view_from_health", "views_from_fleet_doc",
    "EngineReplica", "FleetRouter",
]

# routing policies (serving_fleet_routed_total{policy=})
AFFINITY = "affinity"
LEAST_DELAY = "least_delay"
REROUTE = "reroute"
ROUTE_POLICIES = (AFFINITY, LEAST_DELAY, REROUTE)

# a replica whose step raised out of the engine's own recovery — out
# of rotation (distinct from STOPPED: nobody drained it). With an
# engine_factory armed the slot respawns; the fresh replica passes
# through JOINING probation before it is eligible again
DEAD = "dead"


class ReplicaHung(RuntimeError):
    """A replica's step exceeded the fleet step budget and was
    abandoned on its worker thread — the replica is dead-by-hang."""

# everything the policy needs to know about one replica: lifecycle
# state, the admission queue-delay estimate, waiting depth, how many of
# THIS prompt's tokens its prefix cache already holds, slot occupancy
# (busy decode slots / max_slots — the autoscaler's forward-looking
# load signal), and the replica's ROLE in a disaggregated fleet
# (fleet/disagg.py; "both" = monolithic). Both trailing fields are
# defaulted so view literals predating elasticity / disaggregation
# keep constructing
ReplicaView = namedtuple(
    "ReplicaView",
    ("replica_id", "state", "est_delay_s", "waiting", "resident_tokens",
     "occupancy", "role"),
    defaults=(0.0, BOTH_ROLE))

RoutingDecision = namedtuple("RoutingDecision", ("replica_id", "policy"))


def choose_replica(views, *, min_affinity_tokens: int | None = None,
                   role: str | None = None) -> RoutingDecision:
    """The routing policy as a pure function: pick one replica from
    ``views`` (ReplicaView rows) or raise :class:`RequestRejected`.
    ``min_affinity_tokens`` overrides
    ``FLAGS_serving_fleet_affinity_min_tokens``. ``role`` restricts
    candidates to replicas serving that role (``both`` replicas
    always qualify — a monolithic fleet routes identically with or
    without the filter); affinity therefore only applies WITHIN the
    role. A fleet with SERVING capacity but none of it in-role
    raises a RETRYABLE ``degraded`` refusal, not a terminal one —
    the fleet exists, it just cannot take this phase yet."""
    views = list(views)
    if role is not None:
        in_role = [v for v in views if v.role in (role, BOTH_ROLE)]
        if not in_role and any(v.state == SERVING for v in views):
            raise RequestRejected(
                "degraded",
                f"no {role}-capable replica: the fleet is serving "
                f"but every replica in rotation carries another "
                f"role — retry when one joins")
        views = in_role
    eligible = [v for v in views if v.state == SERVING]
    if not eligible:
        states = {v.state for v in views}
        if states <= {DRAINING, STOPPED, DEAD}:
            raise RequestRejected(
                "draining",
                f"no serving replica: every replica is "
                f"draining/stopped/dead ({sorted(states) or 'none'})")
        # DEGRADED and JOINING both mean "healing, receives nothing":
        # a recovering survivor's clean-step run and a respawned
        # replica's probation are the same refusal from the caller's
        # point of view — the fleet exists but cannot take this yet
        raise RequestRejected(
            "degraded",
            f"no serving replica: the remaining replica(s) are "
            f"degraded/joining and receive nothing while they "
            f"recover (states: {sorted(states)})")
    if min_affinity_tokens is None:
        min_affinity_tokens = int(
            flag_value("serving_fleet_affinity_min_tokens"))
    min_affinity_tokens = max(1, int(min_affinity_tokens))
    best = max(v.resident_tokens for v in eligible)
    if best >= min_affinity_tokens:
        pool = [v for v in eligible if v.resident_tokens == best]
        pick = min(pool, key=lambda v: (v.est_delay_s, v.waiting,
                                        v.replica_id))
        return RoutingDecision(pick.replica_id, AFFINITY)
    pick = min(eligible, key=lambda v: (v.est_delay_s, v.waiting,
                                        v.replica_id))
    return RoutingDecision(pick.replica_id, LEAST_DELAY)


def view_from_health(replica_id, health: dict,
                     resident_tokens: int = 0) -> ReplicaView:
    """A ReplicaView from a published ``ServingEngine.health()``
    document (the ``serving`` section of a pushed snapshot).
    ``resident_tokens`` stays 0 unless the caller can peek the
    replica's prefix index (in-process replicas can; a cross-process
    router routes on health alone)."""
    return ReplicaView(
        int(replica_id), str(health.get("state", STOPPED)),
        float(health.get("estimated_queue_delay_s") or 0.0),
        int(health.get("waiting") or 0), int(resident_tokens),
        float(health.get("occupancy") or 0.0),
        str(health.get("role") or BOTH_ROLE))


def views_from_fleet_doc(doc: dict) -> list[ReplicaView]:
    """ReplicaViews from a ``telemetry.collect_fleet`` document's
    per-rank ``serving`` sections — the cross-process router input
    (absent ranks contribute nothing, exactly like dead replicas)."""
    serving = doc.get("serving") or {}
    return [view_from_health(r, h) for r, h in sorted(
        serving.items(), key=lambda kv: int(kv[0]))
        if isinstance(h, dict)]


class EngineReplica:
    """One engine plus its fleet identity. ``step()`` threads the
    ``serving.fleet.replica`` chaos site (FLAGS_fault_spec grammar:
    ``key=`` is the replica id, ``step=`` the engine step) BEFORE the
    engine runs, so an armed rule kills the replica from the router's
    point of view without the engine's own step-failure recovery ever
    seeing it — the deterministic stand-in for a replica process
    dying mid-request — then ``serving.fleet.replica_hang`` (same
    context; arm with ``sleep=S``) so a WEDGED step, not just a
    crashing one, is injectable. ``drain()`` threads
    ``serving.fleet.replica_drain`` the same way for drain-phase
    deaths.

    A replica built with ``joining=True`` (the router's respawn path)
    starts in probation: ``view()`` reports state JOINING — never
    routable — until the router promotes it after its clean-step run
    plus readiness probe."""

    __slots__ = ("replica_id", "engine", "role", "dead", "death_reason",
                 "joining", "join_clean_steps", "hung",
                 "retiring", "retire_deadline",
                 "_worker", "_req_q", "_res_q", "__weakref__")

    def __init__(self, replica_id: int, engine, *, joining: bool = False,
                 role: str = BOTH_ROLE):
        self.replica_id = int(replica_id)
        self.engine = engine
        # disaggregated serving (fleet/disagg.py): the role this slot
        # plays; stamped onto the engine so health() and the fleet
        # telemetry narrate it from either side
        self.role = str(role)
        engine.fleet_role = self.role
        self.dead = False
        self.death_reason: str | None = None
        self.joining = bool(joining)
        self.join_clean_steps = 0
        # scale-down in progress: the engine is DRAINING (admissions
        # shed, routing ineligible), in-flight work runs to completion
        # until retire_deadline, stragglers then re-place on survivors
        # and the slot leaves the fleet (_service_retirements)
        self.retiring = False
        self.retire_deadline = 0.0
        # set when a step blew the fleet budget: the worker thread
        # checks it after the step returns and discards the stale
        # result instead of handing it to a router that moved on
        self.hung = False
        self._worker: threading.Thread | None = None
        self._req_q: queue.SimpleQueue | None = None
        self._res_q: queue.SimpleQueue | None = None

    def view(self, prompt=None, *,
             resident_pool: bool = False) -> ReplicaView:
        if self.dead:
            return ReplicaView(self.replica_id, DEAD, 0.0, 0, 0,
                               role=self.role)
        if self.joining:
            # probation: visible, stepped, never routed to (its engine
            # may well say SERVING — the PROBATION is the router's)
            return ReplicaView(self.replica_id, JOINING, 0.0, 0, 0,
                               role=self.role)
        # routing_signals also carries pool-wide resident tokens (the
        # health parity test reads it there); the VIEW's residency is
        # prompt-prefix overlap, computed below only when it matters
        state, est_delay, waiting, occupancy, pool_resident = \
            self.engine.routing_signals()
        resident = 0
        if resident_pool:
            # scale-down victim selection: pool-WIDE resident context
            # tokens — the migration cost of retiring this replica.
            # Never fed to choose_replica (it would masquerade as
            # prompt-prefix affinity)
            resident = int(pool_resident)
        elif prompt is not None and state == SERVING:
            # the prefix-index walk is the expensive part of a view;
            # ineligible replicas never need it (the policy discards
            # their residency unread)
            resident = self.engine.pool.peek_prefix(list(prompt))
        return ReplicaView(self.replica_id, state, est_delay, waiting,
                           resident, occupancy, self.role)

    def step(self):
        fault_point("serving.fleet.replica", key=str(self.replica_id),
                    step=self.engine.metrics.steps)
        fault_point("serving.fleet.replica_hang",
                    key=str(self.replica_id),
                    step=self.engine.metrics.steps)
        return self.engine.step()

    def drain(self, deadline_s=None):
        fault_point("serving.fleet.replica_drain",
                    key=str(self.replica_id))
        return self.engine.drain(deadline_s)

    # -- budgeted calls (the fleet hung-replica watchdog) ------------------
    # Every engine-touching call the router makes on a replica's
    # behalf — step, readiness probe, drain — goes through the same
    # worker thread while a budget is armed: a wedged device must not
    # be able to hang the router from ANY of those entry points.
    def dispatch(self, fn) -> None:
        """Start one call on this replica's worker thread (created
        lazily; one thread per replica, only while a step budget is
        armed — the budget-less path calls inline and never spawns a
        thread)."""
        if self._worker is None or not self._worker.is_alive():
            # the queues are only REBOUND here, where the worker is
            # provably dead or never started (is_alive() guard above);
            # a live worker only ever sees one generation of its
            # SimpleQueues, and SimpleQueue itself is thread-safe
            self._req_q = queue.SimpleQueue()
            self._res_q = queue.SimpleQueue()
            # the thread holds the replica only while it runs a call: a
            # replica the router lets go of (dead, respawned, retired)
            # frees its engine, and the pool's device memory, at once,
            # and its idle thread ends
            self._worker = threading.Thread(
                target=_work_loop, daemon=True,
                args=(weakref.ref(self), self._req_q, self._res_q),
                name=f"fleet-replica-{self.replica_id}-step")
            weakref.finalize(self, self._req_q.put, None)
            self._worker.start()
        self._req_q.put(fn)

    def collect(self, timeout_s: float, what: str = "step"):
        """The monitor half: wait for the dispatched call's result up
        to ``timeout_s``. Returns the call's result, the exception it
        raised, or :class:`ReplicaHung` when the budget expired — the
        call is then ABANDONED on its thread (daemon; it discards its
        own result via ``self.hung`` if it ever returns) and the
        router marks the replica dead-by-hang."""
        try:
            _, payload = self._res_q.get(timeout=max(1e-3, timeout_s))
        except queue.Empty:
            # `hung` is a monotonic one-way latch (False -> True, never
            # back) with one writer (the router thread, here); the
            # worker only polls it to discard its stale result, and a
            # racy stale read merely delays that discard by one put
            self.hung = True
            return ReplicaHung(
                f"replica {self.replica_id} {what} exceeded its "
                f"{timeout_s:.3f}s fleet budget "
                f"(FLAGS_serving_fleet_step_timeout_s) — abandoning "
                f"it on its worker thread")
        return payload    # the call's result, or the exception it raised


def _work_loop(replica_ref, req_q, res_q) -> None:
    """A replica's worker thread: run each dispatched call and hand its
    result back, until the replica is gone (``None`` arrives when it is
    freed) or the router declared the running call hung."""
    while True:
        fn = req_q.get()
        if fn is None:
            return
        try:
            res = (True, fn())
        except BaseException as e:      # delivered, not swallowed:
            res = (False, e)            # the router re-raises it
        del fn
        replica = replica_ref()
        if replica is None or replica.hung:
            # the router already declared this call hung and moved on;
            # a late result must not land in a queue nobody will ever
            # read again
            return
        del replica
        res_q.put(res)
        del res


class _Routed:
    """Router-side record of one accepted request: enough to replay
    it from the prompt on another replica."""

    __slots__ = ("fleet_rid", "prompt", "kwargs", "arrival_s",
                 "created_s", "replica_id", "local_rid", "reroutes",
                 "lost_ctx")

    def __init__(self, fleet_rid, prompt, kwargs, arrival_s):
        self.fleet_rid = int(fleet_rid)
        self.prompt = list(prompt)
        self.kwargs = dict(kwargs)
        self.arrival_s = arrival_s
        self.created_s = now_s()    # deadline fallback when arrival_s
        self.replica_id = None      # was not back-dated by the caller
        self.local_rid = None
        self.reroutes = 0
        # context tokens the request had computed when it last lost
        # its replica (death or retirement straggler): the re-placed
        # Sequence is stamped with it so the replayed span books under
        # recompute_replay, not fresh goodput (_admit consumes it)
        self.lost_ctx = 0

    def deadline_passed(self, now: float) -> bool:
        """Whether this request's own deadline (seconds from arrival,
        the engine contract) has already passed — the backlog analog
        of the engine's expiry sweep."""
        deadline = self.kwargs.get("deadline_s")
        if deadline is None:
            return False
        arrival = (self.created_s if self.arrival_s is None
                   else float(self.arrival_s))
        return now >= arrival + float(deadline)


class FleetRouter:
    """Routes an arrival stream over N :class:`EngineReplica`\\ s and
    drives them in lockstep. API mirrors the engine: ``submit`` /
    ``step`` / ``run`` / ``drain`` / ``health``, with fleet-level
    request ids (a request keeps its id across reroutes).

    ``engine_factory`` (optional, a zero-arg callable returning a
    fresh ``ServingEngine`` — the same callable callers already build
    their replicas with) arms SELF-HEALING: dead replica slots are
    respawned with capped exponential backoff and rejoin rotation
    through JOINING probation. Without it the fleet serves
    short-handed and losing the last replica with work in flight
    raises (the pre-resurrection contract)."""

    def __init__(self, replicas, engine_factory=None, *,
                 handoff_store=None):
        self.replicas: dict[int, EngineReplica] = {}
        for r in replicas:
            if r.replica_id in self.replicas:
                raise ValueError(f"duplicate replica id {r.replica_id}")
            self.replicas[r.replica_id] = r
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")
        self.engine_factory = engine_factory
        # disaggregated serving (fleet/disagg.py): remember each
        # slot's role so a respawn rebuilds the SAME role (a dead
        # prefill slot must not come back as a both), and arm the
        # handoff coordinator when any replica is role-split. The
        # ledger rides ``handoff_store`` (set/delete) write-ahead
        # when one is attached, in-memory otherwise
        self._slot_roles: dict[int, str] = {
            r.replica_id: r.role for r in self.replicas.values()}
        self._disagg = None
        if any(r.role != BOTH_ROLE for r in self.replicas.values()):
            from .disagg import HandoffCoordinator
            self._disagg = HandoffCoordinator(self, handoff_store)
        # live migration (fleet/migrate.py): always armed — the
        # FLAGS_serving_fleet_migrate gate is checked at use time so an
        # A/B can flip it without rebuilding the fleet. Its ledger
        # journals under /serving/migrate/ on the same store
        from .migrate import MigrationCoordinator
        self._migrate = MigrationCoordinator(self, handoff_store)
        self.requests: dict[int, _Routed] = {}
        self.done: dict[int, object] = {}
        self.backlog: deque[_Routed] = deque()
        # requests terminated while in the backlog (deadline expiry,
        # impossible reroute, drain stragglers), awaiting delivery in
        # the next step()'s finished map (they never re-entered an
        # engine, so no engine can report them)
        self._terminal_pending: list[tuple[int, object]] = []
        self.routed = {p: 0 for p in ROUTE_POLICIES}
        self.rejected: dict[str, int] = {}
        # HISTORICAL death record (one entry per death, repeats
        # possible across die→respawn cycles); health() derives the
        # currently-dead set from the replica objects instead
        self.deaths: list[int] = []
        self.hangs = 0
        self.respawns = 0
        self._draining = False
        # replica_id -> monotonic due time of its pending respawn, and
        # replica_id -> attempts since its last successful rejoin (the
        # backoff exponent; reset when probation completes)
        self._respawn: dict[int, float] = {}
        self._respawn_attempts: dict[int, int] = {}
        self._by_local: dict[tuple[int, int], int] = {}
        self._next_rid = 0
        # elasticity (enable_autoscale arms the control loop; the
        # scale_up/scale_down mechanisms work without it)
        self._autoscale = False
        self._scale_window: LoadWindow | None = None
        self._last_scale_s = 0.0
        self._sheds_seen = 0
        # the scale-event timeline (dicts: direction/replica/reason/
        # t_s + the policy-input snapshot) — a ramp report reads it;
        # flight digests carry the same events
        self.scale_events: list[dict] = []
        # declare the fleet families up front so a healthy fleet's
        # snapshot still SHOWS the failure/heal channels at zero (the
        # declare_defaults idea, scoped to the router that owns them)
        telemetry.counter("serving_fleet_deaths_total")
        telemetry.counter("serving_fleet_hangs_total")
        telemetry.counter("serving_fleet_respawns_total")
        self._update_gauges()

    # -- placement ---------------------------------------------------------
    def _live(self) -> list[EngineReplica]:
        return [r for r in self.replicas.values() if not r.dead]

    def _joining(self) -> list[EngineReplica]:
        return [r for r in self.replicas.values()
                if not r.dead and r.joining]

    def _update_gauges(self) -> None:
        telemetry.gauge("serving_fleet_live_replicas").set(
            len(self._live()))
        telemetry.gauge("serving_fleet_joining_replicas").set(
            len(self._joining()))

    # -- resurrection ------------------------------------------------------
    def _schedule_respawn(self, replica_id: int) -> bool:
        """Arm a respawn for a dead slot after the capped exponential
        backoff. False when healing is impossible: no factory, the
        fleet is draining, or FLAGS_serving_fleet_respawn_max attempts
        burned since the slot last healed."""
        if self.engine_factory is None or self._draining:
            return False
        attempt = self._respawn_attempts.get(replica_id, 0)
        max_attempts = int(flag_value("serving_fleet_respawn_max"))
        if max_attempts > 0 and attempt >= max_attempts:
            from ...distributed.watchdog import report_degraded
            report_degraded(
                "serving.fleet.respawn_exhausted",
                RuntimeError(f"replica {replica_id} burned "
                             f"{attempt} respawn attempt(s) "
                             f"(FLAGS_serving_fleet_respawn_max="
                             f"{max_attempts}); giving the slot up"))
            return False
        self._respawn_attempts[replica_id] = attempt + 1
        base = float(flag_value("serving_fleet_respawn_backoff_s"))
        cap = float(flag_value("serving_fleet_respawn_backoff_max_s"))
        delay = min(max(0.0, base) * (2 ** attempt), max(0.0, cap))
        self._respawn[replica_id] = now_s() + delay
        return True

    def _service_respawns(self) -> None:
        """Build a fresh JOINING replica for every due respawn. A
        factory failure reschedules with grown backoff — the factory
        talks to real devices and may itself blip."""
        if not self._respawn:
            return
        now = now_s()
        for rid, due in sorted(self._respawn.items()):
            if now < due:
                continue
            del self._respawn[rid]
            try:
                engine = self.engine_factory()
            except Exception as e:
                from ...distributed.watchdog import report_degraded
                report_degraded("serving.fleet.respawn_factory", e)
                self._schedule_respawn(rid)
                continue
            self.replicas[rid] = EngineReplica(
                rid, engine, joining=True,
                role=self._slot_roles.get(rid, BOTH_ROLE))
            self.respawns += 1
            telemetry.counter("serving_fleet_respawns_total").inc()
            # respawn events ride the flight-recorder digest ring so a
            # postmortem shows the heal timeline next to the steps
            telemetry.record_flight_step(
                src="fleet", kind="respawn", replica=rid,
                attempt=self._respawn_attempts.get(rid, 0))
            self._update_gauges()

    def _note_replica_step(self, replica: EngineReplica) -> None:
        """JOINING probation accounting after one successful step:
        count the clean step, and at the threshold run the readiness
        probe — pass promotes to SERVING (and resets the slot's
        respawn backoff), fail is a death like any other (the slot
        respawns again with grown backoff)."""
        if not replica.joining:
            return
        replica.join_clean_steps += 1
        need = max(1, int(flag_value("serving_fleet_join_steps")))
        if replica.join_clean_steps < need:
            return
        if self._probe_replica(replica):
            replica.joining = False
            self._respawn_attempts.pop(replica.replica_id, None)
            telemetry.record_flight_step(
                src="fleet", kind="rejoin", replica=replica.replica_id,
                clean_steps=replica.join_clean_steps)
            self._update_gauges()
        else:
            self._on_replica_death(
                replica,
                RuntimeError(f"replica {replica.replica_id} failed its "
                             f"readiness probe after "
                             f"{replica.join_clean_steps} clean "
                             f"probation step(s)"),
                # a probe abandoned on the worker thread is a hang;
                # a probe that answered False is a failed probe
                cause="hang" if replica.hung else "probe")

    def _probe_replica(self, replica: EngineReplica) -> bool:
        """Run the readiness probe under the same budget discipline as
        steps: with a step budget armed it executes on the replica's
        worker thread — a probe against a wedged device is abandoned
        there (the replica dies by hang below, in the caller's probe-
        failed path) instead of hanging the whole router. The probe is
        a fresh engine's first dispatch, so it gets a generous multiple
        of the per-step budget."""
        timeout = self._step_timeout_s()
        if timeout <= 0.0:
            return replica.engine.readiness_probe()
        replica.dispatch(replica.engine.readiness_probe)
        res = replica.collect(8.0 * timeout, what="readiness probe")
        if isinstance(res, Exception):
            # ReplicaHung included: a hung/raising probe is a failed
            # probe — readiness_probe() itself reports-and-returns
            # False, so anything exceptional here is the budget or a
            # BaseException-grade failure
            return False
        if isinstance(res, BaseException):
            raise res
        return bool(res)

    def _step_timeout_s(self) -> float:
        """Effective per-replica step budget: the explicit flag, else
        8x the engine's own hung-step threshold (a fleet-level
        abandonment should be rarer and later than the engine's
        post-hoc detector), else 0 = unbudgeted inline stepping."""
        t = float(flag_value("serving_fleet_step_timeout_s"))
        if t > 0.0:
            return t
        hung = float(flag_value("serving_hung_step_s"))
        return 8.0 * hung if hung > 0.0 else 0.0

    # -- elasticity --------------------------------------------------------
    def enable_autoscale(self) -> None:
        """Arm the load-driven control loop: every step samples
        fleet-wide load into a :class:`LoadWindow` and (outside the
        cooldown) asks :func:`autoscaler.decide` whether to grow or
        shrink the fleet. Scale-UP rides the respawn path (factory →
        JOINING probation → readiness probe), scale-DOWN the
        drain-and-retire path — both already proven against deaths
        and hangs, which is exactly why the autoscaler drives them
        instead of owning replicas itself."""
        if self.engine_factory is None:
            raise ValueError(
                "autoscaling needs an engine_factory: scale-up builds "
                "replicas with it (the same callable that arms "
                "self-healing)")
        self._autoscale = True
        self._scale_window = LoadWindow()
        # declare the elasticity families up front so a fleet that
        # never resizes still SHOWS the channels at zero
        for direction in (UP, DOWN):
            telemetry.counter("serving_fleet_scale_events_total",
                              labels={"direction": direction})
        telemetry.gauge("serving_fleet_target_replicas").set(
            self._target_replicas())

    def _target_replicas(self) -> int:
        """The replica count the fleet is currently steering toward:
        live non-retiring slots plus scheduled respawns."""
        return (len([r for r in self._live() if not r.retiring])
                + len(self._respawn))

    def _maybe_autoscale(self) -> None:
        """One control-loop tick (called every step): sample load,
        then — outside the cooldown — act on the policy's verdict.
        Sampling NEVER pauses, so the first post-cooldown decision
        sees a full window, not a cold restart."""
        if not self._autoscale or self._draining:
            return
        # resident_pool views: the policy's victim tie-break prefers
        # the replica with the fewest resident context tokens — the
        # cheapest migration (fleet/migrate.py) — before load order
        views = [r.view(resident_pool=True)
                 for r in self.replicas.values() if not r.dead]
        serving = [v for v in views if v.state == SERVING]
        occ = (sum(v.occupancy for v in serving) / len(serving)
               if serving else 0.0)
        waiting = (sum(v.waiting for v in serving) / len(serving)
                   if serving else 0.0)
        total_sheds = sum(self.rejected.values())
        shed_delta = max(0, total_sheds - self._sheds_seen)
        self._sheds_seen = total_sheds
        backlog_tokens = sum(
            len(rr.prompt) + max(1, int(rr.kwargs.get(
                "max_new_tokens", 1))) for rr in self.backlog)
        self._scale_window.note(sheds=shed_delta,
                                backlog_tokens=backlog_tokens,
                                occupancy=occ, waiting=waiting)
        cooldown = max(0.0, float(
            flag_value("serving_fleet_scale_cooldown_s")))
        if now_s() - self._last_scale_s < cooldown:
            return
        d = scale_decide(views, backlog_tokens, self._scale_window,
                         pending=len(self._respawn))
        if d.direction == UP:
            self.scale_up(reason=d.reason, role=d.role)
        elif d.direction == DOWN:
            self.scale_down(d.replica_id, reason=d.reason)

    def scale_up(self, *, reason: str = "requested",
                 role: str | None = None) -> int | None:
        """Grow the fleet by one replica via the respawn path: the
        new slot enters ``_respawn`` due immediately, the next
        ``_service_respawns`` builds it JOINING, probation and the
        readiness probe gate rotation — warm-up never lands in
        a caller's TTFT. Returns the new slot id, or None when
        impossible (no factory, draining) or already at
        ``FLAGS_serving_fleet_max_replicas`` capacity."""
        if self.engine_factory is None or self._draining:
            return None
        if self._target_replicas() >= max(
                1, int(flag_value("serving_fleet_max_replicas"))):
            return None
        rid = max(list(self.replicas) + list(self._respawn)) + 1
        # a role-split fleet grows the role the policy named (the
        # bottleneck role); monolithic fleets grow "both" as before
        if role is not None or self._disagg is not None:
            self._slot_roles[rid] = str(role) if role else BOTH_ROLE
        # due NOW with zero burned attempts: a scale-up is not a
        # failure recovery, so it starts at the backoff base — a
        # factory blip reschedules with grown backoff like any respawn
        self._respawn[rid] = now_s()
        self._note_scale(UP, rid, reason)
        self._update_gauges()
        return rid

    def scale_down(self, replica_id: int | None = None, *,
                   reason: str = "requested") -> bool:
        """Shrink the fleet by one replica, losslessly. The victim
        (least-loaded SERVING replica when not named) flips to
        ``retiring``: its engine enters DRAINING (admissions shed,
        ``choose_replica`` ineligible), in-flight requests run to
        completion under ``FLAGS_serving_drain_timeout_s``, deadline
        stragglers re-place on survivors through the reroute path
        (fresh Sequence + same seed ⇒ bitwise-identical output), and
        ``_service_retirements`` then removes the slot. A scale-down
        racing a PENDING respawn cancels the respawn instead — unbuilt
        capacity is the cheapest retirement. Refuses (False) rather
        than retire below ``FLAGS_serving_fleet_min_replicas``."""
        if self._draining:
            return False
        min_replicas = max(1, int(
            flag_value("serving_fleet_min_replicas")))
        serving = [r for r in self._live()
                   if not r.joining and not r.retiring
                   and r.engine.lifecycle.state == SERVING]
        if replica_id is None and self._respawn \
                and len(serving) >= min_replicas:
            rid = max(self._respawn)
            del self._respawn[rid]
            self._respawn_attempts.pop(rid, None)
            placeholder = self.replicas.get(rid)
            if placeholder is not None and placeholder.dead:
                # the cancelled respawn was healing a dead slot: the
                # slot is now retired, not a ghost awaiting a heal
                # that will never come
                del self.replicas[rid]
            self._note_scale(DOWN, rid, f"{reason} (cancelled pending "
                             f"respawn)", cancelled_respawn=True)
            self._update_gauges()
            return True
        if len(serving) <= min_replicas:
            # the floor re-checked at EXECUTION time: the policy
            # decided on a snapshot, and a death may have landed since
            return False
        if replica_id is None:
            candidates = [r for r in serving
                          if self._role_coverage_ok(r)]
            if not candidates:
                # every retirement would strand a role (the last
                # prefill or last decode-capable replica) — refuse
                return False
            victim = min(
                candidates,
                key=lambda r: ((v := r.view(resident_pool=True))
                               .resident_tokens, v.occupancy,
                               v.waiting, v.est_delay_s,
                               -r.replica_id))
        else:
            victim = self.replicas.get(int(replica_id))
            if (victim is None or victim.dead or victim.joining
                    or victim.retiring
                    or victim.engine.lifecycle.state != SERVING
                    or not self._role_coverage_ok(victim)):
                return False
        victim.retiring = True
        victim.retire_deadline = now_s() + float(
            flag_value("serving_drain_timeout_s"))
        # DRAINING stops admissions at the engine AND makes the view
        # ineligible in choose_replica — from this instant the victim
        # only finishes what it already holds
        victim.engine.lifecycle.to(DRAINING)
        self._note_scale(DOWN, victim.replica_id, reason)
        return True

    def _role_coverage_ok(self, victim: EngineReplica) -> bool:
        """Whether retiring ``victim`` keeps at least one routable
        prefill-capable AND one decode-capable replica. Always True
        in a monolithic fleet (no coordinator armed) — the
        min_replicas floor is the only guard there; a role-split
        fleet must additionally never retire the last SERVING
        replica of a role (fleet/disagg.py)."""
        if self._disagg is None:
            return True
        survivors = [r for r in self._live()
                     if not r.joining and not r.retiring
                     and r.replica_id != victim.replica_id
                     and r.engine.lifecycle.state == SERVING]
        return all(
            any(r.role in (role, BOTH_ROLE) for r in survivors)
            for role in (PREFILL_ROLE, DECODE_ROLE))

    def _service_retirements(self) -> None:
        """Walk retiring replicas out of the fleet: one still running
        its in-flight work inside its retire deadline keeps stepping
        (the step loop steps it because it has work); one that is
        empty — or out of deadline budget — re-places any stragglers
        on survivors through the reroute path and leaves. A retiring
        replica that DIES mid-drain never reaches here: the death
        path re-places its orphans and retires the slot itself."""
        if self._draining:
            return
        for replica in list(self.replicas.values()):
            if replica.dead or not replica.retiring:
                continue
            mapped = [(frid, rr) for frid, rr in self.requests.items()
                      if rr.replica_id == replica.replica_id
                      and frid not in self.done]
            if (mapped and replica.engine.has_work()
                    and now_s() < replica.retire_deadline):
                continue
            if mapped:
                # live migration first: stragglers move to survivors
                # WITH their KV, rng and clocks — zero recompute
                # (fleet/migrate.py; a no-op with the flag off or no
                # SERVING peer). Whatever could not move falls through
                # to the prompt-replay requeue below
                self._migrate.evacuate(replica, reason="scale_retire")
                if replica.dead:
                    # the migration's chaos site killed the source:
                    # the death path already requeued and retired
                    continue
                mapped = [(frid, rr)
                          for frid, rr in self.requests.items()
                          if rr.replica_id == replica.replica_id
                          and frid not in self.done]
            replaced = []
            for frid, rr in mapped:
                try:
                    seq = replica.engine.requests.get(rr.local_rid)
                    rr.lost_ctx = int(seq.ctx)
                except Exception:
                    # mid-teardown structures: charge the whole prompt
                    rr.lost_ctx = len(rr.prompt)
                try:
                    # settle the abandoned partial on the engine that
                    # computed it (books under expired_partial, frees
                    # the blocks): the retiring engine must leave the
                    # fleet with its token-ledger kinds summing to
                    # tokens_computed — the replay's recompute bill is
                    # booked on the DESTINATION via lost_ctx
                    replica.engine.cancel(rr.local_rid)
                except Exception:
                    # best-effort settle: a seq that raced to terminal (or a
                    # torn-down request table) is already booked; the
                    # requeue below must proceed regardless
                    pass
                self._by_local.pop(
                    (replica.replica_id, rr.local_rid), None)
                rr.replica_id = rr.local_rid = None
                rr.reroutes += 1
                self.backlog.append(rr)
                replaced.append(frid)
            self._retire_slot(replica, replaced)

    def _retire_slot(self, replica: EngineReplica,
                     replaced_rids) -> None:
        """Remove a retiring replica's slot from the fleet and leave
        the audit trail: the ``scale_retire`` flight event names the
        fleet rids that had to re-place (empty for a fully graceful
        drain) — the postmortem answer to 'where did the retiring
        replica's work go'."""
        rid = replica.replica_id
        self.replicas.pop(rid, None)
        telemetry.record_flight_step(
            src="fleet", kind="scale_retire", replica=rid,
            replaced=sorted(replaced_rids))
        self._update_gauges()
        if self._autoscale:
            telemetry.gauge("serving_fleet_target_replicas").set(
                self._target_replicas())

    def _note_scale(self, direction: str, replica_id: int,
                    reason: str, **extra) -> None:
        """Account one scale event everywhere at once: the cooldown
        clock, the window reset (each decision is judged on evidence
        gathered AFTER the previous one took effect), the timeline,
        the telemetry counter/gauge, and a flight-ring digest carrying
        the policy's input snapshot."""
        self._last_scale_s = now_s()
        snap = (self._scale_window.snapshot()
                if self._scale_window is not None else {})
        if self._scale_window is not None:
            self._scale_window.clear()
        event = {"direction": direction, "replica": int(replica_id),
                 "reason": reason, "t_s": now_s(), **extra, **snap}
        self.scale_events.append(event)
        telemetry.counter("serving_fleet_scale_events_total",
                          labels={"direction": direction}).inc()
        telemetry.record_flight_step(
            src="fleet", kind=f"scale_{direction}",
            replica=int(replica_id), reason=reason, **extra, **snap)
        if self._autoscale:
            telemetry.gauge("serving_fleet_target_replicas").set(
                self._target_replicas())

    def submit(self, prompt, *, arrival_s=None, **kwargs) -> int:
        """Route and admit one request; returns its FLEET id (stable
        across reroutes). Raises :class:`RequestRejected` when no
        replica can take it — router-level refusals (no SERVING
        replica) carry cause ``draining``/``degraded``, engine-level
        sheds keep their own cause."""
        if hasattr(prompt, "tolist"):       # a numpy array or a tensor
            prompt = prompt.tolist()
        rr = _Routed(self._next_rid, list(prompt), kwargs, arrival_s)
        placed = self._admit(rr, raise_on_reject=True)
        assert placed          # raise_on_reject never returns False
        self._next_rid += 1
        self.requests[rr.fleet_rid] = rr
        return rr.fleet_rid

    def _admit(self, rr: _Routed, *, reroute: bool = False,
               raise_on_reject: bool = False) -> bool:
        """Pick a replica and admit ``rr``; on an engine-level shed,
        fall through to the next candidate. False (requeue mode) or
        raise (submit mode) when nobody takes it."""
        tried: set[int] = set()
        last_shed = None
        while True:
            views = [r.view(rr.prompt) for r in self._live()
                     if r.replica_id not in tried]
            try:
                if not views and self._respawn and not self._draining:
                    # every replica is dead but a respawn is pending:
                    # the pure policy would say "draining" (a terminal
                    # verdict) over an empty view list, but this fleet
                    # is PARKED and healing — tell the caller to retry
                    raise RequestRejected(
                        "degraded",
                        f"no live replica, but {len(self._respawn)} "
                        f"respawn(s) are pending — the fleet is "
                        f"parked and healing; retry shortly")
                # a role-split fleet admits NEW work (and reroutes —
                # a replay starts from the prompt, i.e. at prefill)
                # onto prefill-capable replicas only; the handoff
                # coordinator moves it to a decode replica after its
                # first token. Monolithic fleets route as before
                decision = choose_replica(
                    views, role=(PREFILL_ROLE if self._disagg is not None
                                 else None))
            except RequestRejected as e:
                if not raise_on_reject:
                    return False
                # every eligible replica shed it (last_shed) or none
                # was eligible at all (e) — either way the FLEET
                # refused this request: count it here, where both
                # paths converge
                refusal = last_shed if last_shed is not None else e
                self.rejected[refusal.cause] = \
                    self.rejected.get(refusal.cause, 0) + 1
                telemetry.counter("serving_fleet_rejected_total",
                                  labels={"cause": refusal.cause}).inc()
                raise refusal
            replica = self.replicas[decision.replica_id]
            try:
                # arrival is ALWAYS anchored at the original submit
                # (caller back-date, else created_s): a reroute that
                # passed arrival_s=None would let the new engine grant
                # the request a fresh full deadline budget — silently
                # doubling the caller's SLO
                local = replica.engine.add_request(
                    list(rr.prompt),
                    arrival_s=(rr.created_s if rr.arrival_s is None
                               else rr.arrival_s),
                    **rr.kwargs)
            except PoolOOM:
                # the request can never fit ANY replica's pool (the
                # replicas share one engine config) — not a routing
                # problem, surface it like the engine would
                raise
            except RequestRejected as e:
                if e.cause == "max_context":
                    raise               # identically impossible everywhere
                last_shed = e
                tried.add(decision.replica_id)
                continue
            rr.replica_id = decision.replica_id
            rr.local_rid = local
            self._by_local[(rr.replica_id, local)] = rr.fleet_rid
            if reroute and rr.lost_ctx > 0:
                # the dead/retired replica had computed lost_ctx
                # context tokens this replay will recompute: stamp the
                # fresh Sequence's high water so on_tokens_computed
                # books the replayed span under recompute_replay, not
                # fresh goodput — even when the dead engine's state
                # was unreadable (lost_ctx then fell back to the
                # prompt length; attribution only, the kinds still
                # sum exactly to tokens_computed)
                seq = replica.engine.requests.get(local)
                if seq is not None:
                    seq.computed_hw = max(seq.computed_hw,
                                          int(rr.lost_ctx))
                    seq.rewind_cause = "retry"
                rr.lost_ctx = 0
            self._count_route(REROUTE if reroute else decision.policy)
            return True

    def _count_route(self, policy: str) -> None:
        self.routed[policy] = self.routed.get(policy, 0) + 1
        telemetry.counter("serving_fleet_routed_total",
                          labels={"policy": policy}).inc()

    def _place_backlog(self) -> None:
        if not self.backlog:
            return
        now = now_s()
        can_place = bool(self._live())
        still: deque[_Routed] = deque()
        while self.backlog:
            rr = self.backlog.popleft()
            if rr.deadline_passed(now):
                # the backlog analog of the engine's expiry sweep: a
                # rerouted request whose deadline budget is gone would
                # otherwise be re-shed (est_delay) by every replica
                # forever — run()/drain() would never terminate.
                # Finish it `expired`, like the engine would have.
                # This sweep runs even with ZERO live replicas: a
                # parked fleet still owes deadline-carrying requests
                # their terminal outcome
                self._terminate_backlogged(rr, EXPIRED)
                continue
            if not can_place:
                # whole-fleet loss is a PARKED state, not an error:
                # the backlog persists until the first respawn heals
                # the fleet (step() raises only when no heal can ever
                # come — see _assert_healable)
                still.append(rr)
                continue
            try:
                placed = self._admit(rr, reroute=True)
            except (PoolOOM, RequestRejected) as e:
                # only the IMPOSSIBLE causes escape _admit in requeue
                # mode (pool-capacity / max_context): with replicas
                # of heterogeneous configs, a request only the dead
                # replica could hold must fail ALONE — raising out of
                # step() would strand every other in-flight request
                from ...distributed.watchdog import report_degraded
                report_degraded("serving.fleet.reroute_impossible", e)
                self._terminate_backlogged(rr, FAILED)
                continue
            if not placed:
                still.append(rr)       # retried next step
        self.backlog = still

    def _terminate_backlogged(self, rr: _Routed, outcome: str) -> None:
        """Terminal outcome for a request that cannot leave the
        backlog — its deadline passed while it waited (``expired``),
        no surviving replica can ever hold it (``failed``), or the
        fleet drained out from under it (``cancelled``). No
        engine re-admitted it, so the router synthesizes the terminal
        Sequence itself (req_id is the FLEET id; any partial output
        died with the replica — replay starts from the prompt, so
        there is nothing salvageable to attach)."""
        seq = Sequence(rr.fleet_rid, rr.prompt,
                       max_new_tokens=max(
                           1, int(rr.kwargs.get("max_new_tokens", 1))),
                       arrival_s=(rr.created_s if rr.arrival_s is None
                                  else rr.arrival_s),
                       deadline_s=rr.kwargs.get("deadline_s"))
        seq.state = FINISHED
        seq.outcome = outcome
        seq.finish_reason = outcome
        seq.finish_s = now_s()
        self.done[rr.fleet_rid] = seq
        self._terminal_pending.append((rr.fleet_rid, seq))
        telemetry.counter("serving_terminal_total",
                          labels={"reason": outcome}).inc()

    # -- driving -----------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.backlog) or any(
            r.engine.has_work() for r in self._live())

    def step(self) -> dict[int, object]:
        """One fleet iteration: service due respawns, place any
        backlog, step every live replica (under the fleet step budget
        when one is armed), collect finishes (keyed by fleet id). A
        replica whose step raises — or blows the budget — is marked
        dead and its in-flight requests are requeued; a parked fleet
        (zero live replicas, backlog waiting on a respawn) sleeps
        briefly instead of spinning."""
        finished: dict[int, object] = {}
        self._service_respawns()
        # the control loop ticks BETWEEN respawn servicing and
        # retirement servicing: a scale-up's new slot spawns next
        # step, a scale-down's victim starts draining before this
        # step's placement runs (its re-placed stragglers, if the
        # deadline already passed, land in the backlog in time for
        # _place_backlog below)
        self._maybe_autoscale()
        self._service_retirements()
        # expire/terminate before judging healability: a backlog of
        # already-expired deadline requests empties in the sweep and
        # must not count as "work stranded forever"
        self._place_backlog()
        self._assert_healable()
        to_step: list[EngineReplica] = []
        for replica in list(self.replicas.values()):
            if replica.dead:
                continue
            degraded = replica.engine.lifecycle.state == DEGRADED
            if (not replica.engine.has_work() and not self.backlog
                    and not degraded and not replica.joining):
                # idle engines still step while a backlog waits, while
                # they are DEGRADED, or while they are JOINING:
                # recovery and probation both take clean steps, and an
                # idle all-DEGRADED fleet that never stepped would
                # reject traffic forever
                continue
            to_step.append(replica)
        for replica, outcome in self._step_replicas(to_step):
            if isinstance(outcome, ReplicaHung):
                self._on_replica_death(replica, outcome, cause="hang")
                continue
            if isinstance(outcome, Exception):   # escaped engine recovery
                self._on_replica_death(replica, outcome)
                continue
            if isinstance(outcome, BaseException):
                # SystemExit/KeyboardInterrupt from a budgeted worker
                # propagate exactly as the inline path would — they
                # are a process verdict, not a replica death
                raise outcome
            self._note_replica_step(replica)
            for seq in outcome:
                frid = self._by_local.pop(
                    (replica.replica_id, seq.req_id), None)
                if frid is not None:
                    self.done[frid] = seq
                    finished[frid] = seq
        if self._disagg is not None:
            # move every handoff-ready request (first token just
            # emitted on a prefill replica) to a decode replica NOW,
            # so its next fleet step decodes in its new home — the
            # monolithic cadence of one token per fleet step holds
            self._disagg.service()
        # proactive evacuation: a replica that slipped into DEGRADED
        # moves its in-flight sequences to SERVING peers before a
        # probable death turns them into prompt-replays
        self._migrate.service()
        self._place_backlog()
        for frid, seq in self._terminal_pending:
            finished[frid] = seq
        self._terminal_pending.clear()
        self._park_wait()
        return finished

    def _step_replicas(self, replicas):
        """Step each replica, inline (no budget) or through the
        per-replica worker threads (budget armed: all steps dispatch
        FIRST, then results collect under one shared deadline, so a
        hung replica costs the fleet at most one budget — not one
        budget per survivor behind it)."""
        out: list[tuple[EngineReplica, object]] = []
        timeout = self._step_timeout_s()
        if timeout <= 0.0:
            for replica in replicas:
                try:
                    out.append((replica, replica.step()))
                except Exception as e:
                    out.append((replica, e))
            return out
        for replica in replicas:
            replica.dispatch(replica.step)
        deadline = now_s() + timeout
        for replica in replicas:
            out.append((replica,
                        replica.collect(deadline - now_s())))
        return out

    def _assert_healable(self) -> None:
        """The one condition that still raises: work in flight, zero
        live replicas, and NO respawn ever coming (no factory, or the
        respawn budget burned). Everything else parks and heals."""
        if (self.backlog and not self._live() and not self._respawn
                and not self._draining):
            raise RuntimeError(
                f"fleet lost every replica with {len(self.backlog)} "
                f"request(s) still in flight and no respawn possible "
                f"(engine_factory "
                f"{'unset' if self.engine_factory is None else 'gave up'})")

    def _park_wait(self) -> None:
        """A parked fleet (nothing live, backlog waiting on a
        respawn) sleeps toward the next respawn due time instead of
        spinning run() hot — capped so deadline expiry sweeps stay
        responsive."""
        if self._live() or not self.backlog or not self._respawn:
            return
        due = min(self._respawn.values())
        wait = min(max(0.0, due - now_s()), 0.05)
        if wait > 0.0:
            time.sleep(wait)

    def run(self, max_steps: int | None = None) -> dict[int, object]:
        done: dict[int, object] = {}
        steps = 0
        while self.has_work():
            done.update(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return done

    def _on_replica_death(self, replica: EngineReplica, exc: Exception,
                          cause: str = "error") -> None:
        replica.dead = True
        replica.joining = False
        replica.death_reason = repr(exc)
        self.deaths.append(replica.replica_id)
        rid = replica.replica_id
        in_flight = [(frid, rr) for frid, rr in self.requests.items()
                     if rr.replica_id == rid and frid not in self.done]
        # disaggregated serving: abort the dead replica's pending
        # handoff-ledger entries and carry their fleet rids into the
        # postmortem — the write-ahead ledger is how an operator (and
        # the disagg drill) answers "which requests were MID-MOVE
        # when the prefill host died"; the requeue below re-prefills
        # them on survivors like any other orphan
        handoff_rids = (self._disagg.on_replica_death(rid)
                        if self._disagg is not None else [])
        # same for the live-migration ledger: a source dying with
        # moves in flight aborts them (the fallback is the normal
        # prompt-replay requeue below) and the dump names them
        migrate_rids = self._migrate.on_replica_death(rid)
        # capture how much context each orphan had computed BEFORE the
        # requeue forgets the mapping: the re-placed Sequence is
        # stamped with it so the replay books under recompute_replay.
        # A dead engine's structures may be mid-mutation (hang) or
        # gone — fall back to the prompt length rather than crash or
        # silently book the replay as fresh goodput
        for _, rr in in_flight:
            try:
                seq = replica.engine.requests.get(rr.local_rid)
                rr.lost_ctx = int(seq.ctx)
            except Exception:
                rr.lost_ctx = len(rr.prompt)
        from ...distributed.watchdog import report_degraded
        report_degraded("serving.fleet.replica_death", exc)
        telemetry.counter("serving_fleet_deaths_total").inc()
        if cause == "hang":
            self.hangs += 1
            telemetry.counter("serving_fleet_hangs_total").inc()
        self._update_gauges()
        if replica.retiring and self._live():
            # a retiring replica that dies (or hangs) mid-drain was
            # already LEAVING: its orphans re-place like any death,
            # but the slot retires instead of respawning — unless it
            # was the last live replica, where survival overrides
            # retirement and the normal respawn path runs
            respawning = False
        else:
            respawning = self._schedule_respawn(rid)
        # the dead replica's postmortem MUST name what it took down
        # with it — the rids the drill asserts on — and HOW it died
        # (cause=hang distinguishes a wedged step from a crashing one)
        telemetry.dump_flight(
            "replica_death", health=self.health(),
            extra={"replica": rid, "error": repr(exc), "cause": cause,
                   "retiring": replica.retiring,
                   "respawn_scheduled": respawning,
                   "in_flight_rids": sorted(rr.local_rid
                                            for _, rr in in_flight),
                   "fleet_rids": sorted(frid for frid, _ in in_flight),
                   "handoff_rids": handoff_rids,
                   "migrate_rids": migrate_rids})
        for frid, rr in in_flight:
            self._by_local.pop((rid, rr.local_rid), None)
            rr.replica_id = rr.local_rid = None
            rr.reroutes += 1
            self.backlog.append(rr)
        if replica.retiring and not respawning and self._live():
            self._retire_slot(replica,
                              [frid for frid, _ in in_flight])
        if self._live():
            self._place_backlog()
        elif self.backlog and not respawning and not self._respawn \
                and not self._draining:
            # no heal can ever come: the pre-resurrection loud failure
            raise RuntimeError(
                f"fleet lost every replica with {len(self.backlog)} "
                f"request(s) still in flight and no respawn possible "
                f"(engine_factory "
                f"{'unset' if self.engine_factory is None else 'gave up'})"
            ) from exc
        elif self.backlog:
            # whole-fleet loss with a heal pending: PARK — the backlog
            # persists, deadline expiry keeps sweeping, and the first
            # completed respawn picks the work back up
            report_degraded(
                "serving.fleet.parked",
                RuntimeError(f"zero live replicas with "
                             f"{len(self.backlog)} request(s) parked "
                             f"in the backlog awaiting respawn"))
        # the traceback holds the frames the exception passed through,
        # and the inline step loop's frame holds the exception: without
        # it the dead replica's engine, and its pool, are freed by
        # reference counting and not only by the cycle collector
        exc.__traceback__ = None

    # -- lifecycle ---------------------------------------------------------
    def drain(self, deadline_s: float | None = None) -> dict[int, object]:
        """Drain every live replica (the engine's graceful-shutdown
        contract) after driving any backlog home; returns everything
        that finished during the drain keyed by fleet id. The fleet
        lands with ``health()['state'] == 'stopped'``.

        Shutdown semantics under failure: pending respawns are
        cancelled (the fleet is going DOWN, not healing), but
        already-spawned JOINING replicas may still finish probation
        inside the drain window and absorb backlog. A replica whose
        own drain raises (the ``serving.fleet.replica_drain`` chaos
        site) is routed through the normal death path — its in-flight
        requests requeue onto survivors that have not drained yet —
        instead of aborting the fleet drain and stranding every other
        replica's stragglers. Whatever still cannot finish by the
        deadline leaves terminally: ``expired`` if its own deadline
        passed, else ``cancelled`` (the engine's drain-straggler
        contract). The whole fleet drain is bounded by ONE deadline
        (``FLAGS_serving_drain_timeout_s`` when None), not one per
        replica."""
        self._draining = True
        self._respawn.clear()
        if deadline_s is None:
            deadline_s = float(flag_value("serving_drain_timeout_s"))
        deadline = now_s() + float(deadline_s)
        out: dict[int, object] = {}
        while self.backlog and self._live() and now_s() < deadline:
            out.update(self.step())
        to_drain = list(self._live())
        while to_drain:
            # rerouted drain-phase orphans land on survivors still
            # SERVING (i.e. not yet drained) before each drain
            self._place_backlog()
            replica = to_drain.pop(0)
            if replica.dead:
                continue
            # drain consolidation (fleet/migrate.py): move this
            # replica's in-flight sequences to peers that have not
            # drained yet (still SERVING — drained peers are STOPPED
            # and ineligible) so it exits immediately and the work
            # keeps streaming with zero recompute; the last replica
            # has no peer and drains its own work as before
            self._migrate.evacuate(replica, reason="drain")
            if replica.dead:
                continue
            budget = self._step_timeout_s()
            remaining = max(0.01, deadline - now_s())
            try:
                if budget > 0.0:
                    # same watchdog discipline as steps: a wedged
                    # engine must not hang the fleet drain — the drain
                    # legitimately takes up to `remaining`, plus one
                    # step budget of margin for its final wedged step
                    replica.dispatch(
                        lambda r=replica, s=remaining: r.drain(s))
                    res = replica.collect(remaining + budget,
                                          what="drain")
                    if isinstance(res, ReplicaHung):
                        self._on_replica_death(replica, res,
                                               cause="hang")
                        continue
                    if isinstance(res, BaseException):
                        raise res
                    drained = res
                else:
                    drained = replica.drain(remaining)
            except Exception as e:
                self._on_replica_death(replica, e)
                continue
            for local, seq in drained.items():
                frid = self._by_local.pop(
                    (replica.replica_id, local), None)
                if frid is not None:
                    self.done[frid] = seq
                    out[frid] = seq
        now = now_s()
        while self.backlog:
            rr = self.backlog.popleft()
            self._terminate_backlogged(
                rr, EXPIRED if rr.deadline_passed(now) else CANCELLED)
        for frid, seq in self._terminal_pending:
            out[frid] = seq
        self._terminal_pending.clear()
        # the gauge tracks NOT-DEAD replicas (health()["live"]): a
        # graceful drain leaves them alive-but-stopped, so it must
        # not zero the gauge and fire "whole fleet dead" alerts
        self._update_gauges()
        return out

    def health(self) -> dict:
        """Fleet /healthz: per-replica engine health (dead replicas
        carry state ``dead`` + the death reason, JOINING replicas
        their probation progress), the aggregate state (best live
        state, ``stopped`` once nothing live remains), and the
        routing/requeue/heal counters. ``dead`` is the CURRENTLY-dead
        slot set — a healed fleet reports no ghosts — while
        ``deaths_total`` keeps the historical count (the
        die→respawn→rejoin ledger)."""
        reps: dict[str, dict] = {}
        live_states: list[str] = []
        cur_dead: list[int] = []
        for r in self.replicas.values():
            try:
                h = dict(r.engine.health())
            except Exception as e:
                # a hung replica's ABANDONED step keeps mutating its
                # engine on the worker thread; reading its health mid-
                # mutation may raise (e.g. deque mutated during
                # iteration). The fleet /healthz — and the death dump
                # taken at that exact moment — must degrade to a stub,
                # not crash the router
                h = {"state": STOPPED, "health_error": repr(e)}
            if r.dead:
                h["state"] = DEAD
                h["death_reason"] = r.death_reason
                cur_dead.append(r.replica_id)
            elif r.joining:
                h["state"] = JOINING
                h["join_clean_steps"] = r.join_clean_steps
                live_states.append(JOINING)
            else:
                live_states.append(h["state"])
            if r.retiring and not r.dead:
                h["retiring"] = True
            # the router's slot role is authoritative (the engine's
            # stamp mirrors it; a health_error stub has neither)
            h["role"] = r.role
            reps[str(r.replica_id)] = h
        state = STOPPED
        for cand in (SERVING, DEGRADED, JOINING, DRAINING):
            if cand in live_states:
                state = cand
                break
        # per-role LIVE replica counts (disaggregated serving; a
        # monolithic fleet reports everything under "both") and the
        # handoff-ledger counters when a coordinator is armed
        roles: dict[str, int] = {}
        for r in self._live():
            roles[r.role] = roles.get(r.role, 0) + 1
        doc_handoffs = (self._disagg.ledger.counts()
                        if self._disagg is not None else None)
        return {"state": state, "replicas": reps,
                "live": len(self._live()),
                "roles": roles,
                "handoffs": doc_handoffs,
                "migrations": self._migrate.ledger.counts(),
                "dead": sorted(cur_dead),
                "deaths_total": len(self.deaths),
                "hangs_total": self.hangs,
                "respawns_total": self.respawns,
                "joining": sorted(r.replica_id for r in self._joining()),
                "retiring": sorted(r.replica_id
                                   for r in self._live() if r.retiring),
                "scale_events": len(self.scale_events),
                "respawn_pending": {
                    str(rid): round(max(0.0, due - now_s()), 3)
                    for rid, due in sorted(self._respawn.items())},
                "backlog": len(self.backlog),
                "in_flight": len(self.requests) - len(self.done),
                "routed": dict(self.routed),
                "rejected": dict(self.rejected)}
