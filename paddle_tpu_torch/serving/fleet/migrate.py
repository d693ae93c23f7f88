"""Live migration of in-flight requests: drain, retire and evacuate
with zero recompute (port of ``serving/fleet/migrate.py``).

Every planned disruption the fleet already survives — scale-down
retirement, graceful drain, a replica degrading — survives by
RE-ADMITTING in-flight requests from the PROMPT on a survivor and
recomputing everything (the router's reroute path). That is lossless
but wasteful: the replay burns goodput exactly when the fleet is under
stress. The primitives that make the waste unnecessary —
``KVBlockPool.export_seq``/``import_seq`` move a sequence's paged
blocks (partially-filled tail block included) and the write-ahead
:class:`~.disagg.HandoffLedger` journals the move on an optional store
— serve the one-shot prefill→decode handoff at first token. This
module generalizes that transaction to ANY in-flight sequence at any
depth:

- **mid-decode** (RUNNING, ``ctx == len(tokens) - 1``): the snapshot
  carries ``tokens = prompt + emitted-so-far`` and the destination
  re-admits it as the same 1-token chunk the disaggregated handoff
  uses — the next decode step runs bit-identically in the new home.
- **mid-prefill** (PREFILL at a chunk boundary — between engine steps
  every sequence IS at one): the snapshot carries ``ctx`` prompt
  tokens of KV and the destination simply continues chunked prefill
  from the boundary.
- sampler rng state, prefix pins, speculation degraded-flags and the
  ABSOLUTE deadline ride the engine's export/import verbatim, so a
  migrated request's remaining output is BITWISE-equal to the run
  that was never disturbed in f32 (the migration matrix of
  ``tests/test_torch_serving_fleet.py`` pins greedy,
  seeded-stochastic and prefix-hit sampling against the JAX fleet).

Transaction order (:meth:`MigrationCoordinator.migrate_one`), same
ledger discipline as the disaggregated handoff but under its own key
namespace (``/serving/migrate/<fleet_rid>``):

ledger.begin → chaos ``serving.fleet.migrate_export`` → export
(read-only) → chaos ``serving.fleet.migrate_import`` → import on dest
→ release on src → remap → ledger.commit.

The source keeps computing the request untouched until release, so a
death on EITHER side mid-transaction degrades to today's behavior,
never below it:

- the SOURCE dies at the export site → the router's death path aborts
  its pending migration entries (``fail_source`` — the death dump
  names them under ``migrate_rids``) and requeues its in-flight work;
  the request re-prefills on a survivor from the prompt, zero loss.
- the DESTINATION dies at the import site → the entry aborts, the
  source still owns the blocks and the request; if the source is
  retiring past its deadline the straggler falls back to the
  prompt-replay reroute — equal output either way.
- the destination merely REFUSES (pool full, draining) → abort, the
  request keeps running where it is; the next pass may retry.

Wired into the three planned-disruption paths by the router, all
gated on ``FLAGS_serving_fleet_migrate``:

a. scale-down retirement: ``_service_retirements`` migrates a
   retiring replica's deadline stragglers instead of re-placing them
   from the prompt.
b. ``FleetRouter.drain()``: before each replica's engine drain, its
   in-flight sequences consolidate onto peers that have not drained
   yet, so earlier replicas exit immediately and the work keeps
   streaming.
c. DEGRADED evacuation (:meth:`service`, each fleet step): a replica
   that slipped into DEGRADED gets its sequences moved to SERVING
   peers before a probable death turns them into prompt-replays.

Accounting: the source classifies the first-pass tokens it computed
under the ledger kind ``migrated`` at release
(``metrics.resolve_handoff(seq, fresh_kind=MIGRATED)``) — preserved
work, distinguishable from both ordinary goodput and replay — and the
kinds still sum exactly to ``tokens_computed`` on every engine.
Committed moves count into ``serving_fleet_migrations_total`` /
``serving_migrate_bytes_total`` and leave ``kind=migrate`` flight
digests naming rids, depth and byte counts.
"""

from __future__ import annotations

import weakref

from ... import telemetry
from ...flags import flag_value
from ..metrics import MIGRATED
from ..robustness import (DECODE_ROLE, DEGRADED, PREFILL_ROLE,
                          RequestRejected, fault_point)
from .disagg import HandoffLedger

__all__ = ["MigrationCoordinator", "MIGRATE_LEDGER_PREFIX"]

# the migration ledger journals under its own absolute-key namespace:
# failover replay and health counts stay per-subsystem (the disagg
# ledger's committed counts must not mix with migrations)
MIGRATE_LEDGER_PREFIX = "/serving/migrate/"


class MigrationCoordinator:
    """Drives live migrations for one
    :class:`~.router.FleetRouter`. Pure
    control plane over the engine/pool export-import API, one ledgered
    transaction per move (module docstring). The router owns WHEN to
    migrate (retirement, drain, degradation); this class owns HOW."""

    __slots__ = ("router", "ledger")

    def __init__(self, router, store=None):
        # held weakly, as the handoff coordinator holds it
        self.router = weakref.proxy(router)
        self.ledger = HandoffLedger(store,
                                    prefix=MIGRATE_LEDGER_PREFIX)
        # declare the families up front so a fleet that never migrates
        # still SHOWS the channels at zero
        telemetry.counter("serving_fleet_migrations_total")
        telemetry.counter("serving_migrate_bytes_total")

    @staticmethod
    def enabled() -> bool:
        return bool(flag_value("serving_fleet_migrate"))

    # -- disruption paths --------------------------------------------------
    def service(self) -> int:
        """One per-step pass: proactive evacuation of every DEGRADED
        replica's sequences onto SERVING peers (disruption path c).
        Retirement and drain call :meth:`evacuate` directly from
        their own sites."""
        if not self.enabled():
            return 0
        moved = 0
        for src in list(self.router.replicas.values()):
            if src.dead or src.joining or src.retiring:
                continue
            lifecycle = getattr(src.engine, "lifecycle", None)
            if getattr(lifecycle, "state", None) != DEGRADED:
                continue
            moved += self.evacuate(src, reason="degraded")
        return moved

    def evacuate(self, src, *, reason: str) -> int:
        """Move every migration-ready sequence off ``src``; returns
        how many committed. A source death mid-pass stops the walk
        (the death path already requeued everything it still held);
        per-sequence refusals (no peer, dest full) leave that
        sequence where it is — the caller's fallback path handles
        it."""
        if not self.enabled() or src.dead:
            return 0
        moved = 0
        for local_rid in list(src.engine.migrate_ready()):
            if src.dead:
                break
            if self.migrate_one(src, local_rid, reason=reason):
                moved += 1
        return moved

    # -- the transaction ---------------------------------------------------
    def migrate_one(self, src, local_rid: int, *,
                    reason: str) -> bool:
        """One ledgered move of ``src``'s ``local_rid`` to a SERVING
        peer. False when nothing moved — ledger backpressure, no
        eligible destination, a refusal, or a death on either side
        (each settling the ledger as the module docstring
        describes)."""
        router = self.router
        frid = router._by_local.get((src.replica_id, local_rid))
        rr = None if frid is None else router.requests.get(frid)
        if rr is None or frid in router.done:
            return False
        if self.ledger.full:
            # backpressure: the request keeps computing where it is
            return False
        dest = self._choose_dest(src, rr)
        if dest is None:
            return False
        self.ledger.begin(frid, src=src.replica_id,
                          dest=dest.replica_id, local_rid=local_rid)
        try:
            fault_point("serving.fleet.migrate_export",
                        key=str(src.replica_id),
                        step=src.engine.metrics.steps)
        except Exception as e:
            # the SOURCE died mid-migration: the death path aborts
            # this (and every) pending entry for the source
            # (``fail_source`` — the dump names them) and requeues its
            # in-flight work — the request re-prefills on a survivor
            # from the prompt, zero loss
            router._on_replica_death(src, e)
            return False
        try:
            state = src.engine.export_request(local_rid)
        except Exception as e:
            # export refused (the sequence slipped out of readiness) —
            # abort; the request is untouched where it is
            self.ledger.abort(frid, cause=repr(e))
            from ...distributed.watchdog import report_degraded
            report_degraded("serving.fleet.migrate_export", e)
            return False
        try:
            fault_point("serving.fleet.migrate_import",
                        key=str(dest.replica_id),
                        step=dest.engine.metrics.steps)
        except Exception as e:
            # the DESTINATION died mid-import: settle the ledger
            # first (the death dump must show it aborted), then run
            # the normal death path. The source never let go — the
            # request keeps computing there, or falls back to the
            # prompt-replay straggler path if the source is leaving
            self.ledger.abort(
                frid, cause=f"dest replica {dest.replica_id} died "
                            f"mid-import: {e!r}")
            router._on_replica_death(dest, e)
            return False
        try:
            new_local = dest.engine.import_request(state)
        except Exception as e:
            # dest refused (draining, pool full, geometry) — abort;
            # the source still owns the request
            self.ledger.abort(frid, cause=repr(e))
            from ...distributed.watchdog import report_degraded
            report_degraded("serving.fleet.migrate_import", e)
            return False
        src.engine.release_handoff(local_rid, dest=dest.replica_id,
                                   kind=MIGRATED)
        router._by_local.pop((src.replica_id, local_rid), None)
        rr.replica_id = dest.replica_id
        rr.local_rid = new_local
        router._by_local[(dest.replica_id, new_local)] = frid
        self.ledger.commit(frid, dest=dest.replica_id)
        telemetry.counter("serving_fleet_migrations_total").inc()
        telemetry.counter("serving_migrate_bytes_total").inc(
            state["kv"]["nbytes"])
        telemetry.record_flight_step(
            src="fleet", kind="migrate", fleet_rid=frid,
            from_replica=src.replica_id, to_replica=dest.replica_id,
            reason=reason, ctx=state["ctx"],
            tokens=len(state["output"]),
            kv_bytes=state["kv"]["nbytes"])
        return True

    def _choose_dest(self, src, rr):
        """Least-loaded SERVING peer able to take the move (the
        routing policy, source excluded — retiring/joining/degraded
        peers are ineligible through their view state). In a
        role-split fleet a sequence past its first token must land
        decode-capable, one still prefilling lands prefill-capable;
        monolithic fleets place role-free. None when no peer can take
        it right now."""
        from .router import choose_replica
        router = self.router
        views = [r.view(rr.prompt) for r in router.replicas.values()
                 if not r.dead and r.replica_id != src.replica_id]
        role = None
        if router._disagg is not None:
            seq = src.engine.requests.get(rr.local_rid)
            role = (DECODE_ROLE if seq is not None and seq.output
                    else PREFILL_ROLE)
        try:
            decision = choose_replica(views, role=role)
        except RequestRejected:
            return None
        return router.replicas[decision.replica_id]

    def on_replica_death(self, replica_id: int) -> list[int]:
        """Death hook: abort the dead source's pending migration
        entries and return the affected fleet rids (the router puts
        them in the death dump; its normal requeue does the
        re-prefill)."""
        return self.ledger.fail_source(replica_id)
