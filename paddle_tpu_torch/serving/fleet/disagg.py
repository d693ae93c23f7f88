"""Disaggregated prefill/decode serving: role-split fleet with paged
KV-block handoff (port of ``serving/fleet/disagg.py``).

Prefill and decode are different machines wearing the same engine:
prefill is compute-bound (one long matmul-heavy pass over the prompt),
decode is weight-bandwidth-bound (one token per step, the whole model
streamed per token). A monolithic replica time-slices both and each
phase degrades the other — decode steps queue behind prefill chunks
(TTFT pressure becomes TPOT jitter), and the batch geometry that
saturates prefill starves decode. Disaggregation gives each phase its
own replicas: a request lands on a PREFILL-role replica, runs to its
first token there, and then MOVES — its paged KV blocks and sampler
state hand off to a DECODE-role replica that streams the rest.

This module is the layer that moves requests; everything it relies on
already exists in the port:

- roles (``robustness.PREFILL_ROLE/DECODE_ROLE/BOTH_ROLE``): every
  replica carries one, default ``both`` — a monolithic fleet is the
  degenerate case and stays byte-identical.
- the engine's handoff API (``ServingEngine.export_request`` /
  ``import_request`` / ``release_handoff``): a read-only snapshot of
  the request (params, output, clocks, the EXACT sampler rng state)
  plus the pool's block manifest (``KVBlockPool.export_seq`` /
  ``import_seq``: the block contents go through host memory, one
  gather and one copy per direction; a device-to-device copy between
  two pools on one card is a later step).
- an optional store (any object with ``set(key, bytes)`` and
  ``delete(key)``, such as the JAX package's HA store) as a WRITE-AHEAD
  handoff ledger: an entry is journaled under
  ``/serving/handoff/<fleet_rid>`` BEFORE the move is attempted and
  deleted when it commits or aborts, so a control-plane failover
  replays exactly the in-flight handoffs and a replica death names
  which requests were mid-move (the flight-recorder dump carries
  them).

Why the move is safe — the bitwise argument: a handoff only happens
at a RUNNING boundary, where ``ctx == len(tokens) - 1`` and the
newest token's KV has NOT been computed yet. The snapshot therefore
carries exactly the context the next step needs, and the destination
re-admits the sequence as a 1-token PREFILL chunk computing position
``ctx`` from ``tokens[-1]`` — the same inputs the source's next
decode step would have used (prefill/decode logits parity at equal
positions is what the recompute-replay drills already prove). The rng
state rides verbatim, so greedy, seeded-stochastic AND speculative
sampling continue bit-for-bit: a role-split fleet's outputs are
bitwise-equal to the monolithic fleet's in f32 (the parity tests pin
it; in bf16 a moved request's dispatch shapes differ, and its tokens
may round apart).

Failure story, in transaction order (``HandoffCoordinator.service``):
ledger.begin → chaos ``serving.fleet.handoff`` → choose dest →
export (read-only) → import on dest → release on src → remap →
ledger.commit. The source keeps serving the request untouched until
release, so:

- no eligible decode replica → nothing happens; the request keeps
  decoding on its prefill replica (a ``both``-grade fallback, not an
  error).
- import fails (dest pool full, dest draining) → ledger.abort; the
  request keeps decoding on its prefill replica.
- the SOURCE dies mid-handoff (the chaos site) → the router's death
  path fires, ``HandoffCoordinator.on_replica_death`` aborts the
  dead source's pending ledger entries and names them, and the
  normal requeue re-prefills the request on a survivor from its
  prompt — same seed, same tokens, zero loss.

Accounting stays exact across the split: the source classifies the
tokens it computed via ``metrics.resolve_handoff`` at release (its
goodput ledger sums still equal its ``tokens_computed``), the
destination counts only its own compute, arrival is counted once (on
the prefill engine) and terminal once (on the decode engine).
Handoffs land in ``serving_fleet_handoffs_total`` and the host-copied
bytes in ``serving_handoff_bytes_total``.
"""

from __future__ import annotations

import json
import weakref

from ... import telemetry
from ...flags import flag_value
from ..robustness import (BOTH_ROLE, DECODE_ROLE, PREFILL_ROLE, ROLES,
                          RequestRejected, fault_point)

__all__ = [
    "PREFILL_ROLE", "DECODE_ROLE", "BOTH_ROLE", "ROLES",
    "parse_roles", "HandoffLedger", "HandoffCoordinator",
    "LEDGER_PREFIX",
]

# absolute store keys ("/"-prefixed): an HA store journals absolute
# keys write-ahead and replays them across failovers — exactly the
# durability a mid-flight handoff record needs
LEDGER_PREFIX = "/serving/handoff/"


def parse_roles(spec: str | None = None) -> list[str]:
    """``'P:D'`` replica-count spec -> per-replica role list, e.g.
    ``'2:1'`` -> ``[prefill, prefill, decode]``. ``None`` falls back
    to ``FLAGS_serving_fleet_roles``; the empty spec (that flag's
    default) returns ``[]`` — caller keeps every replica ``both``,
    the monolithic fleet."""
    if spec is None:
        spec = str(flag_value("serving_fleet_roles"))
    spec = (spec or "").strip()
    if not spec:
        return []
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(
            f"role spec must be 'P:D' (prefill:decode replica "
            f"counts), got {spec!r}")
    try:
        n_prefill, n_decode = (int(p) for p in parts)
    except ValueError:
        raise ValueError(f"role spec counts must be integers, "
                         f"got {spec!r}") from None
    if n_prefill < 1 or n_decode < 1:
        raise ValueError(
            f"a disaggregated fleet needs at least one prefill AND "
            f"one decode replica, got {spec!r}")
    return [PREFILL_ROLE] * n_prefill + [DECODE_ROLE] * n_decode


class HandoffLedger:
    """Write-ahead record of in-flight handoffs. ``begin`` journals
    the entry (to the store when one is attached — absolute key, so
    an HA store write-ahead-journals it and failover replays it),
    ``commit``/``abort`` retire it. ``fail_source`` is the death
    hook: it aborts every pending entry whose SOURCE replica died and
    returns their fleet rids, so the death dump can name exactly
    which requests were mid-move (the reroute itself is the router's
    normal requeue — the ledger's job is naming, durability and
    backpressure, not placement)."""

    __slots__ = ("store", "max_entries", "prefix", "pending",
                 "begun", "committed", "aborted")

    def __init__(self, store=None, *, max_entries: int | None = None,
                 prefix: str = LEDGER_PREFIX):
        self.store = store
        self.max_entries = max_entries
        # key namespace: the prefill→decode handoff and the live
        # migration (serving/fleet/migrate.py) each journal under
        # their own prefix, so failover replay and health counts stay
        # per-subsystem
        self.prefix = prefix
        # fleet_rid -> entry dict (src/dest/local_rid/phase)
        self.pending: dict[int, dict] = {}
        self.begun = 0
        self.committed = 0
        self.aborted = 0

    @property
    def full(self) -> bool:
        """Backpressure: at the in-flight bound
        (``FLAGS_serving_handoff_ledger_max``) no new handoff begins —
        requests just keep decoding on their prefill replica until
        entries retire."""
        cap = self.max_entries
        if cap is None:
            cap = int(flag_value("serving_handoff_ledger_max"))
        return cap > 0 and len(self.pending) >= cap

    def _key(self, fleet_rid: int) -> str:
        return f"{self.prefix}{int(fleet_rid)}"

    def begin(self, fleet_rid: int, *, src: int, dest: int,
              local_rid: int) -> dict:
        entry = {"fleet_rid": int(fleet_rid), "src": int(src),
                 "dest": int(dest), "local_rid": int(local_rid),
                 "phase": "begun"}
        if self.store is not None:
            # WRITE-AHEAD: the store journals this before the move is
            # attempted — a failover mid-handoff replays the entry
            self.store.set(self._key(fleet_rid),
                           json.dumps(entry).encode())
        self.pending[int(fleet_rid)] = entry
        self.begun += 1
        return entry

    def commit(self, fleet_rid: int, *, dest: int | None = None) -> None:
        entry = self.pending.pop(int(fleet_rid), None)
        if entry is None:
            return
        if dest is not None:
            entry["dest"] = int(dest)
        entry["phase"] = "committed"
        self.committed += 1
        if self.store is not None:
            self.store.delete(self._key(fleet_rid))

    def abort(self, fleet_rid: int, *, cause: str = "") -> None:
        entry = self.pending.pop(int(fleet_rid), None)
        if entry is None:
            return
        entry["phase"] = "aborted"
        entry["cause"] = cause
        self.aborted += 1
        if self.store is not None:
            self.store.delete(self._key(fleet_rid))

    def fail_source(self, replica_id: int) -> list[int]:
        """Abort every pending entry whose source replica died;
        returns the affected fleet rids (sorted) for the death
        postmortem."""
        hit = sorted(frid for frid, e in self.pending.items()
                     if e["src"] == int(replica_id))
        for frid in hit:
            self.abort(frid, cause=f"source replica {replica_id} died")
        return hit

    def counts(self) -> dict:
        return {"pending": len(self.pending), "begun": self.begun,
                "committed": self.committed, "aborted": self.aborted}


class HandoffCoordinator:
    """Drives the prefill→decode moves for one
    :class:`~.router.FleetRouter`. Called once
    per fleet step (after replicas stepped, before backlog placement):
    every handoff-ready request on a healthy prefill-role replica is
    moved through the ledgered transaction documented in the module
    docstring. Pure control plane — the data plane is the engine/pool
    handoff API."""

    __slots__ = ("router", "ledger")

    def __init__(self, router, store=None):
        # held weakly: the router holds this coordinator, and a cycle
        # would keep a dropped fleet's replicas, and their pools' device
        # memory, until the cycle collector ran
        self.router = weakref.proxy(router)
        self.ledger = HandoffLedger(store)
        # declare the handoff families up front so a role-split fleet
        # that never hands off still SHOWS the channels at zero
        telemetry.counter("serving_fleet_handoffs_total")
        telemetry.counter("serving_handoff_bytes_total")

    def service(self) -> int:
        """One coordination pass; returns how many handoffs committed.
        A source death injected at the ``serving.fleet.handoff`` chaos
        site routes through the router's normal death path (orphans
        requeue and re-prefill on survivors) — the deterministic
        stand-in for a prefill host dying with moves in flight."""
        moved = 0
        for src in list(self.router.replicas.values()):
            if (src.dead or src.joining or src.retiring
                    or src.role != PREFILL_ROLE):
                continue
            for local_rid in src.engine.handoff_ready():
                frid = self.router._by_local.get(
                    (src.replica_id, local_rid))
                rr = (None if frid is None
                      else self.router.requests.get(frid))
                if rr is None:
                    continue
                if self.ledger.full:
                    # backpressure: the request keeps decoding where
                    # it is; next step retries
                    return moved
                dest = self._choose_dest(rr.prompt)
                if dest is None:
                    # no decode-capable replica right now — not an
                    # error: prefill replicas CAN decode (same engine),
                    # just not what they are provisioned for
                    return moved
                self.ledger.begin(frid, src=src.replica_id,
                                  dest=dest.replica_id,
                                  local_rid=local_rid)
                try:
                    fault_point("serving.fleet.handoff",
                                key=str(src.replica_id),
                                step=src.engine.metrics.steps)
                except Exception as e:
                    # the source "died" mid-handoff: the death path
                    # aborts this (and every) pending entry for the
                    # source and requeues its in-flight work — the
                    # request re-prefills on a survivor, zero loss
                    self.router._on_replica_death(src, e)
                    break
                try:
                    state = src.engine.export_request(local_rid)
                    new_local = dest.engine.import_request(state)
                except Exception as e:
                    # dest refused (draining, pool full, geometry) —
                    # abort the entry; the source never let go, the
                    # request keeps decoding there
                    self.ledger.abort(frid, cause=repr(e))
                    from ...distributed.watchdog import report_degraded
                    report_degraded("serving.fleet.handoff_import", e)
                    continue
                src.engine.release_handoff(local_rid,
                                           dest=dest.replica_id)
                self.router._by_local.pop(
                    (src.replica_id, local_rid), None)
                rr.replica_id = dest.replica_id
                rr.local_rid = new_local
                self.router._by_local[
                    (dest.replica_id, new_local)] = frid
                self.ledger.commit(frid, dest=dest.replica_id)
                moved += 1
                telemetry.counter(
                    "serving_fleet_handoffs_total").inc()
                telemetry.counter(
                    "serving_handoff_bytes_total").inc(
                        state["kv"]["nbytes"])
                telemetry.record_flight_step(
                    src="fleet", kind="handoff", fleet_rid=frid,
                    from_replica=src.replica_id,
                    to_replica=dest.replica_id,
                    tokens=len(state["output"]),
                    kv_bytes=state["kv"]["nbytes"])
        return moved

    def _choose_dest(self, prompt):
        """Least-loaded decode-capable SERVING replica (the
        choose_replica policy with the decode role filter); None when
        no decode replica can take the move right now."""
        from .router import choose_replica
        views = [r.view(prompt) for r in self.router.replicas.values()
                 if not r.dead]
        try:
            decision = choose_replica(views, role=DECODE_ROLE)
        except RequestRejected:
            return None
        return self.router.replicas[decision.replica_id]

    def on_replica_death(self, replica_id: int) -> list[int]:
        """Death hook: abort the dead source's pending ledger entries
        and return the affected fleet rids (the router puts them in
        the death dump; its normal requeue does the re-prefill)."""
        return self.ledger.fail_source(replica_id)
