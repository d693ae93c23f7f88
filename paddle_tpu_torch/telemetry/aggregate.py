"""Cross-rank aggregation (port of ``telemetry/aggregate.py``):
rank-local snapshots -> one fleet view.

Every rank pushes its ``snapshot_doc()`` to a key-value store under the
``/telemetry/`` key prefix (``push_snapshot``); one reader merges
whatever ranks have published into a fleet-wide document
(``collect_fleet``). The store is duck-typed: any object with
``set(key, bytes)`` and ``get(key, default=)`` (the JAX package's
TCPStore has both), with an optional ``epoch`` attribute. Reads never
block: a rank that has not pushed, or died, contributes nothing and is
listed in ``absent``.

Merge semantics per metric kind:

- counter: SUM across ranks (events are disjoint).
- gauge: per-rank values kept under a ``rank`` label, plus a fleet
  ``min``/``max``/``mean`` summary.
- histogram: counts and sums ADD; percentiles are summarised as the
  min/max of the per-rank percentiles (reservoirs cannot be merged
  exactly without the raw samples).

The documents are the JAX package's, so either package's ranks and
readers mix in one fleet.
"""

from __future__ import annotations

import json

from .exporters import snapshot_doc

__all__ = ["KEY_PREFIX", "push_snapshot", "collect_fleet", "merge_docs",
           "format_fleet"]

# absolute key (leading "/"), the JAX package's: a store that prefixes
# keys per recovery round must not hide a prior round's snapshot
KEY_PREFIX = "/telemetry/"


def push_snapshot(store, rank: int, serving: dict | None = None) -> None:
    """Publish this rank's current snapshot in one ``store.set``
    (retries, if any, are the store's own).

    ``serving`` attaches a serving-replica health document
    (``ServingEngine.health()``: lifecycle state, estimated queue
    delay, prefix-cache occupancy) under the ``serving`` key — the
    per-replica liveness the fleet router and ``format_fleet`` read.
    Training ranks publish without it, exactly as before."""
    doc = snapshot_doc()
    doc["rank"] = int(rank)
    if serving is not None:
        doc["serving"] = serving
    epoch = getattr(store, "epoch", None)
    if epoch is not None:
        # a replicated store's era: the fleet view can show that a
        # failover happened before the counters re-aggregate
        doc["store_epoch"] = int(epoch)
    store.set(KEY_PREFIX + "rank%d" % int(rank),
              json.dumps(doc, default=str).encode())


def _fetch(store, rank: int) -> dict | None:
    raw = store.get(KEY_PREFIX + "rank%d" % int(rank), default=b"")
    if not raw:
        return None
    try:
        return json.loads(raw)
    except ValueError as e:
        from ..distributed.watchdog import report_degraded
        report_degraded("telemetry.aggregate.decode", e)
        return None


def collect_fleet(store, world_size: int) -> dict:
    """Gather every published rank snapshot and merge. Non-blocking:
    missing ranks are listed in ``absent`` rather than waited for."""
    docs = {}
    for r in range(int(world_size)):
        doc = _fetch(store, r)
        if doc is not None:
            docs[r] = doc
    merged = merge_docs(docs)
    merged["world_size"] = int(world_size)
    merged["absent"] = [r for r in range(int(world_size)) if r not in docs]
    return merged


def merge_docs(docs: dict[int, dict]) -> dict:
    """Merge rank -> snapshot_doc into one fleet document."""
    out = {
        "schema": "paddle_tpu.telemetry/fleet/1",
        "ranks": sorted(docs),
        "metrics": {},
    }
    # serving-replica health sections ride through UNMERGED, keyed by
    # rank (string keys: the document is JSON-bound) — per-replica
    # lifecycle state is exactly what averaging would destroy
    serving = {str(r): docs[r]["serving"] for r in sorted(docs)
               if isinstance(docs[r].get("serving"), dict)}
    if serving:
        out["serving"] = serving
    epochs = [int(docs[r]["store_epoch"]) for r in sorted(docs)
              if isinstance(docs[r].get("store_epoch"), int)]
    if epochs:
        # max across ranks: a mixed view means some ranks' failovers
        # have not landed (or their pre-failover snapshot is what the
        # journal replayed) — the max is the era the fleet is moving to
        out["store_epoch"] = max(epochs)
    fams: dict[str, dict] = {}
    for rank in sorted(docs):
        for name, fam in (docs[rank].get("metrics") or {}).items():
            slot = fams.setdefault(name, {"type": fam["type"], "rows": []})
            for s in fam.get("samples", []):
                slot["rows"].append((rank, s))

    for name in sorted(fams):
        kind = fams[name]["type"]
        rows = fams[name]["rows"]
        if kind == "counter":
            total = 0.0
            by_labels: dict[tuple, dict] = {}
            for rank, s in rows:
                key = tuple(sorted((s.get("labels") or {}).items()))
                ent = by_labels.setdefault(
                    key, {"labels": dict(s.get("labels") or {}),
                          "value": 0.0})
                ent["value"] += s.get("value", 0)
                total += s.get("value", 0)
            out["metrics"][name] = {
                "type": "counter", "fleet_total": total,
                "samples": [by_labels[k] for k in sorted(by_labels)]}
        elif kind == "gauge":
            vals = [s.get("value", 0.0) for _, s in rows]
            out["metrics"][name] = {
                "type": "gauge",
                "min": min(vals) if vals else None,
                "max": max(vals) if vals else None,
                "mean": (sum(vals) / len(vals)) if vals else None,
                "samples": [
                    {"labels": {**(s.get("labels") or {}),
                                "rank": str(rank)},
                     "value": s.get("value", 0.0)}
                    for rank, s in rows]}
        else:  # histogram
            count = sum(int(s.get("count", 0)) for _, s in rows)
            total = sum(float(s.get("sum", 0.0)) for _, s in rows)
            p95s = [s.get("p95") for _, s in rows
                    if s.get("p95") is not None]
            p50s = [s.get("p50") for _, s in rows
                    if s.get("p50") is not None]
            out["metrics"][name] = {
                "type": "histogram", "count": count, "sum": total,
                "p50_min": min(p50s) if p50s else None,
                "p50_max": max(p50s) if p50s else None,
                "p95_min": min(p95s) if p95s else None,
                "p95_max": max(p95s) if p95s else None,
                "samples": [
                    {"labels": {**(s.get("labels") or {}),
                                "rank": str(rank)}, **{
                        k: s.get(k) for k in
                        ("count", "sum", "min", "max", "p50", "p95",
                         "p99")}}
                    for rank, s in rows]}
    return out


def format_fleet(doc: dict) -> str:
    """Textual rendering of a ``collect_fleet`` document: one health
    line per present rank (from its ``serving`` section when the rank
    is a serving replica), absent ranks called out explicitly, and the
    merged metric-family count. Pure stdlib over the JSON document."""
    ranks = doc.get("ranks") or []
    absent = doc.get("absent") or []
    world = doc.get("world_size", len(ranks) + len(absent))
    head = f"fleet: {len(ranks)}/{world} rank(s) present"
    if doc.get("store_epoch"):
        head += (f"  [store epoch {doc['store_epoch']} — control plane "
                 f"failed over]")
    lines = [head]
    serving = doc.get("serving") or {}
    for r in ranks:
        s = serving.get(str(r), serving.get(r))
        if not isinstance(s, dict):
            lines.append(f"  rank {r}: present (no serving section — "
                         f"training rank or pre-serving snapshot)")
            continue
        state = str(s.get("state", "?"))
        if s.get("degraded_reason"):
            state += f"({s['degraded_reason']})"
        # disaggregated serving: the replica's role and its handoff
        # ledger traffic (requests moved out of / into this replica)
        # — omitted entirely for pre-disaggregation snapshots and
        # uninteresting monolithic ("both") replicas with no traffic
        role = s.get("role")
        ho = s.get("handoffs") or {}
        extra = ""
        if role and (role != "both" or ho.get("out") or ho.get("in")):
            extra = (f"  role={role} "
                     f"handoffs_out={ho.get('out', 0)} "
                     f"handoffs_in={ho.get('in', 0)}")
        lines.append(
            f"  rank {r}: {state}  waiting={s.get('waiting', '?')} "
            f"active={s.get('active', '?')} "
            f"in_flight={s.get('in_flight', '?')}  "
            f"est_delay_s={s.get('estimated_queue_delay_s', '?')}  "
            f"steps={s.get('steps', '?')}  "
            f"pool_util={s.get('pool_utilization', '?')}  "
            f"goodput={s.get('goodput_ratio', '?')}{extra}")
    for r in absent:
        lines.append(f"  rank {r}: ABSENT — no snapshot published "
                     f"(never started, or died before its first push)")
    lines.append(f"{len(doc.get('metrics') or {})} merged metric "
                 f"famil(ies)")
    return "\n".join(lines)
