"""Degraded-path reporting (port of ``distributed/watchdog.py``, its
``report_degraded`` only).

``report_degraded`` is the visibility channel for recoverable failures
that a path survives: a serving step that failed and was replayed, a
pool exhausted into preemption, a telemetry write that could not land.
The JAX module's collective hang watchdog (``CommTaskManager``,
``comm_task``, ``CommTimeoutError``) guards distributed operations the
port does not have yet.
"""

from __future__ import annotations

import logging

from .. import telemetry

__all__ = ["report_degraded"]

logger = logging.getLogger(__name__)

_degraded_seen: set = set()


def report_degraded(site: str, exc: Exception) -> None:
    """Report one recoverable failure at ``site``.

    Two channels with different cardinality budgets: the LOG line fires
    once per (site, exception type), so a pool thrashing 10k times does
    not bury the log, while the telemetry counter
    ``watchdog_degraded_total{site}`` counts EVERY occurrence, so that
    same pool is distinguishable from one blip in any snapshot. The
    counter label is the site cut at its first ``(``: call sites may
    embed keys or steps there, and per-value label series would grow the
    registry without bound. The full site still reaches the log line."""
    telemetry.counter("watchdog_degraded_total",
                      labels={"site": site.split("(", 1)[0]}).inc()
    key = (site, type(exc).__name__)
    if key in _degraded_seen:
        return
    _degraded_seen.add(key)
    # the record gets the message, never the exception: a handler that
    # keeps records (a test's log capture) would keep its traceback, and
    # with it every frame's locals, a failed engine step's pool included
    logger.warning("degraded path at %s: %s: %s (continuing)", site,
                   type(exc).__name__, str(exc))
