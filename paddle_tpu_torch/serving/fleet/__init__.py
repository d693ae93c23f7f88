"""Multi-replica serving fleet (port of ``serving/fleet/``): a
health-aware router over in-process engine replicas, self-healing,
autoscaling, disaggregated prefill/decode and live migration.

The layer ABOVE one ServingEngine, built from the engine's hooks: its
``health()``/``drain()`` lifecycle, the prefix cache's ``peek_prefix``
pricing, ``routing_signals()``, and the request handoff
(``export_request``/``import_request``/``release_handoff``). The
router sits on the host; every replica's engine launches K5 (paged
attention) and K6 (RMSNorm) on the card, so a fleet's launches are the
sum of its replicas' dispatches.

- router.py     ``choose_replica`` (pure policy: cache-affinity when
                the prompt's prefix is resident, least estimated
                delay otherwise, DEGRADED/JOINING replicas receive
                nothing) and ``FleetRouter`` (in-process replicas,
                requeue-without-loss on replica death, SELF-HEALING
                when built with an ``engine_factory``: dead slots
                respawn with capped backoff through JOINING probation,
                whole-fleet loss parks the backlog instead of raising,
                hung steps are abandoned under
                ``FLAGS_serving_fleet_step_timeout_s``, drain to
                STOPPED).
- autoscaler.py ``decide`` (pure policy: scale UP on sheds/backlog
                immediately or sustained high occupancy over a full
                window, scale DOWN only after a fully idle window,
                hysteresis + ``FLAGS_serving_fleet_min/max_replicas``
                bounds) and ``LoadWindow`` — the control loop
                ``FleetRouter.enable_autoscale()`` arms; scale-up
                rides the respawn/JOINING path, scale-down drains and
                retires the least-loaded replica with zero loss.
- disagg.py     disaggregated prefill/decode serving: replicas carry
                a role (``prefill``/``decode``/``both`` — the
                default, the monolithic fleet), new requests route to
                prefill replicas, run to first token, and hand their
                paged KV blocks + sampler rng to a decode replica
                through a write-ahead handoff ledger.
- migrate.py    live migration of in-flight requests: the handoff
                transaction generalized to ANY depth (mid-decode,
                mid-prefill at a chunk boundary) under its own
                write-ahead ledger, wired into scale-down retirement,
                drain consolidation and DEGRADED evacuation — moved
                requests keep their KV, rng and deadline.

Not here yet: the JAX package's ``sharding.py`` (tensor parallelism of
one engine over a device mesh) and ``worker.py`` (one replica per
process under the launcher, publishing over its TCP store). One card
has no tensor-parallel mesh, and the worker needs the launcher and the
store; both come with the multi-card slice, and with the worker its
flag ``serving_fleet_replicas``, which nothing here reads.

Quick start (in-process fleet on one card, replicas sharing one
model)::

    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.fleet import EngineReplica, FleetRouter

    def factory():
        return ServingEngine.from_model(model, pool_blocks=512)

    fleet = FleetRouter([EngineReplica(i, factory()) for i in range(2)],
                        engine_factory=factory)
    rid = fleet.submit(prompt_ids, max_new_tokens=64)
    results = fleet.run()          # {fleet rid: Sequence}
    fleet.drain()                  # health()["state"] == "stopped"
"""

from .autoscaler import (  # noqa: F401
    DOWN, HOLD, UP, LoadWindow, ScaleDecision, decide,
)
from .disagg import (  # noqa: F401
    BOTH_ROLE, DECODE_ROLE, PREFILL_ROLE, ROLES,
    HandoffCoordinator, HandoffLedger, parse_roles,
)
from .migrate import (  # noqa: F401
    MigrationCoordinator,
)
from .router import (  # noqa: F401
    AFFINITY, DEAD, JOINING, LEAST_DELAY, REROUTE, ROUTE_POLICIES,
    EngineReplica, FleetRouter, ReplicaHung, ReplicaView,
    RoutingDecision, choose_replica, view_from_health,
    views_from_fleet_doc,
)

__all__ = [
    "AFFINITY", "LEAST_DELAY", "REROUTE", "ROUTE_POLICIES", "DEAD",
    "JOINING", "ReplicaHung",
    "ReplicaView", "RoutingDecision", "choose_replica",
    "view_from_health", "views_from_fleet_doc",
    "EngineReplica", "FleetRouter",
    "UP", "DOWN", "HOLD", "ScaleDecision", "LoadWindow", "decide",
    "PREFILL_ROLE", "DECODE_ROLE", "BOTH_ROLE", "ROLES",
    "HandoffLedger", "HandoffCoordinator", "parse_roles",
    "MigrationCoordinator",
]
