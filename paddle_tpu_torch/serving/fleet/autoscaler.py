"""Load-driven fleet autoscaling policy (port of
``serving/fleet/autoscaler.py``) — a PURE function, like
:func:`.router.choose_replica`.

The router owns the mechanisms (respawn → JOINING probation →
readiness probe for scale-UP, DRAINING → re-place → retire for
scale-DOWN); this module owns the DECISION: one call per router step
over fleet-wide load evidence, returning ``up`` / ``down`` / ``hold``
plus the victim replica for a scale-down. Keeping the policy free of
router state makes it unit-testable with hand-built
:class:`~.router.ReplicaView` rows — the same
discipline ``choose_replica`` set.

Signals, and why each one:

- **shed rate** (``RequestRejected`` refusals since the last sample,
  the engine's est-delay/queue_full shedders at fleet level): a shed IS
  lost traffic — any shed inside the window scales up immediately,
  no full-window confirmation needed.
- **router backlog tokens** (queued work no replica has admitted yet):
  same urgency as sheds — the fleet is already behind.
- **mean SERVING occupancy** (busy decode slots / ``max_slots``, from
  ``ServingEngine.routing_signals()``): the forward-looking signal.
  High occupancy over a FULL window scales up before the queue-delay
  estimator starts shedding; low occupancy over a full window with
  zero sheds and zero backlog scales down.
- **mean waiting depth** (queued-but-unscheduled requests per SERVING
  replica): occupancy saturates at 1.0 and even oscillates under full
  load (a finishing slot refills on the NEXT step), so a replica that
  is merely busy and one that is drowning look alike — a waiting
  queue that stays non-empty across a full window is unambiguous
  "behind", and scales up even when mean occupancy hovers under the
  threshold.

Hysteresis and damping, each guarding a distinct failure mode:

- the **up/down occupancy gap** (``FLAGS_serving_fleet_scale_up/
  down_occupancy``) keeps one load level from oscillating the fleet;
- the **window** (``FLAGS_serving_fleet_scale_window_steps``) makes
  occupancy-driven decisions require sustained evidence — a single
  busy step proves nothing; scale-down additionally requires the
  WHOLE window quiet, so one idle step after a burst retires nobody;
- the **cooldown** (``FLAGS_serving_fleet_scale_cooldown_s``,
  enforced by the router, not here) spaces consecutive scale events
  so a decision's effect lands before the next decision is taken;
- **in-flight capacity counts**: JOINING/DEGRADED replicas and
  pending respawns count toward the ceiling (scale-up does not stack
  spawns on top of an unfinished heal) and block scale-down (never
  retire a survivor while a newcomer is still proving itself — the
  newcomer might fail probation and die).

Bounds: ``FLAGS_serving_fleet_min_replicas`` is a floor on SERVING
replicas — the policy never proposes a retirement below it, and the
router re-checks it at execution time (the policy ran on a snapshot;
a death may have landed since). ``FLAGS_serving_fleet_max_replicas``
caps live + healing + pending capacity.
"""

from __future__ import annotations

from collections import deque, namedtuple

from ...flags import flag_value
from ..robustness import (BOTH_ROLE, DECODE_ROLE, DEGRADED, JOINING,
                          PREFILL_ROLE, SERVING)

__all__ = [
    "UP", "DOWN", "HOLD", "ScaleDecision", "LoadWindow", "decide",
]

# scale directions (serving_fleet_scale_events_total{direction=})
UP = "up"
DOWN = "down"
HOLD = "hold"

# direction, the victim replica id (scale-down only, else None), a
# short machine-greppable reason string that rides the flight digest,
# and — in a role-split fleet (fleet/disagg.py) — which ROLE the
# decision targets: scale-up names the bottleneck role the new slot
# should serve, scale-down the victim's role. None in monolithic
# fleets (defaulted, so pre-disaggregation constructions and
# comparisons are unchanged)
ScaleDecision = namedtuple("ScaleDecision",
                           ("direction", "replica_id", "reason", "role"),
                           defaults=(None,))

# mean waiting-queue depth per SERVING replica at or above which a
# full window scales up: >= 1 means requests were queued behind busy
# slots at EVERY sample — the fleet is behind, whatever occupancy says
UP_WAITING = 1.0


class LoadWindow:
    """A rolling window of per-step fleet load samples — the evidence
    one :func:`decide` call sees. The router notes one sample per
    step and clears the window after every scale event, so each
    decision is judged on evidence gathered AFTER the previous one
    took effect (a half-stale window would re-litigate the same
    burst)."""

    __slots__ = ("_samples",)

    def __init__(self, steps: int | None = None):
        if steps is None:
            steps = int(flag_value("serving_fleet_scale_window_steps"))
        self._samples: deque[tuple[int, int, float, float]] = deque(
            maxlen=max(1, int(steps)))

    def note(self, *, sheds: int, backlog_tokens: int,
             occupancy: float, waiting: float = 0.0) -> None:
        """Record one router step's evidence: sheds since the last
        sample (a delta, not a running total), queued-token backlog,
        mean SERVING-replica occupancy, and mean SERVING-replica
        waiting-queue depth at sampling time."""
        self._samples.append((max(0, int(sheds)),
                              max(0, int(backlog_tokens)),
                              float(occupancy), float(waiting)))

    def clear(self) -> None:
        self._samples.clear()

    def __len__(self) -> int:
        return len(self._samples)

    @property
    def full(self) -> bool:
        return len(self._samples) == self._samples.maxlen

    @property
    def sheds(self) -> int:
        return sum(s[0] for s in self._samples)

    @property
    def max_backlog(self) -> int:
        return max((s[1] for s in self._samples), default=0)

    @property
    def mean_occupancy(self) -> float:
        if not self._samples:
            return 0.0
        return sum(s[2] for s in self._samples) / len(self._samples)

    @property
    def mean_waiting(self) -> float:
        if not self._samples:
            return 0.0
        return sum(s[3] for s in self._samples) / len(self._samples)

    @property
    def min_waiting(self) -> float:
        return min((s[3] for s in self._samples), default=0.0)

    def snapshot(self) -> dict:
        """The policy-input digest a scale event carries on the
        flight ring — a postmortem must be able to say WHY the fleet
        resized from the dump alone."""
        return {"samples": len(self._samples),
                "window": self._samples.maxlen,
                "sheds": self.sheds,
                "max_backlog": self.max_backlog,
                "mean_occupancy": round(self.mean_occupancy, 4),
                "mean_waiting": round(self.mean_waiting, 4)}


def decide(views, backlog_tokens: int, window: LoadWindow, *,
           pending: int = 0,
           min_replicas: int | None = None,
           max_replicas: int | None = None,
           up_occupancy: float | None = None,
           down_occupancy: float | None = None) -> ScaleDecision:
    """One scaling decision over a fleet snapshot: ``views`` are
    :class:`ReplicaView` rows for every non-dead replica, ``backlog_
    tokens`` the router's queued-but-unplaced work, ``window`` the
    rolling evidence, ``pending`` the count of scheduled-but-unbuilt
    respawns. Keyword overrides substitute for the flags (the
    ``choose_replica`` testing convention)."""
    if min_replicas is None:
        min_replicas = int(flag_value("serving_fleet_min_replicas"))
    if max_replicas is None:
        max_replicas = int(flag_value("serving_fleet_max_replicas"))
    if up_occupancy is None:
        up_occupancy = float(flag_value("serving_fleet_scale_up_occupancy"))
    if down_occupancy is None:
        down_occupancy = float(
            flag_value("serving_fleet_scale_down_occupancy"))
    min_replicas = max(1, int(min_replicas))
    max_replicas = max(min_replicas, int(max_replicas))

    views = list(views)
    serving = [v for v in views if v.state == SERVING]
    # healing capacity: JOINING probationers and DEGRADED recoverers
    # will (probably) serve soon — counted toward the ceiling, and
    # their unfinished heal blocks any scale-down
    healing = [v for v in views if v.state in (JOINING, DEGRADED)]
    capacity = len(serving) + len(healing) + max(0, int(pending))
    backlog_tokens = max(0, int(backlog_tokens))
    # disaggregated fleets (fleet/disagg.py): the DECISION is scoped
    # per role — scale-up names the bottleneck role so the new slot
    # serves where the pressure is, scale-down never proposes the
    # last SERVING replica of a role and the flap guard projects
    # within the victim's role group. All-"both" fleets take the
    # exact pre-disaggregation paths (role=None everywhere)
    split = any(getattr(v, "role", BOTH_ROLE) != BOTH_ROLE
                for v in views)
    up_role = _bottleneck_role(serving) if split else None

    if capacity < max_replicas:
        # sheds and backlog are traffic ALREADY refused or waiting —
        # act on any evidence at all; occupancy is predictive and
        # needs a full window of sustained pressure
        if window.sheds > 0:
            return ScaleDecision(UP, None,
                                 f"sheds={window.sheds} in window",
                                 up_role)
        if backlog_tokens > 0:
            return ScaleDecision(UP, None,
                                 f"backlog_tokens={backlog_tokens}",
                                 up_role)
        if (serving and window.full
                and window.mean_occupancy >= up_occupancy):
            return ScaleDecision(
                UP, None,
                f"mean_occupancy={window.mean_occupancy:.3f}"
                f">={up_occupancy:.3f} over full window", up_role)
        if (serving and window.full
                and window.mean_waiting >= UP_WAITING):
            return ScaleDecision(
                UP, None,
                f"mean_waiting={window.mean_waiting:.2f}"
                f">={UP_WAITING:.0f} per replica over full window",
                up_role)

    if (len(serving) > min_replicas
            and not healing and pending <= 0 and window.full
            and window.sheds == 0 and window.max_backlog <= 0
            and backlog_tokens <= 0
            and window.mean_occupancy <= down_occupancy
            and window.mean_waiting < UP_WAITING):
        candidates = [v for v in serving
                      if _coverage_after(serving, v)]
        if candidates:
            # resident_tokens first: with live migration armed
            # (fleet/migrate.py) the victim's resident context is what
            # a retirement must move, so the emptiest pool is the
            # cheapest retirement; views predating the signal carry 0
            # everywhere and fall through to the load order unchanged
            victim = min(candidates,
                         key=lambda v: (v.resident_tokens,
                                        v.occupancy, v.waiting,
                                        v.est_delay_s, -v.replica_id))
            # the mean dilutes: one saturated replica among idle
            # peers reads as low fleet occupancy, and retiring a peer
            # would concentrate the load and trip the scale-UP
            # threshold next window — project the survivors'
            # occupancy and refuse any retirement that lands inside
            # the up band (the flap guard the cooldown alone cannot
            # provide). Monolithic fleets project the WINDOWED fleet
            # mean (the original formula, bit-for-bit); role-split
            # fleets project within the victim's role group from the
            # instantaneous views (the window cannot be unmixed per
            # role after the fact)
            if not split:
                projected = (window.mean_occupancy * len(serving)
                             / max(1, len(serving) - 1))
            else:
                group = [v for v in serving
                         if getattr(v, "role", BOTH_ROLE)
                         == getattr(victim, "role", BOTH_ROLE)]
                gocc = sum(v.occupancy for v in group) / len(group)
                projected = (gocc * len(group)
                             / max(1, len(group) - 1))
            if projected < up_occupancy:
                return ScaleDecision(
                    DOWN, victim.replica_id,
                    f"mean_occupancy={window.mean_occupancy:.3f}"
                    f"<={down_occupancy:.3f} over idle full window "
                    f"(projected {projected:.3f} after retirement)",
                    getattr(victim, "role", BOTH_ROLE) if split
                    else None)

    return ScaleDecision(HOLD, None, "within band")


def _bottleneck_role(serving) -> str | None:
    """The role group carrying the most load (mean occupancy, then
    mean waiting, then group size ascending — the SMALLER of two
    equally-loaded groups has less headroom) — where a scale-up's new
    replica should serve. None when there is nothing serving to
    attribute the pressure to (the router's respawn default,
    ``both``, is the safe answer there)."""
    groups: dict[str, list] = {}
    for v in serving:
        groups.setdefault(getattr(v, "role", BOTH_ROLE), []).append(v)
    if not groups:
        return None

    def load(role):
        vs = groups[role]
        return (sum(v.occupancy for v in vs) / len(vs),
                sum(v.waiting for v in vs) / len(vs),
                -len(vs))
    return max(sorted(groups), key=load)


def _coverage_after(serving, victim) -> bool:
    """Whether retiring ``victim`` keeps at least one SERVING
    prefill-capable AND one decode-capable replica — the policy-side
    twin of the router's execution-time re-check (a disaggregated
    fleet that retired its last prefill replica could admit nothing;
    its last decode replica would strand every handoff)."""
    survivors = [v for v in serving if v is not victim]
    return all(
        any(getattr(s, "role", BOTH_ROLE) in (role, BOTH_ROLE)
            for s in survivors)
        for role in (PREFILL_ROLE, DECODE_ROLE))
