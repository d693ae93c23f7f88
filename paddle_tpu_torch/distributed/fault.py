"""Deterministic fault injection (port of ``distributed/fault.py``: the
registry behind ``fault_point``).

``FLAGS_fault_spec`` arms a registry of rules; injection points
(:func:`fault_point`) are threaded into the serving engine, its pool and
its host tier, so a recovery path can be triggered on demand and held to
its contract.

Spec grammar (comma-separated rules)::

    site[:filter=value...][:action]

    site     injection-point name. The port's serving sites:
             serving.pool_alloc (``KVBlockPool.ensure``, key= the
             request id), serving.host_tier.restore
             (``KVBlockPool._restore_chain``, key= the request id),
             serving.prefill and serving.sample (step= the engine step
             AND key= the request id), serving.decode (step= only: the
             whole batch fails), serving.spec.propose and
             serving.spec.verify (step= and key=). Any string matches
             its fault_point call site. All fire OUTSIDE the device
             step, so recovery sees intact pool buffers
             (serving/robustness.py)
    filters  rank=N   only this PADDLE_TRAINER_ID (or explicit ctx rank)
             round=N  only this PADDLE_RESTART_ROUND
             step=N   only when the call site passes step=N
             key=S    only when the call site's key contains S
             after=N  skip the first N matching calls
             times=N  fire at most N times (default: unlimited)
    action   raise    raise FaultInjected (a ConnectionError — retryable)
             exit     os._exit(43) — a hard crash, no cleanup
             truncate cut the file at ctx ``path`` to half its size
             corrupt  flip bytes in the middle of the file at ``path``
             sleep=S  block the calling thread for S seconds (float) —
                      the deterministic stand-in for a wedged step
             nan      a value rule (poisons a value at a value site);
                      at plain ``fault_point`` sites it is a no-op

Determinism: rules count *matching* calls under a lock; the same spec
against the same call sequence fires at the same points run to run.
With the flag unset the registry is empty and every instrumented site
reduces to one module-level ``if not _RULES`` check. Every firing counts
into ``fault_injected_total{site, action}`` (``telemetry``; a no-op while
``FLAGS_telemetry`` is off). The JAX module's ``RetryPolicy`` and its
``store_retry_total`` count have no counterpart yet: the port has no
store.
"""

from __future__ import annotations

import os
import threading
import time

from ..flags import define_flag, get_flags

__all__ = ["FaultInjected", "enabled", "fault_point", "reset"]


class FaultInjected(ConnectionError):
    """Raised by an armed ``raise`` rule: a simulated store or network
    blip. Subclasses ConnectionError so retry and recovery paths treat
    it exactly like the real failure it stands in for."""


class _Rule:
    __slots__ = ("site", "action", "rank", "round", "step", "key",
                 "after", "times", "calls", "fired", "spec", "sleep_s")

    _ACTIONS = ("raise", "exit", "truncate", "corrupt", "nan")

    def __init__(self, spec: str):
        self.spec = spec
        parts = [p for p in spec.split(":") if p]
        if not parts:
            raise ValueError(f"empty fault spec {spec!r}")
        self.site = parts[0]
        self.action = "raise"
        self.rank = self.round = self.step = None
        self.key = None
        self.after = 0
        self.times = None
        self.sleep_s = 0.0
        for p in parts[1:]:
            if p in self._ACTIONS:
                self.action = p
            elif "=" in p:
                k, v = p.split("=", 1)
                if k == "key":
                    self.key = v
                elif k == "sleep":
                    # the only k=v action: it carries its own duration
                    self.action = "sleep"
                    self.sleep_s = float(v)
                elif k in ("rank", "round", "step", "after", "times"):
                    setattr(self, k, int(v))
                else:
                    raise ValueError(f"unknown fault filter {k!r} in {spec!r}")
            else:
                raise ValueError(f"unknown fault field {p!r} in {spec!r}")
        self.calls = 0   # matching calls seen
        self.fired = 0   # times the action ran

    def matches(self, site, rank, step, key) -> bool:
        if site != self.site:
            return False
        if self.rank is not None:
            r = rank if rank is not None else int(
                os.environ.get("PADDLE_TRAINER_ID", "0"))
            if r != self.rank:
                return False
        if self.round is not None and int(
                os.environ.get("PADDLE_RESTART_ROUND", "0")) != self.round:
            return False
        if self.step is not None and step != self.step:
            return False
        if self.key is not None and (key is None or self.key not in key):
            return False
        return True


_RULES: list[_Rule] = []
_LOCK = threading.Lock()


def _parse(spec: str) -> list[_Rule]:
    return [_Rule(s.strip()) for s in (spec or "").split(",") if s.strip()]


def _rearm(value) -> None:
    global _RULES
    _RULES = _parse(value)


define_flag(
    "fault_spec", "",
    "deterministic fault injection rules (comma-separated "
    "'site[:rank=N][:round=N][:step=N][:key=S][:after=N][:times=N]"
    "[:raise|exit|truncate|corrupt|sleep=S|nan]'), e.g. "
    "'serving.decode:times=1' or "
    "'serving.host_tier.restore:key=3:raise'. Empty (default) disables "
    "all injection — instrumented sites reduce to one registry check",
    type=str, on_change=_rearm)
_rearm(get_flags("fault_spec")["fault_spec"])


def enabled() -> bool:
    """True when any injection rule is armed."""
    return bool(_RULES)


def reset() -> None:
    """Zero every rule's counters (tests); the spec stays armed."""
    with _LOCK:
        for r in _RULES:
            r.calls = r.fired = 0


def _mutate_file(path: str, action: str) -> None:
    size = os.path.getsize(path)
    if action == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    else:  # corrupt: flip bytes mid-file, past any header
        with open(path, "r+b") as f:
            f.seek(max(0, size // 2))
            chunk = f.read(8) or b"\0"
            f.seek(max(0, size // 2))
            f.write(bytes(b ^ 0xFF for b in chunk))


def _fire(rule, site, rank, step, key):
    """Match one rule against the call context and, when it fires,
    count it and return its action (None otherwise)."""
    with _LOCK:
        if not rule.matches(site, rank, step, key):
            return None
        rule.calls += 1
        if rule.calls <= rule.after:
            return None
        if rule.times is not None and rule.fired >= rule.times:
            return None
        rule.fired += 1
        action = rule.action
    from .. import telemetry
    telemetry.counter("fault_injected_total",
                      labels={"site": site, "action": action}).inc()
    return action


def _raise_injected(site, rule):
    raise FaultInjected(
        f"injected fault at {site} (rule {rule.spec!r}, "
        f"call #{rule.calls})")


def fault_point(site: str, *, rank: int | None = None,
                step: int | None = None, key: str | None = None,
                path: str | None = None) -> None:
    """Fire any armed rule matching this site and context. A no-op (one
    list check) when nothing is armed. ``nan`` rules are value rules and
    are ignored here."""
    if not _RULES:
        return
    for rule in _RULES:
        if rule.action == "nan":
            continue
        action = _fire(rule, site, rank, step, key)
        if action is None:
            continue
        if action == "raise":
            _raise_injected(site, rule)
        if action == "exit":
            os._exit(43)
        if action == "sleep":
            time.sleep(rule.sleep_s)
        if action in ("truncate", "corrupt") and path is not None:
            _mutate_file(path, action)
