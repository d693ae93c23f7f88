"""Typed runtime flag registry (port of ``paddle_tpu/flags.py``).

One registry, three surfaces: :func:`define_flag` at import time,
``FLAGS_*`` environment variables read when a flag is defined, and
:func:`set_flags` / :func:`get_flags` at run time. Only the flags the
serving slice (with its prefix cache, speculative decoding, host-RAM
tier, robustness contract, fleet publishing and the fleet: router,
self-healing, autoscaler, disaggregation, migration), the telemetry
package, the ResNet model and amp's tensor checker read are defined
here; ``fault_spec`` is defined beside its registry in
``distributed/fault.py``, which re-arms
the rules whenever it changes (``on_change``). The attention, RMSNorm
and BN-statistics kernels are not chosen by flags: the tensor's device
picks between a kernel and its plain version. The two ResNet
flags below choose something else, a different composition of the
training step (see their help).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

_LOCK = threading.RLock()
_REGISTRY: dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "type", "value", "default", "help", "on_change")

    def __init__(self, name, type_, default, help_, on_change=None):
        self.name = name
        self.type = type_
        self.default = default
        self.value = default
        self.help = help_
        self.on_change = on_change


def _parse(type_: type, raw: str) -> Any:
    if type_ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return type_(raw)


def define_flag(name: str, default: Any, help: str = "",
                type: type | None = None,
                on_change: Callable[[Any], None] | None = None) -> None:
    """Register a flag. Env var ``FLAGS_<name>`` overrides the default.
    ``on_change(value)`` runs after every :func:`set_flags` of it."""
    type_ = type if type is not None else default.__class__
    with _LOCK:
        flag = _Flag(name, type_, default, help, on_change)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            flag.value = _parse(type_, env)
        _REGISTRY[name] = flag


def _key(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def set_flags(flags: dict[str, Any]) -> None:
    """Set registered flags; mirrors ``paddle.set_flags``."""
    with _LOCK:
        for name, value in flags.items():
            key = _key(name)
            if key not in _REGISTRY:
                raise ValueError(f"unknown flag {name!r}")
            flag = _REGISTRY[key]
            if isinstance(value, str) and flag.type is not str:
                flag.value = _parse(flag.type, value)
            else:
                flag.value = flag.type(value)
            if flag.on_change is not None:
                flag.on_change(flag.value)


def get_flags(names: str | list[str]) -> dict[str, Any]:
    """Read registered flags; mirrors ``paddle.get_flags``."""
    if isinstance(names, str):
        names = [names]
    with _LOCK:
        return {name: _REGISTRY[_key(name)].value for name in names}


def flag_value(name: str) -> Any:
    return _REGISTRY[name].value


# -- amp's tensor checker (amp/debugging.py), read at the op-cast point
# (ops/registry.py), as in the JAX package ----------------------------------
define_flag("check_nan_inf", False,
            "scan op outputs for nan/inf (eager debugging)")
define_flag("check_nan_inf_level", 0,
            "0: error on nan/inf; 3: only collect stats")

# -- serving (serving/engine.py defaults; constructor kwargs override) ------
define_flag("serving_block_size", 16,
            "tokens per paged KV-cache block")
define_flag("serving_max_batch_slots", 8,
            "decode batch slots: the engine's fixed [slots, 1] decode batch")
define_flag("serving_prefill_chunk", 128,
            "largest prefill chunk per step; chunks pad up to power-of-two "
            "buckets capped here")
define_flag("serving_pool_blocks", 0,
            "KV pool blocks including the scratch block; 0 sizes the pool "
            "so every slot can hold a full-length context")
define_flag("serving_token_budget", 0,
            "tokens of work per engine step (decodes + prefill chunk); 0 "
            "means prefill_chunk + max_batch_slots")
define_flag("serving_max_queue", 0,
            "bounded admission (serving/robustness.py): max WAITING "
            "requests per engine — an arrival finding the queue full "
            "is SHED at add_request (RequestRejected, terminal reason "
            "'shed') instead of growing the deque forever; 0 "
            "(default) = unbounded")
define_flag("serving_step_retries", 2,
            "step-failure isolation: recompute attempts per sequence "
            "(over its lifetime) after an exception in its "
            "prefill/decode/sample plan component — the replay reuses "
            "preemption-by-recompute (blocks freed, prompt+output "
            "re-prefilled); beyond the budget the sequence is "
            "quarantined with terminal reason 'failed' while every "
            "other sequence keeps serving. 0 = quarantine on first "
            "failure")
define_flag("serving_hung_step_s", 0.0,
            "hung-step detector threshold (seconds): an engine step "
            "exceeding this is reported (robustness._report_degraded) "
            "and flips the engine lifecycle to DEGRADED until "
            "clean steps accumulate; 0 (default) disables",
            type=float)
define_flag("serving_prefix_cache", True,
            "prefix caching + copy-on-write KV sharing in the paged "
            "pool (serving/kv_pool.py): full blocks are refcounted "
            "and indexed by token content, add_request/admission "
            "acquire the longest resident prefix instead of "
            "re-prefilling it, and freed zero-ref blocks park in an "
            "LRU cached set the allocator reclaims under pressure. "
            "Greedy outputs are equal with this on or off "
            "(tests/test_torch_serving_prefix_spec.py)")
define_flag("serving_prefix_cached_blocks", 0,
            "budget of zero-ref cached prefix blocks retained after "
            "their last reference drops; beyond it the LRU block is "
            "evicted to the free list immediately. 0 = unbounded: "
            "cached blocks are reclaimable capacity the allocator "
            "evicts under pressure anyway")
define_flag("serving_prefix_min_blocks", 1,
            "minimum matched FULL blocks before a prefix lookup "
            "counts as a hit and bumps refcounts — shorter matches "
            "skip sharing (the bookkeeping outweighs a sub-block "
            "saving); 1 (default) shares from the first full block")
define_flag("serving_host_tier", False,
            "host-RAM spill tier behind the paged pool's prefix cache "
            "(serving/host_tier.py): blocks evicted from the device "
            "cached-LRU set copy their contents + token path to a "
            "bounded host store instead of vanishing, and a prefix "
            "hit on a host-resident chain restores them through an "
            "asynchronous host-to-device block copy on the engine's "
            "stream, ahead of the request's cold-suffix prefill. "
            "Default off — every existing eviction/allocation path "
            "stays the same. Requires FLAGS_serving_prefix_cache; "
            "binds at pool construction")
define_flag("serving_host_tier_bytes", 1 << 26,
            "host-tier capacity in bytes of spilled K+V payload "
            "(2 * layers * block_size * kv_heads * head_dim * "
            "itemsize per block); beyond it the LRU host entry is "
            "dropped. 0 keeps the tier empty (spills copy and "
            "immediately age out). Read per spill, so a change takes "
            "effect at the next eviction. Default 64 MiB")
define_flag("serving_host_tier_restore_frac", 0.35,
            "admission price of one host-resident prefix token "
            "(robustness.AdmissionController.priced_tokens), as a "
            "fraction of a cold token: the restore is a host-to-device "
            "block copy, cheaper than recompute but not free, so a "
            "host hit must shed-price strictly between a device hit "
            "(0.0) and cold (1.0). Clamped to [0, 1]", type=float)
define_flag("serving_spec", "off",
            "speculative decoding mode for the serving engine "
            "(serving/speculation.py): 'ngram' = prompt/output n-gram "
            "proposer, 'draft' = small draft model sharing the paged "
            "pool's block tables (requires ServingEngine(..., "
            "draft_model=)), 'off' = plain one-token decode. Binds at "
            "engine construction. Greedy outputs are equal to the "
            "dense path with speculation on or off; seeded stochastic "
            "outputs equal the spec-off engine's (sample-and-match)")
define_flag("serving_spec_lookahead", 4,
            "draft tokens per speculative verify row (k): each "
            "speculating sequence submits its last token + k drafts "
            "as one ragged multi-token row and emits accepted+1 "
            "tokens. The verify batch is [slots, W], W the next power "
            "of two >= 1+k; adaptive back-off can shrink a sequence's "
            "k below this, never above")
define_flag("serving_spec_ngram_max", 3,
            "longest suffix n-gram the ngram proposer matches against "
            "the request's own token history before proposing the "
            "continuation of the most recent earlier occurrence "
            "(longest n wins, then latest occurrence)")
define_flag("serving_spec_min_accept", 0.0,
            "per-sequence rolling-acceptance floor for adaptive "
            "lookahead: below it a sequence's lookahead backs off to 1 "
            "draft until acceptance recovers; 0 disables back-off",
            type=float)
define_flag("serving_drain_timeout_s", 30.0,
            "default ServingEngine.drain() deadline: in-flight "
            "requests get this many seconds to finish after "
            "admissions stop; stragglers still running at the "
            "deadline are finished with terminal reason 'cancelled'",
            type=float)

# -- telemetry (telemetry/*; serving's metric families, spans, flight
# recorder and request timelines) and the serving SLO targets ------------
define_flag("telemetry", False,
            "master switch for paddle_tpu.telemetry (unified metrics + "
            "span tracing). Off (default): every counter/gauge/"
            "histogram/span helper is a guarded no-op — one registry "
            "lookup, no samples retained, no exporter thread started. "
            "On: serving, watchdog, fault, checkpoint and resilient "
            "paths publish into the process-wide registry")
define_flag("telemetry_reservoir", 512,
            "per-histogram reservoir size (Vitter Algorithm R): "
            "percentiles are estimated from a fixed-size uniform "
            "sample while counts/sums stay exact, so a server running "
            "for days keeps flat memory. Also bounds ServingMetrics' "
            "TTFT/TPOT sample buffers")
define_flag("telemetry_spans_max", 4096,
            "span ring capacity for telemetry.tracer — the newest N "
            "host spans are kept, older ones dropped (the drop count "
            "is reported in the tracer); bounds trace memory on "
            "long-wedged jobs exactly like the watchdog TIMEOUT_RING")
define_flag("telemetry_export_interval", 0.0,
            "seconds between periodic background snapshot exports "
            "(telemetry.maybe_start_exporter); 0 (default) disables "
            "the exporter thread entirely", type=float)
define_flag("telemetry_export_path", "",
            "periodic exporter target file (atomically replaced each "
            "tick); empty = one JSON line per tick on stdout",
            type=str)
define_flag("telemetry_requests_max", 256,
            "per-request lifecycle timelines retained in the process "
            "request log (telemetry/requests.py); oldest-started "
            "evicted first, so a long-running server keeps a sliding "
            "window of recent requests")
define_flag("telemetry_request_events_max", 64,
            "events per request timeline (arrival/admitted/prefill "
            "chunks/first token/retries/terminal); the first events "
            "are kept and the final slot is reserved for the terminal "
            "outcome, overflow is counted as dropped")
define_flag("telemetry_flight_steps", 256,
            "flight-recorder ring capacity (telemetry/flight.py): the "
            "newest N per-step digests are retained and frozen into "
            "the auto-dump document on DEGRADED entry / quarantine / "
            "hung step / drain / resilient recovery")
define_flag("telemetry_flight_dir", "",
            "directory for flight-recorder auto-dumps "
            "(flight-NNN-<trigger>.json, written atomically); empty "
            "(default) keeps dumps in memory only "
            "(telemetry.flight().last_dump / .dump_for(trigger))",
            type=str)
define_flag("serving_ttft_slo_s", 0.0,
            "TTFT SLO target in seconds: first tokens slower than "
            "this count into serving_slo_miss_total{slo=ttft} and the "
            "bench serve summary's SLO attainment; 0 (default) "
            "disables the comparison", type=float)
define_flag("serving_tpot_slo_s", 0.0,
            "TPOT SLO target in seconds (mean inter-token gap after "
            "the first token, per finished request): slower requests "
            "count into serving_slo_miss_total{slo=tpot}; 0 (default) "
            "disables the comparison", type=float)
define_flag("serving_fleet_publish_every", 8,
            "engine steps between health-snapshot publications once "
            "ServingEngine.enable_fleet_publish(store, rank) is "
            "armed: each publication pushes health() (lifecycle "
            "state, estimated queue delay, prefix-cache occupancy) "
            "plus the telemetry snapshot under /telemetry/rank<N> — "
            "the keys the fleet router and telemetry.collect_fleet "
            "read; <= 0 disables publishing")

define_flag("serving_fleet_affinity_min_tokens", 1,
            "minimum prompt-prefix tokens resident on a replica "
            "before cache-affinity routing prefers it over the "
            "least-estimated-delay replica (serving/fleet/router."
            "choose_replica); below the threshold the router falls "
            "back to least-delay")
define_flag("serving_fleet_respawn_backoff_s", 0.5,
            "initial delay (seconds) before the fleet router respawns "
            "a dead replica through its engine_factory; attempt i "
            "waits backoff * 2**i, capped at "
            "FLAGS_serving_fleet_respawn_backoff_max_s — the attempt "
            "counter resets once a respawned replica completes "
            "JOINING probation and rejoins SERVING", type=float)
define_flag("serving_fleet_respawn_backoff_max_s", 8.0,
            "upper bound (seconds) on one replica-respawn backoff "
            "delay", type=float)
define_flag("serving_fleet_respawn_max", 0,
            "respawn attempts per replica slot between heals before "
            "the router gives the slot up for dead (a run with a "
            "backlog and no heal left then raises instead of waiting "
            "forever); 0 (default) retries without limit")
define_flag("serving_fleet_join_steps", 4,
            "clean engine steps a respawned replica must complete in "
            "the JOINING probation state — stepped by the router but "
            "receiving no routed traffic — before its readiness probe "
            "(one scratch prefill+decode round-trip) runs and, on "
            "success, the replica flips to SERVING and rejoins "
            "choose_replica eligibility")
define_flag("serving_fleet_step_timeout_s", 0.0,
            "wall-clock budget (seconds) for one replica step in the "
            "fleet router: a step still running past it is abandoned "
            "in its worker thread and the replica is marked dead with "
            "cause=hang (serving_fleet_hangs_total; the death dump "
            "carries the cause) while survivors keep stepping; 0 "
            "(default) derives 8 * FLAGS_serving_hung_step_s, and "
            "with both unset the router steps replicas inline with "
            "no budget", type=float)
define_flag("serving_fleet_min_replicas", 1,
            "autoscaler floor (serving/fleet/autoscaler.decide): the "
            "policy never proposes a scale-down that would leave "
            "fewer SERVING replicas than this, and the router refuses "
            "to retire the last SERVING replica even when asked "
            "directly — a fleet that can take traffic must keep "
            "taking it")
define_flag("serving_fleet_max_replicas", 4,
            "autoscaler ceiling: scale-up decisions stop once live + "
            "JOINING + pending-respawn replicas reach this count — "
            "the burst absorber is bounded capacity, not unbounded "
            "spawn")
define_flag("serving_fleet_scale_cooldown_s", 10.0,
            "minimum seconds between autoscaler actions: after any "
            "scale-up or scale-down the policy holds until the "
            "cooldown passes AND the decision window refills with "
            "fresh post-scale evidence, so one burst cannot flap the "
            "fleet up and down", type=float)
define_flag("serving_fleet_scale_window_steps", 8,
            "router steps of fleet-wide load evidence (shed deltas, "
            "queued-token backlog, mean occupancy) one autoscaler "
            "decision sees: scale-up needs pressure inside the "
            "window, scale-down needs the WHOLE window idle — the "
            "hysteresis that keeps a single idle tick from retiring "
            "a replica")
define_flag("serving_fleet_scale_up_occupancy", 0.85,
            "mean SERVING-replica slot occupancy (busy decode slots "
            "/ max_slots) over a full decision window at or above "
            "which the autoscaler scales UP (sheds and router "
            "backlog scale up immediately, without waiting for the "
            "window)", type=float)
define_flag("serving_fleet_scale_down_occupancy", 0.30,
            "mean occupancy at or below which — with a full window "
            "of zero sheds and zero backlog, nothing JOINING and no "
            "respawn pending — the autoscaler retires the "
            "least-loaded replica; keep it well under "
            "FLAGS_serving_fleet_scale_up_occupancy or the "
            "hysteresis gap closes and the fleet flaps", type=float)
define_flag("serving_fleet_roles", "",
            "disaggregated prefill/decode split for the serving fleet "
            "(serving/fleet/disagg.py): 'P:D' replica counts, e.g. "
            "'1:1' builds one prefill-role and one decode-role "
            "replica — bench.py fleet and the fleet worker read it "
            "when the caller passes no explicit roles; empty "
            "(default) keeps every replica role 'both' (monolithic, "
            "byte-identical to the pre-disaggregation fleet)",
            type=str)
define_flag("serving_fleet_migrate", True,
            "live migration of in-flight sequences "
            "(serving/fleet/migrate.MigrationCoordinator): on "
            "scale-down retirement, drain consolidation, and DEGRADED "
            "evacuation the router moves each straggler's KV blocks, "
            "sampler rng state, and ledger counters to a SERVING peer "
            "under the write-ahead migration ledger instead of "
            "re-admitting it from the prompt; disabling falls back to "
            "the prompt-replay reroute path everywhere")
define_flag("serving_handoff_ledger_max", 64,
            "bound on IN-FLIGHT entries in the write-ahead handoff "
            "ledger (serving/fleet/disagg.HandoffLedger): while this "
            "many handoffs are begun-but-uncommitted the router "
            "starts no new ones (backpressure — the prefill replica "
            "keeps decoding the request itself until a slot frees), "
            "so a stuck decode fleet cannot grow the ledger or the "
            "HA-store journal without bound")

# -- vision (vision/models/resnet.py, nn/functional/norm.py) ----------------
define_flag("use_fused_resnet_unit", False,
            "route training BottleneckBlocks (NHWC, bf16/f16, groups 1) "
            "through the fused conv+BN kernels K7 and K8: BN statistics "
            "come from the conv's f32 accumulator and each BN's "
            "scale/shift folds into the next conv's prologue. A different "
            "composition from the default path, so results differ at the "
            "working precision")
define_flag("use_pallas_bn_stats", False,
            "compute training BatchNorm statistics of bf16/f16 "
            "channel-last inputs (C % 128 == 0, rows % 8 == 0) with the "
            "statistics kernel K9 (mean and E[x^2] in f32)")
