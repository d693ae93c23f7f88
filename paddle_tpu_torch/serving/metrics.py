"""Serving metrics (port of ``serving/metrics.py``: a subset, without the
telemetry registry).

- TTFT (time to first token): arrival -> first sampled token.
- TPOT (time per output token): inter-arrival of each output token
  after the first, recorded by the step that emitted it.
- Engine steps, output and computed tokens, decode-batch occupancy,
  pool utilisation, preemptions, and per-step phase seconds
  (schedule / prefill / decode / sample / other).
- Prefix cache: hits, hit and miss tokens, copy-on-write copies and the
  cached-block count, synced from the pool once a step (``on_prefix``).
- Speculative decoding: draft tokens proposed and accepted, and
  accepted tokens per engine step.
- Robustness (``robustness.py``): one count per request outcome in
  ``terminal`` (ok, expired, cancelled, shed, failed), sheds by cause in
  ``sheds``, step failures by phase in ``step_failures`` (prefill,
  decode, schedule) and hung-step trips in ``hung_steps``. A request's
  replays are on its ``Sequence.retries``; degraded paths are reported
  through ``robustness._report_degraded``.
- Host tier: restore hits, restored tokens, spills, evictions and
  restore failures, synced from the pool once a step
  (``on_host_tier``), with the tier's current blocks and bytes.

Timestamps are host wall-clock (``robustness.now_s``) taken around the
step; a device phase's seconds include waiting for the device, since the
step reads its logits back to the host. TTFT/TPOT samples live in
fixed-size reservoirs, so a long run keeps flat memory while the counts
stay exact. The telemetry families and the goodput ledger of the JAX
package are not ported yet.
"""

from __future__ import annotations

import random

from .robustness import OK, SHED

STEP_PHASES = ("schedule", "prefill", "decode", "sample", "other")
RESERVOIR_SIZE = 4096


class Reservoir:
    """Fixed-size uniform sample (Vitter's Algorithm R) with an exact
    count. Replacement slots come from a private seeded generator."""

    def __init__(self, capacity: int = RESERVOIR_SIZE, seed: int = 0):
        self.capacity = int(capacity)
        self.samples: list[float] = []
        self.count = 0
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        self.count += 1
        if len(self.samples) < self.capacity:
            self.samples.append(float(x))
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.samples[j] = float(x)

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over the sample (q in 0..100)."""
        if not self.samples:
            return None
        srt = sorted(self.samples)
        i = min(len(srt) - 1, max(0, int(round(q / 100.0 * (len(srt) - 1)))))
        return srt[i]


class ServingMetrics:
    """Counters and latency reservoirs for one ServingEngine."""

    def __init__(self):
        self.requests_arrived = 0
        self.requests_finished = 0
        self.tokens_out = 0
        self.tokens_computed = 0
        self.preemptions = 0
        self.pool_oom_events = 0
        self.terminal: dict[str, int] = {}
        self.sheds: dict[str, int] = {}
        self.step_failures: dict[str, int] = {}
        self.hung_steps = 0
        self.steps = 0
        self.phase_seconds = dict.fromkeys(STEP_PHASES, 0.0)
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.cow_copies = 0
        self.prefix_cached_blocks = 0
        self.host_tier_hits = 0
        self.host_tier_hit_tokens = 0
        self.host_tier_spills = 0
        self.host_tier_evictions = 0
        self.host_tier_restore_failures = 0
        self.host_tier_blocks = 0
        self.host_tier_bytes = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_step_tokens = Reservoir(seed=3)
        self.ttft_s = Reservoir(seed=1)
        self.tpot_s = Reservoir(seed=2)
        self._decode_slot_steps = 0
        self._slot_steps = 0
        self._pool_util_sum = 0.0

    def on_arrival(self):
        self.requests_arrived += 1

    def on_first_token(self, ttft_s: float):
        self.ttft_s.add(ttft_s)

    def on_token(self):
        self.tokens_out += 1

    def on_token_gap(self, gap_s: float, n: int = 1):
        """``n`` output tokens of one sequence arrived ``gap_s`` apart:
        a verify step that emits several tokens spreads its wall time
        over them instead of reporting zero gaps."""
        for _ in range(int(n)):
            self.tpot_s.add(gap_s)

    def on_finish(self):
        """One request finished ok."""
        self.requests_finished += 1
        self.on_terminal(OK)

    def on_terminal(self, reason: str):
        """One count per request outcome (``robustness.TERMINAL_REASONS``)."""
        self.terminal[reason] = self.terminal.get(reason, 0) + 1

    def on_shed(self, cause: str):
        """A request refused at admission (it never became a Sequence);
        ``cause``: queue_full, est_delay, max_context, pool_capacity or
        draining."""
        self.sheds[cause] = self.sheds.get(cause, 0) + 1
        self.on_terminal(SHED)

    def on_step_failure(self, phase: str):
        """An exception escaped one plan component (prefill, decode) or
        planning itself (schedule)."""
        self.step_failures[phase] = self.step_failures.get(phase, 0) + 1

    def on_hung_step(self):
        self.hung_steps += 1

    def on_tokens_computed(self, n: int):
        """n context tokens had their K/V computed this step (prefill
        chunks, decode rows, and recomputation after a preemption)."""
        self.tokens_computed += int(n)

    def on_spec_tokens(self, kept: int, rejected: int):
        """One verify row's compute: ``kept`` positions whose K/V
        survives and ``rejected`` positions past the accepted point,
        whose K/V was rewound."""
        self.tokens_computed += int(kept) + int(rejected)

    def on_spec_verify(self, proposed: int, accepted: int):
        """One sequence's verify outcome: draft tokens judged and kept
        (before eos or the length limit cut the emission short)."""
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)

    def on_spec_step(self, accepted_tokens: int):
        """Accepted draft tokens across one engine step's verify rows."""
        self.spec_step_tokens.add(float(accepted_tokens))

    def on_prefix(self, hits, hit_tokens, miss_tokens, cow, cached_blocks):
        """The pool's prefix-cache counters since the last step."""
        self.prefix_hits += int(hits)
        self.prefix_hit_tokens += int(hit_tokens)
        self.prefix_miss_tokens += int(miss_tokens)
        self.cow_copies += int(cow)
        self.prefix_cached_blocks = int(cached_blocks)

    def on_host_tier(self, hits, hit_tokens, spills, evictions,
                     restore_failures, *, blocks, nbytes):
        """The pool's host-tier counters since the last step, and the
        tier's current residency."""
        self.host_tier_hits += int(hits)
        self.host_tier_hit_tokens += int(hit_tokens)
        self.host_tier_spills += int(spills)
        self.host_tier_evictions += int(evictions)
        self.host_tier_restore_failures += int(restore_failures)
        self.host_tier_blocks = int(blocks)
        self.host_tier_bytes = int(nbytes)

    @property
    def prefix_hit_rate(self) -> float | None:
        """Cached over cacheable tokens; None before any lookup."""
        total = self.prefix_hit_tokens + self.prefix_miss_tokens
        return None if total <= 0 else self.prefix_hit_tokens / total

    @property
    def spec_accept_rate(self) -> float | None:
        """Accepted over proposed draft tokens; None before a proposal."""
        if self.spec_proposed <= 0:
            return None
        return self.spec_accepted / self.spec_proposed

    def on_preempt(self):
        self.preemptions += 1

    def on_phases(self, phases: dict):
        for p in STEP_PHASES:
            self.phase_seconds[p] += float(phases.get(p, 0.0))

    def on_step(self, *, decode_slots, total_slots, pool_utilization):
        self.steps += 1
        self._decode_slot_steps += int(decode_slots)
        self._slot_steps += int(total_slots)
        self._pool_util_sum += float(pool_utilization)

    @property
    def mean_batch_occupancy(self) -> float:
        return self._decode_slot_steps / max(self._slot_steps, 1)

    @property
    def mean_pool_utilization(self) -> float:
        return self._pool_util_sum / max(self.steps, 1)

    def snapshot(self) -> dict:
        return {
            "requests_arrived": self.requests_arrived,
            "requests_finished": self.requests_finished,
            "tokens_out": self.tokens_out,
            "tokens_computed": self.tokens_computed,
            "preemptions": self.preemptions,
            "pool_oom_events": self.pool_oom_events,
            "terminal_reasons": dict(self.terminal),
            "sheds": dict(self.sheds),
            "step_failures": dict(self.step_failures),
            "hung_steps": self.hung_steps,
            "steps": self.steps,
            "phase_seconds": dict(self.phase_seconds),
            "mean_batch_occupancy": self.mean_batch_occupancy,
            "mean_pool_utilization": self.mean_pool_utilization,
            "ttft_count": self.ttft_s.count,
            "tpot_count": self.tpot_s.count,
            "ttft_p50_s": self.ttft_s.percentile(50),
            "ttft_p95_s": self.ttft_s.percentile(95),
            "tpot_p50_s": self.tpot_s.percentile(50),
            "tpot_p95_s": self.tpot_s.percentile(95),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_miss_tokens": self.prefix_miss_tokens,
            "prefix_hit_rate": self.prefix_hit_rate,
            "cow_copies": self.cow_copies,
            "prefix_cached_blocks": self.prefix_cached_blocks,
            "host_tier_hits": self.host_tier_hits,
            "host_tier_hit_tokens": self.host_tier_hit_tokens,
            "host_tier_spills": self.host_tier_spills,
            "host_tier_evictions": self.host_tier_evictions,
            "host_tier_restore_failures": self.host_tier_restore_failures,
            "host_tier_blocks": self.host_tier_blocks,
            "host_tier_bytes": self.host_tier_bytes,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": self.spec_accept_rate,
            "spec_steps": self.spec_step_tokens.count,
            "spec_tokens_per_step_p50": self.spec_step_tokens.percentile(50),
            "spec_tokens_per_step_p95": self.spec_step_tokens.percentile(95),
        }
