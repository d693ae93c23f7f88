"""Serving metrics (port of ``serving/metrics.py``: a subset, without the
telemetry registry).

- TTFT (time to first token): arrival -> first sampled token.
- TPOT (time per output token): inter-arrival of each output token
  after the first, recorded by the step that emitted it.
- Engine steps, output and computed tokens, decode-batch occupancy,
  pool utilisation, preemptions, and per-step phase seconds
  (schedule / prefill / decode / sample / other).

Timestamps are host wall-clock (``robustness.now_s``) taken around the
step; a device phase's seconds include waiting for the device, since the
step reads its logits back to the host. TTFT/TPOT samples live in
fixed-size reservoirs, so a long run keeps flat memory while the counts
stay exact.
"""

from __future__ import annotations

import random

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
        self.steps = 0
        self.phase_seconds = dict.fromkeys(STEP_PHASES, 0.0)
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

    def on_token_gap(self, gap_s: float):
        self.tpot_s.add(gap_s)

    def on_finish(self):
        self.requests_finished += 1

    def on_tokens_computed(self, n: int):
        """n context tokens had their K/V computed this step (prefill
        chunks, decode rows, and recomputation after a preemption)."""
        self.tokens_computed += int(n)

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
        }
