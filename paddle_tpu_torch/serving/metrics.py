"""Serving metrics (port of ``serving/metrics.py``): request latency,
engine occupancy, the goodput ledger and the telemetry families.

- TTFT (time to first token): arrival -> first sampled token.
- TPOT (time per output token): the inter-arrival of each output token
  after the first, recorded by the STEP that emitted it (a verify step
  accepting several drafts spreads its wall time over the burst).
- Queue depth, decode-batch occupancy and pool utilisation per step.
- Per-step phase seconds (``schedule/prefill/decode/sample/other``), and
  the decode roofline: model bytes over the decode phase's seconds as a
  share of the HBM peak the engine was given (``hbm_peak_gbs``).
- Prefix cache (hits, hit and miss tokens, copy-on-write copies, cached
  blocks) and host tier (restore hits and tokens, spills, evictions,
  restore failures, blocks, bytes), synced from the pool once a step.
- Speculative decoding: draft tokens proposed and accepted per proposer,
  accepted tokens per engine step.
- Robustness (``robustness.py``): one count per request outcome in
  ``terminal`` (``serving_terminal_total{reason=}``: ok, expired,
  cancelled, shed, failed), sheds by cause (``serving_shed_total``),
  step failures by phase (``serving_step_failures_total``) and hung-step
  trips. With ``FLAGS_serving_ttft_slo_s``/``FLAGS_serving_tpot_slo_s``
  set, requests over target count into ``serving_slo_miss_total{slo=}``.
- The goodput ledger: every token of model work is COUNTED when its K/V
  is computed (``tokens_computed``) and CLASSIFIED when its request ends
  (``resolve_ledger``) into exactly one kind of
  ``serving_tokens_total{kind=}``: an ok request's first-pass tokens are
  ``goodput``, re-prefilled tokens after a preemption
  ``preempt_reprefill`` and after a step-failure replay
  ``recompute_replay``, an expired or cancelled request's first-pass
  tokens ``expired_partial`` and a quarantined one's ``failed``;
  accepted drafts are ``spec_accepted`` and rejected ones
  ``spec_rejected``. A handoff books the source's tokens when it lets
  the request go (``resolve_handoff``), a live migration's under
  ``migrated`` (``serving/fleet/migrate.py``). Once every request is terminal
  the kinds sum EXACTLY to ``tokens_computed``; ``serving_goodput_ratio``
  is delivered work over everything classified so far.
- The attention-bytes ledger (``serving_attn_bytes_total{kind=touched|
  dense}``): per dispatch, the unique context K/V bytes the paged attend
  addresses through the block tables against the dense static-buffer
  re-read of the same rows; ``attn_bytes_frac`` in the snapshot.

Timestamps are host wall-clock (``robustness.now_s``) taken around the
step; a device phase's seconds include waiting for the device, since the
step reads its logits back to the host. TTFT/TPOT samples live in
fixed-size reservoirs (``telemetry.Reservoir``, capacity
``FLAGS_telemetry_reservoir``, the JAX package's seeds), so a long run
keeps flat memory while counts and sums stay exact. Every update also
publishes into the process registry under the JAX package's ``serving_*``
names and labels: a guarded no-op while ``FLAGS_telemetry`` is off.
"""

from __future__ import annotations

from .. import telemetry
from ..flags import flag_value
from .robustness import CANCELLED, EXPIRED, FAILED, OK, SHED

# goodput-ledger token kinds (serving_tokens_total{kind=}).
# Speculative decoding adds two: an ACCEPTED draft position is a
# delivered token that skipped a decode step (spec_accepted — counted
# as goodput in the ratio), a REJECTED draft position is compute whose
# K/V was rewound (spec_rejected — the price of guessing wrong). The
# kinds still sum EXACTLY to tokens_computed once every request is
# terminal.
GOODPUT = "goodput"
RECOMPUTE_REPLAY = "recompute_replay"
PREEMPT_REPREFILL = "preempt_reprefill"
EXPIRED_PARTIAL = "expired_partial"
FAILED_TOKENS = "failed"
SPEC_ACCEPTED = "spec_accepted"
SPEC_REJECTED = "spec_rejected"
MIGRATED = "migrated"
LEDGER_KINDS = (GOODPUT, RECOMPUTE_REPLAY, PREEMPT_REPREFILL,
                EXPIRED_PARTIAL, FAILED_TOKENS, SPEC_ACCEPTED,
                SPEC_REJECTED, MIGRATED)

# what an OK/expired/cancelled/failed request's FIRST-PASS tokens
# resolve to (replayed tokens keep their replay kind regardless)
_FRESH_KIND_BY_OUTCOME = {OK: GOODPUT, EXPIRED: EXPIRED_PARTIAL,
                          CANCELLED: EXPIRED_PARTIAL,
                          FAILED: FAILED_TOKENS}

STEP_PHASES = ("schedule", "prefill", "decode", "sample", "other")


def _pct(res, q):
    v = res.percentile(q)
    return None if v is None else float(v)


class ServingMetrics:
    """Counters + latency reservoirs for one ServingEngine."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.requests_arrived = 0
        self.requests_finished = 0
        self.tokens_out = 0
        self.preemptions = 0
        self.pool_oom_events = 0
        # SLO/robustness accounting (serving/robustness.py): terminal
        # reason per finished-or-shed request, shed causes, step
        # failures per phase, hung-step trips — all bounded-cardinality
        # dicts (reasons/causes/phases are small fixed vocabularies)
        self.terminal: dict[str, int] = {}
        self.sheds: dict[str, int] = {}
        self.step_failures: dict[str, int] = {}
        self.hung_steps = 0
        # goodput ledger: tokens counted at compute time, classified
        # at terminal time (module docstring); kinds sum to
        # tokens_computed once every request is terminal. A reset
        # (interval snapshotting) carries the tokens of still-in-
        # flight sequences forward — their terminal resolve will fold
        # their FULL lifetime counts into the new interval's ledger,
        # so the sum invariant must start the interval already owing
        # them (computed-but-unclassified so far), not at zero
        pending = (getattr(self, "tokens_computed", 0)
                   - sum(getattr(self, "ledger", {}).values()))
        self.tokens_computed = max(0, pending)
        self.ledger: dict[str, int] = {}
        # per-phase step-time attribution + decode roofline fraction
        self.phase_seconds: dict[str, float] = {p: 0.0
                                                for p in STEP_PHASES}
        self._roofline_sum = 0.0
        self._roofline_steps = 0
        # SLO attainment (FLAGS_serving_ttft_slo_s/_tpot_slo_s; both
        # dicts stay empty while the flags are 0)
        self.slo_checked: dict[str, int] = {}
        self.slo_missed: dict[str, int] = {}
        # prefix-cache effectiveness (serving/kv_pool.py): hits and
        # hit/miss token splits mirrored from the pool's counters once
        # per engine step, COW duplications, and the cached-block
        # gauge's last value — all bounded scalars
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.cow_copies = 0
        self.prefix_cached_blocks = 0
        # host-tier traffic (serving/host_tier.py), mirrored from the
        # pool once per step exactly like the prefix counters above;
        # the blocks/bytes gauges track the tier's current residency
        self.host_tier_hits = 0
        self.host_tier_hit_tokens = 0
        self.host_tier_spills = 0
        self.host_tier_evictions = 0
        self.host_tier_restore_failures = 0
        self.host_tier_blocks = 0
        self.host_tier_bytes = 0
        # attention-bytes ledger (engine._note_attn_bytes): K/V bytes
        # the paged attend actually streams per dispatch vs what the
        # dense static-buffer path would re-read for the same rows —
        # the paged kernel's bandwidth story as a number
        self.attn_bytes_touched = 0
        self.attn_bytes_dense = 0
        # speculative decoding (serving/speculation.py): proposed and
        # accepted draft-token totals plus the accepted-tokens-per-
        # verify-step distribution — the numbers that say whether
        # speculation is paying for its verify rows
        self.spec_proposed = 0
        self.spec_accepted = 0
        cap = int(flag_value("telemetry_reservoir"))
        self.spec_step_tokens = telemetry.Reservoir(cap, seed=3)
        self.ttft_s = telemetry.Reservoir(cap, seed=1)
        self.tpot_s = telemetry.Reservoir(cap, seed=2)
        self.steps = 0
        self._decode_slot_steps = 0     # sum of busy decode slots
        self._slot_steps = 0            # sum of total slots
        self._queue_depth_sum = 0
        self._pool_util_sum = 0.0

    # -- request lifecycle -------------------------------------------------
    def on_arrival(self):
        self.requests_arrived += 1
        telemetry.counter("serving_requests_total").inc()

    def on_first_token(self, ttft_s: float):
        self.ttft_s.add(float(ttft_s))
        telemetry.histogram("serving_ttft_seconds").observe(float(ttft_s))
        self._check_slo("ttft", float(ttft_s),
                        float(flag_value("serving_ttft_slo_s")))

    def on_token(self):
        # delivered-output count; the telemetry serving_tokens_total
        # family is the COMPUTED-token ledger (resolve_ledger), so the
        # raw emission count stays engine-local here
        self.tokens_out += 1

    def on_token_gap(self, gap_s: float, n: int = 1):
        """``n`` output tokens of one sequence arrived ``gap_s``
        apart — the TPOT sample stream. Recorded by the STEP that
        emitted the tokens (engine._note_token_gaps), not averaged per
        request at finish: a speculative verify step accepting several
        drafts emits them in one burst, and dividing the step's wall
        over them keeps TPOT honest instead of reporting zero gaps
        (or, at finish-time averaging, hiding the burst entirely)."""
        gap_s = float(gap_s)
        for _ in range(int(n)):
            self.tpot_s.add(gap_s)
            telemetry.histogram("serving_tpot_seconds").observe(gap_s)

    def on_finish(self, tpot_slo_s: float | None = None):
        """One request finished ok. ``tpot_slo_s`` is the request's
        MEAN inter-token gap, used only for the SLO attainment check —
        the TPOT percentile stream is fed per token via
        :meth:`on_token_gap`."""
        self.requests_finished += 1
        telemetry.counter("serving_finished_total").inc()
        self.on_terminal(OK)
        if tpot_slo_s is not None:
            self._check_slo("tpot", float(tpot_slo_s),
                            float(flag_value("serving_tpot_slo_s")))

    def _check_slo(self, which: str, value_s: float, target_s: float):
        if target_s <= 0.0:
            return
        self.slo_checked[which] = self.slo_checked.get(which, 0) + 1
        if value_s > target_s:
            self.slo_missed[which] = self.slo_missed.get(which, 0) + 1
            telemetry.counter("serving_slo_miss_total",
                              labels={"slo": which}).inc()

    # -- goodput ledger -----------------------------------------------------
    def on_tokens_computed(self, seq, start: int, n: int):
        """``n`` context tokens [start, start+n) were computed for
        ``seq`` this step. Tokens at or above the sequence's computed
        high water are first-pass work; tokens below it are a REPLAY
        of work a rewind threw away, charged to the latest rewind's
        cause (preemption vs step-failure retry). Classification into
        the process ledger happens at terminal time."""
        n = int(n)
        if n <= 0:
            return
        self.tokens_computed += n
        replay = max(0, min(seq.computed_hw, start + n) - start)
        seq.tok_fresh += n - replay
        if replay:
            if seq.rewind_cause == "retry":
                seq.tok_replay_retry += replay
            else:
                seq.tok_replay_preempt += replay
        seq.computed_hw = max(seq.computed_hw, start + n)

    def on_spec_tokens(self, seq, start: int, kept: int, rejected: int):
        """One verify row's compute: ``kept`` positions
        [start, start+kept) whose K/V survives (the ordinary decode
        position plus the accepted drafts) and ``rejected`` positions
        past the accepted point whose K/V was rewound. The kept span
        rides :meth:`on_tokens_computed` (so replay-after-rewind
        classification keeps working), then all but one of its FRESH
        tokens move to the per-seq spec_accepted count — position
        ``start`` is the write a plain decode step would also have
        done, everything beyond it exists only because of
        speculation."""
        fresh0 = seq.tok_fresh
        self.on_tokens_computed(seq, start, kept)
        moved = max(0, (seq.tok_fresh - fresh0) - 1)
        if moved:
            seq.tok_fresh -= moved
            seq.tok_spec_accepted += moved
        rejected = int(rejected)
        if rejected > 0:
            # rejected positions never advance computed_hw: their K/V
            # is discarded, so a later write there is first-pass work,
            # not a replay
            self.tokens_computed += rejected
            seq.tok_spec_rejected += rejected

    def on_spec_verify(self, proposer: str, proposed: int,
                       accepted: int):
        """One sequence's verify outcome: ``proposed`` draft tokens
        judged, ``accepted`` kept (pre-truncation — the proposer-
        quality signal, independent of eos cutting the emission
        short)."""
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)
        telemetry.counter("serving_spec_proposed_total",
                          labels={"proposer": proposer}).inc(
                              int(proposed))
        telemetry.counter("serving_spec_accepted_total",
                          labels={"proposer": proposer}).inc(
                              int(accepted))

    def on_spec_step(self, accepted_tokens: int):
        """Accepted draft tokens across all verify rows of one engine
        step: the accepted-tokens-per-step distribution (p50/p95 from
        the reservoir)."""
        self.spec_step_tokens.add(float(accepted_tokens))
        telemetry.histogram("serving_spec_accepted_tokens").observe(
            float(accepted_tokens))

    @property
    def spec_accept_rate(self) -> float | None:
        """Accepted over proposed draft tokens; None before any
        proposal."""
        if self.spec_proposed <= 0:
            return None
        return self.spec_accepted / self.spec_proposed

    def resolve_ledger(self, seq):
        """Terminal classification: fold the sequence's per-class
        token counts into the engine ledger and the
        ``serving_tokens_total{kind=}`` telemetry family, then refresh
        ``serving_goodput_ratio``. Called exactly once per Sequence
        (every terminal path funnels through here). Accepted-draft
        tokens of a request that did NOT finish ok were never
        delivered — they fold into the outcome's fresh kind
        (expired_partial/failed) instead of spec_accepted; rejected
        drafts are waste regardless of outcome."""
        fresh_kind = _FRESH_KIND_BY_OUTCOME.get(seq.outcome,
                                                FAILED_TOKENS)
        self._ledger_add(fresh_kind, seq.tok_fresh)
        self._ledger_add(PREEMPT_REPREFILL, seq.tok_replay_preempt)
        self._ledger_add(RECOMPUTE_REPLAY, seq.tok_replay_retry)
        self._ledger_add(SPEC_ACCEPTED if seq.outcome == OK
                         else fresh_kind, seq.tok_spec_accepted)
        self._ledger_add(SPEC_REJECTED, seq.tok_spec_rejected)
        telemetry.gauge("serving_goodput_ratio").set(self.goodput_ratio)

    def resolve_handoff(self, seq, fresh_kind: str = GOODPUT):
        """Mid-stream handoff: this engine EXPORTED ``seq`` to another
        engine (a disaggregated prefill-to-decode handoff or a live
        migration, ``engine.release_handoff``), so the tokens
        it computed leave with the request and can never reach
        :meth:`resolve_ledger` here. Classify them NOW, on the engine
        that computed them, as delivered work (an export only happens
        for work the destination will keep — no recompute), then zero
        the per-seq counters so the importing engine's terminal
        resolve classifies ONLY the tokens it computes itself. Keeps
        both engines' sum invariant (ledger kinds == tokens_computed
        once in-flight work settles) intact. ``fresh_kind`` lets a
        live migration book the preserved first-pass tokens under
        ``migrated`` so goodput attribution distinguishes preserved
        work from an ordinary handoff."""
        self._ledger_add(fresh_kind, seq.tok_fresh)
        self._ledger_add(PREEMPT_REPREFILL, seq.tok_replay_preempt)
        self._ledger_add(RECOMPUTE_REPLAY, seq.tok_replay_retry)
        self._ledger_add(SPEC_ACCEPTED, seq.tok_spec_accepted)
        self._ledger_add(SPEC_REJECTED, seq.tok_spec_rejected)
        seq.tok_fresh = 0
        seq.tok_replay_preempt = 0
        seq.tok_replay_retry = 0
        seq.tok_spec_accepted = 0
        seq.tok_spec_rejected = 0
        telemetry.gauge("serving_goodput_ratio").set(self.goodput_ratio)

    def _ledger_add(self, kind: str, n: int):
        if n <= 0:
            return
        self.ledger[kind] = self.ledger.get(kind, 0) + n
        telemetry.counter("serving_tokens_total",
                          labels={"kind": kind}).inc(n)

    @property
    def goodput_ratio(self) -> float:
        """Delivered work (goodput + accepted speculation + tokens
        preserved across a live migration) over everything classified
        so far; 1.0 before any request reached a terminal outcome."""
        total = sum(self.ledger.values())
        if total <= 0:
            return 1.0
        return (self.ledger.get(GOODPUT, 0)
                + self.ledger.get(SPEC_ACCEPTED, 0)
                + self.ledger.get(MIGRATED, 0)) / total

    # -- phase attribution --------------------------------------------------
    def on_phases(self, phases: dict):
        """One observation per phase per engine step (zeros included,
        so the histogram counts stay comparable across phases)."""
        for phase in STEP_PHASES:
            s = float(phases.get(phase, 0.0))
            self.phase_seconds[phase] = (
                self.phase_seconds.get(phase, 0.0) + s)
            telemetry.histogram("serving_step_phase_seconds",
                                labels={"phase": phase}).observe(s)

    def on_decode_roofline(self, fraction: float):
        """Decode-phase achieved HBM bandwidth as a fraction of peak
        (engine-computed: model bytes / decode seconds / peak GB/s)."""
        self._roofline_sum += float(fraction)
        self._roofline_steps += 1
        telemetry.gauge("serving_decode_roofline_ratio").set(
            float(fraction))

    def on_prefix(self, hits, hit_tokens, miss_tokens, cow,
                  cached_blocks):
        """Per-step delta sync of the pool's prefix-cache counters
        (engine._step_inner): hit/miss token splits land in
        ``serving_prefix_tokens_total{kind=}``, hits in
        ``serving_prefix_hits_total``, copy-on-write duplications in
        ``serving_cow_copies_total``, and the zero-ref cached-block
        count in the ``serving_prefix_cached_blocks`` gauge."""
        if hits:
            self.prefix_hits += int(hits)
            telemetry.counter("serving_prefix_hits_total").inc(int(hits))
        if hit_tokens:
            self.prefix_hit_tokens += int(hit_tokens)
            telemetry.counter("serving_prefix_tokens_total",
                              labels={"kind": "hit"}).inc(int(hit_tokens))
        if miss_tokens:
            self.prefix_miss_tokens += int(miss_tokens)
            telemetry.counter("serving_prefix_tokens_total",
                              labels={"kind": "miss"}).inc(
                                  int(miss_tokens))
        if cow:
            self.cow_copies += int(cow)
            telemetry.counter("serving_cow_copies_total").inc(int(cow))
        self.prefix_cached_blocks = int(cached_blocks)
        telemetry.gauge("serving_prefix_cached_blocks").set(
            int(cached_blocks))

    def on_host_tier(self, hits, hit_tokens, spills, evictions,
                     restore_failures, *, blocks, nbytes):
        """Per-step delta sync of the pool's host-tier counters
        (engine._step_inner, only when the tier exists): restore hits
        in ``serving_host_tier_hits_total``, restored tokens in
        ``serving_host_tier_restored_tokens_total``, spill/eviction/
        restore-failure traffic in their ``_total`` families, and the
        tier's current residency in the ``serving_host_tier_blocks``/
        ``serving_host_tier_bytes`` gauges."""
        if hits:
            self.host_tier_hits += int(hits)
            telemetry.counter(
                "serving_host_tier_hits_total").inc(int(hits))
        if hit_tokens:
            self.host_tier_hit_tokens += int(hit_tokens)
            telemetry.counter(
                "serving_host_tier_restored_tokens_total").inc(
                    int(hit_tokens))
        if spills:
            self.host_tier_spills += int(spills)
            telemetry.counter(
                "serving_host_tier_spills_total").inc(int(spills))
        if evictions:
            self.host_tier_evictions += int(evictions)
            telemetry.counter(
                "serving_host_tier_evictions_total").inc(int(evictions))
        if restore_failures:
            self.host_tier_restore_failures += int(restore_failures)
            telemetry.counter(
                "serving_host_tier_restore_failures_total").inc(
                    int(restore_failures))
        self.host_tier_blocks = int(blocks)
        self.host_tier_bytes = int(nbytes)
        telemetry.gauge("serving_host_tier_blocks").set(int(blocks))
        telemetry.gauge("serving_host_tier_bytes").set(int(nbytes))

    def on_attn_bytes(self, touched: int, dense: int):
        """One paged-attention dispatch's K/V byte estimate (engine
        host arithmetic, ``engine._note_attn_bytes``):
        ``touched`` = unique context bytes addressed through the block
        tables (a lower bound on literal kernel DMA — see
        engine._note_attn_bytes), ``dense`` = the static
        ``[B, final_len]`` buffer re-read the dense path would cost
        for the same rows."""
        self.attn_bytes_touched += int(touched)
        self.attn_bytes_dense += int(dense)
        telemetry.counter("serving_attn_bytes_total",
                          labels={"kind": "touched"}).inc(int(touched))
        telemetry.counter("serving_attn_bytes_total",
                          labels={"kind": "dense"}).inc(int(dense))

    @property
    def attn_bytes_frac(self) -> float | None:
        """Paged over dense attention bytes across the run — < 1 means
        the block tables are saving bandwidth; None before any
        dispatch."""
        if self.attn_bytes_dense <= 0:
            return None
        return self.attn_bytes_touched / self.attn_bytes_dense

    @property
    def prefix_hit_rate(self) -> float | None:
        """Cached over cacheable tokens across the counted lookups;
        None before any lookup was counted."""
        total = self.prefix_hit_tokens + self.prefix_miss_tokens
        if total <= 0:
            return None
        return self.prefix_hit_tokens / total

    def on_terminal(self, reason: str):
        """One count per request outcome (robustness.TERMINAL_REASONS:
        ok|expired|cancelled|shed|failed) — the single place the SLO
        story of every request lands."""
        self.terminal[reason] = self.terminal.get(reason, 0) + 1
        telemetry.counter("serving_terminal_total",
                          labels={"reason": reason}).inc()

    def on_shed(self, cause: str):
        """A request refused at admission (never became a Sequence);
        ``cause`` is the shed policy that fired (queue_full/est_delay/
        max_context/pool_capacity/draining)."""
        self.sheds[cause] = self.sheds.get(cause, 0) + 1
        telemetry.counter("serving_shed_total",
                          labels={"cause": cause}).inc()
        self.on_terminal(SHED)

    def on_step_failure(self, phase: str):
        """An exception escaped one plan component (prefill/decode)
        or planning itself (schedule)."""
        self.step_failures[phase] = self.step_failures.get(phase, 0) + 1
        telemetry.counter("serving_step_failures_total",
                          labels={"phase": phase}).inc()

    def on_hung_step(self):
        self.hung_steps += 1
        telemetry.counter("serving_hung_steps_total").inc()

    def on_preempt(self):
        self.preemptions += 1
        telemetry.counter("serving_preemptions_total").inc()

    # -- engine step gauges ------------------------------------------------
    def on_step(self, *, decode_slots, total_slots, queue_depth,
                pool_utilization):
        self.steps += 1
        self._decode_slot_steps += int(decode_slots)
        self._slot_steps += int(total_slots)
        self._queue_depth_sum += int(queue_depth)
        self._pool_util_sum += float(pool_utilization)
        telemetry.counter("serving_engine_steps_total").inc()
        telemetry.gauge("serving_queue_depth").set(int(queue_depth))
        telemetry.gauge("serving_batch_occupancy").set(
            int(decode_slots) / max(int(total_slots), 1))
        telemetry.gauge("serving_pool_utilization").set(
            float(pool_utilization))

    # -- reporting ---------------------------------------------------------
    @property
    def mean_batch_occupancy(self) -> float:
        return self._decode_slot_steps / max(self._slot_steps, 1)

    @property
    def mean_queue_depth(self) -> float:
        return self._queue_depth_sum / max(self.steps, 1)

    @property
    def mean_pool_utilization(self) -> float:
        return self._pool_util_sum / max(self.steps, 1)

    @property
    def mean_decode_roofline(self) -> float | None:
        if self._roofline_steps == 0:
            return None
        return self._roofline_sum / self._roofline_steps

    def snapshot(self, reset: bool = False) -> dict:
        out = {
            "requests_arrived": self.requests_arrived,
            "requests_finished": self.requests_finished,
            "tokens_out": self.tokens_out,
            "preemptions": self.preemptions,
            "pool_oom_events": self.pool_oom_events,
            "terminal_reasons": dict(self.terminal),
            "sheds": dict(self.sheds),
            "step_failures": dict(self.step_failures),
            "hung_steps": self.hung_steps,
            "tokens_computed": self.tokens_computed,
            "token_ledger": dict(self.ledger),
            "goodput_ratio": round(self.goodput_ratio, 4),
            "phase_seconds": {p: round(s, 6)
                              for p, s in sorted(
                                  self.phase_seconds.items())},
            "decode_roofline_frac": (
                None if self.mean_decode_roofline is None
                else round(self.mean_decode_roofline, 4)),
            "slo_checked": dict(self.slo_checked),
            "slo_missed": dict(self.slo_missed),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_miss_tokens": self.prefix_miss_tokens,
            "prefix_hit_rate": (
                None if self.prefix_hit_rate is None
                else round(self.prefix_hit_rate, 4)),
            "cow_copies": self.cow_copies,
            "prefix_cached_blocks": self.prefix_cached_blocks,
            "host_tier_hits": self.host_tier_hits,
            "host_tier_hit_tokens": self.host_tier_hit_tokens,
            "host_tier_spills": self.host_tier_spills,
            "host_tier_evictions": self.host_tier_evictions,
            "host_tier_restore_failures": self.host_tier_restore_failures,
            "host_tier_blocks": self.host_tier_blocks,
            "host_tier_bytes": self.host_tier_bytes,
            "attn_bytes_touched": self.attn_bytes_touched,
            "attn_bytes_dense": self.attn_bytes_dense,
            "attn_bytes_frac": (
                None if self.attn_bytes_frac is None
                else round(self.attn_bytes_frac, 4)),
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": (
                None if self.spec_accept_rate is None
                else round(self.spec_accept_rate, 4)),
            "spec_steps": self.spec_step_tokens.count,
            "spec_tokens_per_step_p50": _pct(self.spec_step_tokens, 50),
            "spec_tokens_per_step_p95": _pct(self.spec_step_tokens, 95),
            "steps": self.steps,
            "mean_batch_occupancy": round(self.mean_batch_occupancy, 4),
            "mean_queue_depth": round(self.mean_queue_depth, 4),
            "mean_pool_utilization": round(self.mean_pool_utilization, 4),
            # exact totals from the reservoirs (the sample is bounded,
            # the bookkeeping is not)
            "ttft_count": self.ttft_s.count,
            "tpot_count": self.tpot_s.count,
            "ttft_p50_s": _pct(self.ttft_s, 50),
            "ttft_p95_s": _pct(self.ttft_s, 95),
            "ttft_p99_s": _pct(self.ttft_s, 99),
            "tpot_p50_s": _pct(self.tpot_s, 50),
            "tpot_p95_s": _pct(self.tpot_s, 95),
            "tpot_p99_s": _pct(self.tpot_s, 99),
        }
        if reset:
            self.reset()
        return out
