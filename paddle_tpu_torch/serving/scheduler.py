"""Continuous-batching scheduler (port of ``serving/scheduler.py``):
token-budgeted FCFS admission, chunked prefill interleaved with decode,
preemption by recompute, prefix-cache lookups and speculative lookahead.

One engine step = one :meth:`Scheduler.schedule` call:

- DECODE every RUNNING sequence (one token each), planned first;
- PREFILL one chunk of the oldest sequence that still needs context,
  sized ``min(prefill_chunk, budget - decodes, remaining)``;
- ADMIT waiting sequences into free slots (FCFS) before planning;
- SPECULATE: with a lookahead oracle (``spec_k``), what the token budget
  has left after decode and prefill funds draft tokens per decoding
  sequence (``StepPlan.spec``), FCFS, each count halved until the pool
  can hold it without preempting anyone.

Preemption by recompute: when the pool is exhausted the NEWEST active
sequence holding blocks is evicted: its blocks are freed, its context
cursor rewinds to zero, and it re-enters the waiting queue at the
FRONT. On re-admission its prompt AND already sampled tokens are
re-prefilled, so decoding continues where it stopped. The oldest
active sequence is never preempted, so it can always take the whole
pool: no deadlock. Each exhaustion is reported through
``distributed/watchdog.report_degraded``
(``serving.scheduler.pool_exhausted``), and a rewind records its cause
on the Sequence for the goodput ledger.

Prefix caching (``kv_pool.py``): admission makes the BINDING prefix
lookup. A sequence about to prefill with no blocks acquires the longest
resident full-block prefix of its tokens and moves ``ctx`` past it, so
its prefill starts after the shared prefix (a preemption replay thus
re-acquires the blocks its own rewind just cached). A chunk that starts
inside a shared block reserves its copy-on-write block when planned.
Under pool pressure, waiting sequences that pin prefix refs release them
before any active sequence is preempted, which keeps the no-deadlock
argument. With the host tier on, the binding lookup may restore host
blocks (``KVBlockPool.acquire_prefix``), noted as a ``host_restore``
event.

The engine's robustness paths (``robustness.py``) finish a sequence from
wherever it is with :meth:`Scheduler.remove` (expiry, cancel,
quarantine) and replay a failed one with :meth:`Scheduler.recompute`,
the same rewind as a preemption, charged to ``Sequence.retries``.
"""

from __future__ import annotations

from collections import deque, namedtuple

import numpy as np

from .kv_pool import PoolOOM
from .robustness import note_event, now_s

WAITING = "waiting"
PREFILL = "prefill"
RUNNING = "running"
FINISHED = "finished"

StepPlan = namedtuple("StepPlan", ["decode", "prefill", "preempted",
                                   "spec"])


class Sequence:
    """One in-flight request: prompt + sampled tokens + cache cursor.

    ``tokens`` is prompt + output; ``ctx`` counts tokens whose KV is in
    the pool. While RUNNING, ``ctx == len(tokens) - 1`` (the newest
    token is fed to the next decode step); PREFILL drives ``ctx`` up to
    ``len(tokens)`` in chunks, and the chunk that reaches it yields the
    logits the next token is sampled from."""

    __slots__ = ("req_id", "prompt_len", "tokens", "output", "ctx",
                 "state", "max_new_tokens", "temperature", "top_k",
                 "top_p", "eos_token_id", "rng", "arrival_s",
                 "first_token_s", "last_token_s", "finish_s",
                 "finish_reason", "outcome", "preemptions", "deadline_s",
                 "retries", "events", "events_dropped", "computed_hw",
                 "rewind_cause", "tok_fresh", "tok_replay_preempt",
                 "tok_replay_retry", "spec_off", "spec_hist",
                 "tok_spec_accepted", "tok_spec_rejected")

    def __init__(self, req_id, prompt, *, max_new_tokens, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=0,
                 arrival_s=None, deadline_s=None):
        self.req_id = int(req_id)
        self.tokens = [int(t) for t in prompt]
        self.prompt_len = len(self.tokens)
        if self.prompt_len < 1:
            raise ValueError("empty prompt")
        self.output: list[int] = []
        self.ctx = 0
        self.state = WAITING
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p if top_p is not None else 1.0)
        self.eos_token_id = eos_token_id
        self.rng = np.random.default_rng(seed)
        self.arrival_s = now_s() if arrival_s is None else float(arrival_s)
        # absolute monotonic deadline; deadline_s is SECONDS FROM ARRIVAL
        # (a back-dated arrival_s shortens what is left)
        self.deadline_s = (None if deadline_s is None
                           else self.arrival_s + float(deadline_s))
        self.first_token_s = None
        self.last_token_s = None
        self.finish_s = None
        self.finish_reason = None
        # terminal reason (robustness.TERMINAL_REASONS) once finished,
        # None in flight
        self.outcome = None
        self.preemptions = 0
        self.retries = 0          # step-failure recompute attempts
        # bounded lifecycle timeline (robustness.note_event): empty
        # while FLAGS_telemetry is off
        self.events: list[dict] = []
        self.events_dropped = 0
        # goodput ledger (metrics.py): the computed-context high water,
        # the cause of the latest rewind, and per-kind token counts
        # classified into serving_tokens_total{kind=} at the end
        self.computed_hw = 0
        self.rewind_cause = None       # None | "preempt" | "retry"
        self.tok_fresh = 0             # computed for the first time
        self.tok_replay_preempt = 0    # recomputed after a preemption
        self.tok_replay_retry = 0      # recomputed after a step failure
        # speculative decoding (speculation.py): spec_off keeps the
        # sequence on plain decode for the rest of its life; spec_hist
        # is the rolling (proposed, accepted) window adaptive lookahead
        # reads
        self.spec_off = False
        self.spec_hist: list[tuple[int, int]] = []
        # accepted and rejected draft positions, the ledger's
        # spec_accepted and spec_rejected kinds
        self.tok_spec_accepted = 0
        self.tok_spec_rejected = 0

    @property
    def output_ids(self) -> list[int]:
        return list(self.output)

    @property
    def is_finished(self) -> bool:
        return self.state == FINISHED

    @property
    def prefill_target(self) -> int:
        return len(self.tokens)

    def __repr__(self):
        return (f"Sequence(id={self.req_id}, state={self.state}, "
                f"ctx={self.ctx}/{len(self.tokens)}, "
                f"out={len(self.output)}/{self.max_new_tokens})")


class Scheduler:
    """Owns the waiting queue and the active set; plans one step."""

    def __init__(self, pool, *, max_slots, prefill_chunk, token_budget,
                 spec_k=None):
        if max_slots < 1 or prefill_chunk < 1 or token_budget < 1:
            raise ValueError("max_slots, prefill_chunk and token_budget "
                             "must all be >= 1")
        self.pool = pool
        self.max_slots = int(max_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.token_budget = int(token_budget)
        # the lookahead oracle (engine.SpecPlan): draft tokens a
        # RUNNING sequence wants this step; None = speculation off
        self.spec_k = spec_k
        self.waiting: deque[Sequence] = deque()
        self.active: list[Sequence] = []

    def add(self, seq: Sequence) -> None:
        seq.state = WAITING
        self.waiting.append(seq)

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def remove(self, seq: Sequence) -> None:
        """Terminal removal from WHEREVER the sequence is (waiting
        queue, active set, or neither): a request's end (eos or length)
        and the engine's expiry, cancel and quarantine paths. Its blocks
        and prefix refs are always freed."""
        seq.state = FINISHED
        if seq in self.active:
            self.active.remove(seq)
        elif seq in self.waiting:
            self.waiting.remove(seq)
        self.pool.free_seq(seq.req_id)

    def schedule(self) -> StepPlan:
        preempted: list[Sequence] = []
        while self.waiting and len(self.active) < self.max_slots:
            seq = self.waiting.popleft()
            seq.state = PREFILL if seq.ctx < seq.prefill_target else RUNNING
            self.active.append(seq)
        # FCFS by arrival: a preempted sequence re-admits at the END of
        # the append order but keeps its age-based priority
        self.active.sort(key=lambda s: s.req_id)

        decode: list[Sequence] = []
        for seq in list(self.active):
            if seq.state != RUNNING:
                continue
            if not self._make_room(seq, seq.ctx + 1, preempted):
                continue                     # seq itself was evicted
            decode.append(seq)

        budget = self.token_budget - len(decode)
        prefill = None
        if budget > 0:
            cand = next((s for s in self.active if s.state == PREFILL),
                        None)
            if cand is not None:
                if (self.pool.prefix_cache and cand.ctx == 0
                        and not self.pool.holds(cand.req_id)):
                    # the binding prefix lookup, just before compute:
                    # rewound sequences and arrivals whose add_request
                    # probe missed (an identical prompt may have
                    # prefilled since) hit here
                    c = self.pool.acquire_prefix(cand.req_id, cand.tokens)
                    if c:
                        cand.ctx = c
                        note_event(cand, "prefix_hit", tokens=c)
                        restored = self.pool.take_last_restored()
                        if restored:
                            note_event(cand, "host_restore",
                                       tokens=restored)
                n = min(self.prefill_chunk, budget,
                        cand.prefill_target - cand.ctx)
                # a chunk starting inside a SHARED acquired block copies
                # it on write: reserve that block now
                if n > 0 and self._make_room(cand, cand.ctx + n, preempted,
                                             cow_start=cand.ctx, cow_len=n):
                    prefill = (cand, cand.ctx, n)

        # a preemption while planning the prefill may have evicted a
        # member of the decode set; it holds no blocks anymore
        decode = [s for s in decode if s.state == RUNNING]

        # draft rows are priced against the same token budget as the
        # prefill chunk. They never preempt and never count an OOM
        # event: can_extend probes first, and a pool too tight for a
        # guess halves it (down to 0)
        spec: dict[int, int] = {}
        if self.spec_k is not None and decode:
            left = self.token_budget - len(decode) - (
                0 if prefill is None else prefill[2])
            for seq in decode:
                if left <= 0:
                    break
                k = min(int(self.spec_k(seq)), left)
                while k > 0:
                    reserve = self.pool.cow_need(seq.req_id, seq.ctx, 1 + k)
                    if self.pool.can_extend(seq.req_id, seq.ctx + 1 + k,
                                            reserve=reserve):
                        self.pool.ensure(seq.req_id, seq.ctx + 1 + k,
                                         reserve=reserve)
                        spec[seq.req_id] = k
                        left -= k
                        break
                    k //= 2
        return StepPlan(decode, prefill, preempted, spec)

    def _make_room(self, needy: Sequence, n_tokens: int,
                   preempted: list[Sequence], cow_start: int | None = None,
                   cow_len: int = 1) -> bool:
        """ensure() with preemption by recompute. Returns False when
        ``needy`` itself had to be evicted; raises PoolOOM only when a
        LONE sequence cannot fit, which the engine's admission check
        makes unreachable for accepted requests.

        Victims, cheapest first: a WAITING sequence pinning prefix refs
        (releasing them recomputes nothing), then the newest ACTIVE
        block holder. A victim whose blocks are shared frees less than
        its table, so one allocation may take several victims; each
        round lowers the total refcount, so the loop ends.
        ``cow_start``/``cow_len`` also reserve the copy-on-write blocks
        of the planned write, counted again each round (preempting the
        other sharer can remove the need)."""
        while True:
            reserve = (0 if cow_start is None
                       else self.pool.cow_need(needy.req_id, cow_start,
                                               cow_len))
            try:
                self.pool.ensure(needy.req_id, n_tokens, reserve=reserve)
                return True
            except PoolOOM as e:
                from ..distributed.watchdog import report_degraded
                report_degraded("serving.scheduler.pool_exhausted", e)
                holders = [s for s in self.waiting
                           if self.pool.holds(s.req_id)]
                if holders:
                    self._release_prefix(
                        max(holders, key=lambda s: s.req_id))
                    continue
                # only sequences that HOLD blocks are useful victims
                victims = [s for s in self.active
                           if s is not needy and self.pool.holds(s.req_id)]
                if not victims:
                    raise
                victim = max(victims, key=lambda s: s.req_id)
                if victim.req_id < needy.req_id:
                    # everyone left is OLDER: the newer needy one yields
                    self._preempt(needy, preempted)
                    return False
                self._preempt(victim, preempted)

    def _release_prefix(self, seq: Sequence) -> None:
        """Drop a WAITING sequence's acquired prefix refs under pool
        pressure: the blocks stay cached while unreferenced elsewhere,
        its cursor rewinds to zero, and it keeps its place in the
        queue; admission re-acquires what survives."""
        self.pool.free_seq(seq.req_id)
        seq.ctx = 0
        note_event(seq, "prefix_released")

    def _preempt(self, seq: Sequence, preempted: list[Sequence]) -> None:
        ctx_discarded = seq.ctx
        self._rewind(seq)
        seq.preemptions += 1
        seq.rewind_cause = "preempt"
        note_event(seq, "preempted", ctx=ctx_discarded,
                   preemptions=seq.preemptions)
        preempted.append(seq)

    def recompute(self, seq: Sequence) -> None:
        """Step-failure replay (``robustness.handle_step_failure``): the
        SAME rewind as preemption by recompute (blocks freed, cursor back
        to zero, front of the waiting queue, so the prompt + output
        replay resumes decoding where it stopped), accounted on
        ``seq.retries`` by the caller, not on ``seq.preemptions``. The
        replayed tokens are charged to the goodput ledger's
        ``recompute_replay`` kind."""
        self._rewind(seq)
        seq.rewind_cause = "retry"

    def _rewind(self, seq: Sequence) -> None:
        self.pool.free_seq(seq.req_id)
        seq.ctx = 0
        seq.state = WAITING
        if seq in self.active:
            self.active.remove(seq)
        self.waiting.appendleft(seq)   # resumes first once blocks free
