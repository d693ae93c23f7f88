"""Continuous-batching scheduler (port of ``serving/scheduler.py``):
token-budgeted FCFS admission, chunked prefill interleaved with decode,
preemption by recompute.

One engine step = one :meth:`Scheduler.schedule` call:

- DECODE every RUNNING sequence (one token each), planned first;
- PREFILL one chunk of the oldest sequence that still needs context,
  sized ``min(prefill_chunk, budget - decodes, remaining)``;
- ADMIT waiting sequences into free slots (FCFS) before planning.

Preemption by recompute: when the pool is exhausted the NEWEST active
sequence holding blocks is evicted: its blocks are freed, its context
cursor rewinds to zero, and it re-enters the waiting queue at the
FRONT. On re-admission its prompt AND already sampled tokens are
re-prefilled, so decoding continues where it stopped. The oldest
active sequence is never preempted, so it can always take the whole
pool: no deadlock.

Not ported yet: prefix-cache lookups, copy-on-write reservations and
speculative verify rows.
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

StepPlan = namedtuple("StepPlan", ["decode", "prefill", "preempted"])


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
                 "finish_reason", "outcome", "preemptions", "events",
                 "events_dropped")

    def __init__(self, req_id, prompt, *, max_new_tokens, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=0,
                 arrival_s=None):
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
        self.first_token_s = None
        self.last_token_s = None
        self.finish_s = None
        self.finish_reason = None
        self.outcome = None
        self.preemptions = 0
        self.events: list[dict] = []
        self.events_dropped = 0

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

    def __init__(self, pool, *, max_slots, prefill_chunk, token_budget):
        if max_slots < 1 or prefill_chunk < 1 or token_budget < 1:
            raise ValueError("max_slots, prefill_chunk and token_budget "
                             "must all be >= 1")
        self.pool = pool
        self.max_slots = int(max_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.token_budget = int(token_budget)
        self.waiting: deque[Sequence] = deque()
        self.active: list[Sequence] = []

    def add(self, seq: Sequence) -> None:
        seq.state = WAITING
        self.waiting.append(seq)

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def finish(self, seq: Sequence) -> None:
        seq.state = FINISHED
        if seq in self.active:
            self.active.remove(seq)
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
                n = min(self.prefill_chunk, budget,
                        cand.prefill_target - cand.ctx)
                if n > 0 and self._make_room(cand, cand.ctx + n, preempted):
                    prefill = (cand, cand.ctx, n)

        # a preemption while planning the prefill may have evicted a
        # member of the decode set; it holds no blocks anymore
        decode = [s for s in decode if s.state == RUNNING]
        return StepPlan(decode, prefill, preempted)

    def _make_room(self, needy: Sequence, n_tokens: int,
                   preempted: list[Sequence]) -> bool:
        """ensure() with preemption by recompute. Returns False when
        ``needy`` itself had to be evicted; raises PoolOOM only when a
        LONE sequence cannot fit, which the engine's admission check
        makes unreachable for accepted requests."""
        while True:
            try:
                self.pool.ensure(needy.req_id, n_tokens)
                return True
            except PoolOOM:
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

    def _preempt(self, seq: Sequence, preempted: list[Sequence]) -> None:
        ctx_discarded = seq.ctx
        self.pool.free_seq(seq.req_id)
        seq.ctx = 0
        seq.state = WAITING
        if seq in self.active:
            self.active.remove(seq)
        self.waiting.appendleft(seq)   # resumes first once blocks free
        seq.preemptions += 1
        note_event(seq, "preempted", ctx=ctx_discarded,
                   preemptions=seq.preemptions)
        preempted.append(seq)
