"""ServingEngine: request-level continuous batching (port of
``serving/engine.py``).

Callers ``add_request()`` at any time; ``step()`` advances every
admitted sequence by up to one token (decode) plus one prefill chunk,
and requests finish independently on eos or max tokens. K/V lives in
the paged block pool (``kv_pool.py``), attention runs through the
ragged paged kernel (``paged_attention.py``), and admission and
preemption are the scheduler's (``scheduler.py``).

Shapes stay as in the JAX package: decode always runs the full slot
batch ``[max_slots, 1]`` (idle slots ride along with length 0 and write
to the pool's scratch block) and prefill chunks pad up to power-of-two
buckets capped at ``prefill_chunk``. The model returns logits only at
each row's last valid position (``logits_rows``): the LM head is
row-wise, so those rows' numbers are the same as the full head's.

Sampling is per request and host-side: each step returns one f32
logits row per batch row, and each sequence applies its own
temperature/top-k/top-p with its own numpy Generator, so greedy and
seeded stochastic outputs match the JAX engine token for token.

Prefix caching (``kv_pool.py``, ``FLAGS_serving_prefix_cache``, on by
default as in the JAX package): ``add_request`` pins the resident
full-block prefix of the prompt by refcount, schedule admission makes
the binding lookup and moves the context cursor past the cached tokens,
and the first write into a still-shared block copies it on the device
(``gather_copy_blocks``) first. Greedy outputs are equal with caching on
or off.

Speculative decoding (``speculation.py``, ``FLAGS_serving_spec``, off by
default): a proposer drafts k tokens per decoding sequence and the
decode step becomes a batch of VERIFY rows ``[max_slots, W]`` (last
token + drafts, W the next power of two >= 1 + lookahead) whose logits
come back at every position; host-side lossless acceptance emits
accepted + 1 tokens per row, and ``pool.trim`` rewinds the rejected
positions. A step where no row drafts takes the plain ``[max_slots, 1]``
decode. Greedy outputs equal the dense path's.

Not ported yet: the host-RAM prefix tier (``host_tier`` raises),
deadlines and cancellation, load shedding and admission pricing,
step-failure quarantine (a failing proposer is not caught), drain and
health, telemetry, fleet hooks, and CUDA graphs for the decode
signature.
"""

from __future__ import annotations

import numpy as np
import torch

from ..flags import flag_value
from ..framework.device import resolve_device
from .kv_pool import KVBlockPool, PoolOOM
from .metrics import STEP_PHASES, ServingMetrics
from .paged_attention import gather_copy_blocks, paged_forward
from .robustness import OK, note_event, now_s
from .scheduler import RUNNING, Scheduler, Sequence
from .speculation import (SPEC_MODES, adaptive_k, build_proposer,
                          note_acceptance, processed_probs, verify_draft)


def sample_token(logits: np.ndarray, seq: Sequence) -> int:
    """Host-side per-request sampling over one f32 logits row:
    temperature <= 0 is argmax; otherwise temperature/top-k/top-p
    (``speculation.processed_probs``) and a draw from ``seq.rng``."""
    logits = np.asarray(logits, dtype=np.float32)
    if seq.temperature <= 0.0:
        return int(np.argmax(logits))
    p = processed_probs(logits, seq)
    return int(seq.rng.choice(len(p), p=p))


class ServingEngine:
    """Continuous-batching engine over a model exposing
    ``forward(ids, kv_caches=..., position_offset=..., logits_rows=...)
    -> (logits, caches)``. ``prefix_cache`` and ``spec`` default to their
    flags; ``spec="draft"`` needs ``draft_model``, a smaller model of the
    same vocabulary on the same device."""

    def __init__(self, model, *, num_layers, kv_heads, head_dim,
                 max_context, eos_token_id=None, block_size=None,
                 max_slots=None, prefill_chunk=None, pool_blocks=None,
                 token_budget=None, dtype=None, device=None,
                 prefix_cache=None, spec=None, draft_model=None,
                 host_tier=None):
        want = resolve_device(device)
        self.device = next(model.parameters()).device
        if self.device.type != want.type or want.index not in (
                None, self.device.index):
            raise ValueError(f"model lives on {self.device}, engine asked "
                             f"for {want}")
        self.model = model
        self.num_layers = int(num_layers)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.max_context = int(max_context)
        self.eos_token_id = eos_token_id
        self.block_size = int(block_size if block_size is not None
                              else flag_value("serving_block_size"))
        self.max_slots = int(max_slots if max_slots is not None
                             else flag_value("serving_max_batch_slots"))
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else flag_value("serving_prefill_chunk"))
        pool_blocks = int(pool_blocks if pool_blocks is not None
                          else flag_value("serving_pool_blocks"))
        self.max_blocks = -(-self.max_context // self.block_size)
        if pool_blocks <= 0:
            # every slot can hold a full-length context, plus scratch:
            # preemption then fires only when a caller shrinks the pool
            pool_blocks = 1 + self.max_slots * self.max_blocks
        token_budget = int(token_budget if token_budget is not None
                           else flag_value("serving_token_budget"))
        if token_budget <= 0:
            token_budget = self.prefill_chunk + self.max_slots
        if dtype is None:
            # the first FLOATING parameter sets the KV dtype
            dtype = next((p.dtype for p in model.parameters()
                          if p.is_floating_point()), torch.float32)
        self.pool = KVBlockPool(num_layers=self.num_layers,
                                num_blocks=pool_blocks,
                                block_size=self.block_size,
                                kv_heads=self.kv_heads,
                                head_dim=self.head_dim, dtype=dtype,
                                device=self.device,
                                prefix_cache=prefix_cache,
                                host_tier=host_tier)
        # speculation binds at construction: the flag when spec is None
        self.spec_mode = str(flag_value("serving_spec")
                             if spec is None else spec)
        if self.spec_mode not in SPEC_MODES:
            raise ValueError(f"spec={self.spec_mode!r} (want one of "
                             f"{'/'.join(SPEC_MODES)})")
        self._spec_k = int(flag_value("serving_spec_lookahead"))
        if self.spec_mode != "off" and self._spec_k < 1:
            raise ValueError(
                f"FLAGS_serving_spec_lookahead={self._spec_k} with "
                f"spec={self.spec_mode!r}: lookahead must be >= 1 (use "
                f"spec='off' to disable speculation)")
        self.scheduler = Scheduler(
            self.pool, max_slots=self.max_slots,
            prefill_chunk=self.prefill_chunk, token_budget=token_budget,
            spec_k=(self._spec_plan_k if self.spec_mode != "off"
                    else None))
        self.metrics = ServingMetrics()
        # IN-FLIGHT requests only: finished ones go back to the caller
        self.requests: dict[int, Sequence] = {}
        self.dispatches = 0          # target model calls, every kind
        self.verify_dispatches = 0   # of which [max_slots, W] verify rows
        self._next_id = 0
        self._oom_seen = 0
        self._prefix_seen = (0, 0, 0, 0)
        self._sample_s = 0.0
        self._step_t0 = now_s()
        # the verify width W: a power of two covering 1 + lookahead, so
        # the batch shape never varies with a sequence's adaptive k
        self._proposer = None
        self._spec_width = 0
        if self.spec_mode != "off":
            w = 1
            while w < 1 + self._spec_k:
                w *= 2
            self._spec_width = min(w, max(2, self.max_context))
            self._proposer = build_proposer(self.spec_mode, engine=self,
                                            draft_model=draft_model)

    @classmethod
    def from_model(cls, model, device=None, **kw):
        """Read the geometry from a Llama-style config. ``device``
        defaults to the card and must be where the model lives."""
        cfg = model.config
        geom = dict(num_layers=cfg.num_hidden_layers,
                    kv_heads=cfg.num_key_value_heads,
                    head_dim=cfg.hidden_size // cfg.num_attention_heads,
                    max_context=cfg.max_position_embeddings)
        geom.update(kw)
        return cls(model, device=device, **geom)

    # -- request API -------------------------------------------------------
    def add_request(self, prompt, *, max_new_tokens=16, temperature=0.0,
                    top_k=0, top_p=1.0, eos_token_id=None, seed=0,
                    arrival_s=None) -> int:
        """Queue a request; returns its id. Rejects what could never
        complete: the scheduler's no-deadlock argument assumes every
        admitted request fits the pool alone. ``arrival_s`` (a
        ``robustness.now_s`` time) back-dates the TTFT clock."""
        prompt = np.asarray(prompt).reshape(-1).tolist()
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not np.isfinite(temperature):
            raise ValueError(f"non-finite temperature {temperature!r}")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_context:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max context {self.max_context}")
        # the final emitted token's KV is never written: the worst-case
        # pool need is total-1 tokens
        if self.pool.blocks_for(total - 1) > self.pool.num_usable:
            raise PoolOOM(
                f"request needs {self.pool.blocks_for(total - 1)} "
                f"blocks; the whole pool has {self.pool.num_usable}")
        rid = self._next_id
        self._next_id += 1
        seq = Sequence(rid, prompt, max_new_tokens=max_new_tokens,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       eos_token_id=(self.eos_token_id if eos_token_id is None
                                     else eos_token_id),
                       seed=seed, arrival_s=arrival_s)
        if self.pool.prefix_cache:
            # pin the resident prefix now so it cannot be evicted while
            # the request queues; a total miss leaves its hit/miss
            # accounting to the binding lookup at admission
            seq.ctx = self.pool.acquire_prefix(rid, seq.tokens,
                                               defer_miss=True)
        note_event(seq, "arrival", t_s=seq.arrival_s,
                   prompt_len=seq.prompt_len)
        self.requests[rid] = seq
        self.scheduler.add(seq)
        self.metrics.on_arrival()
        return rid

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> list[Sequence]:
        """One engine iteration: plan, prefill one chunk, decode the
        batch. Returns the sequences that FINISHED this step."""
        finished: list[Sequence] = []
        t_step = self._step_t0 = now_s()
        plan = self.scheduler.schedule()
        phases = dict.fromkeys(STEP_PHASES, 0.0)
        phases["schedule"] = now_s() - t_step
        self._sample_s = 0.0
        for seq in plan.preempted:
            self.metrics.on_preempt()
            self._spec_forget(seq)   # rewound blocks invalidate draft K/V
        self.metrics.pool_oom_events += self.pool.oom_events - self._oom_seen
        self._oom_seen = self.pool.oom_events
        if plan.prefill is not None:
            t0, s0 = now_s(), self._sample_s
            self._run_prefill(*plan.prefill, finished)
            phases["prefill"] = (now_s() - t0) - (self._sample_s - s0)
        if plan.decode:
            t0, s0 = now_s(), self._sample_s
            if plan.spec:
                self._run_spec_decode(plan.decode, plan.spec, finished)
            else:
                self._run_decode(plan.decode, finished)
            phases["decode"] = (now_s() - t0) - (self._sample_s - s0)
        if plan.prefill is None and not plan.decode and self.has_work():
            raise RuntimeError("scheduler made no progress with work "
                               "pending: pool/budget configuration bug")
        phases["sample"] = self._sample_s
        phases["other"] = max(0.0, (now_s() - t_step) - sum(
            phases[p] for p in ("schedule", "prefill", "decode", "sample")))
        # the pool counts hits and copies as they happen (add_request's
        # acquisitions too); the metrics take the delta once a step
        cur = (self.pool.prefix_hits, self.pool.prefix_hit_tokens,
               self.pool.prefix_miss_tokens, self.pool.cow_copies)
        self.metrics.on_prefix(*(a - b for a, b in
                                 zip(cur, self._prefix_seen)),
                               cached_blocks=self.pool.num_cached)
        self._prefix_seen = cur
        self.metrics.on_phases(phases)
        self.metrics.on_step(decode_slots=len(plan.decode),
                             total_slots=self.max_slots,
                             pool_utilization=self.pool.utilization)
        return finished

    def run(self, max_steps: int | None = None) -> dict[int, Sequence]:
        """Drive step() until every admitted request finished."""
        done: dict[int, Sequence] = {}
        steps = 0
        while self.has_work():
            for seq in self.step():
                done[seq.req_id] = seq
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return done

    # -- device step -------------------------------------------------------
    def _dispatch(self, ids, positions, lengths, block_tables) -> np.ndarray:
        """One model call over the paged caches; returns the f32 logits
        row at each batch row's LAST VALID position, on the host."""
        self.dispatches += 1
        return paged_forward(self.model, self.pool.kbufs, self.pool.vbufs,
                             ids, positions, lengths, block_tables)

    def _dispatch_full(self, ids, positions, lengths,
                       block_tables) -> np.ndarray:
        """The verify dispatch: f32 logits at EVERY position of every
        row ``[B, W, vocab]`` on the host, since each draft is judged at
        its own position."""
        self.dispatches += 1
        self.verify_dispatches += 1
        return paged_forward(self.model, self.pool.kbufs, self.pool.vbufs,
                             ids, positions, lengths, block_tables,
                             full=True)

    def _apply_cow(self, copies) -> None:
        """The device half of copy-on-write: copy each shared block's
        K/V onto its private replacement (``pool.prepare_write`` already
        rewired the table) before this step's write lands; a draft
        proposer mirrors the copies into its own buffers."""
        for src, dst in copies:
            gather_copy_blocks(self.pool.kbufs, self.pool.vbufs, src, dst)
        if copies and self._proposer is not None:
            self._proposer.on_cow(copies)

    def _bucket(self, n: int) -> int:
        if n > self.prefill_chunk:
            raise ValueError(f"prefill chunk {n} exceeds "
                             f"prefill_chunk {self.prefill_chunk}")
        b = 1
        while b < n:
            b *= 2
        return min(b, self.prefill_chunk)

    def _table_row(self, seq: Sequence) -> np.ndarray:
        row = np.zeros(self.max_blocks, np.int32)
        tab = self.pool.table(seq.req_id)
        row[:len(tab)] = tab
        return row

    # -- prefill / decode --------------------------------------------------
    def _run_prefill(self, seq: Sequence, start: int, n: int,
                     finished: list[Sequence]) -> None:
        # a chunk starting inside a SHARED acquired block copies it first
        # (the scheduler reserved the block when it planned the chunk)
        self._apply_cow(self.pool.prepare_write(seq.req_id, start, n))
        ids = np.zeros((1, self._bucket(n)), np.int32)
        ids[0, :n] = seq.tokens[start:start + n]
        last = self._dispatch(ids, np.asarray([start], np.int32),
                              np.asarray([n], np.int32),
                              self._table_row(seq)[None, :])
        seq.ctx = start + n
        self.pool.register_prefix_blocks(seq.req_id, seq.tokens, seq.ctx)
        self.metrics.on_tokens_computed(n)
        note_event(seq, "prefill_chunk", start=start, tokens=n)
        if seq.ctx >= seq.prefill_target:
            # the chunk that completes the context yields the next token
            # (a fresh prompt and a preemption replay alike)
            self._emit(seq, self._sample(last[0], seq), finished)

    def _run_decode(self, seqs: list[Sequence],
                    finished: list[Sequence]) -> None:
        s_slots = self.max_slots
        ids = np.zeros((s_slots, 1), np.int32)
        positions = np.zeros(s_slots, np.int32)
        lengths = np.zeros(s_slots, np.int32)
        tables = np.zeros((s_slots, self.max_blocks), np.int32)
        # a row writing into a still-shared block copies it first (the
        # first prefill chunk already privatised a shared tail, so this
        # is a backstop that parents' blocks do not depend on)
        copies: list = []
        for seq in seqs:
            copies.extend(self.pool.prepare_write(seq.req_id, seq.ctx, 1))
        self._apply_cow(copies)
        for i, seq in enumerate(seqs):
            ids[i, 0] = seq.tokens[-1]
            positions[i] = seq.ctx
            lengths[i] = 1
            tables[i] = self._table_row(seq)
        last = self._dispatch(ids, positions, lengths, tables)
        self.metrics.on_tokens_computed(len(seqs))
        for i, seq in enumerate(seqs):
            seq.ctx += 1
            tok = self._sample(last[i], seq)
            self.pool.register_prefix_blocks(seq.req_id, seq.tokens,
                                             seq.ctx)
            self._emit(seq, tok, finished)

    # -- speculative decoding ----------------------------------------------
    def _spec_plan_k(self, seq: Sequence) -> int:
        """The scheduler's lookahead oracle: the configured lookahead,
        capped so the verify row never writes past ``max_context`` or
        drafts past the request's remaining output (emitted tokens are
        accepted + 1), backed off by :func:`adaptive_k`."""
        if seq.spec_off:
            return 0
        remaining = seq.max_new_tokens - len(seq.output)
        k = min(self._spec_k, remaining - 1,
                self.max_context - 1 - seq.ctx, self._spec_width - 1)
        if k <= 0:
            return 0
        return adaptive_k(seq, k)

    def _spec_forget(self, seq: Sequence) -> None:
        """Drop proposer-side draft state of a sequence whose blocks
        were rewound, finished or freed."""
        if self._proposer is not None:
            self._proposer.forget(seq.req_id)

    def _run_spec_decode(self, seqs: list[Sequence], plan_k: dict,
                         finished: list[Sequence]) -> None:
        """Decode with verify rows: every RUNNING sequence rides the
        ``[max_slots, W]`` full-logits batch, a drafting row with its
        last token + k drafts, a plain row with length 1. Acceptance
        keeps the longest draft prefix the target would have produced;
        ``pool.trim`` rewinds the rejected positions."""
        drafts: dict[int, list[int]] = {}
        for seq in seqs:
            k = int(plan_k.get(seq.req_id, 0))
            if k <= 0 or seq.spec_off:
                continue
            d = [int(t) for t in
                 self._proposer.propose(seq, k, self._table_row(seq))[:k]]
            if d:
                drafts[seq.req_id] = d
        if not drafts:
            # nobody drafted: the plain batch is cheaper than W-wide pads.
            # Return the headroom the scheduler ensured for the drafts
            # first, or a draftless workload holds extra blocks and
            # preempts earlier than spec=off would
            for seq in seqs:
                self.pool.trim(seq.req_id, seq.ctx + 1)
            self._run_decode(seqs, finished)
            return
        s_slots, w = self.max_slots, self._spec_width
        ids = np.zeros((s_slots, w), np.int32)
        positions = np.zeros(s_slots, np.int32)
        lengths = np.zeros(s_slots, np.int32)
        tables = np.zeros((s_slots, self.max_blocks), np.int32)
        copies: list = []
        rows: list[tuple[int, Sequence, list[int], int]] = []
        for i, seq in enumerate(seqs):
            d = drafts.get(seq.req_id, [])
            m = 1 + len(d)
            copies.extend(self.pool.prepare_write(seq.req_id, seq.ctx, m))
            ids[i, 0] = seq.tokens[-1]
            ids[i, 1:m] = d
            positions[i] = seq.ctx
            lengths[i] = m
            tables[i] = self._table_row(seq)
            rows.append((i, seq, d, m))
        self._apply_cow(copies)
        full = self._dispatch_full(ids, positions, lengths, tables)
        step_accepted = 0
        for i, seq, d, m in rows:
            start = seq.ctx
            t0 = now_s()
            if d:
                toks, accepted = verify_draft(full[i, :m], d, seq)
            else:
                toks, accepted = [sample_token(full[i, 0], seq)], 0
            self._sample_s += now_s() - t0
            # tokens past eos or the length limit are dropped
            emitted, out_len = 0, len(seq.output)
            eos = seq.eos_token_id
            for tok in toks:
                emitted += 1
                if ((eos is not None and tok == int(eos))
                        or out_len + emitted >= seq.max_new_tokens):
                    break
            new_ctx = start + emitted
            self.metrics.on_spec_tokens(emitted, m - emitted)
            # rewind and register BEFORE emission, as the plain path
            # does: a burst that finishes the request frees its blocks
            # in _emit, and only registered blocks park in the cached
            # set. The kept K/V was computed from seq.tokens plus all but
            # the last emitted token; trim keeps one more position so
            # the next decode write's block survives
            self.pool.trim(seq.req_id, new_ctx + 1)
            self.pool.register_prefix_blocks(
                seq.req_id, seq.tokens + toks[:emitted - 1], new_ctx)
            prev = seq.last_token_s
            for tok in toks[:emitted]:
                self._emit(seq, tok, finished, note_gap=False)
            seq.ctx = new_ctx
            self._note_token_gaps(seq, emitted, now_s(), prev)
            if d:
                self.metrics.on_spec_verify(len(d), accepted)
                note_acceptance(seq, len(d), accepted)
                step_accepted += max(0, emitted - 1)
                if not seq.is_finished:
                    self._proposer.observe(seq, start, len(d))
        self.metrics.on_spec_step(step_accepted)

    def _note_token_gaps(self, seq: Sequence, m: int, now: float,
                         prev: float | None) -> None:
        """TPOT samples for ``m`` tokens of one sequence emitted at
        ``now``: the gap since its previous emission spread over them,
        or, when the burst holds the first token (which is TTFT's), the
        step's wall time spread over the burst."""
        if m <= 0:
            return
        if prev is None:
            if m > 1:
                self.metrics.on_token_gap(
                    max(0.0, now - self._step_t0) / m, m - 1)
        else:
            self.metrics.on_token_gap((now - prev) / m, m)
        seq.last_token_s = now

    def _sample(self, logits_row: np.ndarray, seq: Sequence) -> int:
        t0 = now_s()
        try:
            return sample_token(logits_row, seq)
        finally:
            self._sample_s += now_s() - t0

    def _emit(self, seq: Sequence, tok: int, finished: list[Sequence],
              note_gap: bool = True) -> None:
        now = now_s()
        seq.tokens.append(tok)
        seq.output.append(tok)
        seq.state = RUNNING
        if seq.first_token_s is None:
            seq.first_token_s = now
            self.metrics.on_first_token(now - seq.arrival_s)
            note_event(seq, "first_token", t_s=now)
        if note_gap:
            # a multi-token burst passes note_gap=False and records its
            # gaps once (_note_token_gaps)
            if seq.last_token_s is not None:
                self.metrics.on_token_gap(now - seq.last_token_s)
            seq.last_token_s = now
        self.metrics.on_token()
        eos = seq.eos_token_id
        if eos is not None and tok == int(eos):
            seq.finish_reason = "eos"
        elif len(seq.output) >= seq.max_new_tokens:
            seq.finish_reason = "length"
        if seq.finish_reason is not None:
            seq.outcome = OK
            seq.finish_s = now
            self.metrics.on_finish()
            note_event(seq, "terminal", t_s=now, outcome=OK,
                       reason=seq.finish_reason)
            self._spec_forget(seq)
            self.scheduler.finish(seq)
            self.requests.pop(seq.req_id, None)   # the caller owns it now
            finished.append(seq)


__all__ = ["ServingEngine", "sample_token"]
