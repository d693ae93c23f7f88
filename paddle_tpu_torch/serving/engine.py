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

Not ported yet: prefix caching, speculative decoding, deadlines and
cancellation, load shedding, step-failure quarantine, drain/health,
telemetry, fleet hooks, and CUDA graphs for the decode signature.
"""

from __future__ import annotations

import numpy as np
import torch

from ..flags import flag_value
from ..framework.device import resolve_device
from .kv_pool import KVBlockPool, PagedLayerCache, PoolOOM
from .metrics import STEP_PHASES, ServingMetrics
from .robustness import OK, note_event, now_s
from .scheduler import RUNNING, Scheduler, Sequence
from .speculation import processed_probs


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
    -> (logits, caches)``."""

    def __init__(self, model, *, num_layers, kv_heads, head_dim,
                 max_context, eos_token_id=None, block_size=None,
                 max_slots=None, prefill_chunk=None, pool_blocks=None,
                 token_budget=None, dtype=None, device=None):
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
                                device=self.device)
        self.scheduler = Scheduler(
            self.pool, max_slots=self.max_slots,
            prefill_chunk=self.prefill_chunk, token_budget=token_budget)
        self.metrics = ServingMetrics()
        # IN-FLIGHT requests only: finished ones go back to the caller
        self.requests: dict[int, Sequence] = {}
        self.dispatches = 0          # model calls (prefill + decode)
        self._next_id = 0
        self._oom_seen = 0
        self._sample_s = 0.0

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
        t_step = now_s()
        plan = self.scheduler.schedule()
        phases = dict.fromkeys(STEP_PHASES, 0.0)
        phases["schedule"] = now_s() - t_step
        self._sample_s = 0.0
        for _ in plan.preempted:
            self.metrics.on_preempt()
        self.metrics.pool_oom_events += self.pool.oom_events - self._oom_seen
        self._oom_seen = self.pool.oom_events
        if plan.prefill is not None:
            t0, s0 = now_s(), self._sample_s
            self._run_prefill(*plan.prefill, finished)
            phases["prefill"] = (now_s() - t0) - (self._sample_s - s0)
        if plan.decode:
            t0, s0 = now_s(), self._sample_s
            self._run_decode(plan.decode, finished)
            phases["decode"] = (now_s() - t0) - (self._sample_s - s0)
        if plan.prefill is None and not plan.decode and self.has_work():
            raise RuntimeError("scheduler made no progress with work "
                               "pending: pool/budget configuration bug")
        phases["sample"] = self._sample_s
        phases["other"] = max(0.0, (now_s() - t_step) - sum(
            phases[p] for p in ("schedule", "prefill", "decode", "sample")))
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
        dev = self.device
        ids_t = torch.from_numpy(ids).to(dev)
        pos_t = torch.from_numpy(positions).to(dev)
        len_t = torch.from_numpy(lengths).to(dev)
        tab_t = torch.from_numpy(block_tables).to(dev)
        caches = [PagedLayerCache(self.pool.kbufs[i], self.pool.vbufs[i],
                                  tab_t, len_t)
                  for i in range(self.num_layers)]
        with torch.no_grad():
            logits, _ = self.model(ids_t, kv_caches=caches,
                                   position_offset=pos_t,
                                   logits_rows=(len_t - 1).clamp(min=0))
        self.dispatches += 1
        return logits.float().cpu().numpy()

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
        ids = np.zeros((1, self._bucket(n)), np.int32)
        ids[0, :n] = seq.tokens[start:start + n]
        last = self._dispatch(ids, np.asarray([start], np.int32),
                              np.asarray([n], np.int32),
                              self._table_row(seq)[None, :])
        seq.ctx = start + n
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
        for i, seq in enumerate(seqs):
            ids[i, 0] = seq.tokens[-1]
            positions[i] = seq.ctx
            lengths[i] = 1
            tables[i] = self._table_row(seq)
        last = self._dispatch(ids, positions, lengths, tables)
        self.metrics.on_tokens_computed(len(seqs))
        for i, seq in enumerate(seqs):
            seq.ctx += 1
            self._emit(seq, self._sample(last[i], seq), finished)

    def _sample(self, logits_row: np.ndarray, seq: Sequence) -> int:
        t0 = now_s()
        try:
            return sample_token(logits_row, seq)
        finally:
            self._sample_s += now_s() - t0

    def _emit(self, seq: Sequence, tok: int,
              finished: list[Sequence]) -> None:
        now = now_s()
        seq.tokens.append(tok)
        seq.output.append(tok)
        seq.state = RUNNING
        if seq.first_token_s is None:
            seq.first_token_s = now
            self.metrics.on_first_token(now - seq.arrival_s)
            note_event(seq, "first_token", t_s=now)
        else:
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
            self.scheduler.finish(seq)
            self.requests.pop(seq.req_id, None)   # the caller owns it now
            finished.append(seq)


__all__ = ["ServingEngine", "sample_token"]
