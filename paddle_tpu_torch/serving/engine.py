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

Host-RAM tier (``host_tier.py``, ``FLAGS_serving_host_tier``, off by
default): blocks leaving the device cached set spill to a bounded host
store and restore on reuse (``kv_pool.py``); admission prices a host hit
between a device hit and a cold prompt.

SLO guardrails (``robustness.py``): per-request deadlines and
``cancel()``, bounded admission with load shedding
(``FLAGS_serving_max_queue`` and the estimated queue delay), step-failure
isolation with quarantine after ``FLAGS_serving_step_retries`` recompute
replays, a hung-step detector, fault points (``serving.prefill``,
``serving.decode``, ``serving.sample``, ``serving.pool_alloc``,
``serving.host_tier.restore``, ``serving.spec.propose``,
``serving.spec.verify`` under ``FLAGS_fault_spec``, all outside the
device step), and the SERVING -> DEGRADED -> DRAINING -> STOPPED
lifecycle with ``drain()`` and ``health()``. A proposer or verify fault
degrades exactly that sequence to plain decode. Every request leaves
with one terminal outcome (ok, expired, cancelled, shed, failed) on
``Sequence.outcome``.

Telemetry (``telemetry/``, ``FLAGS_telemetry``, off by default): every
step is a ``serving/engine_step`` span with ``serving/prefill``,
``serving/decode`` and ``serving/sample`` spans inside it, appends one
flight-recorder digest, and publishes the ``serving_*`` metric families
(``metrics.py``: the goodput ledger, the attention-bytes ledger, the
decode roofline against ``hbm_peak_gbs``); every request gets a timeline
(``robustness.note_event``); a drain, a quarantine, a first DEGRADED
entry and a hung step freeze a flight dump. ``paged_kernel`` names the
attend the device picks (``"cuda"``: K5; ``"plain"``: its PyTorch
version on the CPU), the port's counterpart of the JAX engine's
``kernel_plan`` stamp. With the flag off all of it is a no-op and the
serving path is unchanged.

Request handoff (a disaggregated prefill-to-decode move or a live
migration): ``export_request`` snapshots an in-flight request (its
parameters, output, clocks, numpy sampler state and the pool's
``export_seq`` manifest of its computed context), ``import_request``
admits it mid-stream on another engine, and ``release_handoff`` lets it
go on the source, booking its tokens through the goodput ledger. The
snapshot is the JAX package's, so a request moves between the two
packages in either direction. ``enable_fleet_publish`` pushes
``health()`` with the telemetry snapshot to a store every few steps, and
``routing_signals`` gives a router its per-request inputs.

The fleet (``serving/fleet/``: router, self-healing replicas,
autoscaler, disaggregated prefill/decode, live migration) consumes these
hooks; its replicas are engines like this one. Not ported yet: CUDA
graphs for the decode signature, and the JAX package's fleet
``worker.py`` and ``sharding.py`` (one replica per process, tensor
parallelism over several cards).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from ..flags import flag_value
from ..framework.device import resolve_device
from . import robustness
from .kv_pool import KVBlockPool, PoolOOM
from .metrics import GOODPUT, STEP_PHASES, ServingMetrics
from .paged_attention import gather_copy_blocks, paged_forward
from .robustness import (BOTH_ROLE, CANCELLED, DRAINING, OK, STOPPED,
                         AdmissionController, Lifecycle, RequestRejected,
                         SampleFailures, check_hung_step, dump_step_failure,
                         fault_point, handle_schedule_failure,
                         handle_step_failure, note_event, now_s,
                         sweep_deadlines)
from .scheduler import PREFILL, RUNNING, Scheduler, Sequence
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


class SpecPlan:
    """The scheduler's lookahead oracle: the configured lookahead,
    capped so the verify row never writes past ``max_context`` or drafts
    past the request's remaining output (emitted tokens are accepted +
    1), backed off by :func:`adaptive_k`."""

    __slots__ = ("k", "max_context", "width")

    def __init__(self, k: int, max_context: int, width: int):
        self.k, self.max_context, self.width = k, max_context, width

    def __call__(self, seq: Sequence) -> int:
        if seq.spec_off:
            return 0
        remaining = seq.max_new_tokens - len(seq.output)
        k = min(self.k, remaining - 1, self.max_context - 1 - seq.ctx,
                self.width - 1)
        if k <= 0:
            return 0
        return adaptive_k(seq, k)


class ServingEngine:
    """Continuous-batching engine over a model exposing
    ``forward(ids, kv_caches=..., position_offset=..., logits_rows=...)
    -> (logits, caches)``. ``prefix_cache``, ``spec`` and ``host_tier``
    default to their flags; ``spec="draft"`` needs ``draft_model``, a
    smaller model of the same vocabulary on the same device.
    ``hbm_peak_gbs`` (the card's HBM peak in GB/s) arms the decode
    roofline; None disables it."""

    def __init__(self, model, *, num_layers, kv_heads, head_dim,
                 max_context, eos_token_id=None, block_size=None,
                 max_slots=None, prefill_chunk=None, pool_blocks=None,
                 token_budget=None, dtype=None, hbm_peak_gbs=None,
                 device=None, prefix_cache=None, spec=None,
                 draft_model=None, host_tier=None):
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
        # decode roofline (metrics.on_decode_roofline): a decode step
        # streams every weight once, so its bytes are the parameters'
        self.hbm_peak_gbs = (None if hbm_peak_gbs is None
                             else float(hbm_peak_gbs))
        self.model_bytes = int(sum(p.numel() * p.element_size()
                                   for p in model.parameters()))
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
        # which attend this engine's dispatches run, stamped into flight
        # digests and health(): the device picks (K5 on a CUDA pool)
        self.paged_kernel = "cuda" if self.device.type == "cuda" else "plain"
        # per-token K/V bytes for the attention-bytes ledger: K + V rows
        # across every layer
        self._kv_token_bytes = (2 * self.num_layers * self.kv_heads
                                * self.head_dim
                                * torch.empty((), dtype=dtype).element_size())
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
        # the verify width W: a power of two covering 1 + lookahead, so
        # the batch shape never varies with a sequence's adaptive k
        self._spec_width = 0
        if self.spec_mode != "off":
            w = 1
            while w < 1 + self._spec_k:
                w *= 2
            self._spec_width = min(w, max(2, self.max_context))
        # the oracle holds the three numbers it reads, not the engine: a
        # bound method here would make a cycle (engine -> scheduler ->
        # engine), and a dropped engine would keep its pool's device
        # memory until the cycle collector ran
        self.scheduler = Scheduler(
            self.pool, max_slots=self.max_slots,
            prefill_chunk=self.prefill_chunk, token_budget=token_budget,
            spec_k=(None if self.spec_mode == "off" else SpecPlan(
                self._spec_k, self.max_context, self._spec_width)))
        self.metrics = ServingMetrics()
        # IN-FLIGHT requests only: finished ones go back to the caller
        self.requests: dict[int, Sequence] = {}
        self.dispatches = 0          # target model calls, every kind
        self.verify_dispatches = 0   # of which [max_slots, W] verify rows
        self._next_id = 0
        self._oom_seen = 0
        self._prefix_seen = (0, 0, 0, 0)
        # host-tier counter high-water, the same per-step delta pattern
        self._host_seen = (0, 0, 0, 0, 0)
        self.lifecycle = Lifecycle()
        self._admission = AdmissionController()
        self._last_step_s = None
        self._sample_s = 0.0
        self._step_t0 = now_s()
        # accepted draft tokens of the current step (flight digest)
        self._spec_step_accepted = 0
        # lifetime proposal/acceptance totals for health()
        self._spec_proposed_life = 0
        self._spec_accepted_life = 0
        self._proposer = None
        if self.spec_mode != "off":
            self._proposer = build_proposer(self.spec_mode, engine=self,
                                            draft_model=draft_model)
        # fleet publishing (enable_fleet_publish): (store, rank, every)
        # once armed
        self._fleet_publish = None
        # the role in a role-split fleet (both = monolithic) and the
        # lifetime handoff counts, in health()
        self.fleet_role = BOTH_ROLE
        self._handoffs_out = 0
        self._handoffs_in = 0
        # the periodic snapshot thread: a no-op unless FLAGS_telemetry
        # and FLAGS_telemetry_export_interval are set
        telemetry.maybe_start_exporter()

    @classmethod
    def from_model(cls, model, device=None, **kw):
        """Read the geometry from a Llama-style ``model.config``, or from
        a GPT's ``model.gpt.cfg`` when there is no ``config`` (K/V at
        every attention head when the config has no
        ``num_key_value_heads``), as the JAX engine does. ``device``
        defaults to the card and must be where the model lives."""
        cfg = getattr(model, "config", None)
        if cfg is None and hasattr(model, "gpt"):
            cfg = model.gpt.cfg
        if cfg is None:
            raise ValueError("cannot infer the geometry; pass num_layers, "
                             "kv_heads, head_dim and max_context")
        geom = dict(num_layers=cfg.num_hidden_layers,
                    kv_heads=getattr(cfg, "num_key_value_heads",
                                     cfg.num_attention_heads),
                    head_dim=cfg.hidden_size // cfg.num_attention_heads,
                    max_context=cfg.max_position_embeddings)
        geom.update(kw)
        return cls(model, device=device, **geom)

    # -- request API -------------------------------------------------------
    def add_request(self, prompt, *, max_new_tokens=16, temperature=0.0,
                    top_k=0, top_p=1.0, eos_token_id=None, seed=0,
                    arrival_s=None, deadline_s=None) -> int:
        """Queue a request; returns its id. Rejects what could never
        complete (the scheduler's no-deadlock argument assumes every
        admitted request fits the pool alone) and SHEDS, with
        :class:`RequestRejected` (a ValueError), what the engine should
        not take on: requests beyond ``max_context``, a full waiting
        queue (``FLAGS_serving_max_queue``), an estimated queue delay
        already past the request's deadline, or a draining or stopped
        engine. ``arrival_s`` (a ``robustness.now_s`` time) back-dates
        the TTFT clock; ``deadline_s`` (seconds from arrival) arms a
        deadline, after which the request finishes ``expired`` wherever
        it is."""
        if self.lifecycle.state in (DRAINING, STOPPED):
            self.metrics.on_shed("draining")
            raise RequestRejected(
                "draining", f"engine is {self.lifecycle.state}; "
                f"not accepting new requests")
        prompt = np.asarray(prompt).reshape(-1).tolist()
        total = len(prompt) + int(max_new_tokens)
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not np.isfinite(temperature):
            raise ValueError(f"non-finite temperature {temperature!r}")
        if deadline_s is not None and float(deadline_s) <= 0.0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if total > self.max_context:
            # it could never reach its prefill target: shed at the door
            self.metrics.on_shed("max_context")
            raise RequestRejected(
                "max_context",
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max context {self.max_context}")
        # the final emitted token's KV is never written: the worst-case
        # pool need is total-1 tokens
        if self.pool.blocks_for(total - 1) > self.pool.num_usable:
            self.metrics.on_shed("pool_capacity")
            raise PoolOOM(
                f"request needs {self.pool.blocks_for(total - 1)} "
                f"blocks; the whole pool has {self.pool.num_usable}")
        # the deadline runs from ARRIVAL: a back-dated arrival has
        # already used part of it, so shedding sees what is left
        remaining_s = None
        if deadline_s is not None:
            remaining_s = float(deadline_s)
            if arrival_s is not None:
                remaining_s -= max(0.0, now_s() - float(arrival_s))
            if remaining_s <= 0.0:
                self.metrics.on_shed("est_delay")
                raise RequestRejected(
                    "est_delay",
                    f"deadline {deadline_s}s was already consumed by "
                    f"pre-admission queueing: the request would expire "
                    f"before its first token")
        # cache-aware pricing: a resident prefix costs only the uncached
        # prefill, a host-resident one prices between a device hit and
        # cold; the peek is read-only
        dev_hint, host_hint = self.pool.peek_prefix_tiered(prompt)
        self._admission.check(
            self.metrics, self.scheduler, remaining_s,
            own_tokens=self._admission.priced_tokens(
                len(prompt), int(max_new_tokens), dev_hint, host_hint))
        rid = self._next_id
        self._next_id += 1
        seq = Sequence(rid, prompt, max_new_tokens=max_new_tokens,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       eos_token_id=(self.eos_token_id if eos_token_id is None
                                     else eos_token_id),
                       seed=seed, arrival_s=arrival_s, deadline_s=deadline_s)
        if self.pool.prefix_cache:
            # pin the resident prefix now so it cannot be evicted while
            # the request queues; a total miss leaves its hit/miss
            # accounting to the binding lookup at admission
            seq.ctx = self.pool.acquire_prefix(rid, seq.tokens,
                                               defer_miss=True)
        self.requests[rid] = seq
        self.scheduler.add(seq)
        self.metrics.on_arrival()
        if telemetry.enabled():
            # the request's timeline: arrival at the (possibly
            # back-dated) TTFT clock origin, admission now
            telemetry.begin_request(rid)
            note_event(seq, "arrival", t_s=seq.arrival_s,
                       prompt_len=seq.prompt_len,
                       max_new_tokens=seq.max_new_tokens)
            note_event(seq, "admitted", queue_depth=len(
                self.scheduler.waiting))
            if seq.ctx:
                note_event(seq, "prefix_hit", tokens=seq.ctx)
                restored = self.pool.take_last_restored()
                if restored:
                    note_event(seq, "host_restore", tokens=restored)
        return rid

    def cancel(self, req_id: int) -> Sequence | None:
        """Cancel an in-flight request (waiting, prefilling or
        decoding): its blocks are freed at once, it finishes with
        terminal reason ``cancelled``, and the Sequence (with any
        partial output) is returned; it will not also appear in a later
        ``step()``'s finished list. Unknown or finished ids return None.
        Call between steps."""
        seq = self.requests.get(req_id)
        if seq is None:
            return None
        self._finish_terminal(seq, CANCELLED, [])
        return seq

    # -- request handoff ---------------------------------------------------
    # A request moves to another engine in three calls: export_request
    # (a read-only snapshot of its state and its computed K/V blocks),
    # import_request on the destination (which admits it mid-stream),
    # and release_handoff on the source once the import succeeded. The
    # source keeps serving the request untouched until the release, so a
    # failure anywhere before it loses no token.

    def handoff_ready(self) -> list[int]:
        """Request ids that can hand off to a decode engine: RUNNING (so
        ``ctx == len(tokens) - 1`` and the newest token's K/V is not yet
        computed), with at least one output token and blocks resident."""
        return [rid for rid, seq in self.requests.items()
                if seq.state == RUNNING and seq.output
                and seq.ctx == len(seq.tokens) - 1
                and self.pool.holds(rid)]

    def migrate_ready(self) -> list[int]:
        """Request ids a live migration can move: computing (PREFILL mid
        chunked prefill, or RUNNING) with at least one context token's
        K/V resident. Between steps each sits at a chunk boundary, so its
        ``ctx`` tokens are exactly what :meth:`export_request`
        snapshots. Preempted sequences (WAITING, blocks freed) are left
        out: they re-prefill wherever they land."""
        return [rid for rid, seq in self.requests.items()
                if seq.state in (PREFILL, RUNNING) and seq.ctx >= 1
                and self.pool.holds(rid)]

    def export_request(self, req_id: int) -> dict:
        """Read-only snapshot of an in-flight request: its generation
        parameters, emitted output, clocks, the exact numpy sampler state
        (``bit_generator.state``, so seeded stochastic sampling continues
        bit for bit) and the pool's ``export_seq`` manifest of its
        ``ctx`` computed tokens. Mid-prefill (no output yet) and
        mid-decode (``ctx == len(tokens) - 1``) alike; the request keeps
        running here until :meth:`release_handoff`."""
        seq = self.requests.get(req_id)
        if seq is None:
            raise KeyError(f"unknown request {req_id}")
        if (seq.state not in (PREFILL, RUNNING) or seq.ctx < 1
                or not self.pool.holds(req_id)
                or (seq.state == RUNNING
                    and seq.ctx != len(seq.tokens) - 1)):
            raise ValueError(
                f"request {req_id} is not export-ready "
                f"(state={seq.state}, ctx={seq.ctx}/{len(seq.tokens)})")
        return {
            "prompt": list(seq.tokens[:seq.prompt_len]),
            "output": list(seq.output),
            "ctx": seq.ctx,
            "max_new_tokens": seq.max_new_tokens,
            "temperature": seq.temperature,
            "top_k": seq.top_k,
            "top_p": seq.top_p,
            "eos_token_id": seq.eos_token_id,
            "arrival_s": seq.arrival_s,
            # seq.deadline_s is ABSOLUTE (arrival + budget): carried as
            # is, the importer adds no arrival offset
            "deadline_abs": seq.deadline_s,
            "first_token_s": seq.first_token_s,
            "last_token_s": seq.last_token_s,
            "preemptions": seq.preemptions,
            "retries": seq.retries,
            # speculation: the acceptance window steers adaptive
            # lookahead, and a degrade to plain decode sticks
            "spec_off": seq.spec_off,
            "spec_hist": [tuple(h) for h in seq.spec_hist],
            "rng_state": seq.rng.bit_generator.state,
            "kv": self.pool.export_seq(req_id, seq.ctx),
        }

    def release_handoff(self, req_id: int, *, dest=None,
                        kind: str | None = None) -> None:
        """Let go of a request whose import on the destination succeeded:
        book the tokens this engine computed in its goodput ledger (the
        destination books only its own), drop draft state, free the
        blocks and remove the sequence, with no terminal outcome (the
        request goes on elsewhere). ``kind`` overrides the ledger kind of
        the first-pass tokens (a live migration passes ``migrated``)."""
        seq = self.requests.pop(req_id, None)
        if seq is None:
            raise KeyError(f"unknown request {req_id}")
        self._handoffs_out += 1
        self.metrics.resolve_handoff(seq, fresh_kind=kind or GOODPUT)
        self._spec_forget(seq)
        note_event(seq, "handoff_out", dest=dest, tokens=len(seq.output))
        self.scheduler.remove(seq)

    def import_request(self, state: dict) -> int:
        """Admit a handed-off request MID-STREAM: rebuild the sequence
        past its emitted output, restore the sampler state and clocks,
        install the K/V manifest in this pool and register its full
        prefix blocks, then queue it. A mid-decode import enters as
        PREFILL with ``ctx == len(tokens) - 1``: one 1-token chunk
        computes the newest token's K/V, as the decode step on the source
        would have; a mid-prefill import continues chunked prefill from
        its boundary. Counts no arrival (the source did). A draining
        engine refuses with ``RequestRejected("draining")``, and a pool
        too small raises PoolOOM without a shed count."""
        if self.lifecycle.state in (DRAINING, STOPPED):
            raise RequestRejected(
                "draining", f"engine is {self.lifecycle.state}; "
                f"not accepting handoffs")
        prompt = [int(t) for t in state["prompt"]]
        total = len(prompt) + int(state["max_new_tokens"])
        if self.pool.blocks_for(total - 1) > self.pool.num_usable:
            raise PoolOOM(
                f"handoff needs {self.pool.blocks_for(total - 1)} "
                f"blocks; the whole pool has {self.pool.num_usable}")
        rid = self._next_id
        self._next_id += 1
        seq = Sequence(rid, prompt,
                       max_new_tokens=state["max_new_tokens"],
                       temperature=state["temperature"],
                       top_k=state["top_k"], top_p=state["top_p"],
                       eos_token_id=state["eos_token_id"],
                       arrival_s=state["arrival_s"], deadline_s=None)
        seq.deadline_s = state["deadline_abs"]
        seq.output = [int(t) for t in state["output"]]
        seq.tokens.extend(seq.output)
        seq.ctx = int(state["ctx"])
        # a replay that rewinds below this high water is replay work, as
        # if this engine had computed the context
        seq.computed_hw = seq.ctx
        seq.first_token_s = state["first_token_s"]
        seq.last_token_s = state["last_token_s"]
        seq.preemptions = int(state.get("preemptions", 0))
        seq.retries = int(state.get("retries", 0))
        seq.spec_off = bool(state.get("spec_off", False))
        seq.spec_hist = [tuple(h) for h in state.get("spec_hist", ())]
        seq.rng.bit_generator.state = state["rng_state"]
        self.pool.import_seq(rid, state["kv"])
        if self.pool.prefix_cache:
            # first writer wins: the imported context joins the prefix
            # index as if this engine had prefilled it
            self.pool.register_prefix_blocks(rid, seq.tokens, seq.ctx)
        self.requests[rid] = seq
        self.scheduler.add(seq)
        self._handoffs_in += 1
        if telemetry.enabled():
            telemetry.begin_request(rid)
            note_event(seq, "handoff_in", ctx=seq.ctx,
                       tokens=len(seq.output),
                       kv_bytes=state["kv"]["nbytes"])
        return rid

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> list[Sequence]:
        """One engine iteration: sweep deadlines, plan, prefill one
        chunk, decode the batch. Returns the sequences that FINISHED this
        step (every terminal outcome). The step is one
        ``serving/engine_step`` span."""
        with telemetry.span("serving/engine_step", cat="Serving",
                            step=self.metrics.steps):
            return self._step_inner()

    def _step_inner(self) -> list[Sequence]:
        finished: list[Sequence] = []
        step_idx = self.metrics.steps
        self._sample_s = 0.0
        self._spec_step_accepted = 0
        t_step = self._step_t0 = now_s()
        sweep_deadlines(self, t_step, finished)
        t0 = now_s()
        try:
            plan = self.scheduler.schedule()
        except ConnectionError as e:
            # a planning blip (an injected serving.pool_alloc fault): no
            # plan component to blame, nobody is charged a retry, and the
            # step yields nothing. Planning may have preempted victims
            # before raising, so every draft state is dropped
            if self._proposer is not None:
                for rid in self.requests:
                    self._proposer.forget(rid)
            handle_schedule_failure(self, e)
            return finished
        phases = dict.fromkeys(STEP_PHASES, 0.0)
        phases["schedule"] = now_s() - t0
        for seq in plan.preempted:
            self.metrics.on_preempt()
            self._spec_forget(seq)   # rewound blocks invalidate draft K/V
        self.metrics.pool_oom_events += self.pool.oom_events - self._oom_seen
        self._oom_seen = self.pool.oom_events
        t0 = now_s()
        step_failed = False
        failed_phases: list[str] = []
        tokens_done = 0
        prefill_rids: list[int] = []
        decode_rids = [s.req_id for s in plan.decode]
        if plan.prefill is not None:
            seq, start, n = plan.prefill
            prefill_rids = [seq.req_id]
            s0, tp = self._sample_s, now_s()
            try:
                with telemetry.span("serving/prefill", cat="Serving",
                                    tokens=n, step=step_idx,
                                    rids=prefill_rids):
                    self._run_prefill(seq, start, n, finished)
                tokens_done += n
            except Exception as e:
                step_failed = True
                failed_phases.append("prefill")
                self._on_phase_failure([seq], "prefill", e, finished)
            finally:
                phases["prefill"] = (now_s() - tp) - (self._sample_s - s0)
        if plan.decode:
            s0, td = self._sample_s, now_s()
            try:
                with telemetry.span("serving/decode", cat="Serving",
                                    slots=len(plan.decode), step=step_idx,
                                    rids=decode_rids):
                    if plan.spec:
                        tokens_done += self._run_spec_decode(
                            plan.decode, plan.spec, finished)
                    else:
                        self._run_decode(plan.decode, finished)
                        tokens_done += len(plan.decode)
            except Exception as e:
                step_failed = True
                failed_phases.append("decode")
                self._on_phase_failure(plan.decode, "decode", e, finished)
            finally:
                decode_s = (now_s() - td) - (self._sample_s - s0)
                phases["decode"] = decode_s
                if (self.hbm_peak_gbs and decode_s > 0.0
                        and "decode" not in failed_phases):
                    # the weights' bytes over the decode phase's seconds,
                    # as a share of the card's HBM peak
                    gbs = self.model_bytes / decode_s / 1e9
                    self.metrics.on_decode_roofline(gbs / self.hbm_peak_gbs)
        if (not step_failed and plan.prefill is None and not plan.decode
                and self.has_work()):
            raise RuntimeError("scheduler made no progress with work "
                               "pending: pool/budget configuration bug")
        dur = now_s() - t_step
        phases["sample"] = self._sample_s
        phases["other"] = max(0.0, dur - phases["schedule"]
                              - phases["prefill"] - phases["decode"]
                              - phases["sample"])
        # the admission EWMA and the hung-step detector rate the compute
        # part of the step, not the sweep and planning
        compute_s = now_s() - t0
        self._last_step_s = compute_s
        self._admission.note_step(tokens_done, compute_s)
        hung = check_hung_step(self, compute_s)
        if not step_failed and not hung:
            self.lifecycle.note_clean_step()
        # the pool counts hits and copies as they happen (add_request's
        # acquisitions too); the metrics take the delta once a step
        cur = (self.pool.prefix_hits, self.pool.prefix_hit_tokens,
               self.pool.prefix_miss_tokens, self.pool.cow_copies)
        dhits, dhit_tok, dmiss_tok, dcow = (
            a - b for a, b in zip(cur, self._prefix_seen))
        self._prefix_seen = cur
        self.metrics.on_prefix(dhits, dhit_tok, dmiss_tok, dcow,
                               cached_blocks=self.pool.num_cached)
        host_extra = {}
        tier = self.pool.host_tier
        if tier is not None:
            hcur = (self.pool.host_hits, self.pool.host_hit_tokens,
                    tier.spills, tier.evictions,
                    self.pool.host_restore_failures)
            dh, dh_tok, dspill, devict, dfail = (
                a - b for a, b in zip(hcur, self._host_seen))
            self._host_seen = hcur
            self.metrics.on_host_tier(dh, dh_tok, dspill, devict, dfail,
                                      blocks=len(tier), nbytes=tier.bytes)
            # the digest has the tier's keys only when the tier exists
            host_extra = {"host_restored_tokens": dh_tok,
                          "host_blocks": len(tier),
                          "host_bytes": tier.bytes}
        self.metrics.on_phases(phases)
        self.metrics.on_step(decode_slots=len(plan.decode),
                             total_slots=self.max_slots,
                             queue_depth=len(self.scheduler.waiting),
                             pool_utilization=self.pool.utilization)
        telemetry.record_flight_step(
            step=step_idx,
            prefill=(0 if plan.prefill is None else int(plan.prefill[2])),
            decode=len(plan.decode), preempted=len(plan.preempted),
            queue_depth=len(self.scheduler.waiting),
            occupancy=len(plan.decode) / max(self.max_slots, 1),
            pool_util=round(self.pool.utilization, 4),
            dur_s=dur, failures=failed_phases,
            prefill_rids=prefill_rids, decode_rids=decode_rids,
            prefix_hit_tokens=dhit_tok, cow=dcow,
            cached_blocks=self.pool.num_cached,
            kernel=self.paged_kernel, spec=self.spec_mode,
            spec_accepted=self._spec_step_accepted, **host_extra)
        self._maybe_publish_fleet()
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

    # -- lifecycle ---------------------------------------------------------
    def drain(self, deadline_s: float | None = None) -> dict[int, Sequence]:
        """Graceful shutdown: stop admissions (new ``add_request`` calls
        shed with cause ``draining``), run every in-flight request to
        completion under a deadline (``FLAGS_serving_drain_timeout_s``
        when None), finish stragglers still in flight at the deadline
        with terminal reason ``cancelled``, and land in STOPPED. Returns
        everything that finished during the drain, keyed by request id.
        Draining a STOPPED engine returns {}."""
        if self.lifecycle.state == STOPPED:
            return {}
        self.lifecycle.to(DRAINING)
        if deadline_s is None:
            deadline_s = float(flag_value("serving_drain_timeout_s"))
        deadline = now_s() + float(deadline_s)
        done: dict[int, Sequence] = {}
        while self.has_work() and now_s() < deadline:
            for seq in self.step():
                done[seq.req_id] = seq
        for seq in list(self.requests.values()):   # deadline stragglers
            self._finish_terminal(seq, CANCELLED, [])
            done[seq.req_id] = seq
        self.lifecycle.to(STOPPED)
        # the end-of-life postmortem: the last steps, the final health
        # and the resolved goodput ledger in one document
        telemetry.dump_flight("drain", health=self.health(),
                              extra={"drained": len(done)})
        if self._fleet_publish is not None:
            # the fleet view must see STOPPED
            self._publish_fleet_snapshot()
        return done

    def enable_fleet_publish(self, store, rank: int,
                             every_steps: int | None = None) -> None:
        """Publish health to a store: every ``every_steps`` engine steps
        (``FLAGS_serving_fleet_publish_every`` when None; <= 0 disables)
        the engine pushes its telemetry snapshot with :meth:`health` as
        its ``serving`` section under ``/telemetry/rank<N>``
        (``telemetry.push_snapshot``), the keys a fleet router and
        ``telemetry.collect_fleet`` read. ``store`` is any object with
        ``set(key, bytes)`` and ``get(key, default=)``. One snapshot is
        pushed at once, so a router sees the replica before its first
        step."""
        every = int(flag_value("serving_fleet_publish_every")
                    if every_steps is None else every_steps)
        if every <= 0:
            self._fleet_publish = None
            return
        self._fleet_publish = (store, int(rank), every)
        self._publish_fleet_snapshot()

    def _maybe_publish_fleet(self) -> None:
        if self._fleet_publish is None:
            return
        if self.metrics.steps % self._fleet_publish[2] == 0:
            self._publish_fleet_snapshot()

    def _publish_fleet_snapshot(self) -> None:
        store, rank, _ = self._fleet_publish
        try:
            telemetry.push_snapshot(store, rank, serving=self.health())
        except (ConnectionError, OSError) as e:
            # publishing is observability, not the data path: a store
            # blip never takes the serving loop down
            robustness._report_degraded("serving.fleet.publish", e)

    def readiness_probe(self) -> bool:
        """One scratch prefill and decode round trip through the model,
        the gate before a respawned replica takes traffic. Every write
        lands in the pool's scratch block 0 (all-zero tables), so no
        scheduler or pool state moves. A third, timed decode dispatch
        seeds a cold admission estimator. Returns False (and reports)
        instead of raising."""
        try:
            ids = np.zeros((1, self._bucket(1)), np.int32)
            last = self._dispatch(
                ids, np.asarray([0], np.int32), np.asarray([1], np.int32),
                np.zeros((1, self.max_blocks), np.int32))
            if not np.all(np.isfinite(last)):
                return False
            zeros = np.zeros(self.max_slots, np.int32)
            last = self._dispatch(
                np.zeros((self.max_slots, 1), np.int32), zeros, zeros,
                np.zeros((self.max_slots, self.max_blocks), np.int32))
            if not np.all(np.isfinite(last)):
                return False
            # the dispatch returns host logits, so the device is done
            t0 = now_s()
            last = self._dispatch(
                np.zeros((self.max_slots, 1), np.int32), zeros, zeros,
                np.zeros((self.max_slots, self.max_blocks), np.int32))
            probe_s = now_s() - t0
            if probe_s > 0.0:
                self._admission.seed(self.max_slots / probe_s)
            return bool(np.all(np.isfinite(last)))
        except Exception as e:
            robustness._report_degraded("serving.readiness_probe", e)
            return False

    def routing_signals(self) -> tuple[str, float, int, float, int]:
        """(lifecycle state, estimated queue delay seconds, waiting depth,
        slot occupancy, resident in-flight tokens): the per-request
        routing inputs a fleet router reads, equal to the same fields of
        :meth:`health` without building the whole document."""
        return (self.lifecycle.state,
                self._admission.estimated_delay_s(self.scheduler),
                len(self.scheduler.waiting),
                len(self.scheduler.active) / max(self.max_slots, 1),
                sum(s.ctx for s in self.requests.values()))

    def health(self) -> dict:
        """One self-describing snapshot of engine liveness, the serving
        analog of a /healthz body. The lifecycle state is also exported
        as one-hot ``serving_health_state`` telemetry gauges."""
        m = self.metrics
        return {
            "state": self.lifecycle.state,
            "state_since_s": self.lifecycle.since_s,
            "degraded_reason": self.lifecycle.degraded_reason,
            # the role in a role-split fleet and the lifetime handoffs
            "role": self.fleet_role,
            "handoffs": {"out": self._handoffs_out,
                         "in": self._handoffs_in},
            "waiting": len(self.scheduler.waiting),
            "active": len(self.scheduler.active),
            "in_flight": len(self.requests),
            "pool_utilization": round(self.pool.utilization, 4),
            "steps": m.steps,
            "last_step_s": self._last_step_s,
            "estimated_queue_delay_s": round(
                self._admission.estimated_delay_s(self.scheduler), 6),
            "occupancy": len(self.scheduler.active) / max(self.max_slots, 1),
            "resident_tokens": sum(s.ctx for s in self.requests.values()),
            "terminal_reasons": dict(m.terminal),
            "sheds": dict(m.sheds),
            "step_failures": dict(m.step_failures),
            "hung_steps": m.hung_steps,
            "tokens_computed": m.tokens_computed,
            "token_ledger": dict(m.ledger),
            "goodput_ratio": round(m.goodput_ratio, 4),
            # which attend the dispatches run (the device picks)
            "paged_kernel": self.paged_kernel,
            "spec": {
                "mode": self.spec_mode,
                "proposer": (None if self._proposer is None
                             else self._proposer.name),
                "lookahead": (self._spec_k
                              if self.spec_mode != "off" else 0),
                "proposed": self._spec_proposed_life,
                "accepted": self._spec_accepted_life,
                "accept_rate": (
                    None if self._spec_proposed_life <= 0
                    else round(self._spec_accepted_life
                               / self._spec_proposed_life, 4)),
            },
            # from the pool's own lifetime counters
            "prefix_cache": {
                "enabled": self.pool.prefix_cache,
                "hits": self.pool.prefix_hits,
                "hit_tokens": self.pool.prefix_hit_tokens,
                "miss_tokens": self.pool.prefix_miss_tokens,
                "cow_copies": self.pool.cow_copies,
                "cached_blocks": self.pool.num_cached,
            },
            # host-tier residency and restore traffic (None: tier off)
            "host_tier": (None if self.pool.host_tier is None else {
                "hits": self.pool.host_hits,
                "hit_tokens": self.pool.host_hit_tokens,
                "restore_failures": self.pool.host_restore_failures,
                **self.pool.host_tier.stats(),
            }),
        }

    def _on_phase_failure(self, planned: list[Sequence], phase: str,
                          exc: Exception, finished: list[Sequence]) -> None:
        """Blame for a failing plan component. Host-side sampling
        failures name their rows (SampleFailures), so only those
        sequences are charged a retry; a dispatch failure cannot be
        attributed and charges the whole component."""
        if isinstance(exc, SampleFailures):
            # row-precise charges, one flight dump naming every row the
            # loop quarantined
            entered, quarantined = False, []
            for seq, row_exc in exc.failures:
                ent, q = handle_step_failure(self, [seq], phase, row_exc,
                                             finished, dump=False)
                entered = entered or ent
                quarantined.extend(q)
            dump_step_failure(self, phase, repr(exc), quarantined, entered)
        else:
            handle_step_failure(self, planned, phase, exc, finished)

    def _finish_terminal(self, seq: Sequence, reason: str,
                         finished: list[Sequence]) -> None:
        """Finish a sequence OUTSIDE the eos/length path (expired,
        cancelled, failed): blocks freed from wherever it is, removed
        from the in-flight map, the terminal reason recorded on the
        Sequence and in the metrics."""
        seq.finish_reason = reason
        seq.outcome = reason
        seq.finish_s = now_s()
        self.scheduler.remove(seq)
        self.requests.pop(seq.req_id, None)
        self.metrics.on_terminal(reason)
        self.metrics.resolve_ledger(seq)
        self._spec_forget(seq)
        note_event(seq, "terminal", outcome=reason,
                   output_tokens=len(seq.output))
        finished.append(seq)

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

    def _note_attn_bytes(self, rows) -> None:
        """The attention-bytes ledger for one dispatch; ``rows`` is
        ``[(position, chunk_len, seq)]``. Touched: the UNIQUE context K/V
        bytes the dispatch addresses through the block tables, each row's
        blocks up to its causal horizon (the volume any implementation
        must stream; K5's own reads of idle rows and repeated blocks are
        not counted). Dense: what a static-buffer decode would read for
        the same rows, each row's full final-length buffer (prompt +
        max_new_tokens)."""
        touched = dense = 0
        for pos, n, seq in rows:
            nb = min((pos + n - 1) // self.block_size + 1, self.max_blocks)
            touched += nb * self.block_size
            dense += seq.prompt_len + seq.max_new_tokens
        self.metrics.on_attn_bytes(touched * self._kv_token_bytes,
                                   dense * self._kv_token_bytes)

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
        # fault point BEFORE the dispatch: the pool buffers stay
        # untouched and the recompute replay is exact
        fault_point("serving.prefill", step=self.metrics.steps,
                    key=str(seq.req_id))
        # a chunk starting inside a SHARED acquired block copies it first
        # (the scheduler reserved the block when it planned the chunk)
        self._apply_cow(self.pool.prepare_write(seq.req_id, start, n))
        ids = np.zeros((1, self._bucket(n)), np.int32)
        ids[0, :n] = seq.tokens[start:start + n]
        last = self._dispatch(ids, np.asarray([start], np.int32),
                              np.asarray([n], np.int32),
                              self._table_row(seq)[None, :])
        seq.ctx = start + n
        self._note_attn_bytes([(start, n, seq)])
        self.pool.register_prefix_blocks(seq.req_id, seq.tokens, seq.ctx)
        # the chunk's K/V exists now: count it even if sampling fails
        # (a replay counts it again, as replay work)
        self.metrics.on_tokens_computed(seq, start, n)
        note_event(seq, "prefill_chunk", start=start, tokens=n,
                   step=self.metrics.steps)
        if seq.ctx >= seq.prefill_target:
            # the chunk that completes the context yields the next token
            # (a fresh prompt and a replay alike)
            try:
                tok = self._sample(last[0], seq)
            except Exception as e:
                raise SampleFailures([(seq, e)]) from e
            self._emit(seq, tok, finished)

    def _run_decode(self, seqs: list[Sequence],
                    finished: list[Sequence]) -> None:
        fault_point("serving.decode", step=self.metrics.steps)
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
        self._note_attn_bytes([(s.ctx, 1, s) for s in seqs])
        row_failures = []
        with telemetry.span("serving/sample", cat="Serving",
                            step=self.metrics.steps,
                            rids=[s.req_id for s in seqs]):
            for i, seq in enumerate(seqs):
                seq.ctx += 1
                try:
                    tok = self._sample(last[i], seq)
                except Exception as e:
                    # back to ctx == len(tokens) - 1 before recovery (the
                    # replay rewrites this row's K/V); the other rows'
                    # logits are valid, so they keep emitting
                    seq.ctx -= 1
                    row_failures.append((seq, e))
                    continue
                # the row's K/V (position ctx - 1) counts only when its
                # row sampled cleanly; a failed row's replay recomputes it
                self.metrics.on_tokens_computed(seq, seq.ctx - 1, 1)
                self.pool.register_prefix_blocks(seq.req_id, seq.tokens,
                                                 seq.ctx)
                self._emit(seq, tok, finished)
        if row_failures:
            raise SampleFailures(row_failures)

    # -- speculative decoding ----------------------------------------------
    def _spec_forget(self, seq: Sequence) -> None:
        """Drop proposer-side draft state of a sequence whose blocks
        were rewound, finished or freed."""
        if self._proposer is not None:
            self._proposer.forget(seq.req_id)

    def _spec_degrade(self, seq: Sequence, site: str,
                      exc: Exception) -> None:
        """A proposer or verify failure is a SPEED fault, not a
        correctness one: plain decode serves the sequence just as
        correctly. Degrade exactly this sequence to plain decode for the
        rest of its life: one report, no retry charged, no quarantine."""
        robustness._report_degraded(site, exc)
        seq.spec_off = True
        note_event(seq, "spec_degraded", site=site)
        self._spec_forget(seq)

    def _run_spec_decode(self, seqs: list[Sequence], plan_k: dict,
                         finished: list[Sequence]) -> int:
        """Decode with verify rows: every RUNNING sequence rides the
        ``[max_slots, W]`` full-logits batch, a drafting row with its
        last token + k drafts, a plain row with length 1. Acceptance
        keeps the longest draft prefix the target would have produced;
        ``pool.trim`` rewinds the rejected positions. Returns the tokens
        dispatched (the admission estimator's measure of work)."""
        # propose BEFORE the decode fault point, so a propose fault
        # degrades without using the decode site's times= budget
        drafts: dict[int, list[int]] = {}
        for seq in seqs:
            k = int(plan_k.get(seq.req_id, 0))
            if k <= 0 or seq.spec_off:
                continue
            try:
                fault_point("serving.spec.propose", step=self.metrics.steps,
                            key=str(seq.req_id))
                d = self._proposer.propose(seq, k, self._table_row(seq))
            except Exception as e:
                self._spec_degrade(seq, "serving.spec.propose", e)
                continue
            d = [int(t) for t in d[:k]]
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
            return len(seqs)
        fault_point("serving.decode", step=self.metrics.steps)
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
        self._note_attn_bytes([(seq.ctx, m, seq) for _, seq, _, m in rows])
        n_tokens = int(sum(m for _, _, _, m in rows))
        row_failures = []
        with telemetry.span("serving/sample", cat="Serving",
                            step=self.metrics.steps,
                            rids=[s.req_id for s in seqs]):
            for i, seq, d, m in rows:
                start = seq.ctx
                toks = None
                accepted = 0
                if d:
                    try:
                        # the per-emission fault point keeps targeting a
                        # request whose emissions ride verify rows; it
                        # fires before any draw, so a replay samples from
                        # an unconsumed stream
                        fault_point("serving.sample",
                                    step=self.metrics.steps,
                                    key=str(seq.req_id))
                    except Exception as e:
                        row_failures.append((seq, e))
                        continue
                    t0 = now_s()
                    try:
                        fault_point("serving.spec.verify",
                                    step=self.metrics.steps,
                                    key=str(seq.req_id))
                        toks, accepted = verify_draft(full[i, :m], d, seq)
                    except Exception as e:
                        # the row's first position is the plain decode's
                        # own distribution: degrade and fall through to
                        # it. d is cleared so a fault is never charged to
                        # the proposer's acceptance; the dispatched drafts
                        # still count as spec_rejected work
                        self._spec_degrade(seq, "serving.spec.verify", e)
                        toks, accepted, d = None, 0, []
                    finally:
                        self._sample_s += now_s() - t0
                if toks is None:
                    try:
                        toks = [self._sample(full[i, 0], seq)]
                    except Exception as e:
                        # the row emits nothing; the replay rewinds its K/V
                        row_failures.append((seq, e))
                        continue
                # tokens past eos or the length limit are dropped; the
                # row's compute is booked before the emission that may
                # finish the request (and resolve its ledger)
                emitted, out_len = 0, len(seq.output)
                eos = seq.eos_token_id
                for tok in toks:
                    emitted += 1
                    if ((eos is not None and tok == int(eos))
                            or out_len + emitted >= seq.max_new_tokens):
                        break
                new_ctx = start + emitted
                # kept span [start, new_ctx); rejected = dispatched
                # positions whose K/V is discarded
                self.metrics.on_spec_tokens(seq, start, emitted,
                                            m - emitted)
                # rewind and register BEFORE emission, as the plain path
                # does: a burst that finishes the request frees its blocks
                # in _emit, and only registered blocks park in the cached
                # set. The kept K/V was computed from seq.tokens plus all
                # but the last emitted token; trim keeps one more position
                # so the next decode write's block survives
                self.pool.trim(seq.req_id, new_ctx + 1)
                self.pool.register_prefix_blocks(
                    seq.req_id, seq.tokens + toks[:emitted - 1], new_ctx)
                prev = seq.last_token_s
                for tok in toks[:emitted]:
                    self._emit(seq, tok, finished, note_gap=False)
                seq.ctx = new_ctx
                self._note_token_gaps(seq, emitted, now_s(), prev)
                if d:
                    self.metrics.on_spec_verify(self._proposer.name,
                                                len(d), accepted)
                    self._spec_proposed_life += len(d)
                    self._spec_accepted_life += accepted
                    note_acceptance(seq, len(d), accepted)
                    self._spec_step_accepted += max(0, emitted - 1)
                    if not seq.is_finished:
                        self._proposer.observe(seq, start, len(d))
        self.metrics.on_spec_step(self._spec_step_accepted)
        if row_failures:
            raise SampleFailures(row_failures)
        return n_tokens

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
        # fault point per emission: a mid-batch failure leaves earlier
        # rows emitted; the replay keeps emitted tokens verbatim (the
        # request's generator advances only on real draws)
        t0 = now_s()
        try:
            fault_point("serving.sample", step=self.metrics.steps,
                        key=str(seq.req_id))
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
            note_event(seq, "first_token", t_s=now,
                       ttft_s=round(now - seq.arrival_s, 6))
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
            tpot = None
            if len(seq.output) > 1:
                # the request's mean gap, for the TPOT SLO check only
                # (the percentile stream is fed per token)
                tpot = ((seq.finish_s - seq.first_token_s)
                        / (len(seq.output) - 1))
            self.metrics.on_finish(tpot)
            self.metrics.resolve_ledger(seq)
            self._spec_forget(seq)
            note_event(seq, "terminal", t_s=now, outcome=OK,
                       reason=seq.finish_reason,
                       output_tokens=len(seq.output))
            self.scheduler.remove(seq)
            self.requests.pop(seq.req_id, None)   # the caller owns it now
            finished.append(seq)


__all__ = ["ServingEngine", "sample_token", "PREFILL", "RUNNING"]
