"""Speculative decoding: proposers and lossless acceptance (port of
``serving/speculation.py``).

A PROPOSER guesses k draft tokens per decoding sequence; the target
model scores the last emitted token plus the k drafts in one ragged
multi-token VERIFY row (the paged forward already takes mid-context rows
of several tokens), and host-side ACCEPTANCE keeps the longest draft
prefix the target itself would have produced. An accepted step emits
several tokens for one pass over the weights.

Losslessness. Both proposers are deterministic, so the proposal is a
point mass at the draft token x, and the standard rule (accept with
probability ``min(1, p(x)/q(x))``, else resample the residual) reduces
to SAMPLE-AND-MATCH: draw the target's own sample t ~ p and accept iff
``t == x``. Greedy (temperature <= 0) accepts while the argmax matches,
so the emitted tokens are the dense path's. Stochastic verification
draws from the request's own ``seq.rng`` exactly ONE categorical per
EMITTED token, in position order, from the same processed distribution
as ``engine.sample_token`` (:func:`processed_probs`), so seeded outputs
equal the spec-off engine's token for token, whatever lookahead the
scheduler granted.

Sampling stays host-side numpy with a per-request
``np.random.default_rng(seed)``, as in the JAX package, so a seeded
stochastic request draws the same tokens in both packages.

Proposers:

- :class:`NgramProposer`: the longest recent suffix n-gram that occurs
  earlier in the request's own tokens proposes what followed it. No
  device work.
- :class:`DraftModelProposer`: a small model proposes greedily. It keeps
  its own per-layer K/V buffers ``[num_blocks, block_size, kv, d]``
  addressed through the TARGET's block tables, so allocation, rewind and
  preemption need no second accounting; the engine mirrors the target's
  copy-on-write into them (:meth:`DraftModelProposer.on_cow`).

Adaptive lookahead: a sequence whose rolling acceptance rate falls below
``FLAGS_serving_spec_min_accept`` backs off to 1 draft until it
recovers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..flags import flag_value
from .paged_attention import gather_copy_blocks, paged_forward

# rolling acceptance window: the WINDOW most recent (proposed, accepted)
# pairs per sequence; back-off waits for PRIMED proposed tokens
SPEC_WINDOW = 16
SPEC_PRIMED = 8

# how far back the n-gram proposer's suffix scan looks: host work per
# proposal stays O(n_max * window), flat in context length
NGRAM_SCAN_WINDOW = 512

SPEC_MODES = ("off", "ngram", "draft")


def processed_probs(logits: np.ndarray, seq) -> np.ndarray:
    """The request's processed distribution over one f32 logits row:
    temperature, then top-k, then top-p. Callers guarantee
    ``seq.temperature > 0``."""
    logits = np.asarray(logits, dtype=np.float32)
    logits = logits / seq.temperature
    if seq.top_k > 0:
        k = min(seq.top_k, logits.size)   # top_k >= vocab keeps all
        kth = np.partition(logits, -k)[-k]
        logits = np.where(logits < kth, -1e30, logits)
    if 0.0 < seq.top_p < 1.0:
        srt = np.sort(logits)[::-1]
        probs = np.exp(srt - srt.max())
        probs /= probs.sum()
        keep = (np.cumsum(probs) - probs) < seq.top_p
        cutoff = srt[keep].min()
        logits = np.where(logits < cutoff, -1e30, logits)
    z = logits - logits.max()
    p = np.exp(z)
    return p / p.sum()


def verify_draft(logits: np.ndarray, draft: list[int], seq):
    """Lossless acceptance over one verify row.

    ``logits`` is ``[1 + len(draft), vocab]``: row i is the target's
    next-token distribution after the row's token i (token 0 is the last
    emitted token, then the drafts), so ``draft[i]`` is judged against
    ``logits[i]`` and full acceptance earns a bonus token from
    ``logits[-1]``. Returns ``(tokens, accepted)``: the tokens to emit
    (always ``accepted + 1``) and the accepted draft count."""
    out: list[int] = []
    k = len(draft)
    if seq.temperature <= 0.0:
        for i in range(k):
            t = int(np.argmax(logits[i]))
            out.append(t)
            if t != int(draft[i]):
                return out, i          # the correction is emitted; stop
        out.append(int(np.argmax(logits[k])))
        return out, k
    for i in range(k):
        # sample-and-match: one draw, as the dense path would make it
        p = processed_probs(logits[i], seq)
        t = int(seq.rng.choice(len(p), p=p))
        out.append(t)
        if t != int(draft[i]):
            return out, i
    p = processed_probs(logits[k], seq)
    out.append(int(seq.rng.choice(len(p), p=p)))
    return out, k


def note_acceptance(seq, proposed: int, accepted: int) -> None:
    """Fold one verify outcome into the sequence's rolling window."""
    seq.spec_hist.append((int(proposed), int(accepted)))
    if len(seq.spec_hist) > SPEC_WINDOW:
        del seq.spec_hist[0]


def acceptance_rate(seq) -> float | None:
    """Rolling acceptance rate, or None while the window holds fewer
    than SPEC_PRIMED proposed tokens."""
    prop = sum(p for p, _ in seq.spec_hist)
    if prop < SPEC_PRIMED:
        return None
    return sum(a for _, a in seq.spec_hist) / prop


def adaptive_k(seq, k: int) -> int:
    """The configured k, backed off to 1 while the rolling acceptance
    rate is below ``FLAGS_serving_spec_min_accept`` (0 disables). 1, not
    0, so acceptance can recover."""
    floor = float(flag_value("serving_spec_min_accept"))
    if k <= 1 or floor <= 0.0:
        return k
    rate = acceptance_rate(seq)
    if rate is not None and rate < floor:
        return 1
    return k


class NgramProposer:
    """Propose the continuation of the most recent earlier occurrence of
    the current suffix: the longest suffix n-gram wins (n from
    ``FLAGS_serving_spec_ngram_max`` down to 1), then the latest
    occurrence, within the last ``NGRAM_SCAN_WINDOW`` positions."""

    name = "ngram"

    def propose(self, seq, k: int, table_row=None) -> list[int]:
        del table_row
        toks = seq.tokens
        n_max = max(1, int(flag_value("serving_spec_ngram_max")))
        last = len(toks)
        floor = max(0, last - NGRAM_SCAN_WINDOW)
        for n in range(min(n_max, last - 1), 0, -1):
            suffix = toks[last - n:]
            for j in range(last - n - 1, floor - 1, -1):
                if toks[j:j + n] == suffix:
                    # j + n <= last - 1: a continuation token exists
                    return [int(t) for t in toks[j + n:j + n + k]]
        return []

    # draft-state hooks: the n-gram proposer keeps none
    def observe(self, seq, start: int, k: int) -> None:
        pass

    def forget(self, rid: int) -> None:
        pass

    def on_cow(self, copies) -> None:
        pass


class DraftModelProposer:
    """Greedy small-model proposer over the target pool's block tables.

    Its own K/V buffers ``[num_blocks, block_size, draft_kv, draft_d]``
    per layer, on the target's device, are read and written through the
    SAME per-sequence tables as the target's. A proposal first runs a
    bucketed catch-up prefill from the draft's context high-water
    (``_ctx``) to the sequence's, then k one-token greedy steps write
    positions ``ctx .. ctx+k-1`` and give the argmax chain. A catch-up
    write into a block shared through the prefix index writes the same
    tokens at the same positions, so the draft needs no copy-on-write
    of its own; the engine mirrors the target's (:meth:`on_cow`).
    ``dispatches`` counts the draft's model calls."""

    name = "draft"

    def __init__(self, model, pool, *, num_layers, kv_heads, head_dim,
                 prefill_chunk, dtype=None):
        self.model = model
        self.num_layers = int(num_layers)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.prefill_chunk = int(prefill_chunk)
        device = next(model.parameters()).device
        if device.type != pool.device.type:
            raise ValueError(f"draft model lives on {device}, the pool on "
                             f"{pool.device}")
        if dtype is None:
            dtype = next((p.dtype for p in model.parameters()
                          if p.is_floating_point()), torch.float32)
        shape = (pool.num_blocks, pool.block_size, self.kv_heads,
                 self.head_dim)
        self.kbufs = [torch.zeros(shape, dtype=dtype, device=device)
                      for _ in range(self.num_layers)]
        self.vbufs = [torch.zeros(shape, dtype=dtype, device=device)
                      for _ in range(self.num_layers)]
        # per-rid draft high-water: positions below it hold VALID draft
        # K/V for the rid's current token path
        self._ctx: dict[int, int] = {}
        self.dispatches = 0

    def _dispatch(self, ids, positions, lengths, table):
        self.dispatches += 1
        return paged_forward(self.model, self.kbufs, self.vbufs, ids,
                             positions, lengths, table)

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.prefill_chunk)

    def propose(self, seq, k: int, table_row=None) -> list[int]:
        if table_row is None:
            raise ValueError("DraftModelProposer needs the sequence's "
                             "block-table row")
        rid = seq.req_id
        table = np.asarray(table_row, np.int32)[None, :]
        # catch up to the target's context (a rewound or new sequence
        # restarts at 0: its blocks are new)
        dctx = min(self._ctx.get(rid, 0), seq.ctx)
        while dctx < seq.ctx:
            n = min(self.prefill_chunk, seq.ctx - dctx)
            ids = np.zeros((1, self._bucket(n)), np.int32)
            ids[0, :n] = seq.tokens[dctx:dctx + n]
            self._dispatch(ids, np.asarray([dctx], np.int32),
                           np.asarray([n], np.int32), table)
            dctx += n
        drafts: list[int] = []
        cur = int(seq.tokens[-1])
        for i in range(k):
            last = self._dispatch(np.asarray([[cur]], np.int32),
                                  np.asarray([seq.ctx + i], np.int32),
                                  np.asarray([1], np.int32), table)
            cur = int(np.argmax(last[0]))
            drafts.append(cur)
        self._ctx[rid] = seq.ctx + k
        return drafts

    def observe(self, seq, start: int, k: int) -> None:
        """After verification: positions ``start .. seq.ctx-1`` carried
        the accepted tokens, which the draft consumed too; everything
        past the accepted point, or past what the proposal wrote, is
        stale."""
        self._ctx[seq.req_id] = min(seq.ctx, start + k)

    def forget(self, rid: int) -> None:
        self._ctx.pop(rid, None)

    def on_cow(self, copies) -> None:
        """Mirror the target's copy-on-write into the draft buffers, so
        a privatised block keeps its draft rows."""
        for src, dst in copies:
            gather_copy_blocks(self.kbufs, self.vbufs, src, dst)


def build_proposer(mode: str, *, engine=None, draft_model=None):
    """The engine's factory for ``FLAGS_serving_spec`` modes."""
    if mode == "ngram":
        return NgramProposer()
    if mode == "draft":
        if draft_model is None:
            raise ValueError(
                "FLAGS_serving_spec=draft needs a draft model: pass "
                "ServingEngine(..., draft_model=small_model)")
        cfg = getattr(draft_model, "config", None)
        if cfg is None:
            raise ValueError("cannot infer draft-model geometry")
        kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        return DraftModelProposer(
            draft_model, engine.pool, num_layers=cfg.num_hidden_layers,
            kv_heads=kv, head_dim=cfg.hidden_size // cfg.num_attention_heads,
            prefill_chunk=engine.prefill_chunk)
    raise ValueError(f"FLAGS_serving_spec={mode!r} (want one of "
                     f"{'/'.join(SPEC_MODES)})")
