"""Paged KV-cache block pool with refcounted prefix sharing (port of
``serving/kv_pool.py``).

The cache is a pool of fixed-size blocks,
``[num_blocks, block_size, kv_heads, head_dim]`` per layer, on the
model's device. A sequence holds a BLOCK TABLE of pool indices covering
exactly the context it has produced; blocks are allocated on demand and
returned on finish or preemption, and the attention kernel addresses
K/V through the table (``serving/paged_attention.py``).

PREFIX CACHING (``FLAGS_serving_prefix_cache``): every block is
refcounted (one count per table that references it). Full blocks whose
content is final are registered in an exact radix index keyed on
``(parent_block_id, block_tokens)``, so a new request acquires the
longest resident full-block prefix of its prompt by bumping refcounts
instead of recomputing it. The match is capped at ``len(tokens) - 1``,
so the last acquired block may cover positions the request still has to
write: the first write into a block with refcount > 1 is a
COPY-ON-WRITE (:meth:`KVBlockPool.prepare_write` returns the
``(src, dst)`` pairs the caller copies on the device before writing). A
sole-owner block that is merely indexed is deregistered and written in
place. Freed blocks that are registered park in an LRU ``cached`` set,
which the allocator reclaims oldest first before it raises
:class:`PoolOOM`; ``check_invariants`` accounts
``allocated + cached + free == usable``.

Host-side accounting lives here: a LIFO free list (freshly freed blocks
are reused first) with an O(1) membership set, per-sequence tables,
refcounts, the prefix index and alloc/free/OOM/hit/COW counters. Block 0
is RESERVED as scratch: padding rows of a bucketed prefill chunk and
idle decode slots write there, so the step needs no conditional write.
Scratch contents are garbage by design and the attention mask
guarantees they are never read by a real row.

TIERED eviction (``FLAGS_serving_host_tier``, ``host_tier.py``): a
block leaving the device cached set (cap eviction, allocator reclaim or
a parent's cascade) SPILLS its contents under its full token path to a
bounded LRU host-RAM store instead of vanishing, and
:meth:`KVBlockPool.acquire_prefix` on a chain whose continuation is
host-resident restores those blocks into fresh device blocks before it
moves the request past them. A token path is resident in exactly ONE
tier: a spill moves it host-ward, a restore (or a cold recompute that
re-registers the path) moves it back, and ``check_invariants`` enforces
it. Restores draw from the FREE list only and never evict device-cached
chains to make room (two tiers trading the same blocks would thrash).

Device layout: all layers' K and V live in ONE tensor
``[2, num_layers, num_blocks, block_size, kv_heads, head_dim]``;
``kbufs[l]`` and ``vbufs[l]`` are its contiguous per-layer views. So one
block of every layer is one strided slice: a spill is one device-to-host
copy into a pinned host block (after one gather into a contiguous
temporary), a restore one host-to-device copy and one scatter, not
``2 * num_layers`` copies each. On a CUDA pool both run with
``non_blocking=True`` on the current stream, so they are ordered before
the next write to the block and before the prefill that reads it; the
pool keeps each copy's host tensors referenced until an event recorded
after the copy has passed. Host code that reads a spilled entry's bytes
synchronises first.

Allocation is all-or-nothing: :meth:`KVBlockPool.ensure` either extends
a table to cover the requested tokens (plus a copy-on-write
reservation) or raises :class:`PoolOOM` with the pool untouched; the
scheduler's preemption depends on that. Its ``serving.pool_alloc``
fault point (``distributed/fault.py``) fires before any accounting, so
an injected blip leaves the pool as a refused allocation would.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from ..flags import flag_value
from ..framework.device import resolve_device
from .host_tier import HostTier
from .robustness import fault_point

# sentinel parent id for the first block of a token path in the prefix
# index (block ids are >= 1, so -1 can never collide)
_ROOT = -1


class PoolOOM(RuntimeError):
    """The pool cannot supply the requested blocks. Raised by
    ``ensure`` (state unchanged); the scheduler treats it as the
    preemption trigger, ``add_request`` as an admission error."""


@dataclass
class PagedLayerCache:
    """One layer's view of the pool for a step: the layer's K/V block
    buffers plus this batch's block tables and valid lengths.
    ``models/generation.cached_attention`` dispatches on
    ``block_tables``."""

    kbuf: torch.Tensor            # [num_blocks, block_size, kv, d]
    vbuf: torch.Tensor
    block_tables: torch.Tensor    # [B, max_blocks] int32
    lengths: torch.Tensor         # [B] int32: valid rows of the chunk


class KVBlockPool:
    """Fixed-size KV block pool shared by every sequence of an engine.
    ``device=None`` is the card (it raises without one); pass
    ``device="cpu"`` for the CPU.

    Every usable block is in exactly ONE of three states:

    - **allocated**: referenced by >= 1 table (``_ref[b]`` counts them;
      a shared prefix block has refcount > 1);
    - **cached**: refcount 0 but registered in the prefix index,
      parked in an LRU set, reused on a prefix hit or reclaimed by the
      allocator under pressure;
    - **free**: on the LIFO free list (``_free_set`` mirrors it for
      O(1) double-free detection).
    """

    def __init__(self, *, num_layers, num_blocks, block_size, kv_heads,
                 head_dim, dtype=torch.float32, device=None,
                 prefix_cache=None, host_tier=None):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved "
                f"scratch block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        # zeros: scratch and never-written blocks hold finite values,
        # which idle rows and masked columns may read. One tensor for
        # every layer's K and V, so a block of all layers is one slice
        self._kv = torch.zeros(
            (2, self.num_layers, self.num_blocks, self.block_size,
             self.kv_heads, self.head_dim), dtype=dtype, device=self.device)
        self.kbufs = list(self._kv[0])
        self.vbufs = list(self._kv[1])
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._tables: dict[int, list[int]] = {}
        # block -> tables referencing it (allocated blocks only)
        self._ref: dict[int, int] = {}
        # prefix index: (parent block | _ROOT, tokens) -> block, its
        # exact reverse map, and each parent's registered children (a
        # parent's reuse cascades them out of the index)
        self._index: dict[tuple, int] = {}
        self._block_key: dict[int, tuple] = {}
        self._children: dict[int, set[int]] = {}
        # zero-ref registered blocks, oldest first (LRU reclaim)
        self._cached: OrderedDict[int, None] = OrderedDict()
        # per-seq count of table blocks already registered, so
        # registration costs O(new full blocks) per step
        self._registered: dict[int, int] = {}
        self.prefix_cache = (bool(flag_value("serving_prefix_cache"))
                             if prefix_cache is None else bool(prefix_cache))
        # the host-RAM spill tier: built only when both the prefix cache
        # and the flag (or argument) say so; None leaves every eviction
        # and allocation path as it is without it
        if host_tier is None:
            host_tier = bool(flag_value("serving_host_tier"))
        self.host_tier = (HostTier()
                          if (self.prefix_cache and host_tier) else None)
        # (event, host tensors) of asynchronous tier copies still in
        # flight on the device, oldest first
        self._inflight: deque = deque()
        self.allocs = 0
        self.frees = 0
        self.oom_events = 0
        self.prefix_hits = 0          # lookups that matched >= min blocks
        self.prefix_hit_tokens = 0    # tokens served from resident blocks
        self.prefix_miss_tokens = 0   # cacheable tokens with no match
        self.cow_copies = 0           # copy-on-write block duplications
        self.cached_evictions = 0     # cached blocks reclaimed/aged out
        self.host_hits = 0            # acquires that restored host blocks
        self.host_hit_tokens = 0      # tokens served from restored blocks
        self.host_restore_failures = 0  # restore-path faults (fell cold)
        self._last_restored = 0       # host tokens of the LAST acquire

    # -- capacity accounting ---------------------------------------------
    @property
    def num_usable(self) -> int:
        """Blocks available to sequences (everything but scratch)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Zero-ref prefix blocks parked for reuse: reclaimable, counted
        apart from both allocated and free."""
        return len(self._cached)

    @property
    def num_allocated(self) -> int:
        return self.num_usable - len(self._free) - len(self._cached)

    @property
    def utilization(self) -> float:
        return self.num_allocated / max(self.num_usable, 1)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold n_tokens."""
        return -(-int(n_tokens) // self.block_size)

    # -- sequence lifecycle ----------------------------------------------
    def table(self, seq_id: int) -> list[int]:
        """A COPY of seq_id's block table ([] when unknown)."""
        return list(self._tables.get(seq_id, ()))

    def holds(self, seq_id: int) -> bool:
        """Whether seq_id references any blocks."""
        return bool(self._tables.get(seq_id))

    # -- host tier plumbing ------------------------------------------------
    def _hold(self, tensors) -> None:
        """Keep the host tensors of an asynchronous copy just enqueued
        on the current stream alive until an event recorded after it has
        passed, and let go of those whose copies have landed."""
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._inflight.append((event, tensors))
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()

    def _token_path(self, b: int) -> tuple:
        """Block b's full token tuple from the chain root: the host
        tier's self-anchoring key (the index's ``(parent, tokens)`` key
        dies with the parent's block id). Only valid while b is
        registered; every ancestor is then registered too
        (deregistration cascades children out with their parent)."""
        parts = []
        while b != _ROOT:
            key = self._block_key[b]
            parts.append(key[1])
            b = key[0]
        return tuple(t for part in reversed(parts) for t in part)

    def _spill_path(self, b: int, path: tuple) -> None:
        """Copy block b of every layer to the host tier under its token
        path: called just before b leaves the device cached set, while
        its content still matches the path. On a CUDA pool the copy
        lands in pinned memory asynchronously, ordered before any later
        write to b on the same stream."""
        blk = self._kv[:, :, b]               # [2, layers, bs, kv, d]
        if self.device.type == "cuda":
            host = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
            host.copy_(blk, non_blocking=True)
            self._hold(host)
        else:
            host = blk.clone()
        self.host_tier.put(path, host)

    def _take_block(self) -> int:
        """One block off the free list, or the LRU cached block (spilled
        to the host tier, then deregistered) when the free list is
        empty. The caller guarantees one is available."""
        if self._free:
            b = self._free.pop()
            self._free_set.discard(b)
            return b
        b, _ = self._cached.popitem(last=False)
        self._deregister(b, spill=True)
        self.cached_evictions += 1
        return b

    def ensure(self, seq_id: int, n_tokens: int, reserve: int = 0) -> None:
        """Grow seq_id's table to cover n_tokens. All-or-nothing: raises
        PoolOOM with the pool untouched when short. ``reserve`` demands
        that many more reclaimable blocks WITHOUT allocating them: the
        scheduler passes the pending copy-on-write count
        (:meth:`cow_need`), so a planned write never lacks its COW
        block. The ``serving.pool_alloc`` fault point fires before any
        accounting."""
        fault_point("serving.pool_alloc", key=str(seq_id))
        tab = self._tables.setdefault(seq_id, [])
        need = self.blocks_for(n_tokens) - len(tab)
        if need <= 0 and reserve <= 0:
            return
        if max(need, 0) + reserve > len(self._free) + len(self._cached):
            self.oom_events += 1
            raise PoolOOM(
                f"seq {seq_id} needs {max(need, 0)} more block(s) "
                f"(+{reserve} copy-on-write reserve) for {n_tokens} "
                f"tokens; {len(self._free)} free + {len(self._cached)} "
                f"cached of {self.num_usable}")
        for _ in range(max(need, 0)):
            b = self._take_block()
            tab.append(b)
            self._ref[b] = 1
        self.allocs += max(need, 0)

    def _release_blocks(self, blocks, seq_id: int) -> None:
        """Drop one reference from each block, in the caller's order
        (``free_seq``/``trim`` pass the table tail reversed, so LIFO
        reuse hands back the hottest blocks first and deep blocks enter
        the LRU older than their parents). A block reaching zero parks
        in the cached set when it is registered, else goes back to the
        free list. A block that is already free is an accounting bug:
        fail loudly."""
        for b in blocks:
            r = self._ref.get(b, 0)
            if b == 0 or r <= 0 or b in self._free_set:
                raise RuntimeError(
                    f"double-free of block {b} (seq {seq_id})")
            if r > 1:
                self._ref[b] = r - 1
                continue
            del self._ref[b]
            if self.prefix_cache and b in self._block_key:
                self._cached[b] = None
            else:
                self._free.append(b)
                self._free_set.add(b)
        self.frees += len(blocks)
        cap = int(flag_value("serving_prefix_cached_blocks"))
        if cap > 0:
            while len(self._cached) > cap:
                b, _ = self._cached.popitem(last=False)
                self._deregister(b, spill=True)
                self._free.append(b)
                self._free_set.add(b)
                self.cached_evictions += 1

    def free_seq(self, seq_id: int) -> None:
        """Release every block of seq_id (finish or preemption)."""
        tab = self._tables.pop(seq_id, None)
        self._registered.pop(seq_id, None)
        if tab is None:
            return
        self._release_blocks(list(reversed(tab)), seq_id)

    def trim(self, seq_id: int, n_tokens: int) -> int:
        """Shrink seq_id's table to exactly cover ``n_tokens``, releasing
        the tail: the speculative-decoding rewind. Rejected draft rows
        inside the kept boundary block need no cleanup (the mask never
        reads past a row's position and the next write overwrites them).
        Returns the number of table entries released."""
        tab = self._tables.get(seq_id)
        keep = self.blocks_for(max(int(n_tokens), 0))
        if tab is None or len(tab) <= keep:
            return 0
        drop = tab[keep:]
        del tab[keep:]
        if self._registered.get(seq_id, 0) > keep:
            self._registered[seq_id] = keep
        self._release_blocks(list(reversed(drop)), seq_id)
        return len(drop)

    def can_extend(self, seq_id: int, n_tokens: int,
                   reserve: int = 0) -> bool:
        """Whether :meth:`ensure` for ``n_tokens`` (+ ``reserve``) would
        succeed now: the scheduler's probe for draft rows, which never
        preempt and never count an OOM event."""
        need = self.blocks_for(n_tokens) - len(self._tables.get(seq_id, ()))
        return (max(need, 0) + max(reserve, 0)
                <= len(self._free) + len(self._cached))

    # -- prefix index ------------------------------------------------------
    def _match_chain(self, tokens) -> list[int]:
        chain: list[int] = []
        parent = _ROOT
        bs = self.block_size
        for i in range(len(tokens) // bs):
            b = self._index.get((parent, tuple(tokens[i * bs:(i + 1) * bs])))
            if b is None:
                break
            chain.append(b)
            parent = b
        return chain

    def _capped_hit_n(self, n_blocks: int, tokens) -> int:
        """Tokens a matched run of ``n_blocks`` may serve, capped at
        ``len(tokens) - 1`` (the last token is always recomputed, so the
        forward pass yields the logits of the next one). Matches below
        ``FLAGS_serving_prefix_min_blocks`` do not count."""
        if n_blocks < max(1, int(flag_value("serving_prefix_min_blocks"))):
            return 0
        return min(n_blocks * self.block_size, len(tokens) - 1)

    def _capped_hit(self, chain, tokens) -> int:
        return self._capped_hit_n(len(chain), tokens)

    def _host_extension(self, tokens, chain) -> list[tuple]:
        """Host-tier keys continuing the device chain, truncated to what
        a restore could take from the FREE list right now: restores
        never evict device-cached chains to make room."""
        ext = self.host_tier.match_extension(tokens, len(chain),
                                             self.block_size)
        return ext[:len(self._free)]

    def peek_prefix_tiered(self, tokens) -> tuple:
        """``(device_tokens, host_tokens)`` a request with these tokens
        would start past on a prefix hit, acquiring and restoring
        nothing: the admission price's split (a host token costs a
        host-to-device copy, not a recompute). The host share is bounded
        by the current free list, as :meth:`acquire_prefix` would
        restore."""
        if not self.prefix_cache or len(tokens) < 2:
            return (0, 0)
        chain = self._match_chain(tokens)
        dev = self._capped_hit(chain, tokens)
        if self.host_tier is None:
            return (dev, 0)
        ext = self._host_extension(tokens, chain)
        total = self._capped_hit_n(len(chain) + len(ext), tokens)
        return (dev, max(0, total - dev))

    def peek_prefix(self, tokens) -> int:
        """Resident tokens across BOTH tiers a request with these tokens
        would start past on a prefix hit, acquiring nothing."""
        dev, host = self.peek_prefix_tiered(tokens)
        return dev + host

    def acquire_prefix(self, seq_id: int, tokens,
                       defer_miss: bool = False) -> int:
        """Point seq_id's (empty) table at the longest resident
        full-block prefix of ``tokens``, bumping refcounts and restoring
        its host-resident continuation into fresh blocks; returns the
        number of cached tokens (the caller moves its context cursor
        there). Acquired blocks leave the cached set. ``defer_miss``
        (the add_request probe) skips miss accounting on a total miss:
        the binding lookup at admission counts it, so each request's
        outcome lands in the hit/miss counters once."""
        if not self.prefix_cache:
            return 0
        if self._tables.get(seq_id):
            raise RuntimeError(
                f"acquire_prefix: seq {seq_id} already holds blocks")
        self._last_restored = 0
        chain = self._match_chain(tokens) if len(tokens) >= 2 else []
        ext: list[tuple] = []
        if self.host_tier is not None and len(tokens) >= 2:
            ext = self._host_extension(tokens, chain)
        c = self._capped_hit_n(len(chain) + len(ext), tokens)
        restored: list[int] = []
        if c > 0 and ext:
            n_host = max(0, -(-c // self.block_size) - len(chain))
            if n_host:
                restored = self._restore_chain(seq_id, chain,
                                               ext[:n_host], tokens)
                if not restored:
                    # restore-path fault: fall back to the device-only
                    # hit (the suffix prefills cold, to the same tokens)
                    c = self._capped_hit(chain, tokens)
        if c <= 0:
            if not defer_miss:
                self.prefix_miss_tokens += max(0, len(tokens) - 1)
            return 0
        n_keep = -(-c // self.block_size)
        tab = self._tables.setdefault(seq_id, [])
        for b in chain[:n_keep]:
            if b in self._cached:
                del self._cached[b]
            self._ref[b] = self._ref.get(b, 0) + 1
            tab.append(b)
        for b in restored:
            self._ref[b] = 1
            tab.append(b)
        # the acquired blocks are in the index already (restored ones
        # re-registered by _restore_chain): registration for this seq
        # resumes after them
        self._registered[seq_id] = len(tab)
        self.prefix_hits += 1
        self.prefix_hit_tokens += c
        self.prefix_miss_tokens += max(0, len(tokens) - 1 - c)
        if restored:
            host_tok = c - (n_keep - len(restored)) * self.block_size
            self.host_hits += 1
            self.host_hit_tokens += host_tok
            self._last_restored = host_tok
        return c

    def _restore_chain(self, seq_id: int, chain, keys, tokens) -> list:
        """Restore ``keys``' host entries into fresh device blocks and
        re-register them in the prefix index, anchored on the device
        chain's tail. All-or-nothing: returns the new block ids in chain
        order, or [] when the restore path faulted. The staging pin is
        released on EVERY path, and the ``serving.host_tier.restore``
        fault point fires BEFORE any pool state moves, so a fault falls
        back to a cold prefill with no leaked block and both tiers
        intact. Only a ConnectionError (which ``FaultInjected`` is) is
        such a fault; anything else propagates.

        On a CUDA pool each block is one asynchronous host-to-device
        copy from pinned memory plus one scatter into every layer, on
        the current stream, so the prefill that reads these blocks is
        ordered after it. The caller guarantees ``len(keys)`` free
        blocks (:meth:`_host_extension` truncated to the free list)."""
        staging = self.host_tier.stage_restore(tuple(keys))
        ok = False
        try:
            fault_point("serving.host_tier.restore", key=str(seq_id))
            blocks = []
            for _ in keys:
                b = self._free.pop()
                self._free_set.discard(b)
                blocks.append(b)
            self.allocs += len(blocks)
            cuda = self.device.type == "cuda"
            for b, entry in zip(blocks, staging.entries):
                self._kv[:, :, b].copy_(entry.block, non_blocking=cuda)
            self._hold([e.block for e in staging.entries])
            bs = self.block_size
            parent = chain[-1] if chain else _ROOT
            base = len(chain)
            for j, b in enumerate(blocks):
                key = (parent,
                       tuple(tokens[(base + j) * bs:(base + j + 1) * bs]))
                self._index[key] = b
                self._block_key[b] = key
                if parent != _ROOT:
                    self._children.setdefault(parent, set()).add(b)
                parent = b
            ok = True
            return blocks
        except ConnectionError:
            # an injected (or real) restore blip; anything else is a bug
            # and propagates
            self.host_restore_failures += 1
            return []
        finally:
            self.host_tier.release_restore(staging, consumed=ok)

    def take_last_restored(self) -> int:
        """Tokens the LAST :meth:`acquire_prefix` served from restored
        host blocks (0 when none); read-and-clear, for the caller's
        ``host_restore`` event."""
        n, self._last_restored = self._last_restored, 0
        return n

    def register_prefix_blocks(self, seq_id: int, tokens, ctx: int) -> None:
        """Index every full block of seq_id's table whose content is now
        final (the context cursor passed its end). First writer wins:
        content already indexed under another block keeps that entry and
        stops this seq's chain (deeper entries would be unreachable
        without their parent)."""
        if not self.prefix_cache:
            return
        tab = self._tables.get(seq_id)
        if not tab:
            return
        bs = self.block_size
        done = self._registered.get(seq_id, 0)
        full = min(ctx // bs, len(tab), len(tokens) // bs)
        while done < full:
            b = tab[done]
            parent = tab[done - 1] if done else _ROOT
            if done and parent not in self._block_key:
                # the chain must anchor in the index
                break
            key = (parent, tuple(tokens[done * bs:(done + 1) * bs]))
            existing = self._index.get(key)
            if existing is not None:
                if existing != b:
                    break
            else:
                old = self._block_key.get(b)
                if old is not None and old != key:
                    # one block carries ONE key: a stale entry (a rewind
                    # re-walked the chain through a replaced parent) and
                    # its descendants go first
                    self._deregister(b)
                self._index[key] = b
                self._block_key[b] = key
                if parent != _ROOT:
                    self._children.setdefault(parent, set()).add(b)
                if self.host_tier is not None:
                    # a path recomputed cold while still host-resident
                    # (after a faulted or partial restore) would live in
                    # BOTH tiers: the fresh device registration wins
                    self.host_tier.drop(tuple(tokens[:(done + 1) * bs]))
            done += 1
        self._registered[seq_id] = done

    def _deregister(self, b: int, spill: bool = False,
                    _path: tuple | None = None) -> None:
        """Drop block b's index entry (it is reused or written in place)
        and CASCADE its registered descendants out: their keys name b as
        parent and would resolve a wrong token path once b holds new
        content. Cascaded blocks parked in the cached set are
        unreachable capacity, returned to the free list at once.

        ``spill=True`` copies b to the host tier first (departures from
        the cached set: cap eviction, allocator reclaim); only valid
        while b's content still matches its path. Cascaded CACHED
        children always spill when the tier is on: their content is
        still right for their own paths. ``_path`` carries b's token
        path down the recursion (a child's path cannot be walked once
        its parent's key is gone)."""
        if b not in self._block_key:
            return
        path = _path
        if path is None and self.host_tier is not None and (
                spill or self._children.get(b)):
            path = self._token_path(b)
        if spill and path is not None and self.host_tier is not None:
            self._spill_path(b, path)
        key = self._block_key.pop(b)
        if self._index.get(key) == b:
            del self._index[key]
        parent = key[0]
        if parent != _ROOT and parent in self._children:
            self._children[parent].discard(b)
            if not self._children[parent]:
                del self._children[parent]
        for child in list(self._children.get(b, ())):
            cpath = None
            if path is not None and child in self._block_key:
                cpath = path + self._block_key[child][1]
            self._deregister(child, spill=(child in self._cached),
                             _path=cpath)
            if child in self._cached:
                del self._cached[child]
                self._free.append(child)
                self._free_set.add(child)
                self.cached_evictions += 1
        self._children.pop(b, None)

    # -- copy-on-write -----------------------------------------------------
    def cow_need(self, seq_id: int, write_start: int, n: int = 1) -> int:
        """Blocks :meth:`prepare_write` would duplicate for a write of
        ``n`` tokens from ``write_start``: the still-shared blocks the
        range touches (at most 1 with the engine's append-only writes)."""
        tab = self._tables.get(seq_id)
        if not tab or n <= 0:
            return 0
        first = write_start // self.block_size
        last = (write_start + n - 1) // self.block_size
        return sum(1 for j in range(first, min(last + 1, len(tab)))
                   if self._ref.get(tab[j], 0) > 1)

    def prepare_write(self, seq_id: int, start: int, n: int) -> list:
        """Make positions [start, start+n) of seq_id's table privately
        writable; returns the (src, dst) block pairs the caller MUST copy
        on the device before its write lands. A shared block is swapped
        for a fresh private one (copy-on-write); a sole-owner block that
        is merely indexed is deregistered and written in place."""
        if n <= 0:
            return []
        tab = self._tables.get(seq_id)
        if not tab:
            return []
        copies: list[tuple[int, int]] = []
        first = start // self.block_size
        last = (start + n - 1) // self.block_size
        for j in range(first, min(last + 1, len(tab))):
            b = tab[j]
            if self._ref.get(b, 0) > 1:
                if not self._free and not self._cached:
                    # unreachable when the scheduler reserved cow_need()
                    # at planning; a loud backstop for hand-driven pools
                    self.oom_events += 1
                    raise PoolOOM(
                        f"copy-on-write for seq {seq_id} block {j} "
                        f"needs a free block; none reclaimable")
                nb = self._take_block()
                self._ref[b] -= 1
                self._ref[nb] = 1
                tab[j] = nb
                copies.append((b, nb))
                self.cow_copies += 1
                self.allocs += 1
            elif b in self._block_key:
                self._deregister(b)
            if j < self._registered.get(seq_id, 0):
                # the block no longer carries an index entry: register
                # again from here once the new content is final
                self._registered[seq_id] = j
        return copies

    # -- paged handoff -----------------------------------------------------
    def export_seq(self, seq_id: int, n_tokens: int) -> dict:
        """Serialize seq_id's first ``n_tokens`` context positions (the
        blocks that hold them and their K/V contents) into a host-memory
        manifest :meth:`import_seq` can install on another pool (the
        disaggregated prefill-to-decode handoff). ``k`` and ``v`` are
        per-layer CPU tensors ``[blocks, block_size, kv, d]`` in the
        pool's dtype, gathered and copied in one call each. Read-only.

        The JAX package's pool hands its buffers to the engine between
        steps and takes them back as ``kbufs=``/``vbufs=`` arguments
        (and ``attach_buffers``); this pool owns its buffers and writes
        them in place, so it needs neither."""
        tab = self._tables.get(seq_id)
        if not tab:
            raise KeyError(f"export_seq: seq {seq_id} holds no blocks")
        n_tokens = int(n_tokens)
        nb = self.blocks_for(n_tokens)
        if n_tokens < 1 or nb > len(tab):
            raise ValueError(
                f"export_seq: seq {seq_id} holds {len(tab)} block(s), "
                f"cannot export {n_tokens} tokens ({nb} blocks)")
        idx = torch.tensor(tab[:nb], dtype=torch.long, device=self.device)
        host = self._kv.index_select(2, idx).cpu()
        k, v = list(host[0]), list(host[1])
        nbytes = sum(t.numel() * t.element_size() for t in (*k, *v))
        return {"n_tokens": n_tokens, "blocks": nb,
                "block_size": self.block_size,
                "num_layers": self.num_layers,
                "k": k, "v": v, "nbytes": nbytes}

    def import_seq(self, seq_id: int, manifest: dict):
        """Install an :meth:`export_seq` manifest as ``seq_id``'s
        context: allocates ``blocks_for(n_tokens)`` FRESH blocks through
        the all-or-nothing :meth:`ensure` (PoolOOM on shortage with
        nothing changed; the ``serving.pool_alloc`` fault point fires)
        and writes the contents into every layer's buffers in place, in
        one copy and one scatter. Returns ``(kbufs, vbufs)``, the same
        (updated) per-layer views. The caller re-registers prefix blocks
        (:meth:`register_prefix_blocks`) once it knows the token ids."""
        if (int(manifest["block_size"]) != self.block_size
                or int(manifest["num_layers"]) != self.num_layers):
            raise ValueError(
                f"import_seq: manifest geometry (block_size "
                f"{manifest['block_size']}, layers "
                f"{manifest['num_layers']}) does not match pool "
                f"(block_size {self.block_size}, layers "
                f"{self.num_layers})")
        if self._tables.get(seq_id):
            raise RuntimeError(
                f"import_seq: seq {seq_id} already holds blocks")
        self.ensure(seq_id, int(manifest["n_tokens"]))
        # a manifest may carry host tensors or numpy arrays (the JAX
        # package's)
        data = torch.stack([
            torch.stack([t if isinstance(t, torch.Tensor)
                         else torch.from_numpy(np.array(t))
                         for t in manifest[part]])
            for part in ("k", "v")]).to(self.device, self.dtype)
        idx = torch.tensor(self._tables[seq_id], dtype=torch.long,
                           device=self.device)
        self._kv.index_copy_(2, idx, data)
        return self.kbufs, self.vbufs

    # -- invariants (tests + debugging) ----------------------------------
    def check_invariants(self) -> None:
        counts: dict[int, int] = {}
        for tab in self._tables.values():
            for b in tab:
                counts[b] = counts.get(b, 0) + 1
        if counts != self._ref:
            raise RuntimeError(
                f"refcounts diverge from table membership: tables say "
                f"{counts}, _ref says {self._ref}")
        alloc = set(counts)
        cached = set(self._cached)
        free = set(self._free)
        if len(self._free) != len(free) or free != self._free_set:
            raise RuntimeError("free list / free set divergence")
        if 0 in alloc or 0 in free or 0 in cached:
            raise RuntimeError("scratch block 0 entered circulation")
        if (alloc & free) or (alloc & cached) or (free & cached):
            raise RuntimeError("a block is in two of allocated/cached/free")
        if len(alloc) + len(cached) + len(free) != self.num_usable:
            raise RuntimeError(
                f"leak: {len(alloc)} allocated + {len(cached)} cached + "
                f"{len(free)} free != {self.num_usable} usable")
        for b in cached:
            if b not in self._block_key:
                raise RuntimeError(
                    f"cached block {b} is not in the prefix index")
        for key, b in self._index.items():
            if self._block_key.get(b) != key:
                raise RuntimeError("prefix index / block-key divergence")
            if b not in counts and b not in cached:
                raise RuntimeError(f"prefix index points at free block {b}")
        for b, key in self._block_key.items():
            if self._index.get(key) != b:
                raise RuntimeError("block-key / prefix index divergence")
        if self.host_tier is not None:
            self.host_tier.check_invariants()
            dev_paths = {self._token_path(b) for b in self._block_key}
            for key in self.host_tier.keys():
                if not key or len(key) % self.block_size:
                    raise RuntimeError(
                        f"host-tier key of {len(key)} tokens is not a "
                        f"full-block token path (bs={self.block_size})")
                if key in dev_paths:
                    raise RuntimeError(
                        f"token path of {len(key)} tokens resident in "
                        f"BOTH tiers: the one-tier rule is broken")

    def stats(self) -> dict:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free": self.num_free,
                "cached": self.num_cached,
                "allocated": self.num_allocated,
                "utilization": round(self.utilization, 4),
                "allocs": self.allocs, "frees": self.frees,
                "oom_events": self.oom_events,
                "prefix_cache": self.prefix_cache,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_miss_tokens": self.prefix_miss_tokens,
                "cow_copies": self.cow_copies,
                "cached_evictions": self.cached_evictions,
                "host_hits": self.host_hits,
                "host_hit_tokens": self.host_hit_tokens,
                "host_restore_failures": self.host_restore_failures,
                "host_tier": (None if self.host_tier is None
                              else self.host_tier.stats())}
