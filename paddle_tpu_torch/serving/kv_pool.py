"""Paged KV-cache block pool (port of ``serving/kv_pool.py``).

The cache is a pool of fixed-size blocks,
``[num_blocks, block_size, kv_heads, head_dim]`` per layer, on the
model's device. A sequence holds a BLOCK TABLE of pool indices covering
exactly the context it has produced; blocks are allocated on demand and
returned on finish or preemption, and the attention kernel addresses
K/V through the table (``serving/paged_attention.py``).

Host-side accounting lives here: a LIFO free list (freshly freed blocks
are reused first) with an O(1) membership set, per-sequence tables and
alloc/free/OOM counters. Block 0 is RESERVED as scratch: padding rows of
a bucketed prefill chunk and idle decode slots write there, so the step
needs no conditional write. Scratch contents are garbage by design and
the attention mask guarantees they are never read by a real row.

Allocation is all-or-nothing: :meth:`KVBlockPool.ensure` either extends
a table to cover the requested tokens or raises :class:`PoolOOM` with
the free list untouched; the scheduler's preemption depends on that.

Not ported yet: the prefix index with refcounted sharing and
copy-on-write, the host-RAM tier, and ``export_seq``/``import_seq``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..framework.device import resolve_device


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
    Each usable block is either allocated (in exactly one table) or on
    the free list. ``device=None`` is the card (it raises without one);
    pass ``device="cpu"`` for the CPU."""

    def __init__(self, *, num_layers, num_blocks, block_size, kv_heads,
                 head_dim, dtype=torch.float32, device=None):
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
        shape = (self.num_blocks, self.block_size, self.kv_heads,
                 self.head_dim)
        # zeros: scratch and never-written blocks hold finite values,
        # which idle rows and masked columns may read
        self.kbufs = [torch.zeros(shape, dtype=dtype, device=self.device)
                      for _ in range(self.num_layers)]
        self.vbufs = [torch.zeros(shape, dtype=dtype, device=self.device)
                      for _ in range(self.num_layers)]
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._tables: dict[int, list[int]] = {}
        self.allocs = 0
        self.frees = 0
        self.oom_events = 0

    # -- capacity accounting ---------------------------------------------
    @property
    def num_usable(self) -> int:
        """Blocks available to sequences (everything but scratch)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return self.num_usable - len(self._free)

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
        """Whether seq_id holds any blocks."""
        return bool(self._tables.get(seq_id))

    def ensure(self, seq_id: int, n_tokens: int) -> None:
        """Grow seq_id's table to cover n_tokens. All-or-nothing:
        raises PoolOOM with the free list untouched when short."""
        tab = self._tables.setdefault(seq_id, [])
        need = self.blocks_for(n_tokens) - len(tab)
        if need <= 0:
            return
        if need > len(self._free):
            self.oom_events += 1
            raise PoolOOM(
                f"seq {seq_id} needs {need} more block(s) for {n_tokens} "
                f"tokens; {len(self._free)} free of {self.num_usable}")
        for _ in range(need):
            b = self._free.pop()
            self._free_set.discard(b)
            tab.append(b)
        self.allocs += need

    def can_extend(self, seq_id: int, n_tokens: int) -> bool:
        """Whether :meth:`ensure` for n_tokens would succeed now."""
        need = self.blocks_for(n_tokens) - len(self._tables.get(seq_id, ()))
        return need <= len(self._free)

    def free_seq(self, seq_id: int) -> None:
        """Release every block of seq_id (finish or preemption). A block
        that is already free is an accounting bug: fail loudly."""
        tab = self._tables.pop(seq_id, None)
        if tab is None:
            return
        for b in reversed(tab):   # LIFO reuse hands back the hottest first
            if b == 0 or b in self._free_set:
                raise RuntimeError(f"double-free of block {b} (seq {seq_id})")
            self._free.append(b)
            self._free_set.add(b)
        self.frees += len(tab)

    # -- invariants (tests + debugging) ----------------------------------
    def check_invariants(self) -> None:
        alloc: list[int] = [b for tab in self._tables.values() for b in tab]
        free = set(self._free)
        if len(self._free) != len(free) or free != self._free_set:
            raise RuntimeError("free list / free set divergence")
        if len(alloc) != len(set(alloc)):
            raise RuntimeError("a block is in two tables")
        if 0 in alloc or 0 in free:
            raise RuntimeError("scratch block 0 entered circulation")
        if set(alloc) & free:
            raise RuntimeError("a block is both allocated and free")
        if len(alloc) + len(free) != self.num_usable:
            raise RuntimeError(
                f"leak: {len(alloc)} allocated + {len(free)} free != "
                f"{self.num_usable} usable")
