"""Bounded host-RAM tier behind the paged KV pool's prefix cache (port of
``serving/host_tier.py``).

The cached-LRU set of the pool is bounded by device blocks
(``FLAGS_serving_prefix_cached_blocks``): at production fan-in the
hot-prefix working set outruns any one device pool, and an evicted chain
recomputes cold. Pool blocks are fixed-shape and relocatable, so a block
evicted from the device cached set can SPILL its contents here instead
of vanishing, and a later prefix hit on it restores the bytes into a
fresh device block.

Keying: the device prefix index anchors entries on
``(parent_block_id, block_tokens)``, but a parent block id dies with the
device block. Host entries are keyed by the block's full CUMULATIVE
token path from the chain root (``tuple(tokens[:i*bs])``):
self-anchoring, exact (no hash collisions), and a chain lookup is just
successive prefix tuples. A token path is resident in EXACTLY ONE tier
(``KVBlockPool.check_invariants`` enforces it): spilling moves a path
host-ward; restoring it, or a cold recompute that re-registers it on the
device, drops the host copy.

Storage: each entry holds one block's per-layer K and V as torch CPU
tensors in the pool's dtype (bf16 at full width; numpy has no bf16),
pinned when the pool lives on a CUDA device so the copies in both
directions run asynchronously on the engine's stream
(``KVBlockPool._spill_path``, ``_restore_chain``). ``nbytes`` counts the
same payload as the JAX package's numpy entries.

Restore staging: :meth:`HostTier.stage_restore` pins the matched entries
and MUST be balanced by :meth:`HostTier.release_restore` on every path;
``release_restore(..., consumed=True)`` also drops the restored entries
(the pool committed them back to device blocks).

Capacity is ``FLAGS_serving_host_tier_bytes`` of K+V payload, LRU:
``put`` ages out the oldest unpinned entries beyond the cap (0 keeps the
tier empty). The flag is read per call, so a capacity change takes effect
at the next spill; callers that shrink it mid-run call
:meth:`HostTier.enforce_cap` to apply the new bound at once.
"""

from __future__ import annotations

from collections import OrderedDict

from ..flags import flag_value


class _Entry:
    """One spilled block: ``block`` is its K and V of every layer on the
    host, ``[2, layers, block_size, kv, d]``; ``k[l]`` and ``v[l]`` are
    its per-layer views."""

    __slots__ = ("block", "k", "v", "nbytes")

    def __init__(self, block):
        self.block = block
        self.k = list(block[0])
        self.v = list(block[1])
        self.nbytes = block.numel() * block.element_size()


class RestoreStaging:
    """Pin handle for one in-flight restore: the matched keys and their
    entries, valid until :meth:`HostTier.release_restore` runs
    (idempotent: a ``finally`` may release after a consumed release)."""

    __slots__ = ("keys", "entries", "released")

    def __init__(self, keys, entries):
        self.keys = tuple(keys)
        self.entries = list(entries)
        self.released = False


class HostTier:
    """LRU host-RAM store of spilled prefix blocks, keyed by full token
    path. Host state only: the device copies are the pool's."""

    __slots__ = ("_entries", "_pinned", "_staging_live", "bytes",
                 "spills", "spilled_bytes", "evictions",
                 "restored_blocks", "dedup_drops")

    def __init__(self):
        # token-path tuple -> _Entry, oldest first (LRU eviction)
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        # keys pinned by in-flight restore staging (never evicted)
        self._pinned: dict[tuple, int] = {}
        self._staging_live = 0
        self.bytes = 0
        self.spills = 0             # blocks offered by the pool
        self.spilled_bytes = 0
        self.evictions = 0          # entries aged out by the byte cap
        self.restored_blocks = 0    # entries consumed by a restore
        self.dedup_drops = 0        # paths re-registered on the device

    # -- capacity ----------------------------------------------------------
    @property
    def capacity_bytes(self) -> int:
        return int(flag_value("serving_host_tier_bytes"))

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return self._entries.keys()

    def has(self, key) -> bool:
        """Read-only membership probe (no LRU touch: admission pricing
        must not change the eviction order)."""
        return key in self._entries

    # -- spill path --------------------------------------------------------
    def put(self, key: tuple, block) -> None:
        """Admit one spilled block's contents (``[2, layers, bs, kv, d]``
        on the host) under its token path, then age out the LRU tail
        past the byte cap."""
        old = self._entries.pop(key, None)
        if old is not None:
            # a duplicate spill can only mean the one-tier rule was
            # bypassed upstream; keep the accounting sane
            self.bytes -= old.nbytes
        entry = _Entry(block)
        self._entries[key] = entry
        self.bytes += entry.nbytes
        self.spills += 1
        self.spilled_bytes += entry.nbytes
        self.enforce_cap()

    def enforce_cap(self) -> None:
        cap = max(self.capacity_bytes, 0)
        while self.bytes > cap and self._entries:
            victim = next((key for key in self._entries
                           if key not in self._pinned), None)
            if victim is None:
                # everything left is pinned by in-flight staging; the
                # overshoot is transient and checked again at release
                break
            entry = self._entries.pop(victim)
            self.bytes -= entry.nbytes
            self.evictions += 1

    def drop(self, key: tuple) -> bool:
        """Remove ``key`` because its path is canonical on the device
        again (a cold recompute re-registered it): the other half of the
        one-tier rule."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return False
        self.bytes -= entry.nbytes
        self.dedup_drops += 1
        return True

    # -- restore path ------------------------------------------------------
    def match_extension(self, tokens, start_block: int,
                        block_size: int) -> list[tuple]:
        """Host keys continuing a device chain that already covers
        ``start_block`` full blocks of ``tokens``: successive cumulative
        paths, stopping at the first gap so the restored run is always
        chain-contiguous. Read-only."""
        keys: list[tuple] = []
        for i in range(start_block, len(tokens) // block_size):
            key = tuple(tokens[:(i + 1) * block_size])
            if key not in self._entries:
                break
            keys.append(key)
        return keys

    def stage_restore(self, keys) -> RestoreStaging:
        """Pin ``keys``' entries for one restore and hand their payloads
        to the caller. MUST be balanced by :meth:`release_restore` on
        every path (put it in a ``finally``). Raises KeyError on an
        unmatched key: callers stage only what :meth:`match_extension`
        just returned."""
        entries = [self._entries[key] for key in keys]
        for key in keys:
            self._pinned[key] = self._pinned.get(key, 0) + 1
        self._staging_live += 1
        return RestoreStaging(keys, entries)

    def release_restore(self, staging: RestoreStaging, *,
                        consumed: bool = False) -> None:
        """Unpin a staging handle. ``consumed=True`` means the pool
        committed the restored blocks on the device: the entries leave
        the tier (a path lives in exactly one tier); otherwise they stay
        for the next hit (the restore-fault fallback). Idempotent."""
        if staging.released:
            return
        staging.released = True
        self._staging_live -= 1
        for key in staging.keys:
            n = self._pinned.get(key, 0) - 1
            if n <= 0:
                self._pinned.pop(key, None)
            else:
                self._pinned[key] = n
        if consumed:
            for key in staging.keys:
                entry = self._entries.pop(key, None)
                if entry is not None:
                    self.bytes -= entry.nbytes
                    self.restored_blocks += 1
        self.enforce_cap()

    # -- invariants / reporting --------------------------------------------
    def check_invariants(self) -> None:
        """At-rest consistency (no staging in flight): exact byte
        accounting and the byte cap. The pool adds the cross-tier checks
        (one tier per path, full-block keys)."""
        if self._staging_live or self._pinned:
            raise RuntimeError(
                f"host tier has {self._staging_live} staging handle(s) "
                f"live at rest ({len(self._pinned)} pinned keys): a "
                f"stage_restore was not release_restore'd")
        total = sum(e.nbytes for e in self._entries.values())
        if total != self.bytes:
            raise RuntimeError(
                f"host tier byte ledger diverged: entries sum to "
                f"{total}, ledger says {self.bytes}")
        if self.bytes > max(self.capacity_bytes, 0):
            raise RuntimeError(
                f"host tier over capacity at rest: {self.bytes} > "
                f"{self.capacity_bytes} bytes")

    def stats(self) -> dict:
        return {"entries": len(self._entries),
                "bytes": self.bytes,
                "capacity_bytes": self.capacity_bytes,
                "spills": self.spills,
                "spilled_bytes": self.spilled_bytes,
                "evictions": self.evictions,
                "restored_blocks": self.restored_blocks,
                "dedup_drops": self.dedup_drops}
