"""Ragged paged attention over block tables (port of
``serving/paged_attention.py``).

One call serves a batch whose rows sit at DIFFERENT positions of
different sequences, with K/V addressed through per-sequence block
tables into a shared pool. The work splits into ``paged_write_kv``
(write this chunk's K/V into the pool) and the attend, which on a CUDA
tensor is the Hopper kernel K5 and on a CPU tensor its plain version.

Shapes (B = batch rows, s = chunk length):

- q: [B, s, h, d]; k/v: [B, s, kv, d], this call's new tokens. Row b
  covers absolute positions ``positions[b] .. positions[b]+s-1``; only
  the first ``lengths[b]`` rows are real (bucketed prefill pads s up,
  idle decode slots have length 0).
- kbuf/vbuf: [num_blocks, block_size, kv, d], ONE layer's pool pages.
- block_tables: [B, max_blocks] int32; unused entries are 0, the
  pool's reserved scratch block.

Why pad rows cannot corrupt the pool: invalid rows write to scratch
block 0, and a valid row at position p only attends to columns <= p;
every real token at position p is written by the call that covers p,
so stale content past a sequence's context is masked now and
overwritten before it ever enters a validity window.
"""

from __future__ import annotations

import torch

from ..ops.hopper.paged_attention import (paged_attend_cuda,
                                          paged_attend_reference)
from .kv_pool import PagedLayerCache

# the plain version, under the JAX package's name
paged_attend = paged_attend_reference


def paged_write_kv(kbuf, vbuf, k, v, block_tables, positions, lengths):
    """Write this chunk's K/V into the pool pages, in place.

    JAX updates the pool functionally and donates the old buffers to the
    step; PyTorch writes the same rows into the live buffers with
    ``index_put_``, which needs no second copy of the pool. Invalid rows
    (r >= lengths[b]) go to scratch block 0; which of several scratch
    writes lands is undefined and does not matter. Returns (kbuf, vbuf)."""
    b, s, kv, d = k.shape
    bs = kbuf.shape[1]
    max_blocks = block_tables.shape[1]
    r = torch.arange(s, device=k.device)[None, :]
    idx = positions.long()[:, None] + r                          # [B, s]
    valid = r < lengths.long()[:, None]                          # [B, s]
    slot = (idx // bs).clamp(0, max_blocks - 1)
    blk = torch.gather(block_tables.long(), 1, slot)
    blk = torch.where(valid, blk, torch.zeros_like(blk)).reshape(-1)
    off = torch.where(valid, idx % bs, torch.zeros_like(idx)).reshape(-1)
    kbuf.index_put_((blk, off), k.to(kbuf.dtype).reshape(b * s, kv, d))
    vbuf.index_put_((blk, off), v.to(vbuf.dtype).reshape(b * s, kv, d))
    return kbuf, vbuf


def _attend(q, kbuf, vbuf, block_tables, positions, *, kv_heads, head_dim):
    """The device picks: kernel K5 for CUDA tensors (raising on shapes
    it does not take), the plain version for CPU tensors."""
    if q.is_cuda:
        return paged_attend_cuda(q, kbuf, vbuf, block_tables, positions,
                                 kv_heads=kv_heads, head_dim=head_dim)
    return paged_attend_reference(q, kbuf, vbuf, block_tables, positions,
                                  kv_heads=kv_heads, head_dim=head_dim)


def ragged_paged_attention(q, k, v, cache: PagedLayerCache, positions, *,
                           kv_heads, head_dim, out_dtype):
    """Write this chunk's K/V into the pool and attend against the
    block-table context: the paged form of ``cached_attention``.

    positions: [B] int32, absolute position of each row's chunk start.
    Returns ([B, s, h*d], the cache, whose buffers were updated in
    place)."""
    b, s, h, d = q.shape
    paged_write_kv(cache.kbuf, cache.vbuf, k, v, cache.block_tables,
                   positions, cache.lengths)
    ctx = _attend(q, cache.kbuf, cache.vbuf, cache.block_tables, positions,
                  kv_heads=kv_heads, head_dim=head_dim)
    return ctx.to(out_dtype).reshape(b, s, h * d), cache


def gather_copy_blocks(kbufs, vbufs, src, dst):
    """Copy block ``src``'s rows onto block ``dst`` in every layer's K
    and V buffer, in place (the device half of copy-on-write, kept for
    the prefix cache's port)."""
    for buf in (*kbufs, *vbufs):
        buf[dst] = buf[src]
    return kbufs, vbufs
