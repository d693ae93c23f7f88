"""Continuous-batching serving of the port.

- kv_pool.py          paged KV-cache block pool + per-sequence tables,
                      refcounted prefix index, copy-on-write
- paged_attention.py  ragged paged attention: pool writes, and the
                      attend (kernel K5 on the card, plain on the CPU)
- scheduler.py        token-budgeted FCFS admission, chunked prefill,
                      preemption by recompute, prefix lookups, draft
                      lookahead
- engine.py           ServingEngine.add_request()/step() with host-side
                      per-request sampling
- metrics.py          TTFT / TPOT / occupancy / pool utilisation
- robustness.py       terminal reasons, the clock, request events
- speculation.py      speculative decoding: lossless verification,
                      n-gram and draft-model proposers, and the shared
                      temperature/top-k/top-p math
"""

from .engine import ServingEngine, sample_token
from .kv_pool import KVBlockPool, PagedLayerCache, PoolOOM
from .paged_attention import (gather_copy_blocks, paged_attend,
                              paged_write_kv, ragged_paged_attention)
from .scheduler import Scheduler, Sequence
from .speculation import (DraftModelProposer, NgramProposer,
                          processed_probs, verify_draft)

__all__ = ["DraftModelProposer", "KVBlockPool", "NgramProposer",
           "PagedLayerCache", "PoolOOM", "Scheduler", "Sequence",
           "ServingEngine", "gather_copy_blocks", "paged_attend",
           "paged_write_kv", "processed_probs", "ragged_paged_attention",
           "sample_token", "verify_draft"]
