"""Continuous-batching serving of the port.

- kv_pool.py          paged KV-cache block pool + per-sequence tables,
                      refcounted prefix index, copy-on-write, the host
                      tier's spill and restore, export/import of a
                      sequence's blocks
- host_tier.py        bounded LRU host-RAM spill tier behind the prefix
                      cache (FLAGS_serving_host_tier)
- paged_attention.py  ragged paged attention: pool writes, and the
                      attend (kernel K5 on the card, plain on the CPU)
- scheduler.py        token-budgeted FCFS admission, chunked prefill,
                      preemption by recompute, prefix lookups, draft
                      lookahead, terminal removal and failure replay
- engine.py           ServingEngine.add_request()/step()/cancel()/
                      drain()/health() with host-side per-request
                      sampling; request handoff (export_request/
                      import_request/release_handoff), fleet publishing
                      and routing signals; spans and flight digests
- metrics.py          TTFT / TPOT / occupancy / pool utilisation /
                      terminal-reason, shed, failure and host-tier
                      counters, the goodput and attention-bytes ledgers,
                      the decode roofline, and their telemetry families
- robustness.py       SLO guardrails: deadlines, bounded admission with
                      shedding, step-failure quarantine, hung-step
                      detection, the SERVING -> DEGRADED -> DRAINING ->
                      STOPPED lifecycle, fault points; request timelines
                      and the failure paths' flight dumps
- speculation.py      speculative decoding: lossless verification,
                      n-gram and draft-model proposers, and the shared
                      temperature/top-k/top-p math
- fleet/              the serving fleet over in-process replicas: the
                      health-aware router with self-healing, the
                      autoscaler, disaggregated prefill/decode and live
                      migration (``serving.fleet``)

Telemetry (``paddle_tpu_torch/telemetry``) is wired through all of it and
off by default (``FLAGS_telemetry``). Not ported yet: CUDA graphs for the
decode signature, and the JAX package's ``serving/fleet/worker.py`` (one
replica per process under the launcher) and ``sharding.py`` (tensor
parallelism over several cards).
"""

from .engine import ServingEngine, sample_token
from .host_tier import HostTier
from .kv_pool import KVBlockPool, PagedLayerCache, PoolOOM
from .metrics import ServingMetrics
from .paged_attention import (gather_copy_blocks, paged_attend,
                              paged_write_kv, ragged_paged_attention)
from .robustness import (CANCELLED, DEGRADED, DRAINING, EXPIRED, FAILED,
                         OK, SERVING, SHED, STOPPED, RequestRejected,
                         now_s)
from .scheduler import Scheduler, Sequence, StepPlan
from .speculation import (DraftModelProposer, NgramProposer,
                          processed_probs, verify_draft)

__all__ = ["CANCELLED", "DEGRADED", "DRAINING", "DraftModelProposer",
           "EXPIRED", "FAILED", "HostTier", "KVBlockPool", "NgramProposer",
           "OK", "PagedLayerCache", "PoolOOM", "RequestRejected", "SERVING",
           "SHED", "STOPPED", "Scheduler", "Sequence", "ServingEngine",
           "ServingMetrics", "StepPlan", "gather_copy_blocks", "now_s",
           "paged_attend", "paged_write_kv", "processed_probs",
           "ragged_paged_attention", "sample_token", "verify_draft"]
