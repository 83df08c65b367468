"""KV-cache-aware routing: send each request to the worker already holding
the longest prefix of its prompt, weighted against load.

Capability parity with the reference's ``lib/llm/src/kv_router/`` (indexer
radix tree + event plane, scheduler cost model, KvPushRouter), re-designed
around this framework's chained block hashes: a chained hash identifies its
entire prefix, so the global index is a flat hash->workers map with
consecutive-run matching instead of a radix tree — same matching power,
O(blocks) lookup, trivially mergeable from events.

Components:
- ``indexer.KvIndexer`` — event-driven global index (worker KV events).
- ``approx.ApproxKvIndexer`` — no-event alternative: predicts cache contents
  from routing decisions with TTL expiry.
- ``scheduler.KvScheduler`` — worker selection: cost = overlap_weight *
  prefill_blocks + active_decode_blocks, softmax-temperature sampling.
- ``router.KvPushRouter`` — the pipeline-facing router: hash, match, select,
  route direct, then track pushed/freed decode blocks.
"""

from dynamo_tpu_torch.kv_router.approx import ApproxKvIndexer
from dynamo_tpu_torch.kv_router.global_index import (
    GlobalPrefixIndexReader,
    GlobalPrefixPublisher,
)
from dynamo_tpu_torch.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.kv_router.recorder import KvRecorder, replay
from dynamo_tpu_torch.kv_router.router import KvPushRouter
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler, WorkerSelector

__all__ = ["KvIndexer", "ApproxKvIndexer", "KvScheduler", "WorkerSelector",
           "KvPushRouter", "KvRecorder", "replay",
           "GlobalPrefixPublisher", "GlobalPrefixIndexReader"]
