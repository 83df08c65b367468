"""Global prefix index over per-worker KV block hashes.

Parity: reference ``lib/llm/src/kv_router/indexer.rs`` (``RadixTree``,
``KvIndexer``, ``OverlapScores``). The reference builds a radix tree over
block-hash sequences; here every block hash is *chained* (identifies its whole
prefix — ``dynamo_tpu_torch.tokens``), so a flat ``hash -> {workers}`` map plus a
consecutive-run walk gives identical overlap scores with O(1) updates and
O(prompt blocks) lookups, and events from different workers can never
interleave wrongly.

Events arrive as ``RouterEvent{worker_id, KvCacheEvent}`` frames published on
the coordinator event bus (reference: per-worker NATS ``kv_events`` subject);
``event_id`` gaps are detected per worker and logged (a gap means a missed
eviction at worst — the scheduler tolerates stale positives).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Set

from dynamo_tpu_torch.protocols.events import KvCacheEvent, RouterEvent

logger = logging.getLogger(__name__)


class KvIndexer:
    """worker-attributed block-hash index with consecutive-prefix matching."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._workers_by_hash: Dict[int, Set[int]] = {}
        self._hashes_by_worker: Dict[int, Set[int]] = {}
        self._last_event_id: Dict[int, int] = {}

    # -- event plane -------------------------------------------------------

    def apply_event(self, ev: RouterEvent) -> None:
        worker = ev.worker_id
        e: KvCacheEvent = ev.event
        last = self._last_event_id.get(worker)
        if last is not None and e.event_id > last + 1:
            logger.warning("kv-event gap for worker %x: %d -> %d",
                           worker, last, e.event_id)
        self._last_event_id[worker] = e.event_id
        if e.all_blocks_cleared:
            self.remove_worker(worker, keep_cursor=True)
        held = self._hashes_by_worker.setdefault(worker, set())
        for blk in e.stored_blocks:
            held.add(blk.block_hash)
            self._workers_by_hash.setdefault(blk.block_hash, set()).add(worker)
        for h in e.removed_block_hashes:
            held.discard(h)
            ws = self._workers_by_hash.get(h)
            if ws is not None:
                ws.discard(worker)
                if not ws:
                    del self._workers_by_hash[h]

    def remove_worker(self, worker: int, keep_cursor: bool = False) -> None:
        """Drop a worker's whole subtree (instance death / cache clear)."""
        for h in self._hashes_by_worker.pop(worker, set()):
            ws = self._workers_by_hash.get(h)
            if ws is not None:
                ws.discard(worker)
                if not ws:
                    del self._workers_by_hash[h]
        if not keep_cursor:
            self._last_event_id.pop(worker, None)

    # -- lookup ------------------------------------------------------------

    def find_matches(self, block_hashes: List[int]) -> Dict[int, int]:
        """Per-worker count of *consecutive leading* blocks already held.

        A worker that lost block i (evicted) cannot serve block i+1 from
        cache even if it still holds it, hence the consecutive-run rule —
        the same semantics the reference's radix-tree walk produces.
        """
        overlaps: Dict[int, int] = {}
        for i, h in enumerate(block_hashes):
            holders = self._workers_by_hash.get(h)
            if not holders:
                break  # no worker can extend past a globally-unknown block
            for w in holders:
                if overlaps.get(w, 0) == i:
                    overlaps[w] = i + 1
        return overlaps

    # -- observers ---------------------------------------------------------

    def workers(self) -> List[int]:
        return list(self._hashes_by_worker)

    def num_blocks(self, worker: Optional[int] = None) -> int:
        if worker is not None:
            return len(self._hashes_by_worker.get(worker, ()))
        return len(self._workers_by_hash)


__all__ = ["KvIndexer"]
