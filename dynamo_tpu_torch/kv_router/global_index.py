"""Fleet-wide prefix->holders index over the coordinator kv-store.

The per-frontend ``KvIndexer`` (indexer.py) already builds a hash->holders
map from the kv_events plane, but it lives and dies with one frontend
process and only sees workers behind that frontend's client. This module
makes the same information *fleet-global and durable*: every worker
publishes a batched, deduped snapshot of the chained block hashes it
currently holds into a coordinator kv-store bucket, and any process
(frontends for routing, workers for peer-onboarding) mirrors the bucket
into a local ``hash -> {holders}`` map.

Index TTL / eviction story:
- Holder entries are written through a TTL'd bucket handle and refreshed
  on every publish interval, so a worker that dies (lease expiry) simply
  stops refreshing and its entry expires — no tombstone protocol needed.
- Evict events shrink the worker's held-set before the next snapshot, so
  a stored-then-evicted block within one interval never reaches the
  coordinator at all (the dedupe), and stale holders are pruned on the
  reader's next refresh.
- The kv-store's own lazy TTL sweep (``entries()`` collection past a
  2x-TTL grace) garbage-collects dead workers' envelopes server-side.
- Coordinator failover is survived for free: ``_CoordBucket`` registers
  every put in the resync replay registry, so after a promote each live
  worker re-puts its own snapshot (writer-side ownership, conflict-free).

Snapshots are one msgpack value per worker (``w/{worker_id:x}``), not one
key per block: at 64k hashes x 8 bytes that is a ~0.5 MB value refreshed
every couple of seconds per worker — far cheaper on the coordinator than
per-block churn, and atomic (a reader never sees half an eviction batch).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

from dynamo_tpu_torch.protocols.events import KvCacheEvent
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.utils.aio import reap_task

logger = logging.getLogger(__name__)

PREFIX_INDEX_BUCKET = "prefix_index"

# Holder-entry TTL: a dead worker's snapshot vanishes from routing within
# this window. Refreshes happen at ttl/3 even when nothing changed.
DEFAULT_INDEX_TTL_S = 30.0

# How often a dirty held-set is flushed (the event batching window).
DEFAULT_PUBLISH_INTERVAL_S = 2.0

# Snapshot size cap: beyond this the OLDEST-stored hashes are dropped from
# the published view (they are the likeliest to be evicted next anyway).
MAX_SNAPSHOT_HASHES = 65536


def consecutive_overlaps(block_hashes: List[int],
                         workers_by_hash: Dict[int, Set[int]]
                         ) -> Dict[int, int]:
    """Per-worker count of consecutive leading blocks held — the same
    semantics as ``KvIndexer.find_matches`` (a chained hash identifies its
    whole prefix, so a flat map + run walk equals the radix-tree result)."""
    overlaps: Dict[int, int] = {}
    for i, h in enumerate(block_hashes):
        holders = workers_by_hash.get(h)
        if not holders:
            break
        for w in holders:
            if overlaps.get(w, 0) == i:
                overlaps[w] = i + 1
    return overlaps


class GlobalPrefixPublisher:
    """Worker-side: fold kv-cache events into a held-set, periodically
    publish it as one snapshot through a TTL'd kv-store bucket handle."""

    def __init__(self, store, worker_id: int,
                 ttl: float = DEFAULT_INDEX_TTL_S,
                 interval: float = DEFAULT_PUBLISH_INTERVAL_S,
                 max_hashes: int = MAX_SNAPSHOT_HASHES):
        self._store = store
        self.worker_id = worker_id
        self.ttl = ttl
        self.interval = interval
        self.max_hashes = max_hashes
        # dict-as-ordered-set: insertion order approximates storage order,
        # so the size cap drops the oldest-stored hashes first
        self._held: Dict[int, None] = {}
        self._dirty = False
        self._bucket = None
        self._task: Optional[asyncio.Task] = None
        self._last_put = 0.0
        self.publishes = 0

    # -- event intake (batching + dedupe happen here) -----------------------

    def apply_event(self, ev: KvCacheEvent) -> None:
        if ev.all_blocks_cleared:
            if self._held:
                self._held.clear()
                self._dirty = True
        for blk in ev.stored_blocks:
            if blk.block_hash not in self._held:
                self._held[blk.block_hash] = None
                self._dirty = True
        for h in ev.removed_block_hashes:
            if h in self._held:
                del self._held[h]
                self._dirty = True

    def held_count(self) -> int:
        return len(self._held)

    # -- publish loop --------------------------------------------------------

    async def start(self) -> None:
        self._bucket = await self._store.bucket(PREFIX_INDEX_BUCKET,
                                                ttl=self.ttl)
        self._task = asyncio.create_task(self._loop(),
                                         name=f"prefix-index-pub-{self.worker_id:x}")

    async def _loop(self) -> None:
        while True:
            try:
                await self.flush()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("prefix-index publish failed")
            await asyncio.sleep(self.interval)

    async def flush(self, force: bool = False) -> None:
        """Write the snapshot when dirty, and unconditionally at ttl/3 so
        the holder entry never expires under a live worker."""
        if self._bucket is None:
            return
        now = time.monotonic()
        refresh_due = (now - self._last_put) >= (self.ttl / 3.0)
        if not (self._dirty or refresh_due or force):
            return
        hashes = list(self._held)
        if len(hashes) > self.max_hashes:
            hashes = hashes[-self.max_hashes:]
        await self._bucket.put(self._key(self.worker_id),
                               codec.pack({"h": hashes}))
        self._dirty = False
        self._last_put = now
        self.publishes += 1

    async def close(self) -> None:
        await reap_task(self._task)
        self._task = None
        if self._bucket is not None:
            try:
                # clean shutdown: evict our holder entry now rather than
                # leaving routing a TTL's worth of stale positives
                await self._bucket.delete(self._key(self.worker_id))
            except Exception:
                pass

    @staticmethod
    def _key(worker_id: int) -> str:
        return f"w/{worker_id:x}"


class GlobalPrefixIndexReader:
    """Any-side: mirror the bucket into ``hash -> {holders}`` and answer
    overlap queries with the consecutive-run walk."""

    def __init__(self, store, refresh_interval: float = 1.0):
        self._store = store
        self.refresh_interval = refresh_interval
        self._bucket = None
        self._task: Optional[asyncio.Task] = None
        self._workers_by_hash: Dict[int, Set[int]] = {}
        self._hashes_by_worker: Dict[int, Set[int]] = {}
        self.refreshes = 0

    async def start(self, background: bool = True) -> None:
        # read-side handle carries no TTL: the writer's TTL rides in each
        # envelope, so expiry/collection follow the publisher's settings
        self._bucket = await self._store.bucket(PREFIX_INDEX_BUCKET)
        await self.refresh()
        if background:
            self._task = asyncio.create_task(self._loop(),
                                             name="prefix-index-reader")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.refresh_interval)
            try:
                await self.refresh()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("prefix-index refresh failed")

    async def refresh(self) -> None:
        if self._bucket is None:
            return
        by_hash: Dict[int, Set[int]] = {}
        by_worker: Dict[int, Set[int]] = {}
        for key, raw in await self._bucket.entries():
            if not key.startswith("w/"):
                continue
            try:
                worker = int(key[2:], 16)
                hashes = codec.unpack(raw)["h"]
            except Exception:
                logger.warning("bad prefix-index entry %r", key)
                continue
            held = set(hashes)
            by_worker[worker] = held
            for h in held:
                by_hash.setdefault(h, set()).add(worker)
        self._workers_by_hash = by_hash
        self._hashes_by_worker = by_worker
        self.refreshes += 1

    async def close(self) -> None:
        await reap_task(self._task)
        self._task = None

    # -- queries (sync, against the local mirror) ---------------------------

    def find_holders(self, block_hashes: List[int]) -> Dict[int, int]:
        """worker -> consecutive leading blocks held, fleet-wide."""
        return consecutive_overlaps(block_hashes, self._workers_by_hash)

    def best_overlap(self, block_hashes: List[int]) -> Tuple[int, int]:
        """(best worker, its overlap) or (-1, 0) when nobody holds block 0."""
        holders = self.find_holders(block_hashes)
        if not holders:
            return -1, 0
        best = max(holders, key=lambda w: holders[w])
        return best, holders[best]

    def holder_order(self, block_hashes: List[int],
                     exclude: Iterable[int] = ()) -> List[int]:
        """Workers sorted by overlap desc — the peer-onboarding pull order."""
        skip = set(exclude)
        holders = self.find_holders(block_hashes)
        return sorted((w for w in holders if w not in skip),
                      key=lambda w: holders[w], reverse=True)

    def workers(self) -> List[int]:
        return list(self._hashes_by_worker)

    def num_blocks(self, worker: Optional[int] = None) -> int:
        if worker is not None:
            return len(self._hashes_by_worker.get(worker, ()))
        return len(self._workers_by_hash)


__all__ = ["GlobalPrefixPublisher", "GlobalPrefixIndexReader",
           "consecutive_overlaps", "PREFIX_INDEX_BUCKET",
           "DEFAULT_INDEX_TTL_S", "DEFAULT_PUBLISH_INTERVAL_S",
           "MAX_SNAPSHOT_HASHES"]
