"""Offload/onboard orchestration across the KV tiers.

Parity in role: reference ``OffloadManager`` (``block_manager/offload.rs`` —
G1->G2->G3 offload with bounded queues off the hot path, onboarding with
batched transfers). Here transfers are page gathers (device->host) and the
content-addressed inject path (``engine/transfer.py``).

``TieredEngine`` wraps a ``TorchEngine``:
- installs the allocator eviction hook: HBM-evicted blocks are snapshotted
  ON DEVICE (a gather on the steps' stream, ordered before the page's
  reuse — no host sync, runs between steps) and handed to a background
  spill thread through a BOUNDED queue; the thread copies the snapshot to
  pinned host memory on a CUDA stream of its own (after an event wait on
  the gather) and does the G2/G3 tier writes (disk IO never runs
  on the eviction path, so an eviction storm cannot stall a decode step —
  reference analog: ``offload.rs:80-99``'s bounded offload queues).
  When the queue is full the oldest pending spill is dropped and counted:
  the tiers are best-effort caches, blocking the engine is worse than
  losing a re-computable block.
- on ``generate``, prompt blocks missing from HBM but held by G2/G3 are
  injected back into the device cache (in place: the fused blocks' CUDA
  graphs hold the cache's address), then normal admission prefix-matches
  them. Onboarding pulls G3 hits back through G2 (promotion on use).
"""

from __future__ import annotations

import asyncio
import logging
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional

import numpy as np

import torch

from dynamo_tpu_torch.engine.base import EngineBase
from dynamo_tpu_torch.engine.torch_engine import TorchEngine
from dynamo_tpu_torch.engine.transfer import (
    BlockPayload,
    host_array,
    inject_blocks,
    wire_dtype,
)
from dynamo_tpu_torch.protocols.common import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.kvbm.tiers import DiskTier, HostTier
from dynamo_tpu_torch.tokens import compute_block_hash_for_seq

logger = logging.getLogger(__name__)


def default_disk_path() -> str:
    """The G3 directory when none is given: this process's own, under the
    temporary directory (``TMPDIR``), so two workers never read or evict
    each other's block files."""
    return os.path.join(tempfile.gettempdir(),
                        f"dynamo_tpu_kvbm_{os.getpid()}")


@dataclass
class TieredKvConfig:
    host_budget_bytes: int = 1 << 30          # G2: 1 GiB default
    disk_budget_bytes: int = 0                # G3: 0 = disabled
    disk_path: str = field(default_factory=default_disk_path)
    # cap on blocks onboarded SYNCHRONOUSLY per request. With the prefetch
    # scheduler on (the default) only the first prefill chunk's blocks
    # onboard synchronously (min of that and this cap) — the rest stream
    # in ahead of the chunked-prefill cursor; with lookahead disabled
    # (depth 0) this is the old hard cap on the whole onboard.
    max_onboard_blocks: int = 256
    # bounded background spill queue (eviction batches in flight)
    max_pending_spills: int = 8
    # packing-prefetch lookahead depth in bytes; None = resolve
    # DYN_KV_PREFETCH_DEPTH / RuntimeConfig.kv_prefetch_depth, 0 disables
    prefetch_depth_bytes: Optional[int] = None


class TieredEngine(EngineBase):
    """EngineBase wrapper adding G2/G3 offload tiers to a TorchEngine."""

    def __init__(self, engine: TorchEngine,
                 config: Optional[TieredKvConfig] = None):
        from dynamo_tpu_torch.kvbm.prefetch import (
            PrefetchScheduler, prefetch_depth_bytes)

        self.engine = engine
        self.cfg = config or TieredKvConfig()
        self.host = HostTier(self.cfg.host_budget_bytes)
        self.disk = (DiskTier(self.cfg.disk_path, self.cfg.disk_budget_bytes)
                     if self.cfg.disk_budget_bytes > 0 else None)
        self.offloaded = 0
        # the spill thread's device->host copies: bytes and seconds
        self.offload_bytes = 0
        self.offload_s = 0.0
        self.onboarded = 0
        self.dropped_spills = 0
        # RLock: _lookup acquires it internally and is also called from
        # sections that already hold it (collect_tiered_blocks)
        self._tier_lock = threading.RLock()
        self._pending_lock = threading.Lock()
        depth = (prefetch_depth_bytes()
                 if self.cfg.prefetch_depth_bytes is None
                 else int(self.cfg.prefetch_depth_bytes))
        # the lookahead promotion scheduler (kvbm/prefetch.py); None =
        # legacy synchronous onboarding
        self.prefetch = (PrefetchScheduler(self, depth)
                         if depth > 0 else None)
        self._pending_hashes: set = set()
        self._spills: "queue.Queue" = queue.Queue(
            maxsize=self.cfg.max_pending_spills)
        self._spill_thread: Optional[threading.Thread] = None
        self._peer_client = None          # G4 (enable_peer_fetch)
        self._self_instance_id = -1
        self._global_index = None         # fleet prefix index (holder order)
        self.peer_onboarded = 0
        # admission-path onboard accounting: blocks/bytes served by a peer
        # pull vs left for local recompute (the fleet-KV-reuse A/B signal)
        self.onboard_peer_blocks = 0
        self.onboard_peer_bytes = 0
        self.onboard_recompute_blocks = 0
        self.onboard_recompute_bytes = 0
        # the spill thread's own stream: its device->host copies stay off
        # the steps' stream (and out of any graph capture on it)
        self._spill_stream = (torch.cuda.Stream(engine.pages.device)
                              if engine.pages.is_cuda else None)
        engine.allocator.on_evict = self._on_evict

    # -- offload (G1 -> G2 -> G3) -----------------------------------------

    def _on_evict(self, evicted: List[tuple]) -> None:
        """Allocator eviction hook — must return fast.

        Runs between engine steps (evictions happen in the scheduler, which
        is serialized with the step loop), so the device gather reads a
        consistent cache. Only the gather DISPATCH happens here; the
        device->host copy and tier writes run on the spill thread.
        """
        try:
            # the gather runs on the steps' stream, behind every write to
            # these pages and before their reuse; its event is what the
            # spill thread's copy waits on
            gathered = self.engine.dispatch_gather_pages(
                [p for _h, p, _i in evicted])
            ready = None
            if gathered.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
            data_dev = (gathered[:, :len(evicted)], ready)
        except Exception:
            logger.exception("kvbm offload gather failed; blocks dropped")
            return
        metas = [(h, info.local_hash, info.parent_hash)
                 for h, _page, info in evicted]
        with self._pending_lock:
            self._pending_hashes.update(h for h, _l, _p in metas)
        item = (metas, data_dev)
        try:
            self._spills.put_nowait(item)
        except queue.Full:
            try:  # drop the OLDEST pending batch, keep the freshest
                old_metas, _old = self._spills.get_nowait()
                with self._pending_lock:
                    self._pending_hashes.difference_update(
                        h for h, _l, _p in old_metas)
                self._spills.task_done()
                self.dropped_spills += 1
            except queue.Empty:
                pass
            try:
                self._spills.put_nowait(item)
            except queue.Full:
                self.dropped_spills += 1
                return
        if self._spill_thread is None or not self._spill_thread.is_alive():
            self._spill_thread = threading.Thread(
                target=self._spill_loop, daemon=True, name="kvbm-spill")
            self._spill_thread.start()

    def _spill_loop(self) -> None:
        # daemon thread, lives for the engine's lifetime: retiring on idle
        # races the producer's is_alive() check and can strand a batch;
        # stop() ends it with a None behind the pending batches
        while True:
            item = self._spills.get()
            if item is None:
                self._spills.task_done()
                return
            metas, data_dev = item
            try:
                t0 = time.perf_counter()
                host = self._to_host(*data_dev)  # the device->host copy
                with self._tier_lock:
                    self.offload_bytes += host.nbytes
                    self.offload_s += time.perf_counter() - t0
                name = wire_dtype(data_dev[0])
                to_disk: List[BlockPayload] = []
                with self._tier_lock:
                    for i, (h, local, parent) in enumerate(metas):
                        blk = BlockPayload(block_hash=h, local_hash=local,
                                           parent_hash=parent,
                                           data=host[:, i].copy(),
                                           dtype=name)
                        self.offloaded += 1
                        to_disk.extend(self.host.put(blk))
                if self.disk is not None:
                    # G2->G3 demotion writes OUTSIDE the tier lock: a slow
                    # disk must only stall this spill thread, never an
                    # onboard/prefetch probe waiting on the lock
                    for demoted in to_disk:
                        self.disk.put(demoted)
            except Exception:
                logger.exception("kvbm spill batch failed; blocks dropped")
            finally:
                with self._pending_lock:
                    self._pending_hashes.difference_update(
                        h for h, _l, _p in metas)
                self._spills.task_done()

    def _to_host(self, dev: torch.Tensor, ready) -> np.ndarray:
        """Copy an eviction snapshot into pinned host memory on the spill
        stream, after the gather's event; waits for this copy alone."""
        if not dev.is_cuda:
            return host_array(dev)
        stream = self._spill_stream
        torch.cuda.set_device(dev.device)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            buf = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            buf.copy_(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host_array(buf)

    def flush_spills(self, timeout: float = 10.0) -> None:
        """Block until every pending spill landed in a tier."""
        import time
        deadline = time.monotonic() + timeout
        while (self._spills.unfinished_tasks
               and time.monotonic() < deadline):
            time.sleep(0.01)

    # -- onboard (G2/G3 -> G1) --------------------------------------------

    def _lookup(self, block_hash: int) -> Optional[BlockPayload]:
        """One tier lookup with disk->host promotion on use. Acquires the
        tier lock internally (RLock — callers may already hold it); when
        called WITHOUT it held (the prefetch worker thread), the disk file
        read and the G2->G3 demotion write-back run outside the host-tier
        lock, so slow disk IO never serializes other tier operations."""
        with self._tier_lock:
            blk = self.host.get(block_hash)
        if blk is not None or self.disk is None:
            return blk
        blk = self.disk.get(block_hash)  # file IO under the disk's own lock
        if blk is None:
            return None
        with self._tier_lock:
            demoted = self.host.put(blk)  # promote on use
        for d in demoted:
            self.disk.put(d)
        return blk

    def _onboard_for(self, token_ids: List[int],
                     cap: Optional[int] = None,
                     host_only: bool = False,
                     hashes: Optional[List[int]] = None) -> int:
        """Inject tier-resident prompt blocks missing from HBM — the
        bounded SYNCHRONOUS path: the prefetch scheduler's first-chunk
        fast path (``cap`` = the first prefill chunk's blocks), or the
        whole legacy onboard when lookahead is disabled.

        ``host_only`` keeps this path off the disk tier (and the spill
        flush) entirely: it runs inside the engine's exclusive window,
        and a wedged disk must never stall the step loop — disk-resident
        blocks are promoted asynchronously by the prefetcher (or
        recomputed). ``hashes`` lets the caller pass the already-computed
        chain so a 100k-token prompt isn't re-hashed inside the window."""
        page_size = self.engine.allocator.page_size
        if hashes is None:
            hashes = compute_block_hash_for_seq(token_ids, page_size)
        cap = self.cfg.max_onboard_blocks if cap is None else int(cap)
        # onboarding must observe completed offloads — but only wait when a
        # NEEDED block is actually still in the spill queue; flushing every
        # pending batch here would re-serialize slow tier writes onto the
        # step loop at every admission. NEVER on the host_only fast path:
        # flush_spills waits out the spill thread's G2->G3 disk writes,
        # and a wedged disk must not stall the exclusive window this runs
        # in — a pending block simply misses here and the async
        # prefetcher (which flushes on ITS thread) promotes it instead.
        if not host_only:
            with self._pending_lock:
                overlap = bool(self._pending_hashes.intersection(
                    h for h in hashes[:cap]))
            if overlap:
                self.flush_spills()
        resident = self.engine.allocator._by_hash
        needed: List[BlockPayload] = []
        with self._tier_lock:
            for h in hashes[:cap]:
                if h in resident:
                    continue
                blk = (self.host.get(h) if host_only
                       else self._lookup(h))
                if blk is None:
                    break  # chain broken: further blocks can't be used
                needed.append(blk)
        if not needed:
            return 0
        n = inject_blocks(self.engine, needed)
        self.onboarded += n
        return n

    # -- G4: cross-worker peer tier ---------------------------------------

    def enable_peer_fetch(self, kv_client, self_instance_id: int) -> None:
        """Turn on the G4 remote tier: on a local tier miss, fetch the
        missing chain from a peer worker's ``kv_export`` endpoint (content
        addressing makes any peer's copy byte-identical). Reference:
        ``CacheLevel::G4`` + distributed leader/worker,
        ``block_manager.rs:67-81``, ``block_manager/distributed/``."""
        self._peer_client = kv_client
        self._self_instance_id = self_instance_id
        self.peer_onboarded = 0

    def enable_global_index(self, reader) -> None:
        """Attach a fleet prefix-index mirror
        (``kv_router.global_index.GlobalPrefixIndexReader``): peer pulls
        walk KNOWN HOLDERS in overlap order instead of every live
        instance blindly."""
        self._global_index = reader

    def _peer_order(self, hashes: List[int]) -> List[int]:
        """Pull order over live peers: global-index holders first (longest
        overlap first), then the unindexed rest as a blind fallback."""
        live = [iid for iid in self._peer_client.instance_ids()
                if iid != self._self_instance_id]
        if self._global_index is None:
            return live
        ranked = [iid for iid in self._global_index.holder_order(
                      hashes, exclude=(self._self_instance_id,))
                  if iid in set(live)]
        seen = set(ranked)
        return ranked + [iid for iid in live if iid not in seen]

    async def _onboard_from_peers(self, token_ids: List[int]) -> int:
        """Fetch the first-missing chain suffix from peer workers —
        holders first — with the export-lease/resume ladder: each pull
        asks the exporter to pin the served blocks under a TTL'd lease
        (acked once committed), a broken stream keeps its landed blocks
        and RESUMES (same peer once, then the next holder) re-pulling
        only what is still missing, and whatever no peer can serve is
        left for local recompute — with both halves (peer-onboarded vs
        recomputed blocks AND bytes) recorded on the ``kv_transfer`` span
        and the ``dynamo_worker_kv_onboard_*`` counters."""
        import time as _time

        from dynamo_tpu_torch.engine.transfer import (
            FRAME_WIRE_VERSION, InjectPipeline, kv_shard_payload)
        from dynamo_tpu_torch.kvbm.prefetch import _block_bytes
        from dynamo_tpu_torch.utils.tracing import get_tracer
        from dynamo_tpu_torch.worker.disagg import get_kv_bandwidth_book
        from dynamo_tpu_torch.worker.metrics import count_metric

        page_size = self.engine.allocator.page_size
        hashes = compute_block_hash_for_seq(token_ids, page_size)
        hashes = hashes[:self.cfg.max_onboard_blocks]
        resident = self.engine.allocator._by_hash
        with self._tier_lock:
            missing_from = next(
                (i for i, h in enumerate(hashes)
                 if h not in resident and self.host.get(h) is None
                 and (self.disk is None or self.disk.get(h) is None)),
                None)
        if missing_from is None:
            return 0
        want = hashes[missing_from:]
        block_bytes = _block_bytes(self.engine)
        span = get_tracer().start_span(
            "kv_transfer", attrs={"path": "admission_onboard",
                                  "blocks": len(want)})
        injected = 0
        pulled_bytes = 0
        try:
            for iid in self._peer_order(hashes):
                # resume across peers: blocks a previous (partially
                # failed) peer fetch already committed are content-
                # addressed resident — the next peer only serves what is
                # still missing. One same-peer resume first (the pull
                # ladder): a transient stream break re-pulls the tail
                # before the walk moves on.
                for attempt in range(2):
                    want = [h for h in want if h not in resident]
                    if not want:
                        break
                    if attempt:
                        span.add_event("pull_resumed", plane="rpc",
                                       peer=f"{iid:x}",
                                       remaining=len(want))
                        count_metric("kv_pull_resumes")
                    pipe = None
                    lease = None
                    nbytes = 0
                    t0 = _time.perf_counter()
                    try:
                        from dynamo_tpu_torch.runtime.codec import release_buffer
                        # wire-v5 pull: shard negotiation rides the
                        # payload (tiered exporters answer merged frames;
                        # a same-layout HBM exporter streams per-shard),
                        # and want_lease pins the served blocks on the
                        # exporter until the commit ack below
                        stream = await self._peer_client.direct(
                            {"block_hashes": want,
                             "wire": FRAME_WIRE_VERSION,
                             "want_lease": 1,
                             **kv_shard_payload(self.engine)}, iid)
                        # staged pipeline: frames batch into bounded
                        # in-place scatters, so a big onboard doesn't
                        # stall decode steps
                        pipe = InjectPipeline(self.engine)
                        async for frame in stream:
                            if frame.get("lease") is not None:
                                lease = int(frame["lease"])
                                span.set_attr("kv_export_lease", lease)
                                continue
                            if "_raw" not in frame:
                                continue
                            nbytes += len(frame["_raw"])
                            # pipeline recycles the pooled trailer once
                            # consumed
                            await pipe.add_frame(frame,
                                                 release=release_buffer)
                        injected += await pipe.finish()
                        dt = _time.perf_counter() - t0
                        pulled_bytes += nbytes
                        if nbytes:
                            # admission pulls ride the RPC plane: feed the
                            # same bandwidth EWMA the router prices with
                            get_kv_bandwidth_book().note("rpc", nbytes, dt)
                        break
                    except BaseException as e:  # incl. CancelledError —
                        # the pipeline's in-flight commits must be reaped
                        # either way
                        if pipe is not None:
                            # reap in-flight commits (no leaked task
                            # exceptions) and keep what landed: content-
                            # addressed blocks from a broken stream are
                            # still good prefix the resume dedups against
                            injected += await pipe.drain()
                        pulled_bytes += nbytes
                        if not isinstance(e, Exception):
                            raise  # cancellation propagates after the reap
                        logger.debug("G4 peer %x fetch failed: %s", iid, e)
                        continue
                    finally:
                        if lease is not None:
                            # commit/abandon ack either way: the exporter
                            # unpins now instead of waiting out the TTL
                            acked = await self._ack_peer_lease(iid, lease)
                            span.set_attr("lease_acked", acked)
                # no break on clean partial service: a peer that served
                # only part of the chain (the rest fell out of its tiers)
                # is not the end — the want-filter stops the walk once
                # nothing is missing, otherwise the next holder serves
                # the remainder
                want = [h for h in want if h not in resident]
                if not want:
                    break
        finally:
            # the recompute-vs-onboard split this admission decided:
            # whatever no peer could serve is prefill work
            recompute = len([h for h in want if h not in resident])
            self.peer_onboarded += injected
            self.onboard_peer_blocks += injected
            self.onboard_peer_bytes += pulled_bytes
            self.onboard_recompute_blocks += recompute
            self.onboard_recompute_bytes += recompute * block_bytes
            span.set_attr("onboarded_blocks", injected)
            span.set_attr("onboarded_bytes", pulled_bytes)
            span.set_attr("recompute_blocks", recompute)
            span.set_attr("recompute_bytes", recompute * block_bytes)
            span.finish()
            if injected:
                count_metric("kv_onboard", "peer", inc=injected)
                count_metric("kv_onboard_bytes", "peer", inc=pulled_bytes)
            if recompute:
                count_metric("kv_onboard", "recompute", inc=recompute)
                count_metric("kv_onboard_bytes", "recompute",
                             inc=recompute * block_bytes)
        return injected

    async def _ack_peer_lease(self, iid: int, lease: int) -> bool:
        try:
            stream = await self._peer_client.direct(
                {"ack_lease": int(lease)}, iid)
            async for _ in stream:
                pass
            return True
        except Exception as e:  # noqa: BLE001 — the exporter's TTL covers
            logger.debug("onboard lease %s ack to %x failed (%s); TTL "
                         "covers", lease, iid, e)
            return False

    # -- EngineBase --------------------------------------------------------

    async def generate(self, request: PreprocessedRequest,
                       ctx=None) -> AsyncIterator[LLMEngineOutput]:
        handle = None
        if request.token_ids:
            if not request.request_id:
                # the engine assigns this same fallback id later; the
                # prefetch cursor needs it NOW to track the sequence
                request.request_id = f"req-{id(request):x}"
            if self.prefetch is not None:
                # admission lookahead: the first prefill chunk's blocks
                # onboard synchronously so admission's prefix match sees
                # them; later chunks' blocks stream in pinned ahead of the
                # chunked-prefill cursor and are adopted mid-prefill
                # (Scheduler._adopt_resident) instead of recomputed
                handle = await self.prefetch.admit(request)
            else:
                # legacy path (DYN_KV_PREFETCH_DEPTH=0): serialized with
                # the step loop — onboarding writes engine.pages in place,
                # which every step reads
                await self.engine.run_exclusive(
                    self._onboard_for, request.token_ids)
            if self._peer_client is not None:
                try:
                    await self._onboard_from_peers(request.token_ids)
                except Exception:  # noqa: BLE001 — G4 must never fail a req
                    logger.exception("G4 peer onboard failed")
        try:
            async for out in self.engine.generate(request, ctx):
                yield out
        finally:
            if handle is not None:
                # commit or abort: release the promotion pins (the
                # sequence's own page refs — or the LRU — own them now)
                await handle.close()

    async def start(self) -> None:
        await self.engine.start()

    async def stop(self) -> None:
        await self.engine.stop()
        # the spill thread ends with the engine, after the batches queued
        # before it: its frame holds this object, so the engine, its cache
        # and its weights would outlive the stop
        t = self._spill_thread
        if t is not None and t.is_alive():
            await asyncio.to_thread(self._spills.put, None)
            await asyncio.to_thread(t.join, 30.0)

    def stats(self):
        return self.engine.stats()

    def kvbm_stats(self) -> Dict[str, float]:
        """Tier/pool gauges for the stats plane (worker ``__stats__`` →
        frontend Prometheus; reference: block-manager pool metrics)."""
        with self._tier_lock:
            out = {
                "kvbm_offloaded_blocks": self.offloaded,
                "kvbm_offload_bytes": self.offload_bytes,
                "kvbm_offload_seconds": self.offload_s,
                "kvbm_onboarded_blocks": self.onboarded,
                "kvbm_dropped_spills": self.dropped_spills,
                "kvbm_host_blocks": len(self.host),
                "kvbm_host_bytes": self.host.used,
                "kvbm_pending_spills": self._spills.qsize(),
                "kvbm_peer_onboarded_blocks": self.peer_onboarded,
                "kvbm_onboard_peer_bytes": self.onboard_peer_bytes,
                "kvbm_onboard_recompute_blocks":
                    self.onboard_recompute_blocks,
                "kvbm_onboard_recompute_bytes":
                    self.onboard_recompute_bytes,
            }
            if self.disk is not None:
                out["kvbm_disk_blocks"] = len(self.disk)
                out["kvbm_disk_bytes"] = self.disk.used
                out["kvbm_disk_corrupt_dropped"] = self.disk.corrupt_dropped
        # mid-prefill prefix adoptions (the consumer half of the prefetch
        # pipeline) live on the engine scheduler
        out["kvbm_prefetch_adopted_blocks"] = \
            self.engine.scheduler.adopted_blocks
        if self.prefetch is not None:
            out.update(self.prefetch.stats())
        return out


def collect_tiered_blocks(tiered: TieredEngine,
                          hashes: List[int]) -> List[BlockPayload]:
    """HBM-resident prefix first (device gather), then continue the chain
    from the G2/G3 tiers; stop at the first total miss. Runs under
    ``run_exclusive``."""
    from dynamo_tpu_torch.engine.transfer import export_blocks

    blocks = export_blocks(tiered.engine, hashes)
    with tiered._tier_lock:
        for h in hashes[len(blocks):]:
            blk = tiered._lookup(h)
            if blk is None:
                break
            blocks.append(blk)
    return blocks


def tiered_export_frames(tiered: TieredEngine, hashes: List[int],
                         layout: str = "layer",
                         frame_blocks: Optional[int] = None):
    """Batched Raw wire frames spanning HBM + tiers (the tier-aware
    counterpart of ``transfer.export_frames``; shared by the RPC and bulk
    planes so neither silently misses tier-resident blocks). ``layout``
    follows the same wire schema: layer-major v3 for new pullers,
    block-major v2 compat otherwise; wire-v4 checksums are stamped by the
    handlers afterward (``transfer.stamp_frame_crcs``, outside the
    exclusive window). Runs under ``run_exclusive``."""
    from dynamo_tpu_torch.engine.transfer import kv_transfer_defaults
    from dynamo_tpu_torch.runtime.codec import Raw

    # handlers resolve the knob outside the exclusive window and pass it
    per = (int(frame_blocks) if frame_blocks
           else kv_transfer_defaults()[0])
    blocks = collect_tiered_blocks(tiered, hashes)
    frames = []
    for i in range(0, len(blocks), per):
        chunk = blocks[i:i + per]
        meta = {"blocks": [[b.block_hash, b.local_hash, b.parent_hash]
                           for b in chunk]}
        if layout == "layer":
            data = np.ascontiguousarray(
                np.stack([b.data for b in chunk], axis=1))
            meta["block_shape"] = [data.shape[0]] + list(data.shape[2:])
            meta["layout"] = "layer"
        else:
            data = np.ascontiguousarray(
                np.stack([b.data for b in chunk], axis=0))
            meta["block_shape"] = list(data.shape[1:])
        meta["dtype"] = chunk[0].dtype
        frames.append(Raw(meta, data))
    return frames


def serve_tiered_kv_export(tiered: TieredEngine):
    """RPC handler: like ``transfer.serve_kv_export`` but also serves
    blocks held only in this worker's G2/G3 tiers — the provider side of
    the G4 remote tier (peers fetch what fell out of our HBM)."""
    from dynamo_tpu_torch.engine.transfer import (
        grant_export_lease,
        release_export_lease,
        resolve_wire,
    )

    async def handler(payload, ctx):
        payload = payload or {}
        if payload.get("ack_lease") is not None:
            # puller committed its pull: unpin the export lease now
            # instead of waiting out the TTL GC
            ok = await release_export_lease(tiered.engine,
                                            int(payload["ack_lease"]))
            yield {"acked": bool(ok)}
            return
        hashes = list(payload.get("block_hashes", []))
        if payload.get("want_lease"):
            # puller-initiated pulls (admission onboarding) have no
            # advertise step to grant a lease through: grant one here so
            # the HBM-resident slice of the chain can't be evicted out
            # from under the stream; tier-resident blocks need no pin.
            # The puller acks {"ack_lease": id} once committed; the TTL
            # GC covers a lost ack.
            lease = await grant_export_lease(tiered.engine, hashes)
            if lease is not None:
                yield {"lease": int(lease)}
        if int(payload.get("wire", 1)) >= 2:
            # tiered exports serve merged frames regardless of the shard
            # negotiation: tier-resident blocks live as unsharded host
            # bytes, so there is no per-shard slice to stream
            layout, per, crc, _shards = resolve_wire(payload, 1)
            frames = await tiered.engine.run_exclusive(
                tiered_export_frames, tiered, hashes, layout, per)
            if crc:  # outside the exclusive window
                from dynamo_tpu_torch.engine.transfer import stamp_frame_crcs
                stamp_frame_crcs(frames)
            for f in frames:
                yield f
        else:
            blocks = await tiered.engine.run_exclusive(
                collect_tiered_blocks, tiered, hashes)
            for b in blocks:
                yield b.to_wire()

    return handler


def serve_tiered_kv_export_bulk(tiered: TieredEngine, loop):
    """Bulk-plane handler spanning HBM + tiers (tier-aware counterpart of
    ``transfer.serve_kv_export_bulk``) — without this, the PREFERRED
    transport would silently truncate chains at the first tier-resident
    block."""
    import asyncio as _aio

    from dynamo_tpu_torch.engine.transfer import resolve_wire

    def handler(payload):
        payload = payload or {}
        hashes = list(payload.get("block_hashes", []))
        # merged frames always — tier-resident blocks are unsharded host
        # bytes (see serve_tiered_kv_export)
        layout, per, crc, _shards = resolve_wire(payload, 2)
        fut = _aio.run_coroutine_threadsafe(
            tiered.engine.run_exclusive(tiered_export_frames, tiered,
                                        hashes, layout, per), loop)
        frames = fut.result(timeout=120.0)
        if crc:  # checksummed in the bulk connection's thread, outside
            # the exclusive window
            from dynamo_tpu_torch.engine.transfer import stamp_frame_crcs
            stamp_frame_crcs(frames)
        for f in frames:
            yield f.obj, f.raw

    return handler


__all__ = ["TieredEngine", "TieredKvConfig", "serve_tiered_kv_export",
           "serve_tiered_kv_export_bulk", "tiered_export_frames",
           "collect_tiered_blocks"]
