"""Lookahead KV tier promotion: the packing-prefetch scheduler.

Paper: "Architecting Long-Context LLM Acceleration with Packing-Prefetch
Scheduler and Ultra-Large Capacity On-Chip Memories" (PAPERS.md) — predict
which KV blocks the next compute window needs and stage them ahead of it,
packing compute and prefetch concurrently instead of serializing them.

Before this module, ``TieredEngine.generate`` promoted G2/G3 blocks
SYNCHRONOUSLY inside the engine's exclusive window, hard-capped at
``max_onboard_blocks`` precisely because onboarding blocked admission — a
100k-token tier-resident prompt either stalled every other request behind
one giant inject or recomputed most of its prefix. Here promotion becomes
pipelined lookahead:

- **Admission lookahead** (``PrefetchScheduler.admit``): when a request
  arrives, compute its block hashes, probe HBM/host/disk residency, onboard
  only the FIRST prefill chunk's blocks synchronously (so the scheduler's
  one prefix-match at admission sees the head of the chain), and start a
  background task streaming the rest through the staged
  ``InjectPipeline``: bounded in-place scatters outside the hot
  path, decode steps interleaving between commit windows.
- **Cursor-paced depth** : the task promotes in chunk order within a
  bytes-budgeted window (``DYN_KV_PREFETCH_DEPTH``) ahead of the request's
  chunked-prefill cursor — never unboundedly ahead, never behind. Blocks
  that land are adopted mid-prefill by ``Scheduler._adopt_resident``
  (the admission hook half of this subsystem) instead of recomputed.
- **Pinning**: each commit window pins its blocks in the SAME exclusive
  window that committed them (``ExportLeaseManager.grant_sync``,
  ``kind="prefetch"`` — the export lease machinery, sharing the
  half-allocator hard cap with export leases), so LRU eviction pressure
  can never drop a promoted block before the request claims it. Pins are
  released when the request finishes or aborts; the lease TTL is the
  crash backstop.

Tier reads (including slow disk IO and the disk->host promote-on-use
demotion writes) run on a worker thread via the tiers' own locking —
"packing and prefetching concurrently" per the paper.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from dynamo_tpu_torch.engine.transfer import (
    InjectPipeline,
    _inject_data,
    _runtime_cfg,
    export_ttl_s,
    get_export_leases,
    inject_blocks,
)
from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
from dynamo_tpu_torch.utils.tracing import get_tracer

if TYPE_CHECKING:  # pragma: no cover — import cycle guard
    from dynamo_tpu_torch.engine.transfer import BlockPayload
    from dynamo_tpu_torch.kvbm.manager import TieredEngine

logger = logging.getLogger(__name__)

# default lookahead window (bytes of KV promoted ahead of the prefill
# cursor); DYN_KV_PREFETCH_DEPTH / RuntimeConfig.kv_prefetch_depth override
DEFAULT_PREFETCH_DEPTH = 64 * 1024 * 1024

# cursor poll interval while the lookahead window is full (the prefill
# cursor advances once per engine step; polling faster buys nothing)
_PACE_POLL_S = 0.005


def prefetch_depth_bytes() -> int:
    """Resolve the lookahead depth: RuntimeConfig ``kv_prefetch_depth``
    (TOML / ``DYN_RUNTIME_*``), then the short-form ``DYN_KV_PREFETCH_DEPTH``
    env wins. ``0`` disables the prefetcher entirely (the tiered engine
    falls back to the bounded synchronous onboard path)."""
    depth = DEFAULT_PREFETCH_DEPTH
    try:
        depth = int(_runtime_cfg().kv_prefetch_depth)
    except Exception:  # noqa: BLE001 — a bad config must not break serving
        logger.warning("bad runtime config; kv prefetch depth falls back "
                       "to %d", depth, exc_info=True)
    raw = os.environ.get("DYN_KV_PREFETCH_DEPTH")
    if raw is not None:
        try:
            depth = int(raw)
        except (TypeError, ValueError):
            logger.warning("malformed DYN_KV_PREFETCH_DEPTH %r; using %d",
                           raw, depth)
    return max(0, depth)


def _block_bytes(engine) -> int:
    """Bytes of one KV block in this engine's cache geometry: the whole
    model's block (``[L, 2, Hkv, ps, Dh]``), also on a rank of a world,
    whose own cache holds its layers and heads only."""
    return int(np.prod(engine.kv_block_shape())) * \
        engine.pages.element_size()


class PrefetchScheduler:
    """Per-``TieredEngine`` promotion scheduler; one ``PrefetchHandle``
    per in-flight request doing lookahead."""

    def __init__(self, tiered: "TieredEngine",
                 depth_bytes: Optional[int] = None):
        self.tiered = tiered
        self.engine = tiered.engine
        self.depth_bytes = (prefetch_depth_bytes() if depth_bytes is None
                            else int(depth_bytes))
        # counters (single event-loop/exclusive-thread writers; reads are
        # advisory for stats)
        self.hits = 0            # blocks promoted from a tier ahead of need
        self.late = 0            # promotions that lost the race (the block
        #                          was already resident — recomputed by the
        #                          cursor or injected by a sibling — or no
        #                          free pages remained for it)
        self.misses = 0          # planned blocks that fell out of every
        #                          tier before promotion reached them
        self.evicted_pinned = 0  # canary: pinned blocks missing from HBM
        #                          at release time (must stay 0 — pinned
        #                          pages are refcounted and unevictable)
        self.promoted_bytes = 0
        self.inflight = 0        # handles with a live promotion task

    # -- admission hook ----------------------------------------------------

    async def admit(self, request) -> Optional["PrefetchHandle"]:
        """Admission lookahead for one request: bounded synchronous onboard
        of the FIRST prefill chunk's blocks, then a background promotion
        task for the rest. Returns a handle the caller must ``close()``
        when the request finishes or aborts (releases the pins), or None
        when there is nothing to prefetch."""
        engine = self.engine
        token_ids = request.token_ids
        page_size = engine.allocator.page_size
        hashes = compute_block_hash_for_seq(token_ids, page_size)
        if not hashes:
            return None
        chunk_blocks = max(
            1, engine.scheduler.cfg.max_prefill_chunk // page_size)
        cap = min(chunk_blocks, self.tiered.cfg.max_onboard_blocks)
        # first-chunk fast path: what remains of the old synchronous
        # onboard, small enough that admission latency stays bounded.
        # The tier reads (disk and spill flush included) run on a worker
        # thread, outside the exclusive window, which only injects: a
        # wedged disk delays this request's admission, never the step
        # loop. Left to the promoter, a disk-resident head would race the
        # prefill cursor, which computes the first chunk at once.
        resident = engine.allocator._by_hash  # advisory: inject re-filters
        head = [h for h in hashes[:cap] if h not in resident]
        blocks = await asyncio.to_thread(self._collect, head) if head else []
        if blocks:
            await engine.run_exclusive(self._inject_head, blocks)
        if self.depth_bytes <= 0:
            return None
        # leave >=1 token to compute (the admission/adoption rule)
        limit = (len(token_ids) - 1) // page_size
        # residency walk (advisory — the commit path re-filters): a block
        # in NO tier breaks the chain; everything past it is unusable
        with self.tiered._pending_lock:
            pending = set(self.tiered._pending_hashes)
        resident = engine.allocator._by_hash
        host, disk = self.tiered.host, self.tiered.disk
        plan: List[Tuple[int, int]] = []
        with self.tiered._tier_lock:
            for i in range(limit):
                h = hashes[i]
                if h in resident:
                    continue
                if (h in host or (disk is not None and h in disk)
                        or h in pending):
                    plan.append((i, h))
                else:
                    # chain gap: blocks past it are unusable (a cold
                    # prompt is not a "miss" — it was never promotable)
                    break
        if not plan:
            return None
        return PrefetchHandle(self, request.request_id or "", plan,
                              page_size, chunk_blocks)

    def _inject_head(self, blocks: List["BlockPayload"]) -> int:
        """The first chunk's blocks into HBM (engine exclusive thread)."""
        n = inject_blocks(self.engine, blocks)
        self.tiered.onboarded += n
        return n

    # -- tier side (worker thread) -----------------------------------------

    def _collect(self, hashes: List[int]) -> List["BlockPayload"]:
        """Read one promotion batch out of the tiers (worker thread; slow
        disk IO happens outside the host-tier lock via ``DiskTier``'s own
        locking). Stops at the first miss — later blocks are useless
        without their parents. A hash still sitting in the spill queue is
        flushed first (onboarding must observe completed offloads)."""
        t = self.tiered
        out: List["BlockPayload"] = []
        for h in hashes:
            with t._pending_lock:
                pending = h in t._pending_hashes
            if pending:
                t.flush_spills()
            blk = t._lookup(h)
            if blk is None:
                break
            out.append(blk)
        return out

    def stats(self) -> Dict[str, float]:
        mgr = get_export_leases(self.engine)
        pinned = (mgr.pinned_pages_kind("prefetch")
                  if mgr is not None else 0)
        return {
            "kvbm_prefetch_hits": self.hits,
            "kvbm_prefetch_late": self.late,
            "kvbm_prefetch_misses": self.misses,
            "kvbm_prefetch_evicted_pinned": self.evicted_pinned,
            "kvbm_prefetch_bytes": self.promoted_bytes,
            "kvbm_prefetch_pinned_pages": pinned,
            "kvbm_prefetch_inflight": self.inflight,
        }


class PrefetchHandle:
    """One request's lookahead promotion: a background task streaming tier
    blocks through an ``InjectPipeline`` paced behind the prefill cursor,
    pinning each commit window until ``close()``."""

    def __init__(self, sched: PrefetchScheduler, request_id: str,
                 plan: List[Tuple[int, int]], page_size: int,
                 chunk_blocks: int):
        self.sched = sched
        self.engine = sched.engine
        self.request_id = request_id
        self.plan = plan                      # [(block_index, hash), ...]
        self.page_size = page_size
        self.block_bytes = max(1, _block_bytes(self.engine))
        # batch = FOUR prefill chunks per promotion iteration: commits
        # land in the exclusive gaps BETWEEN engine steps, and the compute
        # cursor advances one chunk per step — a batch no bigger than a
        # chunk could never outrun it, while a much larger batch stages so
        # long the cursor passes it before the commit lands (measured on
        # the bench long-context leg: 2 chunks -> 0.46 hit rate, 4 ->
        # 0.73, 8 -> 0.18). Four gains ~3 chunks of ground per step.
        self.chunk_blocks = max(1, chunk_blocks)
        self.batch_blocks = 4 * self.chunk_blocks
        self.depth_blocks = max(self.batch_blocks,
                                sched.depth_bytes // self.block_bytes)
        # commit window = the whole batch: ordered flushes land ONE
        # commit per exclusive gap, and gaps come once per engine step —
        # a window smaller than the chunk the step just computed can
        # never gain on the cursor, and halving the window measurably
        # halves the ground gained (bench leg: 0.45 vs 0.72 hit rate,
        # 2x the 32k TTFT). Cost: the pipeline's double-buffered host
        # staging is 2x the batch's bytes (~4 chunks of KV); the
        # exclusive stall per window is a scatter of 4 chunks' blocks —
        # comparable to the prefill step the scheduler already
        # interleaves decode with.
        self.window = self.batch_blocks
        self.hits = 0
        self.late = 0
        self._mgr = get_export_leases(self.engine)
        self._lease_ids: List[int] = []
        self._pinned_hashes: set = set()
        self._closed = False
        self._seen_active = False
        # current=False: this span outlives the admission call that opened
        # it (it finishes when the promotion task does) — it must not
        # become the ambient parent of the request's own stage spans
        self._span = get_tracer().start_span("kv_prefetch", attrs={
            "request_id": request_id,
            "planned_blocks": len(plan),
            "depth_bytes": sched.depth_bytes,
            "depth_blocks": self.depth_blocks,
        }, current=False)
        sched.inflight += 1
        self._task = asyncio.create_task(self._run())

    # -- commit callback (engine exclusive worker thread) ------------------

    def _commit(self, eng, metas, data) -> int:
        n = _inject_data(eng, metas, data, self.window)
        self.hits += n
        self.late += len(metas) - n
        self.sched.hits += n
        self.sched.late += len(metas) - n
        self.sched.promoted_bytes += n * self.block_bytes
        self.sched.tiered.onboarded += n  # prefetched blocks ARE onboards
        if self._mgr is not None and metas:
            # pin in the SAME exclusive window that committed: eviction
            # pressure can never snatch a block between commit and pin
            lease, npinned = self._mgr.grant_sync(
                [m[0] for m in metas], kind="prefetch")
            if lease is not None:
                self._lease_ids.append(lease)
                self._pinned_hashes.update(m[0] for m in metas[:npinned])
        return n

    # -- pacing ------------------------------------------------------------

    def _cursor_block(self) -> Optional[int]:
        """The request's prefill cursor in blocks (advisory read), or None
        once the request has left the engine (finished/aborted)."""
        seq = self.engine.scheduler.active.get(self.request_id)
        if seq is None:
            return None if self._seen_active else 0
        self._seen_active = True
        return seq.num_computed // self.page_size

    async def _run(self) -> None:
        t0 = time.perf_counter()
        pipe = InjectPipeline(self.engine, window=self.window,
                              commit=self._commit)
        aborted = False
        try:
            pos = 0
            while pos < len(self.plan) and not self._closed:
                cursor = self._cursor_block()
                if cursor is None:
                    aborted = True
                    break
                lookahead_end = cursor + self.depth_blocks
                # concede a one-chunk guard ahead of the cursor: blocks
                # the NEXT prefill step will compute before any commit of
                # ours could land — promoting them would be duplicated
                # work that always loses the race. Compute eats the guard
                # chunk while promotion covers everything past it (the
                # paper's packing: compute window k, prefetch window k+1).
                # No guard before the request is ADMITTED: nothing is
                # computing yet, so the blocks past the first chunk
                # (which admission onboarded) get a genuine head start.
                frontier = cursor + (self.chunk_blocks
                                     if self._seen_active else 0)
                resident = self.engine.allocator._by_hash  # advisory
                batch: List[int] = []
                while (pos < len(self.plan)
                       and self.plan[pos][0] < frontier):
                    _i, h = self.plan[pos]
                    pos += 1
                    if h not in resident:
                        self.late += 1        # conceded to the cursor
                        self.sched.late += 1
                while (pos < len(self.plan)
                       and len(batch) < self.batch_blocks
                       and self.plan[pos][0] < lookahead_end):
                    _i, h = self.plan[pos]
                    pos += 1
                    if h in resident:
                        # the cursor (or a sibling request) got there
                        # first: promotion would be filtered anyway
                        self.late += 1
                        self.sched.late += 1
                        continue
                    batch.append(h)
                if not batch:
                    if pos >= len(self.plan):
                        break
                    await asyncio.sleep(_PACE_POLL_S)  # window full: wait
                    continue                           # for the cursor
                blocks = await asyncio.to_thread(self.sched._collect,
                                                 batch)
                if blocks:
                    await pipe.add_blocks(blocks)
                if len(blocks) < len(batch):
                    # a needed block fell out of every tier mid-flight:
                    # the chain is broken past it
                    self.sched.misses += len(batch) - len(blocks)
                    break
            await pipe.finish()
        except asyncio.CancelledError:
            aborted = True
            await pipe.drain()
        except Exception as e:  # noqa: BLE001 — prefetch must never fail
            # the request; the cursor just recomputes what didn't land
            self._span.set_error(str(e))
            logger.exception("kv prefetch promotion failed")
            await pipe.drain()
        finally:
            if self._mgr is not None and self._lease_ids:
                # crash backstop: if close() never runs (process dying,
                # handle leaked), the TTL sweep reclaims the pins
                try:
                    self._mgr.arm_sweep(export_ttl_s())
                except Exception:  # noqa: BLE001
                    pass
            self.sched.inflight -= 1
            self._span.set_attr("promoted_blocks", self.hits)
            self._span.set_attr("bytes", self.hits * self.block_bytes)
            self._span.set_attr("late", self.late)
            self._span.set_attr("pinned_pages", len(self._pinned_hashes))
            self._span.set_attr("promote_ms", round(
                (time.perf_counter() - t0) * 1e3, 1))
            if aborted:
                self._span.set_attr("aborted", True)
            self._span.finish()

    # -- lifecycle ---------------------------------------------------------

    async def wait(self, timeout: float = 30.0) -> None:
        """Test hook: block until the promotion task finished."""
        await asyncio.wait_for(asyncio.shield(self._task), timeout)

    async def close(self) -> None:
        """Stop any in-flight promotion and release the pins — called when
        the request finishes (its own page refs now protect the prefix) or
        aborts (the blocks return to the ordinary LRU). Idempotent."""
        if self._closed:
            return
        self._closed = True
        if not self._task.done():
            self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
        # canary BEFORE release, and only while every lease is still LIVE:
        # a pinned block missing from HBM then means the pin machinery
        # failed (refcounted pages are unevictable). A lease the TTL
        # sweep already reclaimed (request outlived DYN_KV_EXPORT_TTL_S)
        # legitimately un-pinned its pages — not a canary event.
        if (self._mgr is not None and self._lease_ids
                and all(self._mgr.holds(lid) for lid in self._lease_ids)):
            resident = self.engine.allocator._by_hash
            gone = sum(1 for h in self._pinned_hashes
                       if h not in resident)
            if gone:
                self.sched.evicted_pinned += gone
                logger.warning(
                    "%d prefetched block(s) vanished while pinned", gone)
        await self._release_pins()

    async def _release_pins(self) -> None:
        mgr, eng = self._mgr, self.engine
        if mgr is None:
            return
        leases, self._lease_ids = self._lease_ids, []
        for lid in leases:
            try:
                if (getattr(eng, "_stopping", False)
                        or eng._loop_task is None
                        or eng._loop_task.done()):
                    # loop stopped/dead: run_exclusive would restart it
                    mgr.release_detached(lid)
                else:
                    await mgr.release(lid)
            except Exception:  # noqa: BLE001 — TTL covers a failed release
                mgr.release_detached(lid)


__all__ = ["PrefetchScheduler", "PrefetchHandle", "prefetch_depth_bytes",
           "DEFAULT_PREFETCH_DEPTH"]
