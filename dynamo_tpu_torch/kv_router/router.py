"""KvPushRouter: the pipeline-facing KV-aware router.

Parity: reference ``lib/llm/src/kv_router/kv_router.rs`` (``KvRouter`` +
``KvPushRouter``): hash the tokenized prompt, match against the global index,
pick a worker via the scheduler, stamp ``estimated_prefix_hit_num_blocks``,
``direct()`` the request to that worker, then track decoded blocks via
``push``/``free``; plus the event/metrics feedback loops
(``kv_router.rs:178-201``, ``metrics_aggregator.rs``) and the
``KVHitRateEvent`` emission (``scheduler.rs:36-40``).

Feedback planes:
- KV events: subscribes ``{ns}.{component}.kv_events`` (what workers publish
  via ``dynamo_tpu_torch.worker.main``) into the ``KvIndexer``; with
  ``use_kv_events=False`` an ``ApproxKvIndexer`` predicts instead.
- Load metrics: periodic ``component.scrape_stats()`` (the ``__stats__``
  builtin every served endpoint answers) parsed as ``ForwardPassMetrics``.
- Instance liveness: workers that leave the client's instance set are pruned
  from the index and scheduler.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from dynamo_tpu_torch.kv_router.approx import ApproxKvIndexer
from dynamo_tpu_torch.kv_router.global_index import GlobalPrefixIndexReader
from dynamo_tpu_torch.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler, WorkerSelector
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.protocols.events import (
    ForwardPassMetrics,
    KVHitRateEvent,
    RouterEvent,
)
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode
from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
from dynamo_tpu_torch.utils.aio import reap_task

logger = logging.getLogger(__name__)


def kv_events_subject(namespace: str, component: str) -> str:
    return f"{namespace}.{component}.kv_events"


def kv_hit_rate_subject(namespace: str, component: str) -> str:
    return f"{namespace}.{component}.kv_hit_rate"


class KvPushRouter:
    """Drop-in for PushRouter with KV-aware placement."""

    def __init__(self, drt, client, card: ModelDeploymentCard,
                 overlap_score_weight: float = 1.0,
                 temperature: float = 0.0,
                 use_kv_events: bool = True,
                 stats_interval: float = 1.0,
                 selector: Optional[WorkerSelector] = None,
                 policy=None,
                 use_global_index: bool = False,
                 kv_block_bytes: int = 0,
                 net_weight: float = 25.0):
        self.drt = drt
        self.client = client
        self.block_size = card.kv_cache_block_size
        self.use_kv_events = use_kv_events
        self.stats_interval = stats_interval
        self.indexer = (KvIndexer(self.block_size) if use_kv_events
                        else ApproxKvIndexer(self.block_size))
        # optional RouterPolicy (runtime/resilience.py) shared with the
        # inner PushRouter: breakers/budget/latency book apply to the
        # pinned dispatch, the scheduler blends its cost bias
        self.policy = policy
        self.scheduler = KvScheduler(
            self.block_size, overlap_score_weight=overlap_score_weight,
            temperature=temperature, selector=selector, policy=policy,
            block_bytes=kv_block_bytes, net_weight=net_weight)
        self.inner = PushRouter(client, RouterMode.DIRECT, policy=policy)
        self._namespace = client.endpoint.namespace
        self._component = client.endpoint.component
        self._event_sub = None
        self._event_task: Optional[asyncio.Task] = None
        self._stats_task: Optional[asyncio.Task] = None
        # fleet-wide prefix index (coordinator kv-store mirror): lets the
        # scheduler see holders behind OTHER frontends and price onboarding
        self.use_global_index = use_global_index
        self.global_index: Optional[GlobalPrefixIndexReader] = None

    @classmethod
    async def create(cls, drt, client, card: ModelDeploymentCard,
                     **kwargs) -> "KvPushRouter":
        self = cls(drt, client, card, **kwargs)
        if self.use_kv_events:
            self._event_sub = await drt.subscribe_events(
                kv_events_subject(self._namespace, self._component))
            self._event_task = asyncio.create_task(self._event_loop())
        if self.use_global_index:
            self.global_index = GlobalPrefixIndexReader(drt.kv_store())
            await self.global_index.start()
        self._stats_task = asyncio.create_task(self._stats_loop())
        return self

    async def close(self) -> None:
        await reap_task(self._event_task)
        await reap_task(self._stats_task)
        if self.global_index is not None:
            await self.global_index.close()
        await self.inner.close()
        if self._event_sub is not None:
            try:
                await self._event_sub.cancel()
            except Exception:
                pass
        await self.client.close()

    # -- feedback loops ----------------------------------------------------

    async def _event_loop(self) -> None:
        async for _subject, payload in self._event_sub:
            try:
                self.indexer.apply_event(RouterEvent.from_dict(payload))
            except Exception:
                logger.exception("bad kv event %r", payload)

    async def _stats_loop(self) -> None:
        component = (self.drt.namespace(self._namespace)
                     .component(self._component))
        while True:
            try:
                scraped = await component.scrape_stats()
                metrics: Dict[int, ForwardPassMetrics] = {}
                ep_path = self.client.endpoint.path
                for iid, stats in scraped.items():
                    # response is keyed by endpoint rpc name (see
                    # rpc.py __stats__): {path: {requests, active, data}}
                    ep_stats = stats.get(ep_path) if isinstance(stats, dict) else None
                    data = ep_stats.get("data") if isinstance(ep_stats, dict) else None
                    if data:
                        metrics[iid] = ForwardPassMetrics.from_dict(data)
                self.scheduler.update_metrics(metrics)
                live = set(self.client.instance_ids())
                if self.policy is not None:
                    self.policy.ingest_scrape(scraped, ep_path)
                    self.policy.prune(live)
                for wid in [w for w in self._known_workers() if w not in live]:
                    self.indexer.remove_worker(wid)
                    self.scheduler.remove_worker(wid)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("stats scrape failed")
            await asyncio.sleep(self.stats_interval)

    def _known_workers(self) -> List[int]:
        if isinstance(self.indexer, KvIndexer):
            return self.indexer.workers()
        return []

    def _export_decision(self, worker: int, overlap: int, isl_blocks: int,
                         explain: Optional[Dict[int, Dict]],
                         fleet_best: int = 0) -> None:
        """KV routing decision trace attrs on the request's current span —
        the prefix-overlap/cost inputs, plus the policy's failure-aware
        inputs when attached (retrievable post-hoc from /v1/traces)."""
        span = PushRouter._current_span()
        if span is None:
            return
        span.set_attr("router.policy", "kv")
        span.set_attr("router.instance", f"{worker:x}")
        span.set_attr("router.overlap_blocks", overlap)
        span.set_attr("router.isl_blocks", isl_blocks)
        span.set_attr("router.fleet_best_blocks", fleet_best)
        chosen = (explain or {}).get(worker)
        if chosen:
            span.set_attr("router.cost", chosen.get("cost"))
            span.set_attr("router.active_blocks", chosen.get("active_blocks"))
            span.set_attr("router.net_cost", chosen.get("net_cost"))
            span.set_attr("router.net_credit", chosen.get("net_credit"))
        if self.policy is not None:
            _, inputs = self.policy.score(worker)
            for key in ("ewma_ttft_s", "inflight", "queue_depth", "breaker"):
                span.set_attr(f"router.{key}", inputs.get(key))

    # -- routing -----------------------------------------------------------

    def _fleet_view(self, hashes: List[int],
                    overlaps: Dict[int, int]) -> Tuple[Dict[int, int], int]:
        """Merge the global index into the local overlap map.  Returns the
        merged per-candidate overlaps plus ``fleet_best`` — the longest
        leading run held by ANY worker fleet-wide (the onboarding source),
        which prices the scheduler's net credit."""
        if self.global_index is None:
            return overlaps, 0
        fleet = self.global_index.find_holders(hashes)
        if not fleet:
            return overlaps, 0
        live = set(self.client.instance_ids())
        merged = dict(overlaps)
        for w, n in fleet.items():
            if w in live and n > merged.get(w, 0):
                merged[w] = n
        return merged, max(fleet.values())

    def find_best_match(self, token_ids: List[int]) -> Tuple[int, int]:
        """(worker_id, overlap_blocks) for a prompt — the routing decision
        without routing (parity: ``query_instance_id`` annotation,
        ``kv_router.rs:331-337``)."""
        hashes = compute_block_hash_for_seq(token_ids, self.block_size)
        overlaps = self.indexer.find_matches(hashes)
        overlaps, fleet_best = self._fleet_view(hashes, overlaps)
        return self.scheduler.select(self.client.instance_ids(), overlaps,
                                     len(hashes), fleet_best=fleet_best)

    async def generate_stream(self, payload: Dict[str, Any],
                              instance_id: Optional[int] = None,
                              headers: Optional[Dict[str, Any]] = None
                              ) -> AsyncIterator[Any]:
        token_ids = payload.get("token_ids") or []
        rid = payload.get("request_id") or f"kv-{id(payload):x}"
        hashes = compute_block_hash_for_seq(token_ids, self.block_size)
        if instance_id is None:
            overlaps = self.indexer.find_matches(hashes)
            overlaps, fleet_best = self._fleet_view(hashes, overlaps)
            explain: Optional[Dict[int, Dict]] = (
                {} if self.policy is not None else None)
            worker, overlap = self.scheduler.select(
                self.client.instance_ids(), overlaps, len(hashes),
                explain=explain, fleet_best=fleet_best)
            if self.policy is not None:
                self.policy.budget.deposit()
                self.policy.stats.decisions["kv"] += 1
                self._export_decision(worker, overlap, len(hashes), explain,
                                      fleet_best=fleet_best)
        else:
            worker, overlap = instance_id, 0
        payload = dict(payload)
        payload["estimated_prefix_hit_num_blocks"] = overlap
        if isinstance(self.indexer, ApproxKvIndexer):
            self.indexer.record_routing(worker, hashes)
        self.scheduler.begin(rid, worker, len(hashes), overlap)
        self.drt.runtime.spawn(self.drt.publish_event(
            kv_hit_rate_subject(self._namespace, self._component),
            KVHitRateEvent(worker_id=worker, isl_blocks=len(hashes),
                           overlap_blocks=overlap).to_dict()),
            name="kv-hit-rate")
        generated: List[int] = []
        try:
            async for item in self.inner.generate_stream(
                    payload, instance_id=worker, headers=headers):
                ntok = len(item.get("token_ids") or []) if isinstance(item, dict) else 0
                if ntok:
                    self.scheduler.push(rid, ntok)
                    generated.extend(item["token_ids"])
                yield item
        finally:
            self.scheduler.free(rid)
            if isinstance(self.indexer, ApproxKvIndexer) and generated:
                # parity with the event-driven index: the worker's
                # allocator commits DECODE-generated blocks too, so the
                # approx view must observe the full prompt+output chain —
                # not just the prompt hashes recorded at routing time
                self.indexer.record_routing(
                    worker, compute_block_hash_for_seq(
                        list(token_ids) + generated, self.block_size))


__all__ = ["KvPushRouter", "kv_events_subject", "kv_hit_rate_subject"]
