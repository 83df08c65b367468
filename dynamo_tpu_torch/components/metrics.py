"""Standalone metrics component: worker-load plane -> Prometheus.

Parity: reference ``components/metrics/src/main.rs`` — poll a target
component's per-instance stats (our ``__stats__`` plane standing in for NATS
``$SRV.STATS``), aggregate ``ForwardPassMetrics``, subscribe to the router's
KV-hit-rate events, expose everything on an HTTP ``/metrics`` endpoint for
Prometheus/Grafana.

Run: ``python -m dynamo_tpu_torch.components.metrics --namespace ns --component tpu``
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Dict, Optional

from prometheus_client import CollectorRegistry, Counter, Gauge

from dynamo_tpu_torch.kv_router.router import kv_hit_rate_subject
from dynamo_tpu_torch.protocols.events import ForwardPassMetrics, KVHitRateEvent
from dynamo_tpu_torch.runtime.runtime import DEFAULT_COORDINATOR, DistributedRuntime
from dynamo_tpu_torch.runtime.system_server import SystemServer
from dynamo_tpu_torch.utils.aio import reap_task
from dynamo_tpu_torch.utils.logging import configure_logging

logger = logging.getLogger(__name__)


class MetricsAggregator:
    """Scrape + subscribe loops feeding a Prometheus registry."""

    def __init__(self, drt: DistributedRuntime, namespace: str,
                 component: str, endpoint: str = "generate",
                 interval_s: float = 2.0):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.endpoint = endpoint
        self.interval_s = interval_s
        self.registry = CollectorRegistry()
        ns = "dynamo_worker"
        labels = ["worker"]
        self.active_slots = Gauge(f"{ns}_request_active_slots", "",
                                  labels, registry=self.registry)
        self.total_slots = Gauge(f"{ns}_request_total_slots", "",
                                 labels, registry=self.registry)
        self.waiting = Gauge(f"{ns}_requests_waiting", "",
                             labels, registry=self.registry)
        self.kv_active = Gauge(f"{ns}_kv_active_blocks", "",
                               labels, registry=self.registry)
        self.kv_total = Gauge(f"{ns}_kv_total_blocks", "",
                              labels, registry=self.registry)
        self.cache_usage = Gauge(f"{ns}_cache_usage_ratio", "",
                                 labels, registry=self.registry)
        self.hit_rate = Gauge(f"{ns}_prefix_cache_hit_rate", "",
                              labels, registry=self.registry)
        # speculative decoding acceptance (cumulative per worker; gauges
        # SET to the scraped running totals — the source accumulates)
        self.spec_drafts = Gauge(f"{ns}_spec_drafts", "",
                                 labels, registry=self.registry)
        self.spec_draft_tokens = Gauge(f"{ns}_spec_draft_tokens", "",
                                       labels, registry=self.registry)
        self.spec_accepted_tokens = Gauge(
            f"{ns}_spec_accepted_tokens", "", labels,
            registry=self.registry)
        # MoE dispatch-backend overflow (token-expert assignments dropped)
        self.moe_dropped = Gauge(f"{ns}_moe_dropped_tokens", "",
                                 labels, registry=self.registry)
        self.router_isl_blocks = Counter(
            "dynamo_router_isl_blocks_total", "", registry=self.registry)
        self.router_overlap_blocks = Counter(
            "dynamo_router_overlap_blocks_total", "", registry=self.registry)
        self._scrape_task: Optional[asyncio.Task] = None
        self._event_task: Optional[asyncio.Task] = None
        self._event_sub = None

    async def start(self) -> "MetricsAggregator":
        self._event_sub = await self.drt.subscribe_events(
            kv_hit_rate_subject(self.namespace, self.component))
        self._event_task = asyncio.create_task(self._event_loop())
        self._scrape_task = asyncio.create_task(self._scrape_loop())
        return self

    async def stop(self) -> None:
        await reap_task(self._scrape_task)
        await reap_task(self._event_task)
        if self._event_sub is not None:
            try:
                await self._event_sub.cancel()
            except Exception:
                pass

    async def _event_loop(self) -> None:
        async for _subject, payload in self._event_sub:
            try:
                ev = KVHitRateEvent.from_dict(payload)
                self.router_isl_blocks.inc(ev.isl_blocks)
                self.router_overlap_blocks.inc(ev.overlap_blocks)
            except Exception:
                logger.exception("bad kv hit-rate event %r", payload)

    async def _scrape_loop(self) -> None:
        comp = self.drt.namespace(self.namespace).component(self.component)
        ep_path = f"{self.namespace}/{self.component}/{self.endpoint}"
        while True:
            try:
                scraped = await comp.scrape_stats()
                for iid, stats in scraped.items():
                    ep = stats.get(ep_path) if isinstance(stats, dict) else None
                    data = ep.get("data") if isinstance(ep, dict) else None
                    if not data:
                        continue
                    m = ForwardPassMetrics.from_dict(data)
                    w = f"{iid:x}"
                    self.active_slots.labels(w).set(
                        m.worker_stats.request_active_slots)
                    self.total_slots.labels(w).set(
                        m.worker_stats.request_total_slots)
                    self.waiting.labels(w).set(
                        m.worker_stats.num_requests_waiting)
                    self.kv_active.labels(w).set(m.kv_stats.kv_active_blocks)
                    self.kv_total.labels(w).set(m.kv_stats.kv_total_blocks)
                    self.cache_usage.labels(w).set(
                        m.kv_stats.gpu_cache_usage_perc)
                    self.hit_rate.labels(w).set(
                        m.kv_stats.gpu_prefix_cache_hit_rate)
                    if m.spec_decode_stats is not None:
                        sd = m.spec_decode_stats
                        self.spec_drafts.labels(w).set(sd.num_drafts)
                        self.spec_draft_tokens.labels(w).set(
                            sd.num_draft_tokens)
                        self.spec_accepted_tokens.labels(w).set(
                            sd.num_accepted_tokens)
                    self.moe_dropped.labels(w).set(
                        m.worker_stats.moe_dropped_tokens)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("stats scrape failed")
            await asyncio.sleep(self.interval_s)


async def amain(args: argparse.Namespace) -> None:
    drt = await DistributedRuntime.create(coordinator=args.coordinator)
    agg = await MetricsAggregator(
        drt, args.namespace, args.component, args.endpoint,
        interval_s=args.interval).start()
    server = await SystemServer(registry=agg.registry, host=args.host,
                                port=args.port).start()
    print(f"metrics component on {server.host}:{server.port}", flush=True)
    try:
        await drt.runtime.wait_shutdown()
    finally:
        await server.stop()
        await agg.stop()
        await drt.close()


def main() -> None:
    p = argparse.ArgumentParser(description="dynamo_tpu metrics component")
    p.add_argument("--coordinator", default=DEFAULT_COORDINATOR)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="tpu")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9091)
    configure_logging()
    try:
        asyncio.run(amain(p.parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
