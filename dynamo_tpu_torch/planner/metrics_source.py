"""Traffic observation for the planner.

Parity: reference ``planner/utils/prometheus.py`` — the reference planner
scrapes a Prometheus server; here the frontend's ``/metrics`` endpoint is
scraped directly and interval deltas of the counters become the
``TrafficSample`` (request rate, mean isl/osl); ttft/itl come from the
histogram sums/counts.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import aiohttp
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu_torch.planner.planner_core import TrafficSample

logger = logging.getLogger(__name__)

_NS = "dynamo_frontend"


def _collect(text: str) -> Dict[str, float]:
    """Sum interesting series across label sets."""
    want = {
        f"{_NS}_requests": "requests",          # counter family name
        f"{_NS}_input_tokens": "input_tokens",
        f"{_NS}_output_tokens": "output_tokens",
        f"{_NS}_time_to_first_token_seconds": "ttft",
        f"{_NS}_inter_token_latency_seconds": "itl",
    }
    out: Dict[str, float] = {}
    for fam in text_string_to_metric_families(text):
        key = want.get(fam.name)
        if key is None:
            continue
        for s in fam.samples:
            if s.name.endswith("_total"):
                out[key] = out.get(key, 0.0) + s.value
            elif s.name.endswith("_sum"):
                out[f"{key}_sum"] = out.get(f"{key}_sum", 0.0) + s.value
            elif s.name.endswith("_count"):
                out[f"{key}_count"] = out.get(f"{key}_count", 0.0) + s.value
    return out


class PrometheusSource:
    """Scrapes a frontend /metrics URL; sample() returns interval deltas."""

    def __init__(self, url: str):
        self.url = url
        self._last: Optional[Tuple[float, Dict[str, float]]] = None

    async def _fetch(self) -> Optional[Dict[str, float]]:
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(self.url) as resp:
                    return _collect(await resp.text())
        except aiohttp.ClientError as e:
            logger.warning("metrics scrape failed: %s", e)
            return None

    async def sample(self) -> Optional[TrafficSample]:
        cur = await self._fetch()
        now = time.monotonic()
        if cur is None:
            return None
        prev = self._last
        self._last = (now, cur)
        if prev is None:
            return None  # need two scrapes for a delta
        dt = max(1e-6, now - prev[0])
        pv = prev[1]

        def delta(key: str) -> float:
            return max(0.0, cur.get(key, 0.0) - pv.get(key, 0.0))

        nreq = delta("requests")
        if nreq <= 0:
            return TrafficSample(request_rate=0.0, avg_isl=0.0, avg_osl=0.0)
        ttft_n = delta("ttft_count")
        itl_n = delta("itl_count")
        return TrafficSample(
            request_rate=nreq / dt,
            avg_isl=delta("input_tokens") / nreq,
            avg_osl=delta("output_tokens") / nreq,
            observed_ttft_s=(delta("ttft_sum") / ttft_n) if ttft_n else None,
            observed_itl_s=(delta("itl_sum") / itl_n) if itl_n else None,
        )


class QueueAwareSource:
    """Wraps a MetricsSource, adding the coordinator prefill-queue depth
    (the planner's direct backlog signal — reference: JetStream consumer
    lag on the prefill queue)."""

    def __init__(self, inner, drt, namespace: str):
        self.inner = inner
        self.drt = drt
        self.namespace = namespace

    async def sample(self) -> Optional[TrafficSample]:
        s = await self.inner.sample()
        if s is None:
            return None
        try:
            from dynamo_tpu_torch.worker.disagg import prefill_queue_name
            depth, _pullers = await self.drt.coord.queue_depth(
                prefill_queue_name(self.namespace))
            s.prefill_queue_depth = depth
        except Exception as e:  # noqa: BLE001 — depth is best-effort
            logger.debug("queue depth probe failed: %s", e)
        return s


__all__ = ["PrometheusSource", "QueueAwareSource"]
