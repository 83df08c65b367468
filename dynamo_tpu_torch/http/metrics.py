"""Per-request Prometheus metrics for the HTTP frontend.

Parity: reference ``lib/llm/src/http/service/metrics.rs`` (~500 LoC): request
counters by model/endpoint/status, TTFT and inter-token-latency histograms,
inflight gauge, request duration.
"""

from __future__ import annotations

import time
from typing import Optional

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

_TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0, 30.0)
_ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0)
_DUR_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                300.0)
# stage spans range from sub-ms tokenize to multi-second prefill/decode
_STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class StageMetrics:
    """``dynamo_tpu_stage_duration_seconds{stage}`` — per-stage request
    latency breakdown (queue|prefill|kv_transfer|decode|tokenize|detokenize),
    fed from locally-finished trace spans (``utils/tracing``).  Registered on
    BOTH the frontend registry and the worker system-server registry under
    the same name, so dashboards join one series across roles; each process
    observes only the spans it produced (adopted remote spans don't re-fire),
    so nothing double-counts."""

    def __init__(self, registry: Optional[CollectorRegistry] = None):
        self.duration = Histogram(
            "dynamo_tpu_stage_duration_seconds",
            "Per-stage request latency breakdown (trace-span stages)",
            ["stage"], buckets=_STAGE_BUCKETS, registry=registry)
        self._attached: set = set()

    def attach(self, tracer) -> None:
        """Observe this tracer's stage spans (idempotent per tracer)."""
        if id(tracer) in self._attached:
            return
        self._attached.add(id(tracer))
        tracer.add_listener(self._on_span)

    def detach(self, tracer) -> None:
        self._attached.discard(id(tracer))
        tracer.remove_listener(self._on_span)

    def _on_span(self, span) -> None:
        from dynamo_tpu_torch.utils.tracing import STAGES
        if span.name in STAGES:
            self.duration.labels(span.name).observe(span.duration_s)


class FrontendMetrics:
    def __init__(self, registry: Optional[CollectorRegistry] = None,
                 slo_ttft_s: float = 0.0, slo_itl_s: float = 0.0):
        self.registry = registry or CollectorRegistry()
        # SLO targets for goodput accounting (0.0 = target disabled).
        # Judged per request at completion: TTFT against slo_ttft_s, the
        # request's WORST per-token gap against slo_itl_s.
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_itl_s = float(slo_itl_s)
        ns = "dynamo_frontend"
        self.requests_total = Counter(
            f"{ns}_requests_total", "HTTP requests",
            ["model", "endpoint", "status"], registry=self.registry)
        self.inflight = Gauge(
            f"{ns}_inflight_requests", "Concurrent requests",
            ["model"], registry=self.registry)
        self.ttft = Histogram(
            f"{ns}_time_to_first_token_seconds", "TTFT",
            ["model"], buckets=_TTFT_BUCKETS, registry=self.registry)
        self.itl = Histogram(
            f"{ns}_inter_token_latency_seconds", "ITL",
            ["model"], buckets=_ITL_BUCKETS, registry=self.registry)
        self.duration = Histogram(
            f"{ns}_request_duration_seconds", "Request duration",
            ["model", "endpoint"], buckets=_DUR_BUCKETS, registry=self.registry)
        self.input_tokens = Counter(
            f"{ns}_input_tokens_total", "Prompt tokens",
            ["model"], registry=self.registry)
        self.output_tokens = Counter(
            f"{ns}_output_tokens_total", "Generated tokens",
            ["model"], registry=self.registry)
        self.shed_total = Counter(
            f"{ns}_requests_shed_total",
            "Requests shed at admission (503) by overload protection",
            ["model", "endpoint", "reason"], registry=self.registry)
        # -- SLO / goodput ----------------------------------------------
        self.slo_total = Counter(
            f"{ns}_slo_total",
            "Per-request SLO judgments by target (ttft, itl) and outcome: "
            "'met'/'violated' judged at completion (itl against the "
            "request's WORST per-token gap), 'shed' counted at admission "
            "refusal — a shed request is an SLO miss the backlog never "
            "sees. Zero unless --slo-ttft-s/--slo-itl-s enable the target.",
            ["target", "outcome"], registry=self.registry)
        self.goodput_tokens = Counter(
            f"{ns}_goodput_tokens_total",
            "Generated tokens from requests that met EVERY enabled SLO "
            "target — goodput vs. raw dynamo_frontend_output_tokens_total "
            "throughput. Zero while no SLO target is configured.",
            ["model"], registry=self.registry)
        for target in ("ttft", "itl"):
            for outcome in ("met", "violated", "shed"):
                self.slo_total.labels(target, outcome)
        # per-stage latency breakdown from trace spans; HttpService attaches
        # the process tracer at start and detaches at stop
        self.stage = StageMetrics(self.registry)
        # failure-aware routing counters/gauges, sampled from the process-
        # wide RouterStats book at scrape time (routers live in ModelWatcher,
        # outside this registry's reach)
        self.router = RouterMetricsCollector(self.registry)

    def attach_coord(self, coord) -> "CoordClientMetrics":
        """Expose the process's coordinator-connection health next to the
        request metrics (``dynamo_coord_*`` series on the same /metrics)."""
        return CoordClientMetrics(coord, registry=self.registry)

    def record_slo_shed(self) -> None:
        """Count an admission-shed request against every enabled SLO
        target: the client saw a 503 instead of tokens, which is an SLO
        miss regardless of how fast the backlog would have drained."""
        if self.slo_ttft_s > 0:
            self.slo_total.labels("ttft", "shed").inc()
        if self.slo_itl_s > 0:
            self.slo_total.labels("itl", "shed").inc()

    def render(self) -> bytes:
        return generate_latest(self.registry)


class CoordClientMetrics:
    """Custom collector sampling a ``CoordClient``'s supervision state.

    Series: ``dynamo_coord_connected`` (gauge, 1 while the control-plane
    connection is up and resynced), ``dynamo_coord_reconnects_total`` /
    ``dynamo_coord_resyncs_total`` (counters), and
    ``dynamo_coord_last_outage_seconds`` (gauge, duration of the most recent
    survived outage). Sampled at scrape time — no wiring inside the client."""

    def __init__(self, coord, registry: Optional[CollectorRegistry] = None):
        self.coord = coord
        if registry is not None:
            registry.register(self)

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )
        yield GaugeMetricFamily(
            "dynamo_coord_connected",
            "1 while the coordinator connection is up and resynced",
            value=1.0 if self.coord.connected else 0.0)
        rec = CounterMetricFamily(
            "dynamo_coord_reconnects",
            "Coordinator connections re-established after an outage")
        rec.add_metric([], float(self.coord.reconnects_total))
        yield rec
        res = CounterMetricFamily(
            "dynamo_coord_resyncs",
            "State resync attempts after a reconnect (exceeds "
            "dynamo_coord_reconnects_total when resyncs are retried)")
        res.add_metric([], float(self.coord.resyncs_total))
        yield res
        yield GaugeMetricFamily(
            "dynamo_coord_last_outage_seconds",
            "Duration of the most recent survived coordinator outage",
            value=float(self.coord.last_outage_s))


class CoordinatorMetrics:
    """Custom collector sampling a server-side ``Coordinator`` (the
    replicated control-plane process itself, not a client of it).

    Series: ``dynamo_coord_role`` (1 acting primary / 0 standby /
    -1 deposed), ``dynamo_coord_failovers_total`` (promotions this process
    performed), ``dynamo_coord_replication_lag_ops`` (log entries queued to
    the slowest attached standby; 0 = caught up or none attached),
    ``dynamo_coord_standbys_attached`` and
    ``dynamo_coord_prefix_index_entries`` (live worker snapshots in the
    fleet KV prefix index).  Exposed by the standalone coordinator's
    system server (``DYN_SYSTEM_ENABLED=1``)."""

    _ROLES = {"primary": 1.0, "standby": 0.0, "deposed": -1.0}

    def __init__(self, coordinator, registry: Optional[CollectorRegistry] = None):
        self.coordinator = coordinator
        if registry is not None:
            registry.register(self)

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )
        c = self.coordinator
        yield GaugeMetricFamily(
            "dynamo_coord_role",
            "Replication role: 1 acting primary, 0 standby, -1 deposed",
            value=self._ROLES.get(c.role, -1.0))
        fo = CounterMetricFamily(
            "dynamo_coord_failovers",
            "Promotions to primary performed by this coordinator process")
        fo.add_metric([], float(c.failovers_total))
        yield fo
        yield GaugeMetricFamily(
            "dynamo_coord_replication_lag_ops",
            "Replication-log entries queued to the slowest attached "
            "standby (0 = fully caught up or no standby)",
            value=float(c.replication_lag_ops))
        yield GaugeMetricFamily(
            "dynamo_coord_standbys_attached",
            "Hot standbys currently attached to this coordinator",
            value=float(c.standbys_attached))
        yield GaugeMetricFamily(
            "dynamo_coord_prefix_index_entries",
            "Live worker holder-snapshots in the fleet-wide KV prefix "
            "index (kvstore/prefix_index/ entries whose TTL envelope has "
            "not expired; each is one worker's published block-hash set)",
            value=float(getattr(c, "prefix_index_entries", 0)))


class RouterMetricsCollector:
    """Custom collector over the process-wide failure-aware-routing book
    (``runtime/resilience.get_router_stats``).

    Series: ``dynamo_frontend_router_decisions_total{policy}``,
    ``dynamo_frontend_router_retries_total{reason}``,
    ``dynamo_frontend_router_hedges_total{outcome}``,
    ``dynamo_frontend_router_breaker_transitions_total{state}``,
    ``dynamo_frontend_router_breaker_state{instance}`` (0 closed /
    0.5 half-open / 1 open), ``dynamo_frontend_router_retry_budget_balance``,
    ``dynamo_frontend_router_retry_budget_exhausted_total``, and the
    NetKV pricing family: ``dynamo_frontend_router_net_priced_total``
    {outcome}, ``dynamo_frontend_router_net_cost_seconds_total`` and
    ``dynamo_frontend_router_net_priced_decisions_total``."""

    def __init__(self, registry: Optional[CollectorRegistry] = None):
        if registry is not None:
            registry.register(self)

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )
        from dynamo_tpu_torch.runtime.resilience import get_router_stats
        s = get_router_stats()
        dec = CounterMetricFamily(
            "dynamo_frontend_router_decisions",
            "Routing decisions by policy", labels=["policy"])
        for policy, n in s.decisions.items():
            dec.add_metric([policy], float(n))
        yield dec
        ret = CounterMetricFamily(
            "dynamo_frontend_router_retries",
            "Re-dispatches (failover retries) by reason; 'denied' counts "
            "retries refused by the budget", labels=["reason"])
        for reason, n in s.retries.items():
            ret.add_metric([reason], float(n))
        yield ret
        hed = CounterMetricFamily(
            "dynamo_frontend_router_hedges",
            "Hedged dispatches by outcome "
            "(fired|won|lost|denied|expired)", labels=["outcome"])
        for outcome, n in s.hedges.items():
            hed.add_metric([outcome], float(n))
        yield hed
        tr = CounterMetricFamily(
            "dynamo_frontend_router_breaker_transitions",
            "Circuit-breaker state transitions by entered state",
            labels=["state"])
        for state, n in s.breaker_transitions.items():
            tr.add_metric([state], float(n))
        yield tr
        st = GaugeMetricFamily(
            "dynamo_frontend_router_breaker_state",
            "Per-instance breaker state: 0 closed, 0.5 half-open, 1 open",
            labels=["instance"])
        for iid, v in s.breaker_states.items():
            st.add_metric([iid], v)
        yield st
        yield GaugeMetricFamily(
            "dynamo_frontend_router_retry_budget_balance",
            "Retry-budget tokens currently available",
            value=float(s.budget_balance))
        ex = CounterMetricFamily(
            "dynamo_frontend_router_retry_budget_exhausted",
            "Retry/hedge attempts refused because the budget was empty")
        ex.add_metric([], float(s.budget_exhausted))
        yield ex
        np_ = CounterMetricFamily(
            "dynamo_frontend_router_net_priced",
            "KV routing decisions where a fleet-held prefix was priced "
            "against the measured kv_transfer bandwidth, by outcome: "
            "'credit' (transfer beats recompute), 'no_credit' (recompute "
            "wins), 'no_path' (no bandwidth ever measured)",
            labels=["outcome"])
        for outcome in ("credit", "no_credit", "no_path"):
            np_.add_metric([outcome], float(s.net_priced.get(outcome, 0)))
        yield np_
        nc = CounterMetricFamily(
            "dynamo_frontend_router_net_cost_seconds",
            "Estimated KV-transfer seconds behind net-priced decisions "
            "(est_transfer_bytes / plane bandwidth EWMA); _count is the "
            "decisions priced")
        nc.add_metric([], float(s.net_cost_seconds_sum))
        yield nc
        ncc = CounterMetricFamily(
            "dynamo_frontend_router_net_priced_decisions",
            "Net-priced decisions counted into "
            "dynamo_frontend_router_net_cost_seconds")
        ncc.add_metric([], float(s.net_cost_seconds_count))
        yield ncc


class RequestTimer:
    """Tracks one request's TTFT/ITL/duration and reports on completion."""

    def __init__(self, metrics: FrontendMetrics, model: str, endpoint: str):
        self.m = metrics
        self.model = model
        self.endpoint = endpoint
        self.start = time.perf_counter()
        self.last_token: Optional[float] = None
        self.first_token: Optional[float] = None
        self._done = False
        self._ntokens = 0
        self._itl_max_s: Optional[float] = None
        self.m.inflight.labels(model).inc()

    def on_token(self, n: int = 1) -> None:
        if n <= 0:
            return  # role-only / finish-only chunks don't define TTFT
        now = time.perf_counter()
        if self.first_token is None:
            self.first_token = now
            self.m.ttft.labels(self.model).observe(now - self.start)
        elif self.last_token is not None and n:
            itl = (now - self.last_token) / n
            self.m.itl.labels(self.model).observe(itl)
            if self._itl_max_s is None or itl > self._itl_max_s:
                self._itl_max_s = itl
        self.last_token = now
        if n:
            self._ntokens += n
            self.m.output_tokens.labels(self.model).inc(n)

    def done(self, status: str, prompt_tokens: int = 0) -> None:
        if self._done:  # idempotent: unwind paths may overlap
            return
        self._done = True
        self.m.inflight.labels(self.model).dec()
        self.m.requests_total.labels(self.model, self.endpoint, status).inc()
        self.m.duration.labels(self.model, self.endpoint).observe(
            time.perf_counter() - self.start)
        if prompt_tokens:
            self.m.input_tokens.labels(self.model).inc(prompt_tokens)
        # SLO judgment + goodput: only requests that produced tokens are
        # judged (an errored stream with no first token has nothing to
        # measure and contributes zero goodput either way)
        slo_ok = True
        judged = False
        if self.m.slo_ttft_s > 0 and self.first_token is not None:
            met = (self.first_token - self.start) <= self.m.slo_ttft_s
            self.m.slo_total.labels(
                "ttft", "met" if met else "violated").inc()
            slo_ok = slo_ok and met
            judged = True
        if self.m.slo_itl_s > 0 and self._itl_max_s is not None:
            met = self._itl_max_s <= self.m.slo_itl_s
            self.m.slo_total.labels(
                "itl", "met" if met else "violated").inc()
            slo_ok = slo_ok and met
            judged = True
        if judged and slo_ok and self._ntokens:
            self.m.goodput_tokens.labels(self.model).inc(self._ntokens)


__all__ = ["FrontendMetrics", "CoordClientMetrics", "CoordinatorMetrics",
           "RequestTimer", "RouterMetricsCollector", "StageMetrics"]
