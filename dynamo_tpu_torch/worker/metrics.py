"""Worker-side Prometheus metrics, served on the worker's system server.

Until now admission/migration/disagg signals existed only as frontend
metrics (``http/metrics.py``); a worker's own ``/metrics``
(``DYN_SYSTEM_ENABLED=1``, ``runtime/system_server.py``) showed nothing about
the requests it actually absorbed.  This registry closes that gap:

- ``dynamo_worker_requests_total{outcome}`` — requests by admission outcome:
  ``admitted``, ``refused_expired`` (deadline already passed on arrival),
  ``deadline_cancelled`` (expired mid-generation), ``error``.
- ``dynamo_worker_migration_replays_total{mode}`` — migrated streams this
  worker ABSORBED (requests re-issued by a frontend after another worker
  dropped or drained the stream; stamped via
  ``PreprocessedRequest.migration_attempt``): ``resume`` rode a pinned-KV
  resume token, ``replay`` recomputed from scratch.
- ``dynamo_worker_drain_state`` / ``dynamo_worker_migrated_sequences_total``
  — the graceful-drain lifecycle (``worker/drain.py``): drain progress and
  how many in-flight sequences were handed off resumable vs replayed.
- ``dynamo_worker_disagg_kv_bytes_total{direction,plane}`` — disagg KV block
  bytes moved, by direction (``pulled``) and transport plane
  (``direct``/``bulk``/``rpc``) — the FlowKV-dominant cost made visible.
- ``dynamo_tpu_stage_duration_seconds{stage}`` — per-stage latency breakdown
  (queue/prefill/kv_transfer/decode/...), observed from locally-finished
  trace spans (``http/metrics.StageMetrics`` listener), the same series the
  frontend registers so dashboards join on one name.

A process-wide singleton (``get_worker_metrics``) because the handler
factories (``llm/register.engine_handler``) and the disagg handlers have no
shared construction point; the worker main passes its registry to the
system server.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from prometheus_client import CollectorRegistry, Counter, Gauge
from prometheus_client.core import (CounterMetricFamily, GaugeMetricFamily,
                                    HistogramMetricFamily)

from dynamo_tpu_torch.http.metrics import StageMetrics


class KvbmStatsCollector:
    """Scrape-time collector mapping ``TieredEngine.kvbm_stats()`` onto
    ``dynamo_worker_kvbm_*`` gauges/counters.

    Registered UNCONDITIONALLY (zero-valued until a tiered engine is
    attached via :meth:`attach`) so the metrics<->docs drift gate
    (``tools/check_metrics_docs.py``) always sees the full surface, and a
    worker without tiers still exposes a stable schema."""

    # kvbm_stats key -> help text; metric name = "dynamo_worker_" + key
    GAUGES: Dict[str, str] = {
        "kvbm_host_blocks": "KV blocks resident in the G2 host-RAM tier",
        "kvbm_host_bytes": "Bytes used by the G2 host-RAM tier",
        "kvbm_disk_blocks": "KV blocks resident in the G3 disk tier",
        "kvbm_disk_bytes": "Bytes used by the G3 disk tier",
        "kvbm_pending_spills": "Eviction batches waiting in the bounded "
                               "background spill queue",
        "kvbm_prefetch_pinned_pages": "Pages currently pinned by prefetch "
                                      "promotion leases (released when the "
                                      "request commits or aborts)",
        "kvbm_prefetch_inflight": "Requests with a live lookahead "
                                  "promotion task",
    }
    COUNTERS: Dict[str, str] = {
        "kvbm_offloaded_blocks": "Blocks offloaded G1->G2 on eviction",
        "kvbm_onboarded_blocks": "Tier blocks injected back into HBM "
                                 "(synchronous fast path + prefetch)",
        "kvbm_dropped_spills": "Spill batches dropped because the bounded "
                               "queue was full (tiers are best-effort)",
        "kvbm_peer_onboarded_blocks": "Blocks onboarded from the G4 peer "
                                      "tier on a local tier miss",
        "kvbm_disk_corrupt_dropped": "Disk-tier entries rejected by length/"
                                     "crc32 verification on read (treated "
                                     "as a miss, evicted — never injected)",
        "kvbm_prefetch_hits": "Blocks the prefetch scheduler promoted "
                              "ahead of the prefill cursor",
        "kvbm_prefetch_late": "Prefetch promotions that lost the race (the "
                              "block was already resident, or no pages "
                              "were free for it)",
        "kvbm_prefetch_misses": "Planned blocks that fell out of every "
                                "tier before promotion reached them",
        "kvbm_prefetch_evicted_pinned": "Canary: pinned prefetched blocks "
                                        "missing from HBM at release time "
                                        "(must stay 0)",
        "kvbm_prefetch_bytes": "Bytes of KV promoted by the prefetch "
                               "scheduler",
        "kvbm_prefetch_adopted_blocks": "Blocks adopted mid-prefill from "
                                        "the prefix cache instead of "
                                        "recomputed",
    }

    def __init__(self, registry: CollectorRegistry):
        self._source: Optional[Callable[[], Dict[str, float]]] = None
        registry.register(self)

    def attach(self, source: Callable[[], Dict[str, float]]) -> None:
        """Point the collector at a live ``kvbm_stats`` provider."""
        self._source = source

    def collect(self):
        stats: Dict[str, float] = {}
        if self._source is not None:
            try:
                stats = self._source() or {}
            except Exception:  # noqa: BLE001 — a scrape must never fail
                import logging
                logging.getLogger(__name__).debug(
                    "kvbm stats sample failed", exc_info=True)
        for key, help_text in self.GAUGES.items():
            yield GaugeMetricFamily(f"dynamo_worker_{key}", help_text,
                                    value=float(stats.get(key, 0)))
        for key, help_text in self.COUNTERS.items():
            yield CounterMetricFamily(f"dynamo_worker_{key}", help_text,
                                      value=float(stats.get(key, 0)))


class EngineDispatchCollector:
    """Scrape-time collector mapping the engine's dispatch taps onto
    ``dynamo_worker_decode_*`` counters (the scatter-tap style:
    counts of jitted dispatches, not timing walls).

    Registered UNCONDITIONALLY (zero-valued until an engine is attached)
    so the metrics<->docs drift gate always sees the schema."""

    COUNTERS: Dict[str, str] = {
        "decode_dispatches": "Decode-family jitted dispatches (per-step, "
                             "chained, spec-verify, mixed, and fused "
                             "multi-step blocks each count ONE) — with "
                             "fusion on, M decoded tokens cost ~M/width "
                             "dispatches",
        "decode_multistep_blocks": "Fused multi-step decode blocks "
                                   "dispatched (DYN_DECODE_MULTISTEP steps "
                                   "per block before scheduler narrowing)",
        "mixed_dispatches": "Mixed prefill+decode dispatches (prefill "
                            "chunks and decode rows advanced in ONE "
                            "ragged [B, S] step, DYN_MIXED_BATCH)",
        "guided_parity_mismatches": "Guided rows whose host-side automaton "
                                    "re-walk disagreed with the device "
                                    "transition table after a fused block "
                                    "(logged once per row; any nonzero "
                                    "value is a device/host lowering bug)",
    }

    # the known fallback reasons, pre-seeded so every label shows on the
    # scrape at 0 and dashboards/alerts can reference them before the
    # first refusal happens. "mesh" is GONE on purpose: sharded engines
    # run the fused block program (explicit in/out shardings) — a mesh
    # engine reporting fallbacks again would be a regression, and the
    # parity suite asserts the counter stays 0 there. "penalties" and
    # "guided" now only fire when the device path is unavailable
    # (penalty_window=0 / no grammar lowering); "penalty_window" counts
    # rows whose distinct-token set outgrew the configured ring buffer,
    # "guided_table" grammars whose transition table exceeded the byte
    # cap (JaxEngineConfig.guided_table_bytes) — both per-batch, not
    # per-deployment.
    FALLBACK_REASONS = ("waiters", "prefill", "penalties",
                        "penalty_window", "guided", "guided_table",
                        "spec", "budget", "pages", "multihost")

    def __init__(self, registry: CollectorRegistry):
        self._source: Optional[Callable[[], Dict[str, float]]] = None
        registry.register(self)

    def attach(self, source: Callable[[], Dict[str, float]]) -> None:
        """Point the collector at a live engine's dispatch counters."""
        self._source = source

    def collect(self):
        stats: Dict[str, float] = {}
        if self._source is not None:
            try:
                stats = self._source() or {}
            except Exception:  # noqa: BLE001 — a scrape must never fail
                import logging
                logging.getLogger(__name__).debug(
                    "engine dispatch sample failed", exc_info=True)
        for key, help_text in self.COUNTERS.items():
            yield CounterMetricFamily(f"dynamo_worker_{key}", help_text,
                                      value=float(stats.get(key, 0)))
        # why the fused multi-step path was refused, by reason — the
        # ROADMAP "fallback-reason near zero" criterion, measurable
        fb = CounterMetricFamily(
            "dynamo_worker_multistep_fallback",
            "Fused multi-step decode refusals by reason (waiters/prefill "
            "only with DYN_MIXED_BATCH=0; penalties/guided/spec/budget/"
            "pages from the block planner; multihost from the engine "
            "mode — mesh-sharded engines fuse and never fall back)",
            labels=["reason"])
        reasons = dict.fromkeys(self.FALLBACK_REASONS, 0.0)
        reasons.update(stats.get("multistep_fallbacks") or {})
        for reason, value in sorted(reasons.items()):
            fb.add_metric([str(reason)], float(value))
        yield fb


class StepTraceCollector:
    """Scrape-time collector rendering the engine step flight recorder's
    inline aggregates (``engine/steptrace.StepRecorder.aggregates()``) as
    the fleet accounting layer: per-kind step duration / batch-occupancy
    histograms, the step-gap histogram (host overhead between
    dispatches), page-pool pressure gauges, and compile-event counters.

    Registered UNCONDITIONALLY (zero-valued until a recorder is attached)
    so the metrics<->docs drift gate always sees the schema. The recorder
    does the bucketing inline on the hot path; this collector only
    re-renders plain dicts at scrape time — a scrape never touches the
    step loop."""

    # the dispatch families the loop stamps; pre-seeded so dashboards can
    # reference every kind before the first dispatch of that kind runs
    KINDS = ("prefill", "decode", "chained", "multistep", "mixed", "spec",
             "gather")

    def __init__(self, registry: CollectorRegistry):
        self._source = None
        registry.register(self)

    def attach(self, source) -> None:
        """Point the collector at a live recorder's ``aggregates``."""
        self._source = source

    @staticmethod
    def _zero_hist(bounds) -> list:
        return [(str(b), 0) for b in bounds] + [("+Inf", 0)]

    def collect(self):
        agg: Dict[str, object] = {}
        if self._source is not None:
            try:
                agg = self._source() or {}
            except Exception:  # noqa: BLE001 — a scrape must never fail
                import logging
                logging.getLogger(__name__).debug(
                    "steptrace aggregate sample failed", exc_info=True)
        from dynamo_tpu_torch.engine.steptrace import (_DUR_BOUNDS, _GAP_BOUNDS,
                                                 _OCC_BOUNDS)
        dur = HistogramMetricFamily(
            "dynamo_worker_step_duration_seconds",
            "Engine dispatch wall time by kind (prefill/decode/chained/"
            "multistep/mixed/spec/gather) — the host-side dispatch call, "
            "which includes compile time on a fresh jit bucket",
            labels=["kind"])
        occ = HistogramMetricFamily(
            "dynamo_worker_step_occupancy",
            "Batch occupancy per dispatch: real tokens / padded tokens "
            "(bucket-padding waste is 1 - occupancy), by kind",
            labels=["kind"])
        durs = dict(agg.get("duration") or {})
        occs = dict(agg.get("occupancy") or {})
        for kind in sorted(set(self.KINDS) | set(durs) | set(occs)):
            b, s, _n = durs.get(kind) or (self._zero_hist(_DUR_BOUNDS),
                                          0.0, 0)
            dur.add_metric([kind], buckets=b, sum_value=s)
            b, s, _n = occs.get(kind) or (self._zero_hist(_OCC_BOUNDS),
                                          0.0, 0)
            occ.add_metric([kind], buckets=b, sum_value=s)
        yield dur
        yield occ
        gap = HistogramMetricFamily(
            "dynamo_worker_step_gap_seconds",
            "Host time between the end of one dispatch and the start of "
            "the next while work was available (scheduler planning, token "
            "processing, exclusive-window stalls — idle waits excluded)")
        gb, gs, _gn = (agg.get("gap")
                       or (self._zero_hist(_GAP_BOUNDS), 0.0, 0))
        gap.add_metric([], buckets=gb, sum_value=gs)
        yield gap
        yield GaugeMetricFamily(
            "dynamo_worker_page_pool_free_pages",
            "Free KV pages at the most recent dispatch's plan time",
            value=float(agg.get("pool_free", 0)))
        yield GaugeMetricFamily(
            "dynamo_worker_page_pool_pinned_pages",
            "KV pages pinned under export leases at the most recent "
            "dispatch's plan time",
            value=float(agg.get("pool_pinned", 0)))
        ev = CounterMetricFamily(
            "dynamo_worker_compile_events",
            "XLA compiles detected mid-run (first call on a fresh "
            "(kind, batch, seq) jit bucket), by dispatch kind",
            labels=["kind"])
        secs = CounterMetricFamily(
            "dynamo_worker_compile_seconds",
            "Wall seconds spent in mid-run XLA compiles, by dispatch kind",
            labels=["kind"])
        cev = dict(agg.get("compile_events") or {})
        csec = dict(agg.get("compile_seconds") or {})
        for kind in sorted(set(self.KINDS) | set(cev) | set(csec)):
            ev.add_metric([kind], float(cev.get(kind, 0)))
            secs.add_metric([kind], float(csec.get(kind, 0.0)))
        yield ev
        yield secs


def engine_dispatch_stats(engine) -> Dict[str, object]:
    """The ``EngineDispatchCollector.attach`` source for a
    ``ScheduledEngineBase`` engine (JaxEngine and the mocker both carry
    the counters). Values are floats, except ``multistep_fallbacks``:
    a per-reason count dict the collector renders as a labeled family."""
    sched = getattr(engine, "scheduler", None)
    return {
        "decode_dispatches": float(getattr(engine, "decode_dispatches", 0)),
        "decode_multistep_blocks": float(
            getattr(engine, "multistep_blocks", 0)),
        "mixed_dispatches": float(getattr(engine, "mixed_steps", 0)),
        "guided_parity_mismatches": float(
            getattr(engine, "guided_parity_mismatches", 0)),
        "multistep_fallbacks": dict(
            getattr(sched, "multistep_fallbacks", None) or {}),
    }


class WorkerMetrics:
    def __init__(self, registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = "dynamo_worker"
        self.requests_total = Counter(
            f"{ns}_requests_total",
            "Requests by admission outcome (admitted, refused_expired, "
            "deadline_cancelled, error)",
            ["outcome"], registry=self.registry)
        self.migration_replays = Counter(
            f"{ns}_migration_replays_total",
            "Migrated streams absorbed (re-issued by a frontend after "
            "another worker dropped or drained them), by mode: 'resume' "
            "carries a pinned-KV resume token (no recomputed prefill), "
            "'replay' recomputes from scratch",
            ["mode"], registry=self.registry)
        # -- graceful drain ---------------------------------------------
        self.drain_state = Gauge(
            f"{ns}_drain_state",
            "Worker lifecycle state: 0 serving, 1 draining (in-flight "
            "streams being frozen/handed off), 2 drained (migration "
            "complete or timed out; about to exit)",
            registry=self.registry)
        self.migrated_sequences = Counter(
            f"{ns}_migrated_sequences_total",
            "In-flight sequences this worker handed off during a graceful "
            "drain, by outcome: 'ok' shipped a pinned-KV resume token, "
            "'fallback' shipped a replay marker (nothing committed yet, "
            "or the engine cannot export KV)",
            ["outcome"], registry=self.registry)
        # pre-seed the label sets so every mode/outcome shows on the
        # scrape at 0 (dashboards/alerts can reference them before the
        # first drain happens)
        for mode in ("replay", "resume"):
            self.migration_replays.labels(mode)
        for outcome in ("ok", "fallback"):
            self.migrated_sequences.labels(outcome)
        self.disagg_kv_bytes = Counter(
            f"{ns}_disagg_kv_bytes_total",
            "Disaggregated-prefill KV block bytes transferred, by direction "
            "and transport plane (direct/bulk/rpc)",
            ["direction", "plane"], registry=self.registry)
        # -- data-plane fault tolerance ---------------------------------
        self.kv_exports_active = Gauge(
            f"{ns}_kv_exports_active",
            "KV export leases currently pinning pages for a pending pull "
            "(returns to 0 once pullers ack or the TTL GC reclaims)",
            registry=self.registry)
        self.kv_exports_reclaimed = Counter(
            f"{ns}_kv_exports_reclaimed_total",
            "Export leases reclaimed by the TTL GC sweep (the puller "
            "crashed or never acked — orphaned KV bounded, not leaked)",
            registry=self.registry)
        self.prefill_jobs = Counter(
            f"{ns}_prefill_jobs_total",
            "Prefill queue jobs by outcome (ok, failed, stale — dropped "
            "because the job outlived the decode side's reply timeout)",
            ["outcome"], registry=self.registry)
        self.kv_offer_acks = Counter(
            f"{ns}_kv_offer_acks_total",
            "Device-direct offer acks by outcome (ok, failed — a failed "
            "ack leaves the peer's pinned HBM to its offer TTL)",
            ["outcome"], registry=self.registry)
        self.kv_frames_corrupt = Counter(
            f"{ns}_kv_frames_corrupt_total",
            "Wire-v4 KV frames rejected by checksum verification before "
            "staging (corrupted/truncated in transit; never injected)",
            registry=self.registry)
        self.kv_pull_resumes = Counter(
            f"{ns}_kv_pull_resumes_total",
            "KV block pulls resumed after a mid-pull failure, re-pulling "
            "only the blocks not yet committed",
            registry=self.registry)
        # -- fleet-wide KV reuse (admission onboarding) -------------------
        self.kv_onboard = Counter(
            f"{ns}_kv_onboard_total",
            "Prompt blocks the admission path had to source beyond the "
            "local tiers, by source: 'peer' onboarded from another "
            "worker's KV export, 'recompute' left for local prefill "
            "(no peer held them, or every pull failed)",
            ["source"], registry=self.registry)
        self.kv_onboard_bytes = Counter(
            f"{ns}_kv_onboard_bytes_total",
            "KV bytes behind those admission decisions, by source: 'peer' "
            "counts wire bytes pulled, 'recompute' the cache bytes the "
            "local prefill will regenerate",
            ["source"], registry=self.registry)
        for source in ("peer", "recompute"):
            self.kv_onboard.labels(source)
            self.kv_onboard_bytes.labels(source)
        self.prefill_failovers = Counter(
            f"{ns}_prefill_failovers_total",
            "Remote-prefill retries on an alternate prefill instance "
            "after the first one failed, by outcome (ok, failed)",
            ["outcome"], registry=self.registry)
        self.stage = StageMetrics(self.registry)
        # KVBM tier/prefetch gauges+counters, sampled at scrape time from
        # TieredEngine.kvbm_stats() once attached (zero-valued until then)
        self.kvbm = KvbmStatsCollector(self.registry)
        # decode dispatch taps, sampled at scrape time from the engine's
        # counters once attached (zero-valued until then)
        self.engine = EngineDispatchCollector(self.registry)
        # step flight recorder aggregates (duration/occupancy/gap
        # histograms, pool gauges, compile counters), sampled at scrape
        # time once attached (zero-valued until then)
        self.steptrace = StepTraceCollector(self.registry)

    def attach_tracer(self, tracer) -> None:
        """Observe stage spans finished in this process into the stage
        histogram (idempotent per tracer)."""
        self.stage.attach(tracer)


_metrics: Optional[WorkerMetrics] = None


def get_worker_metrics() -> WorkerMetrics:
    global _metrics
    if _metrics is None:
        _metrics = WorkerMetrics()
    return _metrics


def count_metric(name: str, *labels: str, inc: float = 1) -> None:
    """Best-effort increment of a ``WorkerMetrics`` counter by attribute
    name — accounting must never fail serving, so lookup/label errors are
    swallowed (logged at debug). The one place the try/inc/except shape
    lives, instead of a copy per call site."""
    import logging
    try:
        c = getattr(get_worker_metrics(), name)
        if labels:
            c = c.labels(*labels)
        c.inc(inc)
    except Exception:  # noqa: BLE001 — accounting is never load-bearing
        logging.getLogger(__name__).debug(
            "worker metric %s%r increment failed", name, labels,
            exc_info=True)


__all__ = ["WorkerMetrics", "KvbmStatsCollector", "EngineDispatchCollector",
           "StepTraceCollector", "engine_dispatch_stats",
           "get_worker_metrics", "count_metric"]
