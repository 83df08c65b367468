"""Planner-side Prometheus metrics, served on the planner's system server.

The planner is a control loop trusted with live traffic — when it scales a
fleet down it must drain, when a worker dies it must heal, and when healing
loops it must stop. Each of those verbs gets a series an operator can alert
on:

- ``dynamo_planner_replicas{role}`` — READY workers per pool, as counted by
  the connector (a spawned worker only appears here once its
  ``/healthz/ready`` returns 200 — the same gate the capacity math uses).
- ``dynamo_planner_decisions_total{action}`` — planner loop decisions by
  direction: ``up`` (any pool grew), ``down`` (any pool shrank),
  ``reconfig`` (counts held, parallelism config changed), ``hold``
  (no change). ``up``/``down`` both increment on a mixed decision.
- ``dynamo_planner_worker_crashes_total{role}`` — worker processes that
  exited WITHOUT the supervisor asking (nonzero exit, signal death, or a
  clean exit that wasn't a requested stop). Every crash is also logged with
  its exit code and the tail of the worker's log file.
- ``dynamo_planner_crash_loop_holds_total`` — times the supervisor entered
  hold-down because a pool crashed K times inside the detection window
  (the fork-bomb breaker); page on any increase.

A process-wide singleton (``get_planner_metrics``) mirrors the worker
registry pattern: the connector's supervisor tasks and the planner loop have
no shared construction point, and the planner main serves the singleton's
registry on its system server.
"""

from __future__ import annotations

import logging
from typing import Optional

from prometheus_client import CollectorRegistry, Counter, Gauge


class PlannerMetrics:
    """Registry of ``dynamo_planner_*`` series (label sets pre-seeded so a
    scrape shows the full schema before the first event)."""

    def __init__(self, registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = "dynamo_planner"
        self.replicas = Gauge(
            f"{ns}_replicas",
            "Ready workers per pool (readiness-gated: spawned-but-still-"
            "compiling workers are excluded)",
            ["role"], registry=self.registry)
        self.decisions_total = Counter(
            f"{ns}_decisions",
            "Planner loop decisions by direction (up/down/reconfig/hold)",
            ["action"], registry=self.registry)
        self.worker_crashes_total = Counter(
            f"{ns}_worker_crashes",
            "Worker processes that died without the supervisor asking, "
            "by pool",
            ["role"], registry=self.registry)
        self.crash_loop_holds_total = Counter(
            f"{ns}_crash_loop_holds",
            "Times the supervisor held a pool down after K crashes in the "
            "detection window instead of respawning (fork-bomb breaker)",
            registry=self.registry)
        for role in ("prefill", "decode"):
            self.replicas.labels(role)
            self.worker_crashes_total.labels(role)
        for action in ("up", "down", "reconfig", "hold"):
            self.decisions_total.labels(action)


_singleton: Optional[PlannerMetrics] = None


def get_planner_metrics() -> PlannerMetrics:
    global _singleton
    if _singleton is None:
        _singleton = PlannerMetrics()
    return _singleton


def count_metric(name: str, *labels: str, inc: float = 1) -> None:
    """Best-effort increment of a ``PlannerMetrics`` counter by attribute
    name — supervision must never fail on accounting (same contract as
    ``worker.metrics.count_metric``)."""
    try:
        c = getattr(get_planner_metrics(), name)
        if labels:
            c = c.labels(*labels)
        c.inc(inc)
    except Exception:  # noqa: BLE001 — accounting is never load-bearing
        logging.getLogger(__name__).debug(
            "planner metric %s%r increment failed", name, labels,
            exc_info=True)


def set_replicas(role: str, n: int) -> None:
    """Best-effort gauge update (see :func:`count_metric`)."""
    try:
        get_planner_metrics().replicas.labels(role).set(n)
    except Exception:  # noqa: BLE001
        logging.getLogger(__name__).debug(
            "planner replicas gauge update failed", exc_info=True)


__all__ = ["PlannerMetrics", "get_planner_metrics", "count_metric",
           "set_replicas"]
