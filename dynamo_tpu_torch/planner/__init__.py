"""Planner: SLA-driven autoscaling of prefill/decode worker fleets.

Capability parity: reference ``components/planner`` (``planner_core.py``
observe->predict->adjust loop, load predictors, pre-profiled perf
interpolators, local/k8s connectors — SURVEY §2.5). TPU re-design notes:
replicas are whole TPU workers (chips or slices), the local connector spawns
worker processes directly (no circus), and the k8s connector publishes
desired counts to the coordinator KV for an operator to reconcile.
"""

from dynamo_tpu_torch.planner.connectors import KvConnector, LocalConnector
from dynamo_tpu_torch.planner.load_predictor import (
    ConstantPredictor,
    EwmaPredictor,
    TrendPredictor,
    make_predictor,
)
from dynamo_tpu_torch.planner.metrics import PlannerMetrics, get_planner_metrics
from dynamo_tpu_torch.planner.perf_interpolation import PerfInterpolator
from dynamo_tpu_torch.planner.planner_core import Planner, PlannerConfig, SloSpec

__all__ = ["ConstantPredictor", "EwmaPredictor", "TrendPredictor",
           "make_predictor", "PerfInterpolator", "Planner", "PlannerConfig",
           "SloSpec", "LocalConnector", "KvConnector", "PlannerMetrics",
           "get_planner_metrics"]
