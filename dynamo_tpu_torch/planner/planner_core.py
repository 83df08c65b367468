"""The observe -> predict -> adjust loop.

Parity: reference ``planner/utils/planner_core.py:131-245``: each interval,
observe traffic (request rate, input/output lengths) and SLO attainment,
predict the next interval with a load predictor, convert predicted load to
replica counts through the perf interpolators with correction factors (how
far off the last prediction was), clamp, and ask the connector to scale.

Observation source is pluggable: ``MetricsSource.sample()`` returns a
``TrafficSample`` — production wires the frontend's metrics endpoint or the
coordinator stats plane; tests inject synthetic samples.
"""

from __future__ import annotations

import asyncio
import logging
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Protocol

from dynamo_tpu_torch.planner.load_predictor import BasePredictor, make_predictor
from dynamo_tpu_torch.planner.perf_interpolation import PerfInterpolator

logger = logging.getLogger(__name__)


@dataclass
class TrafficSample:
    request_rate: float         # requests/s over the interval
    avg_isl: float              # mean prompt tokens
    avg_osl: float              # mean generated tokens
    observed_ttft_s: Optional[float] = None
    observed_itl_s: Optional[float] = None
    # prefill work-queue backlog (coordinator queue depth): a direct
    # pressure signal the rate math can't see — jobs already waiting mean
    # the prefill pool is undersized RIGHT NOW (reference: JetStream
    # prefill-queue consumer lag)
    prefill_queue_depth: int = 0


@dataclass
class SloSpec:
    ttft_s: float = 0.5
    itl_s: float = 0.05


@dataclass
class PlannerConfig:
    interval_s: float = 30.0
    predictor: str = "ewma"
    min_prefill: int = 1
    max_prefill: int = 16
    min_decode: int = 1
    max_decode: int = 16
    # headroom multiplier on computed need (serve bursts without thrash)
    headroom: float = 1.15


class Connector(Protocol):
    async def scale(self, prefill: int, decode: int,
                    prefill_config: Optional[Dict] = None,
                    decode_config: Optional[Dict] = None) -> None: ...


class MetricsSource(Protocol):
    async def sample(self) -> Optional[TrafficSample]: ...


@dataclass
class PlanDecision:
    prefill: int
    decode: int
    predicted_rate: float
    # chosen parallelism config per pool (multi-config profiles only)
    prefill_config: Optional[Dict] = None
    decode_config: Optional[Dict] = None


class Planner:
    def __init__(self, config: PlannerConfig, slo: SloSpec,
                 interp, source: MetricsSource,
                 connector: Connector):
        self.cfg = config
        self.slo = slo
        # multi-config (parallelism-sweep) profiles: evaluate every option
        # and choose the cheapest in CHIPS (reference profile_sla pattern)
        from dynamo_tpu_torch.planner.perf_interpolation import MultiPerfInterpolator
        self.multi: Optional[MultiPerfInterpolator] = (
            interp if isinstance(interp, MultiPerfInterpolator) else None)
        if self.multi is not None:
            interp = self.multi.options[0]["interp"]
        self.interp = interp
        self.source = source
        self.connector = connector
        self.rate_pred: BasePredictor = make_predictor(config.predictor)
        self.isl_pred: BasePredictor = make_predictor(config.predictor)
        self.osl_pred: BasePredictor = make_predictor(config.predictor)
        # correction factors: observed latency / interpolated latency
        self.prefill_correction = 1.0
        self.decode_correction = 1.0
        self.current = PlanDecision(config.min_prefill, config.min_decode, 0.0)
        self._task: Optional[asyncio.Task] = None

    # -- the math ----------------------------------------------------------

    def _interp_for(self, cfg: Optional[Dict]):
        """Interpolator of a chosen parallelism config (falls back to the
        default surface for flat profiles / unknown configs)."""
        if self.multi is not None and cfg is not None:
            for opt in self.multi.options:
                if (opt["tp"] == cfg.get("tp")
                        and opt["sp"] == cfg.get("sp")):
                    return opt["interp"]
        return self.interp

    def decide(self, sample: TrafficSample) -> PlanDecision:
        self.rate_pred.observe(sample.request_rate)
        self.isl_pred.observe(sample.avg_isl)
        self.osl_pred.observe(sample.avg_osl)
        rate = self.rate_pred.predict() or 0.0
        isl = self.isl_pred.predict() or sample.avg_isl
        osl = self.osl_pred.predict() or sample.avg_osl

        # correction: how much slower reality is than the profile says —
        # measured against the CURRENTLY-DEPLOYED config's interpolator
        # (comparing tp=4 reality to a tp=1 profile would skew every
        # config's cost in the chips comparison)
        pre_now = self._interp_for(self.current.prefill_config)
        dec_now = self._interp_for(self.current.decode_config)
        if sample.observed_ttft_s:
            expect = max(1e-9, pre_now.ttft(isl))
            self.prefill_correction = max(
                0.25, min(4.0, sample.observed_ttft_s / expect))
        if sample.observed_itl_s:
            conc = rate * osl * dec_now.itl(1.0)  # rough concurrency
            expect = max(1e-9, dec_now.itl(max(1.0, conc)))
            self.decode_correction = max(
                0.25, min(4.0, sample.observed_itl_s / expect))

        def prefill_need(interp) -> float:
            # prefill replicas: token arrival rate / per-replica rate
            prefill_tps = interp.prefill_tokens_per_s(isl)
            need = (rate * isl / max(prefill_tps, 1e-9)
                    * self.prefill_correction * self.cfg.headroom)
            if sample.prefill_queue_depth > 0:
                # backlog: each queued job is one prefill of ~isl tokens
                # that must drain within one planner interval
                need += (sample.prefill_queue_depth * isl
                         / max(prefill_tps * self.cfg.interval_s, 1e-9))
            return need

        def decode_need(interp) -> float:
            # decode replicas: sustained concurrency / per-replica budget
            # at the itl SLO (Little's law: conc = rate * osl * itl)
            conc_budget = interp.max_concurrency_for_itl(
                self.slo.itl_s / self.decode_correction)
            itl = interp.itl(conc_budget)
            concurrency = rate * osl * itl
            return (concurrency / max(conc_budget, 1e-9)
                    * self.cfg.headroom)

        def clamp(n: float, lo: int, hi: int) -> int:
            return min(hi, max(lo, math.ceil(n)))

        pre_cfg = dec_cfg = None
        if self.multi is not None and self.multi.is_multi:
            # choose the config minimizing chips = replicas x chips-per;
            # prefill and decode pools pick independently (the reference
            # sweeps TP for each pool separately)
            def cheapest(need_fn):
                best = None
                for opt in self.multi.options:
                    reps = max(1, math.ceil(need_fn(opt["interp"])))
                    cost = reps * opt["chips"]
                    if best is None or cost < best[0]:
                        best = (cost, reps, opt)
                return best
            _, pre_reps, pre_opt = cheapest(prefill_need)
            _, dec_reps, dec_opt = cheapest(decode_need)
            pre_cfg = {"tp": pre_opt["tp"], "sp": pre_opt["sp"]}
            dec_cfg = {"tp": dec_opt["tp"], "sp": dec_opt["sp"]}
            need_prefill, need_decode = pre_reps, dec_reps
        else:
            need_prefill = prefill_need(self.interp)
            need_decode = decode_need(self.interp)

        decision = PlanDecision(
            prefill=clamp(need_prefill, self.cfg.min_prefill,
                          self.cfg.max_prefill),
            decode=clamp(need_decode, self.cfg.min_decode,
                         self.cfg.max_decode),
            predicted_rate=rate,
            prefill_config=pre_cfg, decode_config=dec_cfg)
        return decision

    # -- the loop ----------------------------------------------------------

    def _count_decision(self, decision: PlanDecision) -> None:
        """Best-effort ``dynamo_planner_decisions_total{action}`` accounting
        (a mixed decision — one pool up, the other down — counts both)."""
        from dynamo_tpu_torch.planner.metrics import count_metric
        grew = (decision.prefill > self.current.prefill
                or decision.decode > self.current.decode)
        shrank = (decision.prefill < self.current.prefill
                  or decision.decode < self.current.decode)
        if grew:
            count_metric("decisions_total", "up")
        if shrank:
            count_metric("decisions_total", "down")
        if not grew and not shrank:
            if (decision.prefill_config != self.current.prefill_config
                    or decision.decode_config != self.current.decode_config):
                count_metric("decisions_total", "reconfig")
            else:
                count_metric("decisions_total", "hold")

    def _export_replicas(self) -> None:
        """Mirror the connector's READY counts onto the replicas gauge (a
        connector without ``counts()`` — e.g. ``KvConnector`` — exports the
        desired counts instead: the operator owns observed state there)."""
        from dynamo_tpu_torch.planner.metrics import set_replicas
        counts = getattr(self.connector, "counts", None)
        if callable(counts):
            for role, n in counts().items():
                set_replicas(role, n)
        else:
            set_replicas("prefill", self.current.prefill)
            set_replicas("decode", self.current.decode)

    async def step(self) -> Optional[PlanDecision]:
        sample = await self.source.sample()
        if sample is None:
            return None
        decision = self.decide(sample)
        self._count_decision(decision)
        if (decision.prefill != self.current.prefill
                or decision.decode != self.current.decode
                or decision.prefill_config != self.current.prefill_config
                or decision.decode_config != self.current.decode_config):
            logger.info("planner scaling: prefill %d->%d decode %d->%d "
                        "configs %s/%s (pred rate %.2f req/s)",
                        self.current.prefill, decision.prefill,
                        self.current.decode, decision.decode,
                        decision.prefill_config, decision.decode_config,
                        decision.predicted_rate)
            await self.connector.scale(
                decision.prefill, decision.decode,
                prefill_config=decision.prefill_config,
                decode_config=decision.decode_config)
        self.current = decision
        self._export_replicas()
        return decision

    async def run(self) -> None:
        while True:
            try:
                await self.step()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("planner step failed")
            await asyncio.sleep(self.cfg.interval_s)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self.run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


__all__ = ["Planner", "PlannerConfig", "SloSpec", "TrafficSample",
           "PlanDecision"]
