"""Failure-aware routing policy: breakers, retry budget, latency book.

The three classic resilience mechanisms wrapped around instance selection
(``runtime/push_router.py`` and ``kv_router/``), in the lineage of
Finagle/Envoy outlier handling and "The Tail at Scale" hedging:

- ``CircuitBreaker`` per instance: closed -> open after N consecutive
  failures (connect errors, stream drops, deadline timeouts — and, when
  ``breaker_slow_ttft_s`` is set, slow-call TTFT observations) -> half-open
  single probe after a cooldown that doubles on repeated opens -> closed on
  probe success.  Keepalive-down reports force an immediate open, so the
  breaker fires *before* lease expiry removes the instance.
- ``RetryBudget``: a frontend-wide token bucket — every first attempt
  deposits ``ratio`` tokens (default 0.1: at most ~10% of requests may
  retry), every retry or hedge spends one — so a transient fault is
  retried but a fleet-wide brownout cannot amplify into a retry storm.
- ``LatencyBook``: per-instance EWMA of observed TTFT and request latency
  plus a fleet-wide p95 TTFT ring, feeding the cost score and the hedge
  delay.

``RouterPolicy`` composes the three with router-side in-flight counts and
scraped worker stats (queue depth / active slots from the ``__stats__``
plane) into one object shared by a ``PushRouter`` and (in KV mode) the
``KvScheduler``.  All counters surface process-wide through
``get_router_stats()`` — sampled by the frontend's /metrics collector
(``dynamo_frontend_router_*``) so tests and dashboards see one book.
"""

from __future__ import annotations

import enum
import logging
import random
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


# /metrics gauge encoding of BreakerState (documented in observability.md)
BREAKER_GAUGE = {BreakerState.CLOSED: 0.0, BreakerState.HALF_OPEN: 0.5,
                 BreakerState.OPEN: 1.0}


class RouterStats:
    """Process-wide router counters, sampled at /metrics scrape time by
    ``http.metrics.RouterMetricsCollector``.  Plain dicts, no prometheus
    objects — routers live outside the HTTP service's registry."""

    def __init__(self) -> None:
        self.decisions: Dict[str, int] = defaultdict(int)      # by policy
        self.retries: Dict[str, int] = defaultdict(int)        # by reason
        self.hedges: Dict[str, int] = defaultdict(int)         # by outcome
        self.breaker_transitions: Dict[str, int] = defaultdict(int)  # by state
        self.breaker_states: Dict[str, float] = {}             # by instance hex
        self.budget_balance: float = 0.0
        self.budget_exhausted: int = 0
        # NetKV-style pricing: decisions where a remote prefix hit was
        # priced against the measured kv_transfer plane bandwidth
        self.net_priced: Dict[str, int] = defaultdict(int)     # by outcome
        self.net_cost_seconds_sum: float = 0.0
        self.net_cost_seconds_count: int = 0

    def note_net_priced(self, outcome: str, net_cost_s: float) -> None:
        self.net_priced[outcome] += 1
        self.net_cost_seconds_sum += max(0.0, net_cost_s)
        self.net_cost_seconds_count += 1


_STATS = RouterStats()


def get_router_stats() -> RouterStats:
    return _STATS


@dataclass
class RouterPolicyConfig:
    """Knobs for the failure-aware routing policy (docs/deployment.md
    "Failure-aware routing" table; layered through RuntimeConfig
    ``router_*`` fields and frontend CLI flags)."""

    breaker_failures: int = 3          # consecutive failures that open
    breaker_cooldown_s: float = 1.0    # first open->half-open dwell
    breaker_cooldown_cap_s: float = 30.0  # dwell doubles per re-open, capped
    breaker_slow_ttft_s: float = 0.0   # TTFT >= this counts as a failure (0 off)
    retry_budget_ratio: float = 0.1    # tokens earned per first attempt
    retry_budget_floor: float = 3.0    # starting balance (cold-start retries)
    hedge: bool = False                # hedged dispatch for routed requests
    hedge_delay_s: float = 0.0         # fixed hedge delay (0 = p95-based)
    hedge_delay_floor_s: float = 0.02  # lower bound on the p95-based delay
    ttft_weight: float = 25.0          # score units per second of EWMA TTFT
    net_weight: float = 25.0           # score units per second of KV transfer
    ewma_alpha: float = 0.3            # EWMA smoothing for TTFT/latency
    stats_interval_s: float = 1.0      # __stats__ scrape period (COST mode)

    @classmethod
    def from_runtime_config(cls, cfg: Any) -> "RouterPolicyConfig":
        return cls(
            breaker_failures=cfg.router_breaker_failures,
            breaker_cooldown_s=cfg.router_breaker_cooldown_s,
            breaker_slow_ttft_s=cfg.router_breaker_slow_ttft_s,
            retry_budget_ratio=cfg.router_retry_budget,
            hedge=cfg.router_hedge,
            hedge_delay_s=cfg.router_hedge_delay_s,
            stats_interval_s=cfg.router_stats_interval_s)


class CircuitBreaker:
    """closed -> open -> half-open -> closed, for one instance.

    ``allow()`` is side-effect free (selection filters call it for every
    candidate); the single half-open probe slot is claimed by
    ``on_dispatch()`` when a request is actually sent."""

    def __init__(self, failures: int = 3, cooldown_s: float = 1.0,
                 cooldown_cap_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failures)
        self.base_cooldown_s = cooldown_s
        self.cooldown_cap_s = cooldown_cap_s
        self._clock = clock
        self.state = BreakerState.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._cooldown = cooldown_s
        self._probe_inflight = False
        self.opens = 0  # lifetime open transitions (incl. force_open)

    def allow(self) -> bool:
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.OPEN:
            return (self._clock() - self._opened_at) >= self._cooldown
        return not self._probe_inflight  # HALF_OPEN: one probe at a time

    def on_dispatch(self) -> None:
        """A request was actually sent to this instance."""
        if (self.state is BreakerState.OPEN
                and (self._clock() - self._opened_at) >= self._cooldown):
            self.state = BreakerState.HALF_OPEN
            self._probe_inflight = True
        elif self.state is BreakerState.HALF_OPEN:
            self._probe_inflight = True

    def record_success(self) -> bool:
        """Returns True when the breaker just closed (half-open probe won)."""
        self._consecutive = 0
        self._probe_inflight = False
        if self.state is not BreakerState.CLOSED:
            self.state = BreakerState.CLOSED
            self._cooldown = self.base_cooldown_s
            return True
        return False

    def record_failure(self) -> bool:
        """Returns True when the breaker just opened."""
        self._consecutive += 1
        self._probe_inflight = False
        if self.state is BreakerState.HALF_OPEN:
            # failed probe: back to open with a doubled dwell
            self._cooldown = min(self.cooldown_cap_s, self._cooldown * 2)
            return self._open()
        if (self.state is BreakerState.CLOSED
                and self._consecutive >= self.failure_threshold):
            return self._open()
        return False

    def force_open(self) -> bool:
        """Immediate open (keepalive declared the instance down)."""
        self._probe_inflight = False
        return self._open()

    def _open(self) -> bool:
        was_open = self.state is BreakerState.OPEN
        self.state = BreakerState.OPEN
        self._opened_at = self._clock()
        if not was_open:
            self.opens += 1
        return not was_open


class BreakerBoard:
    """Per-instance breakers for one endpoint, with /metrics bookkeeping."""

    def __init__(self, cfg: RouterPolicyConfig,
                 stats: Optional[RouterStats] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.stats = stats or get_router_stats()
        self._clock = clock
        self._breakers: Dict[int, CircuitBreaker] = {}

    def get(self, iid: int) -> CircuitBreaker:
        br = self._breakers.get(iid)
        if br is None:
            br = self._breakers[iid] = CircuitBreaker(
                failures=self.cfg.breaker_failures,
                cooldown_s=self.cfg.breaker_cooldown_s,
                cooldown_cap_s=self.cfg.breaker_cooldown_cap_s,
                clock=self._clock)
        return br

    def allow(self, iid: int) -> bool:
        return self.get(iid).allow()

    def on_dispatch(self, iid: int) -> None:
        br = self.get(iid)
        before = br.state
        br.on_dispatch()
        if br.state is not before:
            self._transition(iid, br)

    def record_success(self, iid: int) -> None:
        br = self.get(iid)
        if br.record_success():
            self._transition(iid, br)
        else:
            self._publish(iid, br)

    def record_failure(self, iid: int) -> None:
        br = self.get(iid)
        if br.record_failure():
            logger.warning("circuit breaker for instance %x opened", iid)
            self._transition(iid, br)

    def force_open(self, iid: int) -> None:
        br = self.get(iid)
        if br.force_open():
            logger.warning("circuit breaker for instance %x force-opened "
                           "(instance reported down)", iid)
            self._transition(iid, br)

    def state(self, iid: int) -> BreakerState:
        return self.get(iid).state

    def open_count(self) -> int:
        return sum(1 for b in self._breakers.values()
                   if b.state is BreakerState.OPEN)

    def opens_total(self) -> int:
        return sum(b.opens for b in self._breakers.values())

    def prune(self, live: set) -> None:
        for iid in [i for i in self._breakers if i not in live]:
            del self._breakers[iid]
            self.stats.breaker_states.pop(f"{iid:x}", None)

    def _transition(self, iid: int, br: CircuitBreaker) -> None:
        self.stats.breaker_transitions[br.state.value] += 1
        self._publish(iid, br)

    def _publish(self, iid: int, br: CircuitBreaker) -> None:
        self.stats.breaker_states[f"{iid:x}"] = BREAKER_GAUGE[br.state]


class RetryBudget:
    """Token bucket bounding retries+hedges to a fraction of traffic."""

    def __init__(self, ratio: float = 0.1, floor: float = 3.0,
                 stats: Optional[RouterStats] = None):
        self.ratio = max(0.0, ratio)
        self.floor = max(0.0, floor)
        # cap keeps a quiet period from banking unbounded retry credit
        self.cap = max(self.floor, 10.0)
        self.balance = self.floor
        self.stats = stats or get_router_stats()
        self.stats.budget_balance = self.balance

    def deposit(self) -> None:
        self.balance = min(self.cap, self.balance + self.ratio)
        self.stats.budget_balance = self.balance

    def try_spend(self, cost: float = 1.0) -> bool:
        if self.balance >= cost:
            self.balance -= cost
            self.stats.budget_balance = self.balance
            return True
        self.stats.budget_exhausted += 1
        return False


class LatencyBook:
    """Per-instance EWMA TTFT/latency plus a fleet-wide p95 TTFT ring."""

    def __init__(self, alpha: float = 0.3, ring: int = 256):
        self.alpha = alpha
        self._ttft: Dict[int, float] = {}
        self._latency: Dict[int, float] = {}
        self._recent: deque = deque(maxlen=ring)

    def observe_ttft(self, iid: int, seconds: float) -> None:
        prev = self._ttft.get(iid)
        self._ttft[iid] = (seconds if prev is None
                           else prev + self.alpha * (seconds - prev))
        self._recent.append(seconds)

    def observe_latency(self, iid: int, seconds: float) -> None:
        prev = self._latency.get(iid)
        self._latency[iid] = (seconds if prev is None
                              else prev + self.alpha * (seconds - prev))

    def ttft(self, iid: int, default: float = 0.0) -> float:
        return self._ttft.get(iid, default)

    def latency(self, iid: int, default: float = 0.0) -> float:
        return self._latency.get(iid, default)

    def ttft_p95(self, default: float = 0.0) -> float:
        if not self._recent:
            return default
        ordered = sorted(self._recent)
        return ordered[min(len(ordered) - 1, int(len(ordered) * 0.95))]

    def prune(self, live: set) -> None:
        for d in (self._ttft, self._latency):
            for iid in [i for i in d if i not in live]:
                del d[iid]


class RouterPolicy:
    """Shared resilience + scoring state for one endpoint's fleet."""

    def __init__(self, config: Optional[RouterPolicyConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or RouterPolicyConfig()
        self.stats = get_router_stats()
        self.breakers = BreakerBoard(self.cfg, self.stats, clock=clock)
        self.budget = RetryBudget(self.cfg.retry_budget_ratio,
                                  self.cfg.retry_budget_floor, self.stats)
        self.lat = LatencyBook(alpha=self.cfg.ewma_alpha)
        self.inflight: Dict[int, int] = defaultdict(int)
        # scraped worker-side view: iid -> {queue_depth, active_slots, active}
        self.worker_stats: Dict[int, Dict[str, float]] = {}
        # scraped kv_transfer bandwidth book: iid -> {plane -> bytes/s EWMA}
        # (what workers publish from KvBandwidthBook.snapshot())
        self.net_bw: Dict[int, Dict[str, float]] = {}

    # -- client wiring -----------------------------------------------------

    def attach_client(self, client: Any) -> None:
        """Feed keepalive/error instance-down reports into the breakers —
        the breaker opens the moment the pool declares a connection dead,
        before lease expiry prunes the instance."""
        add = getattr(client, "add_down_listener", None)
        if add is not None:
            add(self.on_instance_down)

    def on_instance_down(self, iid: int) -> None:
        self.breakers.force_open(iid)

    # -- request accounting ------------------------------------------------

    def begin(self, iid: int) -> None:
        self.inflight[iid] += 1

    def end(self, iid: int) -> None:
        n = self.inflight.get(iid, 0)
        if n <= 1:
            self.inflight.pop(iid, None)
        else:
            self.inflight[iid] = n - 1

    def observe_ttft(self, iid: int, seconds: float) -> None:
        self.lat.observe_ttft(iid, seconds)
        slow = self.cfg.breaker_slow_ttft_s
        if slow > 0 and seconds >= slow:
            # slow-call accounting: a worker that answers, but only after
            # the threshold, fails toward an open breaker — the
            # SIGSTOP/ChaosProxy-delay case keepalives alone only *detect*
            self.breakers.record_failure(iid)

    def on_success(self, iid: int, latency_s: Optional[float] = None) -> None:
        self.breakers.record_success(iid)
        if latency_s is not None:
            self.lat.observe_latency(iid, latency_s)

    def on_failure(self, iid: int, kind: str) -> None:
        self.breakers.record_failure(iid)

    # -- scraped worker stats ----------------------------------------------

    def ingest_scrape(self, scraped: Dict[int, Any], endpoint_path: str) -> None:
        """Parse a ``component.scrape_stats()`` result (the ``__stats__``
        plane: {iid: {path: {requests, active, errors, data}}}) into the
        per-instance load view the scorer reads."""
        for iid, stats in scraped.items():
            ep = stats.get(endpoint_path) if isinstance(stats, dict) else None
            if not isinstance(ep, dict):
                continue
            data = ep.get("data") if isinstance(ep.get("data"), dict) else {}
            ws = data.get("worker_stats") if isinstance(
                data.get("worker_stats"), dict) else {}
            self.worker_stats[iid] = {
                "queue_depth": float(ws.get("num_requests_waiting", 0) or 0),
                "active_slots": float(ws.get("request_active_slots", 0) or 0),
                "active": float(ep.get("active", 0) or 0),
            }
            kt = data.get("kv_transfer") if isinstance(
                data.get("kv_transfer"), dict) else {}
            planes = {}
            for plane, snap in kt.items():
                if isinstance(snap, dict):
                    bw = float(snap.get("bw_bytes_per_s", 0) or 0)
                    if bw > 0:
                        planes[str(plane)] = bw
            if planes:
                self.net_bw[iid] = planes

    def update_worker_stats(self, iid: int, queue_depth: float,
                            active_slots: float = 0.0,
                            active: float = 0.0) -> None:
        self.worker_stats[iid] = {"queue_depth": float(queue_depth),
                                  "active_slots": float(active_slots),
                                  "active": float(active)}

    def plane_bw(self, iid: int) -> float:
        """Best measured kv_transfer bandwidth (bytes/s EWMA) toward a
        worker, across planes — 0.0 when no transfer has been observed
        (an unmeasured path earns no remote-hit credit)."""
        planes = self.net_bw.get(iid)
        return max(planes.values()) if planes else 0.0

    def net_cost_s(self, iid: int, est_transfer_bytes: float) -> float:
        """NetKV-style network price: seconds to move the missing prefix
        over the best measured plane.  ``inf`` when bytes must move but no
        bandwidth has ever been observed."""
        if est_transfer_bytes <= 0:
            return 0.0
        bw = self.plane_bw(iid)
        return (est_transfer_bytes / bw) if bw > 0 else float("inf")

    def prune(self, live: set) -> None:
        self.breakers.prune(live)
        self.lat.prune(live)
        for iid in [i for i in self.worker_stats if i not in live]:
            del self.worker_stats[iid]
        for iid in [i for i in self.inflight if i not in live]:
            del self.inflight[iid]
        for iid in [i for i in self.net_bw if i not in live]:
            del self.net_bw[iid]

    # -- scoring -----------------------------------------------------------

    def score(self, iid: int,
              est_transfer_bytes: float = 0.0) -> Tuple[float, Dict[str, Any]]:
        """Cost of routing one more request to ``iid``, with the inputs —
        the per-decision trace attrs the ROADMAP's "debuggable post-hoc"
        requirement asks for.  ``est_transfer_bytes`` is the KV volume a
        remote placement would have to move to this worker; it is priced
        at the measured per-plane bandwidth EWMA (``net_cost`` term)."""
        ws = self.worker_stats.get(iid, {})
        inflight = self.inflight.get(iid, 0)
        queue = ws.get("queue_depth", 0.0)
        active = ws.get("active_slots", 0.0)
        ewma = self.lat.ttft(iid, 0.0)
        net_cost = self.net_cost_s(iid, est_transfer_bytes)
        net_term = (self.cfg.net_weight * net_cost
                    if net_cost not in (0.0, float("inf")) else 0.0)
        total = (inflight + queue + active + self.cfg.ttft_weight * ewma
                 + net_term)
        state = self.breakers.state(iid)
        return total, {
            "score": round(total, 4),
            "ewma_ttft_s": round(ewma, 4),
            "inflight": inflight,
            "queue_depth": queue,
            "active_slots": active,
            "net_cost": (round(net_cost, 6)
                         if net_cost != float("inf") else -1.0),
            "breaker": state.value,
        }

    def cost_bias(self, iid: int) -> float:
        """The terms the KV scheduler's own cost model lacks: router-side
        in-flight count and observed-latency penalty.  (Queue depth is NOT
        included — the KvScheduler already prices scraped
        ``num_requests_waiting``.)"""
        return (self.inflight.get(iid, 0)
                + self.cfg.ttft_weight * self.lat.ttft(iid, 0.0))

    def select(self, candidates: List[int]) -> Tuple[int, Dict[str, Any]]:
        """Min-cost choice with random tie-break; candidates are assumed
        pre-filtered for breakers/drain by the caller."""
        scored = [(self.score(i), i) for i in candidates]
        best = min(s for (s, _), _ in scored)
        ties = [(inputs, i) for (s, inputs), i in scored if s == best]
        inputs, chosen = random.choice(ties)
        inputs = dict(inputs)
        inputs["candidates"] = len(candidates)
        inputs["breakers_open"] = self.breakers.open_count()
        return chosen, inputs

    # -- hedging / deadlines -----------------------------------------------

    def hedge_delay_s(self) -> float:
        if self.cfg.hedge_delay_s > 0:
            return self.cfg.hedge_delay_s
        return max(self.cfg.hedge_delay_floor_s,
                   self.lat.ttft_p95(self.cfg.hedge_delay_floor_s))

    def can_redispatch(self, iid: int, deadline_unix: Optional[float]) -> bool:
        """Satellite-1 guard: a retry or hedge whose target cannot plausibly
        produce a first token before the deadline is never dispatched — the
        worker would only drop it."""
        if deadline_unix is None:
            return True
        return (deadline_unix - time.time()) > self.lat.ttft(iid, 0.0)


__all__ = ["BreakerState", "BREAKER_GAUGE", "CircuitBreaker", "BreakerBoard",
           "RetryBudget", "LatencyBook", "RouterPolicy", "RouterPolicyConfig",
           "RouterStats", "get_router_stats"]
