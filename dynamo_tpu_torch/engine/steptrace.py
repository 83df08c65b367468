"""Engine step flight recorder: a bounded, preallocated per-process ring
of StepRecords stamped by the engine loop around every dispatch family
(prefill / decode / chained / multistep / mixed / spec / gather).

The request-level flight recorder (utils/tracing.py) answers "what
happened to THIS request"; this module answers "what was the engine
doing" — per-dispatch kind, fused width, batch occupancy vs padding
waste, queue depth and page-pool pressure at plan time, plan/dispatch/
host-unpack wall time, and the step GAP since the previous dispatch
(host overhead and exclusive-window stalls made visible). XLA compiles
detected on a fresh jit bucket land here too, so a mid-run compile is
attributable instead of masquerading as a throughput regression.

Design constraints, in order:

* The hot path must cost <2% tok/s on fused decode (bench-proven).
  ``record()`` mutates a PREALLOCATED slot in place under one lock —
  no dict building, no prometheus client calls, no allocation beyond
  the occasional fallback string. Aggregates (per-kind duration /
  occupancy / step-gap histograms, compile counters, pool gauges) are
  plain fixed-bucket arrays updated inline; the worker /metrics
  collector renders them at scrape time.
* Bounded memory: the ring holds ``DYN_STEPTRACE_RING`` records
  (default 2048) and overwrites oldest-first. ``snapshot()`` paginates
  newest-first for ``GET /v1/steptrace``.
* ``DYN_STEPTRACE_DISABLE=1`` turns the whole thing into a no-op
  (``record()`` returns None before taking the lock).
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional

__all__ = [
    "StepRecord", "StepRecorder", "get_step_recorder", "set_step_recorder",
]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# fixed histogram bounds (seconds / ratio); cumulative rendering happens
# at scrape time so observe() is a bisect + two adds
_DUR_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
_GAP_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
               0.025, 0.05, 0.1, 0.25, 1.0)
_OCC_BOUNDS = (0.1, 0.25, 0.5, 0.625, 0.75, 0.875, 0.95, 1.0)


class _Hist:
    """Fixed-bucket histogram: observe() is O(log buckets), no alloc."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def cumulative(self) -> List[tuple]:
        """[(le_label, cumulative_count)] incl +Inf — prometheus shape."""
        out, acc = [], 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            out.append((str(b), acc))
        out.append(("+Inf", acc + self.counts[-1]))
        return out


class StepRecord:
    """One engine dispatch. Slots + in-place reuse keep the ring
    allocation-free in steady state; ``seq`` is the monotonic dispatch
    index (survives ring wrap, anchors pagination)."""

    __slots__ = ("seq", "t_unix", "kind", "width", "rows", "batch",
                 "tokens_real", "tokens_padded", "queue_depth", "running",
                 "pool_free", "pool_pinned", "plan_ms", "dispatch_ms",
                 "unpack_ms", "gap_ms", "compile_ms", "fallback", "chained")

    def __init__(self) -> None:
        self.seq = -1
        self.t_unix = 0.0
        self.kind = ""
        self.width = 0
        self.rows = 0
        self.batch = 0
        self.tokens_real = 0
        self.tokens_padded = 0
        self.queue_depth = 0
        self.running = 0
        self.pool_free = 0
        self.pool_pinned = 0
        self.plan_ms = 0.0
        self.dispatch_ms = 0.0
        self.unpack_ms = 0.0
        self.gap_ms = 0.0
        self.compile_ms = 0.0
        self.fallback = ""
        self.chained = False

    def to_dict(self) -> Dict[str, Any]:
        return {s: getattr(self, s) for s in self.__slots__}


class StepRecorder:
    """Process-wide step ring + inline fleet aggregates.

    The loop calls ``record()`` once per dispatch (cheap), then patches
    host-side costs in as they become known: ``note_unpack()`` when the
    overlapped fetch+process completes, ``note_compile()`` when the
    engine reports a fresh-jit-bucket compile attributed to that
    dispatch. Aggregate reads (``aggregates()``/``snapshot()``) take the
    same lock — scrape-time only, never on the hot path.
    """

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        if capacity is None:
            capacity = _env_int("DYN_STEPTRACE_RING", 2048)
        self.capacity = max(1, capacity)
        if enabled is None:
            enabled = os.environ.get(
                "DYN_STEPTRACE_DISABLE", "") not in ("1", "true", "yes")
        self.enabled = enabled
        self._ring = [StepRecord() for _ in range(self.capacity)]
        self._n = 0                      # dispatches ever recorded
        self._lock = threading.Lock()
        # fleet aggregates (rendered by worker/metrics.StepTraceCollector)
        self._dur: Dict[str, _Hist] = {}
        self._occ: Dict[str, _Hist] = {}
        self._gap = _Hist(_GAP_BOUNDS)
        self.compile_events: Dict[str, int] = {}
        self.compile_seconds: Dict[str, float] = {}
        self.pool_free = 0
        self.pool_pinned = 0

    # -- hot path ----------------------------------------------------------

    def record(self, kind: str, *, width: int = 0, rows: int = 0,
               batch: int = 0, tokens_real: int = 0, tokens_padded: int = 0,
               queue_depth: int = 0, running: int = 0, pool_free: int = 0,
               pool_pinned: int = 0, plan_ms: float = 0.0,
               dispatch_ms: float = 0.0, gap_ms: float = 0.0,
               fallback: str = "", chained: bool = False
               ) -> Optional[StepRecord]:
        """Stamp one dispatch; returns the live ring slot (later patched
        by note_unpack/note_compile) or None when disabled."""
        if not self.enabled:
            return None
        now = time.time()
        with self._lock:
            rec = self._ring[self._n % self.capacity]
            self._n += 1
            rec.seq = self._n - 1
            rec.t_unix = now
            rec.kind = kind
            rec.width = width
            rec.rows = rows
            rec.batch = batch
            rec.tokens_real = tokens_real
            rec.tokens_padded = tokens_padded
            rec.queue_depth = queue_depth
            rec.running = running
            rec.pool_free = pool_free
            rec.pool_pinned = pool_pinned
            rec.plan_ms = plan_ms
            rec.dispatch_ms = dispatch_ms
            rec.unpack_ms = 0.0
            rec.gap_ms = gap_ms
            rec.compile_ms = 0.0
            rec.fallback = fallback
            rec.chained = chained
            h = self._dur.get(kind)
            if h is None:
                h = self._dur[kind] = _Hist(_DUR_BOUNDS)
            h.observe(dispatch_ms / 1000.0)
            if tokens_padded > 0:
                o = self._occ.get(kind)
                if o is None:
                    o = self._occ[kind] = _Hist(_OCC_BOUNDS)
                o.observe(min(1.0, tokens_real / tokens_padded))
            if gap_ms > 0.0:
                self._gap.observe(gap_ms / 1000.0)
            self.pool_free = pool_free
            self.pool_pinned = pool_pinned
            return rec

    def note_unpack(self, rec: Optional[StepRecord], ms: float) -> None:
        """Patch host fetch+unpack wall time into a dispatch's record
        (known only when the overlapped fetch completes, often after
        the NEXT dispatch has been stamped)."""
        if rec is None or not self.enabled:
            return
        with self._lock:
            rec.unpack_ms = ms

    def note_compile(self, kind: str, seconds: float,
                     rec: Optional[StepRecord] = None) -> None:
        """Count a first-call compile on a fresh (kind, shape) jit
        bucket; attributes it to ``rec`` when the dispatch is known."""
        if not self.enabled:
            return
        with self._lock:
            self.compile_events[kind] = self.compile_events.get(kind, 0) + 1
            self.compile_seconds[kind] = (
                self.compile_seconds.get(kind, 0.0) + seconds)
            if rec is not None:
                rec.compile_ms += seconds * 1000.0

    # -- read side (scrape / HTTP) -----------------------------------------

    @property
    def total(self) -> int:
        return self._n

    def snapshot(self, limit: int = 100, offset: int = 0) -> Dict[str, Any]:
        """Newest-first page of records for ``GET /v1/steptrace``."""
        limit = max(0, limit)
        offset = max(0, offset)
        with self._lock:
            live = min(self._n, self.capacity)
            recs = []
            for i in range(offset, min(offset + limit, live)):
                # i newest-first -> ring index
                rec = self._ring[(self._n - 1 - i) % self.capacity]
                recs.append(rec.to_dict())
            return {"total": self._n, "capacity": self.capacity,
                    "enabled": self.enabled, "count": len(recs),
                    "offset": offset, "records": recs}

    def aggregates(self) -> Dict[str, Any]:
        """Plain-data aggregate snapshot for the metrics collector."""
        with self._lock:
            return {
                "duration": {k: (h.cumulative(), h.sum, h.count)
                             for k, h in self._dur.items()},
                "occupancy": {k: (h.cumulative(), h.sum, h.count)
                              for k, h in self._occ.items()},
                "gap": (self._gap.cumulative(), self._gap.sum,
                        self._gap.count),
                "compile_events": dict(self.compile_events),
                "compile_seconds": dict(self.compile_seconds),
                "pool_free": self.pool_free,
                "pool_pinned": self.pool_pinned,
            }


_recorder: Optional[StepRecorder] = None
_recorder_lock = threading.Lock()


def get_step_recorder() -> StepRecorder:
    """Process-wide recorder (the ``get_tracer`` pattern): every engine
    in the process stamps the same ring, the system server exports it."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = StepRecorder()
    return _recorder


def set_step_recorder(recorder: StepRecorder) -> StepRecorder:
    """Swap the process recorder (tests / re-reading env knobs)."""
    global _recorder
    _recorder = recorder
    return recorder
