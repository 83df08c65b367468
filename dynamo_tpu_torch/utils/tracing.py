"""End-to-end request tracing: spans, context propagation, flight recorder.

The paper's pitch — disaggregated prefill/decode with KV-aware routing —
makes one user request traverse frontend -> router -> decode worker ->
(remote prefill + KV transfer) -> decode.  This module is the substrate that
makes that path observable: a dependency-free span API (stdlib only, so the
RPC layer can import it without cycles), W3C-traceparent-in-spirit context
propagation over the existing RPC ``headers`` dict, and a bounded in-memory
**flight recorder** per process so the last N requests are reconstructible
after a 504/migration/outage incident without any external collector.

Span model (OTel-shaped, deliberately smaller):

- a **root** span is opened by the process that mints the trace (the HTTP
  frontend, one per request); finishing it finalizes the trace into the
  flight recorder.
- a **hop** span is opened by a server handler from inbound trace context
  (``trace_id``/``parent_span_id`` RPC headers).  Finishing it finalizes the
  local *fragment* into this process's own recorder AND returns the finished
  span dicts so the handler can ship them back to the caller in-band (the
  final response frame) — that shipping is what stitches one tree on the
  frontend with no collector infrastructure.
- **internal** spans (``queue``/``prefill``/``kv_transfer``/``decode``/
  ``tokenize``/``detokenize``/...) parent to the contextvar current span.

Sampling: the ring keeps every finished trace up to ``DYN_TRACE_RING``
(oldest evicted); with ``DYN_TRACE_SLOW_S`` > 0 only traces at least that
slow are kept — except errored traces, which are ALWAYS kept.
``DYN_TRACE_EXPORT=<path>`` appends every *kept* trace as one JSON line for
offline analysis (``tools/trace2perfetto.py`` renders those as a flame
chart).  ``DYN_TRACE_DISABLE=1`` turns span creation into no-ops.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, List, Optional

logger = logging.getLogger(__name__)

# Wire headers carrying trace context over RPC hops (same channel the
# request deadline rides — see runtime/rpc.py request_headers()).
TRACE_ID_HEADER = "trace_id"
PARENT_SPAN_HEADER = "parent_span_id"

# The canonical stage names: these double as the ``stage`` label values of
# the ``dynamo_tpu_stage_duration_seconds`` histogram on both the frontend
# and worker /metrics (see http/metrics.py StageMetrics).
STAGES = ("queue", "prefill", "kv_transfer", "decode", "tokenize",
          "detokenize")

# Key under which a server handler ships its finished spans back to the
# caller on the final response frame (stripped before protocol decoding).
SPANS_FRAME_KEY = "trace_spans"


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation.  Not thread-safe; spans live on the event loop."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_span_id", "name",
                 "service", "kind", "start_unix", "end_unix", "attrs",
                 "events", "status", "error", "_t0", "_ctx_token",
                 "finished")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_span_id: Optional[str], kind: str = "internal",
                 attrs: Optional[Dict[str, Any]] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_span_id = parent_span_id
        self.service = tracer.service
        self.kind = kind  # "root" | "hop" | "internal"
        self.start_unix = time.time()
        self.end_unix: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.events: List[Dict[str, Any]] = []
        self.status = "ok"
        self.error: Optional[str] = None
        self._t0 = time.perf_counter()
        self._ctx_token: Optional[contextvars.Token] = None
        self.finished = False

    # -- mutation ----------------------------------------------------------

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({"name": name, "time_unix": time.time(),
                            **({"attrs": attrs} if attrs else {})})

    def set_error(self, message: str) -> None:
        self.status = "error"
        self.error = str(message)

    # -- lifecycle ---------------------------------------------------------

    def finish(self, end_unix: Optional[float] = None) -> None:
        if self.finished:
            return
        self.finished = True
        if end_unix is not None:
            self.end_unix = end_unix
        else:
            # monotonic duration anchored at the wall-clock start: immune
            # to wall-clock steps within a process, comparable across
            # processes (same-DC skew is far below stage granularity)
            self.end_unix = self.start_unix + (time.perf_counter() - self._t0)
        self.tracer._on_span_finished(self)

    @property
    def duration_s(self) -> float:
        end = self.end_unix if self.end_unix is not None else time.time()
        return max(0.0, end - self.start_unix)

    def headers(self) -> Dict[str, Any]:
        """Trace context for an outgoing hop parented to this span."""
        return {TRACE_ID_HEADER: self.trace_id,
                PARENT_SPAN_HEADER: self.span_id}

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "service": self.service,
            "kind": self.kind,
            "start_unix": self.start_unix,
            "end_unix": self.end_unix,
            "duration_s": round(self.duration_s, 9),
        }
        if self.parent_span_id:
            d["parent_span_id"] = self.parent_span_id
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.events:
            d["events"] = list(self.events)
        if self.status != "ok":
            d["status"] = self.status
            if self.error:
                d["error"] = self.error
        return d


class _NoopSpan:
    """Stand-in when tracing is disabled: absorbs the whole Span surface."""

    trace_id = ""
    span_id = ""
    finished = True
    duration_s = 0.0
    attrs: Dict[str, Any] = {}  # set_attr is a no-op; never written

    def set_attr(self, key, value):
        return self

    def add_event(self, name, **attrs):
        pass

    def set_error(self, message):
        pass

    def finish(self, end_unix=None):
        pass

    def headers(self):
        return {}

    def to_dict(self):
        return {}


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Per-process tracer + flight recorder.

    ``service`` names this process in span records (``frontend``,
    ``worker``, ``prefill``, ...) so a stitched cross-process trace shows
    where each span ran."""

    def __init__(self, service: str = "", capacity: Optional[int] = None,
                 slow_s: Optional[float] = None,
                 export_path: Optional[str] = None,
                 enabled: Optional[bool] = None):
        self.service = service or os.environ.get("DYN_TRACE_SERVICE", "")
        if capacity is None:
            capacity = _env_int("DYN_TRACE_RING", 256)
        if slow_s is None:
            slow_s = _env_float("DYN_TRACE_SLOW_S", 0.0)
        if export_path is None:
            export_path = os.environ.get("DYN_TRACE_EXPORT", "")
        if enabled is None:
            enabled = os.environ.get("DYN_TRACE_DISABLE", "").lower() not in (
                "1", "true", "yes")
        self.capacity = max(1, capacity)
        self.slow_s = slow_s
        self.export_path = export_path
        self.enabled = enabled
        self._current: contextvars.ContextVar[Optional[Span]] = \
            contextvars.ContextVar(f"dyn_trace_{id(self):x}", default=None)
        # finished span dicts awaiting their trace/fragment root, keyed by
        # trace id (bounded: an abandoned trace's buffer is dropped once
        # the buffer table itself outgrows 4x the ring capacity)
        self._live: Dict[str, List[Dict[str, Any]]] = {}
        # finished traces, oldest first (OrderedDict as a ring)
        self._ring: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.dropped_traces = 0     # sampled out or buffer-evicted
        self._last_finalized: Optional[Dict[str, Any]] = None
        # keep-last-K side ring: the most recent finalized traces, kept
        # even when slow-trace sampling (DYN_TRACE_SLOW_S) drops them from
        # the main ring — "the request I JUST sent" stays findable via
        # /v1/traces?request_id= without turning sampling off fleet-wide
        self.keep_last = max(0, _env_int("DYN_TRACE_KEEP_LAST", 64))
        self._keep_last: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._listeners: List[Callable[[Span], None]] = []

    # -- span creation -----------------------------------------------------

    def current_span(self) -> Optional[Span]:
        return self._current.get()

    def current_headers(self) -> Dict[str, Any]:
        """Trace-context headers for an outgoing request from the current
        task context ({} when no span is active or tracing is off)."""
        span = self._current.get()
        if span is None or not self.enabled:
            return {}
        return span.headers()

    def start_span(self, name: str, parent: Optional[Span] = None,
                   attrs: Optional[Dict[str, Any]] = None,
                   current: bool = True):
        """Child of ``parent`` (default: the contextvar current span); a
        fresh root trace when there is no parent."""
        if not self.enabled:
            return NOOP_SPAN
        parent = parent if parent is not None else self._current.get()
        if parent is None:
            span = Span(self, name, _new_trace_id(), None, kind="root",
                        attrs=attrs)
        else:
            span = Span(self, name, parent.trace_id, parent.span_id,
                        attrs=attrs)
        if current:
            span._ctx_token = self._current.set(span)
        return span

    def start_trace(self, name: str,
                    attrs: Optional[Dict[str, Any]] = None,
                    trace_id: Optional[str] = None):
        """Open a new trace root and make it current."""
        if not self.enabled:
            return NOOP_SPAN
        span = Span(self, name, trace_id or _new_trace_id(), None,
                    kind="root", attrs=attrs)
        span._ctx_token = self._current.set(span)
        return span

    def start_hop(self, name: str, headers: Optional[Dict[str, Any]] = None,
                  attrs: Optional[Dict[str, Any]] = None):
        """Server-side span adopting inbound trace context from RPC headers.

        Without inbound context this degrades to a local root — the hop is
        then the head of a process-local trace (still flight-recorded), so
        direct RPC callers get traces too."""
        if not self.enabled:
            return NOOP_SPAN
        headers = headers or {}
        trace_id = headers.get(TRACE_ID_HEADER)
        parent = headers.get(PARENT_SPAN_HEADER)
        if not trace_id:
            span = Span(self, name, _new_trace_id(), None, kind="root",
                        attrs=attrs)
        else:
            span = Span(self, name, str(trace_id),
                        str(parent) if parent else None, kind="hop",
                        attrs=attrs)
        span._ctx_token = self._current.set(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None,
             parent: Optional[Span] = None) -> Iterator[Span]:
        sp = self.start_span(name, parent=parent, attrs=attrs)
        try:
            yield sp
        except BaseException as e:
            sp.set_error(repr(e))
            raise
        finally:
            sp.finish()

    def record(self, name: str, start_unix: float, end_unix: float,
               parent: Optional[Span] = None,
               attrs: Optional[Dict[str, Any]] = None):
        """Retroactive span from already-measured wall-clock stamps (the
        engine reports queue/prefill boundaries after the fact)."""
        if not self.enabled:
            return NOOP_SPAN
        parent = parent if parent is not None else self._current.get()
        if parent is None:
            return NOOP_SPAN  # a dangling retroactive span stitches nowhere
        span = Span(self, name, parent.trace_id, parent.span_id, attrs=attrs)
        span.start_unix = float(start_unix)
        span.finish(end_unix=max(float(start_unix), float(end_unix)))
        return span

    # -- listeners (stage histograms hook in here) -------------------------

    def add_listener(self, fn: Callable[[Span], None]) -> None:
        """``fn(span)`` fires for every LOCALLY-finished span (adopted
        remote spans don't re-fire — each process reports its own time)."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Span], None]) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    # -- finish / adoption / finalize --------------------------------------

    def _on_span_finished(self, span: Span) -> None:
        if span._ctx_token is not None:
            try:
                self._current.reset(span._ctx_token)
            except ValueError:
                # finished from a different context (e.g. a generator's
                # finally running in another task): just clear by best effort
                pass
            span._ctx_token = None
        for fn in list(self._listeners):
            try:
                fn(span)
            except Exception:
                logger.exception("trace span listener failed")
        if span.kind in ("root", "hop"):
            self._finalize(span)
        else:
            self._buffer(span.to_dict())

    def adopt(self, span_dicts: Any) -> None:
        """Merge finished spans shipped from a remote process into this
        trace's pending buffer (they finalize with the local root/hop)."""
        if not self.enabled or not isinstance(span_dicts, list):
            return
        for d in span_dicts:
            if isinstance(d, dict) and d.get("trace_id"):
                d = dict(d)
                d["remote"] = True
                self._buffer(d)

    def finish_hop(self, span: Span) -> List[Dict[str, Any]]:
        """Finish a hop span and return every span of its trace finished or
        adopted in this process — the payload a server handler ships back on
        its final response frame (``SPANS_FRAME_KEY``)."""
        if isinstance(span, _NoopSpan):
            return []
        trace_id = span.trace_id
        span.finish()  # finalizes the local fragment (ring per sampling)
        rec = self._last_finalized
        if rec is not None and rec["trace_id"] == trace_id:
            # even when the local SAMPLING dropped the fragment, the caller
            # still gets the full span set — its sampling decision is its own
            return list(rec["spans"])
        return [span.to_dict()]

    def _buffer(self, d: Dict[str, Any]) -> None:
        self._live.setdefault(d["trace_id"], []).append(d)
        if len(self._live) > 4 * self.capacity:
            # abandoned traces (root never finished — e.g. a crashed peer's
            # shipped fragment): drop the oldest buffer
            self._live.pop(next(iter(self._live)), None)
            self.dropped_traces += 1

    def _finalize(self, root: Span) -> None:
        spans = self._live.pop(root.trace_id, [])
        spans.append(root.to_dict())
        spans.sort(key=lambda s: s.get("start_unix") or 0.0)
        errored = any(s.get("status") == "error" for s in spans)
        record = {
            "trace_id": root.trace_id,
            "name": root.name,
            "service": self.service,
            "request_id": root.attrs.get("request_id", ""),
            "start_unix": root.start_unix,
            "duration_s": round(root.duration_s, 9),
            "error": errored,
            "spans": spans,
        }
        self._last_finalized = record
        if self.keep_last:
            # before the sampling decision: fast traces stay findable
            self._keep_last.pop(root.trace_id, None)
            self._keep_last[root.trace_id] = record
            while len(self._keep_last) > self.keep_last:
                self._keep_last.popitem(last=False)
        if self.slow_s > 0 and root.duration_s < self.slow_s and not errored:
            self.dropped_traces += 1
            return
        # re-finalizing the same trace id (two hops of one trace through
        # the same process) merges into one record
        prev = self._ring.pop(root.trace_id, None)
        if prev is not None:
            seen = {s.get("span_id") for s in prev["spans"]}
            record["spans"] = prev["spans"] + [
                s for s in spans if s.get("span_id") not in seen]
            record["spans"].sort(key=lambda s: s.get("start_unix") or 0.0)
            record["duration_s"] = max(prev["duration_s"],
                                       record["duration_s"])
            record["error"] = record["error"] or prev["error"]
        self._ring[root.trace_id] = record
        while len(self._ring) > self.capacity:
            self._ring.popitem(last=False)
        if self.export_path:
            try:
                with open(self.export_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            except OSError:
                logger.warning("trace export to %s failed; disabling export",
                               self.export_path, exc_info=True)
                self.export_path = ""

    # -- flight-recorder queries (the /v1/traces surface) ------------------

    def traces(self, limit: int = 50, offset: int = 0,
               request_id: str = "") -> Dict[str, Any]:
        """Newest-first summaries with offset pagination; ``request_id``
        filters by exact request id across BOTH the main ring and the
        keep-last ring (so sampled-out fast traces are still findable)."""
        limit = max(1, min(int(limit), self.capacity))
        offset = max(0, int(offset))
        all_traces = list(reversed(self._ring.values()))
        if request_id:
            seen = {t["trace_id"] for t in all_traces}
            all_traces += [t for t in reversed(self._keep_last.values())
                           if t["trace_id"] not in seen]
            all_traces = [t for t in all_traces
                          if t.get("request_id") == request_id]
        page = all_traces[offset:offset + limit]
        return {
            "total": len(all_traces),
            "offset": offset,
            "limit": limit,
            "traces": [{
                "trace_id": t["trace_id"],
                "name": t["name"],
                "request_id": t.get("request_id", ""),
                "start_unix": t["start_unix"],
                "duration_s": t["duration_s"],
                "error": t["error"],
                "num_spans": len(t["spans"]),
            } for t in page],
        }

    def get_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        rec = self._ring.get(trace_id)
        return rec if rec is not None else self._keep_last.get(trace_id)

    def clear(self) -> None:
        self._ring.clear()
        self._keep_last.clear()
        self._live.clear()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        logger.warning("malformed %s=%r; using %d", name,
                       os.environ.get(name), default)
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        logger.warning("malformed %s=%r; using %s", name,
                       os.environ.get(name), default)
        return default


# ---------------------------------------------------------------------------
# Process-global tracer
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The process tracer (created lazily so env knobs set before first use
    take effect; tests may swap it with ``set_tracer``)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    global _tracer
    _tracer = tracer


class StageStitcher:
    """Turns an engine output stream's first-frame ``timings`` stamps into
    ``queue``/``prefill`` spans and the tail into a ``decode`` span — the one
    shared stitching for the worker handler (llm/register.engine_handler)
    and the in-process engine sink (llm/operators.engine_sink), so the
    per-stage breakdown is identical on every topology."""

    def __init__(self, tracer: Tracer, parent=None,
                 skip_decode: bool = False):
        self.tracer = tracer
        self.parent = parent
        self.skip_decode = skip_decode
        self.first_unix: Optional[float] = None
        self._done = False
        self.decode_attrs: Optional[dict] = None

    def on_frame(self, out) -> None:
        """Feed every engine frame (duck-typed: .timings/.token_ids)."""
        timings = getattr(out, "timings", None)
        if timings and "decode_steps" in timings:
            # final-frame decode accounting (engine loop): tokens the
            # decode tail produced and the jitted dispatches they cost —
            # a fused multi-step block is ONE dispatch, so
            # steps/dispatches ~= the configured fuse width
            self.decode_attrs = {
                "steps": int(timings["decode_steps"]),
                "dispatches": int(timings["decode_dispatches"])}
            if "multistep_fallbacks" in timings:
                # fused-decode refusals that touched this request (the
                # per-reason breakdown lives on the worker counter
                # dynamo_worker_multistep_fallback_total{reason})
                self.decode_attrs["multistep_fallbacks"] = int(
                    timings["multistep_fallbacks"])
        if timings and "compile_ms" in timings and self.parent is not None:
            # a fresh-jit-bucket compile stalled this request (engine
            # steptrace detection): an event on the hop span so the stall
            # is attributable from the request's own trace, not just the
            # worker-wide compile counter
            self.parent.add_event(
                "xla_compile", ms=round(float(timings["compile_ms"]), 3),
                count=int(timings.get("compile_events", 1)))
        if self.first_unix is not None:
            return
        if not timings:
            return
        now = time.time()
        first = float(timings.get("first_unix", now))
        enq = timings.get("enqueued_unix")
        adm = timings.get("admitted_unix")
        if enq is not None and adm is not None:
            self.tracer.record("queue", float(enq), float(adm),
                               parent=self.parent)
            self.tracer.record("prefill", float(adm), first,
                               parent=self.parent,
                               attrs={"cached_tokens":
                                      timings.get("cached_tokens")}
                               if timings.get("cached_tokens") is not None
                               else None)
        self.first_unix = first

    def close(self) -> None:
        """Stream ended: close the decode stage (first token -> now)."""
        if self._done:
            return
        self._done = True
        if self.first_unix is not None and not self.skip_decode:
            self.tracer.record("decode", self.first_unix, time.time(),
                               parent=self.parent,
                               attrs=self.decode_attrs)


__all__ = [
    "Span",
    "Tracer",
    "StageStitcher",
    "get_tracer",
    "set_tracer",
    "TRACE_ID_HEADER",
    "PARENT_SPAN_HEADER",
    "SPANS_FRAME_KEY",
    "STAGES",
    "NOOP_SPAN",
]
