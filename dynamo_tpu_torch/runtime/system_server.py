"""Per-process system HTTP server: /health, /live, /metrics, /v1/traces.

Parity: reference ``lib/runtime/src/http_server.rs:104-140`` — every process
(worker, frontend, router) can expose a small operational server, enabled by
``DYN_SYSTEM_ENABLED=1`` on port ``DYN_SYSTEM_PORT`` (0 = ephemeral).
Health is endpoint-gated like the reference's ``SystemHealth``: the process
is "ready" once every registered subsystem reports ready.

When constructed with a ``tracer`` (``utils/tracing.Tracer``) the server
also exposes that process's flight recorder: ``GET /v1/traces`` (newest
first, ``?limit=&offset=&request_id=`` pagination/lookup) and
``GET /v1/traces/{trace_id}`` (the full span tree); with a ``steptrace``
(``engine/steptrace.StepRecorder``) it exposes the engine step timeline
on ``GET /v1/steptrace`` — see ``docs/observability.md``.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

from aiohttp import web
from prometheus_client import CollectorRegistry, generate_latest

logger = logging.getLogger(__name__)


def coord_ready_reasons(coord) -> list:
    """Readiness reasons from a control-plane handle — shared between the
    system server and the HTTP frontend so the LB-facing contract cannot
    drift.  ``coord`` is a ``CoordClient`` (ready while its supervised
    connection is up and resynced) or a server-side ``Coordinator`` (ready
    while it is the acting primary); returns [] when ready."""
    if coord is None:
        return []
    connected = getattr(coord, "connected", None)
    if connected is not None:
        return [] if connected else ["coordinator disconnected"]
    if getattr(coord, "role", "primary") != "primary":
        return [f"coordinator role: {coord.role}"]
    return []


class SystemHealth:
    """Named readiness flags; unhealthy until every flag is set."""

    def __init__(self) -> None:
        self._ready: Dict[str, bool] = {}

    def register(self, name: str, ready: bool = False) -> None:
        self._ready[name] = ready

    def set_ready(self, name: str, ready: bool = True) -> None:
        self._ready[name] = ready

    @property
    def healthy(self) -> bool:
        return all(self._ready.values()) if self._ready else True

    def snapshot(self) -> Dict[str, bool]:
        return dict(self._ready)


class SystemServer:
    def __init__(self, health: Optional[SystemHealth] = None,
                 registry: Optional[CollectorRegistry] = None,
                 extra_metrics: Optional[Callable[[], bytes]] = None,
                 host: str = "0.0.0.0", port: int = 0,
                 tracer=None, steptrace=None):
        self.health = health or SystemHealth()
        self.registry = registry
        self.extra_metrics = extra_metrics
        self.tracer = tracer
        self.steptrace = steptrace
        self.host = host
        self.port = port
        self.app = web.Application()
        self.app.router.add_get("/health", self.handle_health)
        self.app.router.add_get("/live", self.handle_live)
        self.app.router.add_get("/healthz", self.handle_live)
        self.app.router.add_get("/healthz/ready", self.handle_ready)
        self.app.router.add_get("/metrics", self.handle_metrics)
        self.app.router.add_get("/v1/traces", self.handle_traces)
        self.app.router.add_get("/v1/traces/{trace_id}", self.handle_trace)
        self.app.router.add_get("/v1/steptrace", self.handle_steptrace)
        self.app.router.add_post("/drain", self.handle_drain)
        # graceful-drain hook (worker/drain.DrainController): POST /drain
        # triggers it; absent on processes with nothing to drain
        self._drain = None
        # control-plane readiness hook: a CoordClient (readiness follows
        # its supervised connection) or an in-process Coordinator
        # (readiness == acting primary)
        self._coord = None
        self._runner: Optional[web.AppRunner] = None

    def register_drain(self, controller) -> None:
        """Expose a ``DrainController`` on ``POST /drain`` (the operator/
        planner-facing trigger next to SIGTERM)."""
        self._drain = controller

    def attach_coord(self, coord) -> None:
        """Gate ``GET /healthz/ready`` on control-plane state: a
        ``CoordClient`` (ready while its supervised connection is up and
        resynced) or a server-side ``Coordinator`` (ready while it is the
        acting primary)."""
        self._coord = coord

    @classmethod
    def from_env(cls, **kwargs) -> Optional["SystemServer"]:
        """None unless DYN_SYSTEM_ENABLED is truthy."""
        if os.environ.get("DYN_SYSTEM_ENABLED", "").lower() not in (
                "1", "true", "yes"):
            return None
        port = int(os.environ.get("DYN_SYSTEM_PORT", "0"))
        return cls(port=port, **kwargs)

    async def start(self) -> "SystemServer":
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for s in self._runner.sites:
            self.port = s._server.sockets[0].getsockname()[1]
        logger.info("system server on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    async def handle_health(self, request: web.Request) -> web.Response:
        ok = self.health.healthy
        return web.json_response(
            {"status": "healthy" if ok else "unhealthy",
             "subsystems": self.health.snapshot()},
            status=200 if ok else 503)

    async def handle_live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def handle_ready(self, request: web.Request) -> web.Response:
        """Readiness (vs. /healthz liveness): 503 while the control-plane
        connection is down, during a drain, or while a registered
        subsystem is not ready — so load balancers stop routing new work
        into an outage instead of eating 5xx storms.  The process stays
        LIVE (200 on /healthz) the whole time: killing it would only turn
        a reconnect into a cold start."""
        reasons = coord_ready_reasons(self._coord)
        if self._drain is not None and self._drain.draining:
            reasons.append(f"draining ({self._drain.state})")
        if not self.health.healthy:
            reasons.append("subsystems not ready")
        ready = not reasons
        return web.json_response(
            {"ready": ready, "reasons": reasons,
             "subsystems": self.health.snapshot()},
            status=200 if ready else 503)

    async def handle_metrics(self, request: web.Request) -> web.Response:
        body = b""
        if self.registry is not None:
            body += generate_latest(self.registry)
        if self.extra_metrics is not None:
            body += self.extra_metrics()
        return web.Response(body=body, content_type="text/plain")

    async def handle_drain(self, request: web.Request) -> web.Response:
        if self._drain is None:
            return web.json_response(
                {"error": "this process has no drainable endpoint"},
                status=404)
        # fire-and-return: the drain (freeze + lease-ack wait) can take up
        # to DYN_DRAIN_TIMEOUT_S — the caller polls state via repeat POSTs
        # or the dynamo_worker_drain_state gauge
        self._drain.trigger("POST /drain")
        return web.json_response({"state": self._drain.state,
                                  "counts": self._drain.counts})

    async def handle_traces(self, request: web.Request) -> web.Response:
        return trace_list_response(self.tracer, request)

    async def handle_trace(self, request: web.Request) -> web.Response:
        return trace_get_response(self.tracer,
                                  request.match_info["trace_id"])

    async def handle_steptrace(self, request: web.Request) -> web.Response:
        return steptrace_response(self.steptrace, request)


def trace_list_response(tracer, request: web.Request) -> web.Response:
    """``GET /v1/traces`` body from a flight recorder — shared between the
    system server and the HTTP frontend so the surface cannot drift."""
    if tracer is None:
        return web.json_response(
            {"error": "tracing is not enabled on this process"}, status=404)
    try:
        limit = int(request.query.get("limit", "50"))
        offset = int(request.query.get("offset", "0"))
    except ValueError:
        return web.json_response(
            {"error": "limit/offset must be integers"}, status=400)
    return web.json_response(tracer.traces(
        limit=limit, offset=offset,
        request_id=request.query.get("request_id", "")))


def steptrace_response(recorder, request: web.Request) -> web.Response:
    """``GET /v1/steptrace`` body from an engine step flight recorder
    (``engine/steptrace.StepRecorder``): newest-first StepRecords with
    ``?limit=&offset=`` pagination."""
    if recorder is None:
        return web.json_response(
            {"error": "step tracing is not enabled on this process"},
            status=404)
    try:
        limit = int(request.query.get("limit", "100"))
        offset = int(request.query.get("offset", "0"))
    except ValueError:
        return web.json_response(
            {"error": "limit/offset must be integers"}, status=400)
    return web.json_response(recorder.snapshot(limit=limit, offset=offset))


def trace_get_response(tracer, trace_id: str) -> web.Response:
    if tracer is None:
        return web.json_response(
            {"error": "tracing is not enabled on this process"}, status=404)
    record = tracer.get_trace(trace_id)
    if record is None:
        return web.json_response(
            {"error": f"no such trace: {trace_id} (evicted or sampled "
                      "out of the flight recorder)"}, status=404)
    return web.json_response(record)


__all__ = ["SystemServer", "SystemHealth", "coord_ready_reasons",
           "trace_list_response", "trace_get_response",
           "steptrace_response"]
