"""Streaming RPC data plane: direct duplex TCP between callers and workers.

The reference splits the data plane: requests ride NATS to the worker's service
subject, and the worker dials back a raw TCP stream for the response
(``lib/runtime/src/pipeline/network/egress/addressed_router.rs:86-161``,
``ingress/push_handler.rs:25-133``).  That split exists because NATS provides
the discovery/queueing.  Here discovery comes from the coordinator, so we use
one duplex TCP connection per (caller, worker) pair and multiplex many
concurrent request streams over it with stream ids — fewer hops, same
semantics: a request frame out, a stream of response frames back, terminated by
a ``final`` sentinel (the sentinel is how stream-drop faults are detected:
missing ``final`` == "stream ended before generation completed").

Server side: ``RpcServer`` hosts named endpoints.  A handler is an async
callable ``handler(payload, ctx) -> AsyncIterator[Any]``; whatever it yields is
msgpack-framed back.  Cancellation: callers send a ``cancel`` frame; the
handler's task is cancelled and ``ctx.cancelled`` is set (parity with
``AsyncEngineContext.stop_generating``, reference ``lib/runtime/src/engine.rs``).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional

from dynamo_tpu_torch.runtime.codec import Raw, read_frame, send_frame
from dynamo_tpu_torch.utils.aio import reap_task
from dynamo_tpu_torch.utils.tracing import get_tracer

logger = logging.getLogger(__name__)

Handler = Callable[[Any, "RequestContext"], AsyncIterator[Any]]

# Keepalive health probing defaults (gRPC-style: any inbound frame counts as
# liveness proof; pings only generate traffic when the connection is quiet).
# A worker that is alive-but-stuck — engine deadlock, GC pause, network
# partition with the TCP connection still open — never closes its socket, so
# stream-drop detection alone hangs callers forever.  The ping loop bounds
# that: after ``interval * miss_budget`` seconds of silence the connection is
# torn down and every in-flight stream takes the existing ``drop`` path.
# Defaults layer: RuntimeConfig (dataclass -> TOML -> DYN_RUNTIME_* env),
# then the short-form DYN_KEEPALIVE_* env wins.  Resolved lazily (at pool
# construction, not import) so programmatic/monkeypatched env changes take
# effect and importing this module never does TOML file I/O.
def keepalive_defaults() -> "tuple[float, int]":
    interval, budget = 5.0, 3
    try:
        from dynamo_tpu_torch.utils.config import RuntimeConfig
        cfg = RuntimeConfig.load()
        interval, budget = cfg.keepalive_interval_s, cfg.keepalive_miss_budget
    except Exception:  # a bad TOML/env must not break connection setup
        logger.warning("bad runtime config; keepalive falls back to "
                       "%.1fs x %d", interval, budget, exc_info=True)
    # short-form env strings need coercion (RuntimeConfig.load already
    # type-coerces its own sources); fall back per-value so one bad knob
    # doesn't discard the other's configured value
    raw_interval = os.environ.get("DYN_KEEPALIVE_INTERVAL")
    raw_budget = os.environ.get("DYN_KEEPALIVE_MISS_BUDGET")
    try:
        interval = float(raw_interval) if raw_interval is not None else interval
    except (TypeError, ValueError):
        logger.warning("malformed DYN_KEEPALIVE_INTERVAL %r; using %.1fs",
                       raw_interval, interval)
    try:
        budget = int(raw_budget) if raw_budget is not None else budget
    except (TypeError, ValueError):
        logger.warning("malformed DYN_KEEPALIVE_MISS_BUDGET %r; using %d",
                       raw_budget, budget)
    return interval, budget

# Wire header carrying the request deadline (absolute unix seconds, caller's
# clock — same-DC clock skew is far below useful deadline granularity).
DEADLINE_HEADER = "deadline_unix"
# Wire header carrying the frontend-minted request id: every hop propagates
# it (router sink, disagg forwards) instead of synthesizing a stream-local
# one, so one id follows the request across processes and into logs.
REQUEST_ID_HEADER = "request_id"


def request_headers(deadline_unix: Optional[float] = None,
                    request_id: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Optional[Dict[str, Any]]:
    """RPC headers for one hop: deadline + request id (+ extras); None when
    empty.  The one place the wire shape of request-metadata propagation is
    written down — every hop builds its headers here.  Trace context
    (``trace_id``/``parent_span_id``) is NOT added here: the connection
    injects it from the ambient span at send time (see ``request``)."""
    h: Dict[str, Any] = {}
    if deadline_unix is not None:
        h[DEADLINE_HEADER] = deadline_unix
    if request_id:
        h[REQUEST_ID_HEADER] = request_id
    if extra:
        h.update(extra)
    return h or None


def deadline_headers(deadline_unix: Optional[float]) -> Optional[Dict[str, Any]]:
    """Back-compat shim: headers carrying only a deadline."""
    return request_headers(deadline_unix=deadline_unix)


class StreamEndedError(ConnectionError):
    """Response stream dropped before the final sentinel arrived.

    The migration operator keys on this (reference ``lib/llm/src/migration.rs``:
    "Stream ended before generation completed")."""


class StreamMigrationSignal(Exception):
    """Raised by a handler to end its stream WITHOUT a final sentinel.

    The server answers with an explicit ``drop`` frame, so the caller's
    ``ResponseStream`` raises ``StreamEndedError`` immediately — the same
    stream-failover path a crashed worker triggers via connection teardown,
    minus the keepalive detection delay. A draining worker uses this to
    hand its in-flight streams to the migration operator on purpose (after
    shipping a resume token as the last data frame)."""


class DeadlineExceededError(TimeoutError):
    """The request's end-to-end deadline passed before the stream finished.

    Deliberately NOT a ConnectionError subclass: the migration operator
    replays on connection-shaped failures, and an expired request must not
    be replayed onto another worker nobody is waiting for."""


@dataclass
class RequestContext:
    """Per-request context passed to endpoint handlers."""

    request_id: str
    endpoint: str
    headers: Dict[str, Any] = field(default_factory=dict)
    # absolute unix-seconds deadline propagated from the caller (``req``
    # frame header); None = no deadline
    deadline_unix: Optional[float] = None
    _cancel_event: asyncio.Event = field(default_factory=asyncio.Event)

    @property
    def cancelled(self) -> bool:
        return self._cancel_event.is_set()

    @property
    def deadline_expired(self) -> bool:
        return self.deadline_unix is not None and time.time() >= self.deadline_unix

    def time_remaining(self) -> Optional[float]:
        """Seconds until the deadline (negative if past); None = no deadline."""
        if self.deadline_unix is None:
            return None
        return self.deadline_unix - time.time()

    def cancel(self) -> None:
        self._cancel_event.set()

    async def wait_cancelled(self) -> None:
        await self._cancel_event.wait()


@dataclass
class EndpointStats:
    """Per-endpoint counters, scraped via the ``__stats__`` builtin endpoint
    (parity: NATS ``$SRV.STATS`` scraping, reference ``metrics_aggregator.rs``)."""

    requests: int = 0
    active: int = 0
    errors: int = 0
    data: Dict[str, Any] = field(default_factory=dict)  # custom stats-handler payload


class RpcServer:
    """Hosts endpoint handlers on one TCP listen port per process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: Dict[str, Handler] = {}
        self._stats: Dict[str, EndpointStats] = {}
        self._stats_providers: Dict[str, Callable[[], Any]] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._active_tasks: set = set()
        self._conn_writers: set = set()

    def register(self, endpoint: str, handler: Handler,
                 stats_provider: Optional[Callable[[], Any]] = None) -> None:
        self._handlers[endpoint] = handler
        self._stats.setdefault(endpoint, EndpointStats())
        if stats_provider is not None:
            self._stats_providers[endpoint] = stats_provider

    def unregister(self, endpoint: str) -> None:
        self._handlers.pop(endpoint, None)
        self._stats_providers.pop(endpoint, None)

    def stats(self, endpoint: str) -> EndpointStats:
        return self._stats.setdefault(endpoint, EndpointStats())

    async def start(self) -> "RpcServer":
        # 16 MiB stream buffers: KV-block frames are tens of MB; the 64 KiB
        # default limit makes readexactly drain them in tiny wakeups
        # (measured 0.9 -> multi-GB/s loopback with the larger window)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=16 * 1024 * 1024)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server:
            self._server.close()
        # never cancel/await the task calling stop() (a handler may trigger
        # shutdown of its own server) — that would self-cancel forever
        cur = asyncio.current_task()
        tasks = [t for t in self._active_tasks if t is not cur]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        # close live connections BEFORE wait_closed: since py3.12 wait_closed
        # blocks until every connection handler returns
        for w in list(self._conn_writers):
            try:
                w.close()
            except Exception:
                pass
        if self._server:
            await self._server.wait_closed()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        wlock = asyncio.Lock()
        streams: Dict[int, RequestContext] = {}
        stream_tasks: Dict[int, asyncio.Task] = {}
        self._conn_writers.add(writer)

        async def send(obj: Any, raw: Any = None) -> None:
            async with wlock:
                await send_frame(writer, obj, raw)

        async def pong(rid: Any) -> None:
            try:
                await send({"op": "pong", "rid": rid})
            except (ConnectionError, RuntimeError):
                pass  # peer vanished; the read loop will notice

        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                op = frame.get("op")
                if op == "req":
                    sid = frame["sid"]
                    headers = frame.get("headers", {}) or {}
                    deadline = headers.get(DEADLINE_HEADER)
                    try:
                        deadline = (float(deadline)
                                    if deadline is not None else None)
                    except (TypeError, ValueError):
                        # a malformed header must fail open (no deadline),
                        # not unwind the read loop and kill every stream
                        # multiplexed on this connection
                        logger.warning("ignoring malformed %s header %r",
                                       DEADLINE_HEADER, deadline)
                        deadline = None
                    ctx = RequestContext(
                        # the frontend-minted id propagated in headers; the
                        # stream-local sid is only a last-resort fallback
                        # for callers that sent no id at all
                        request_id=headers.get(REQUEST_ID_HEADER, str(sid)),
                        endpoint=frame["endpoint"],
                        headers=headers,
                        deadline_unix=deadline,
                    )
                    streams[sid] = ctx
                    task = asyncio.create_task(
                        self._run_stream(send, sid, ctx, frame.get("payload")))
                    self._active_tasks.add(task)
                    stream_tasks[sid] = task
                    task.add_done_callback(self._active_tasks.discard)
                    task.add_done_callback(lambda _t, s=sid: streams.pop(s, None))
                    task.add_done_callback(lambda _t, s=sid: stream_tasks.pop(s, None))
                elif op == "cancel":
                    # cooperative signal first (handlers can flush/cleanup via
                    # ctx.cancelled), then hard-cancel so a handler blocked in
                    # an await can't leak the stream slot forever
                    ctx = streams.get(frame["sid"])
                    if ctx:
                        ctx.cancel()
                    task = stream_tasks.get(frame["sid"])
                    if task is not None:
                        task.cancel()
                elif op == "ping":
                    # answer off the read loop: awaiting the shared wlock
                    # here would park cancel/req processing behind any large
                    # in-flight send — and the cancel path is exactly what a
                    # deadline-expired peer needs processed promptly
                    task = asyncio.create_task(pong(frame.get("rid")))
                    self._active_tasks.add(task)
                    task.add_done_callback(self._active_tasks.discard)
        except ConnectionError:
            pass  # CancelledError must propagate (see utils/aio.reap_task)
        finally:
            self._conn_writers.discard(writer)
            for ctx in streams.values():
                ctx.cancel()
            try:
                writer.close()
            except Exception:
                pass

    async def _run_stream(self, send, sid: int, ctx: RequestContext,
                          payload: Any) -> None:
        name = ctx.endpoint
        if name == "__stats__":
            out = {
                ep: {"requests": st.requests, "active": st.active,
                     "errors": st.errors,
                     "data": (self._stats_providers[ep]()
                              if ep in self._stats_providers else st.data)}
                for ep, st in self._stats.items()
            }
            await send({"op": "data", "sid": sid, "payload": out})
            await send({"op": "final", "sid": sid})
            return
        handler = self._handlers.get(name)
        if handler is None:
            await send({"op": "err", "sid": sid,
                        "error": f"no such endpoint: {name}"})
            return
        st = self.stats(name)
        st.requests += 1
        st.active += 1
        try:
            agen = handler(payload, ctx)
            async for item in agen:
                if ctx.cancelled:
                    await agen.aclose()
                    break
                if isinstance(item, Raw):
                    # bulk binary (KV blocks): metadata in the msgpack part,
                    # bytes as a zero-copy two-part trailer
                    await send({"op": "data", "sid": sid,
                                "payload": item.obj}, raw=item.raw)
                else:
                    await send({"op": "data", "sid": sid, "payload": item})
            await send({"op": "final", "sid": sid})
        except StreamMigrationSignal:
            # deliberate graceful handoff: every data frame (including the
            # migration/resume token) is already on the wire — end the
            # stream abnormally so the caller's migration operator fires
            # NOW instead of waiting out keepalive detection
            try:
                await send({"op": "drop", "sid": sid})
            except Exception:  # noqa: BLE001 — conn gone: drop path anyway
                pass
        except asyncio.CancelledError:
            # caller cancelled (or server stopping): nothing more to send; the
            # client side tears its stream down locally on cancel
            raise
        except (ConnectionError, RuntimeError) as e:
            # connection gone: nothing more to send
            logger.debug("stream %d connection lost: %s", sid, e)
            st.errors += 1
        except Exception as e:
            st.errors += 1
            logger.exception("endpoint %s handler error", name)
            try:
                await send({"op": "err", "sid": sid, "error": str(e)})
            except Exception:
                pass
        finally:
            st.active -= 1


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class ResponseStream:
    """Async iterator over one request's response frames.

    Raises ``StreamEndedError`` if the connection drops before ``final``; a
    server-reported handler error raises ``RuntimeError``; an expired request
    deadline raises ``DeadlineExceededError`` (enforced between frames, so a
    silent worker can't hold a caller past its deadline).
    """

    def __init__(self, conn: "RpcConnection", sid: int,
                 deadline_unix: Optional[float] = None):
        self._conn = conn
        self.sid = sid
        self.deadline_unix = deadline_unix
        self.queue: asyncio.Queue = asyncio.Queue()
        self.finished = False

    def __aiter__(self) -> "ResponseStream":
        return self

    async def __anext__(self) -> Any:
        if self.finished:
            raise StopAsyncIteration
        if self.deadline_unix is None:
            kind, value = await self.queue.get()
        else:
            remaining = self.deadline_unix - time.time()
            try:
                if remaining <= 0:
                    raise asyncio.TimeoutError
                try:
                    # fast path: a frame already queued skips wait_for's
                    # per-token task + timer allocation on the hot path
                    kind, value = self.queue.get_nowait()
                except asyncio.QueueEmpty:
                    kind, value = await asyncio.wait_for(self.queue.get(),
                                                         timeout=remaining)
            except asyncio.TimeoutError:
                # raise AT the deadline: the cancel frame is sent in the
                # background (send_cancel can wait seconds on a writer lock
                # wedged by the very connection that went silent)
                self.finished = True
                self._conn._streams.pop(self.sid, None)
                self._conn.spawn_cancel(self.sid)
                while not self.queue.empty():
                    self.queue.get_nowait()
                raise DeadlineExceededError(
                    "request deadline exceeded mid-stream") from None
        if kind == "data":
            return value
        self.finished = True
        self._conn._streams.pop(self.sid, None)
        if kind == "final":
            raise StopAsyncIteration
        if kind == "err":
            raise RuntimeError(value)
        raise StreamEndedError("stream ended before generation completed")

    async def cancel(self) -> None:
        """Tell the worker to stop and finish this stream locally (the worker
        may be hard-cancelled mid-await and never send a final frame).

        Idempotent: a second cancel (or one on an already-finished stream) is
        a no-op, and queued frames are drained so a late ``drop`` sentinel
        can't leak into a reused sid map."""
        if self.finished:
            return
        self.finished = True
        self._conn._streams.pop(self.sid, None)
        await self._conn.send_cancel(self.sid)
        while not self.queue.empty():
            self.queue.get_nowait()


class RpcConnection:
    """One multiplexed duplex connection to a worker's RpcServer.

    ``keepalive_interval > 0`` arms a ping loop: when nothing (data, pong,
    anything) has arrived for ``keepalive_interval * keepalive_miss_budget``
    seconds the connection is torn down — in-flight streams get the ``drop``
    sentinel (so migration/failover fire exactly as for a crashed worker) and
    ``on_unexpected_close`` is invoked (the pool uses it to notify clients so
    the instance is marked down)."""

    def __init__(self, address: str, keepalive_interval: float = 0.0,
                 keepalive_miss_budget: int = 3):
        host, _, port = address.rpartition(":")
        self.address = address
        self.host, self.port = host or "127.0.0.1", int(port)
        self.keepalive_interval = keepalive_interval
        self.keepalive_miss_budget = max(1, keepalive_miss_budget)
        self._sids = itertools.count(1)
        self._streams: Dict[int, ResponseStream] = {}
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._wlock: Optional[asyncio.Lock] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._ping_task: Optional[asyncio.Task] = None
        self._bg_tasks: set = set()  # fire-and-forget cancels (spawn_cancel)
        self._last_seen = 0.0  # loop time of the last inbound frame
        self._closing = False  # explicit close() — don't fire death callbacks
        self.keepalive_expired = False
        # fired (synchronously, once) when the connection dies without an
        # explicit close(): conn drop OR keepalive miss-budget exhaustion
        self.on_unexpected_close: Optional[Callable[["RpcConnection"], None]] = None
        self.alive = False

    async def connect(self) -> "RpcConnection":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=16 * 1024 * 1024)
        self._wlock = asyncio.Lock()
        self._last_seen = asyncio.get_running_loop().time()
        self._reader_task = asyncio.create_task(self._read_loop())
        if self.keepalive_interval > 0:
            self._ping_task = asyncio.create_task(self._ping_loop())
        self.alive = True
        return self

    async def close(self) -> None:
        self.alive = False
        self._closing = True
        cur = asyncio.current_task()
        if self._ping_task is not None and self._ping_task is not cur:
            await reap_task(self._ping_task)
        await reap_task(self._reader_task)
        for task in list(self._bg_tasks):
            await reap_task(task)
        self._bg_tasks.clear()
        if self._writer:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass

    async def _ping_loop(self) -> None:
        """Probe a quiet connection; kill it when the miss budget is
        exhausted.  Any inbound frame resets the silence clock, so a healthy
        connection under load never pays for pongs it doesn't need, and a
        connection is only ever torn down after a probe sent SINCE the last
        inbound frame went unanswered (so even miss_budget=1 can't expire a
        healthy idle connection that was never probed).

        Caveat: inbound liveness is credited per COMPLETE frame, so on links
        where a single RPC-plane frame can take longer than
        ``interval * miss_budget`` to arrive (bulk KV riding the RPC
        fallback cross-host), size the budget above the worst-case frame
        time or disable probing for that pool.  The outbound analogue is
        handled below: a probe that can't be written because a large send
        holds the writer only counts as missed when the transport's write
        buffer is NOT draining (a frozen peer stops draining it; a slow
        healthy one keeps consuming)."""
        loop = asyncio.get_running_loop()
        rids = itertools.count(1)
        budget_s = self.keepalive_interval * self.keepalive_miss_budget
        last_ping = 0.0  # loop time of the newest (attempted) probe
        last_buf: Optional[int] = None  # write-buffer size at last miss
        while True:
            await asyncio.sleep(self.keepalive_interval)
            now = loop.time()
            silent_for = now - self._last_seen
            if silent_for >= budget_s and last_ping > self._last_seen:
                logger.warning(
                    "rpc connection %s silent for %.2fs (keepalive budget "
                    "%.2fs): tearing down", self.address, silent_for, budget_s)
                self.keepalive_expired = True
                self._abort()
                return
            if silent_for < self.keepalive_interval / 2:
                last_buf = None
                continue  # recent traffic proves liveness — no probe needed
            try:
                # bound the probe: _wlock may be held by a request blocked
                # in drain() against a peer that stopped reading — waiting
                # on it unbounded would starve the budget check above and
                # defeat frozen-worker detection exactly when it matters
                await asyncio.wait_for(self._send_ping(next(rids)),
                                       timeout=self.keepalive_interval)
                last_ping = now
                last_buf = None
            except asyncio.TimeoutError:
                # probe blocked behind a large in-flight send: only count
                # it as missed when the peer isn't draining our bytes
                buf = self._write_buffer_size()
                if buf is not None and last_buf is not None and buf < last_buf:
                    self._last_seen = now  # peer is consuming: alive
                else:
                    last_ping = now
                last_buf = buf
            except (ConnectionError, RuntimeError):
                self._abort()
                return

    def _write_buffer_size(self) -> Optional[int]:
        try:
            return self._writer.transport.get_write_buffer_size()
        except Exception:
            return None

    async def _send_ping(self, rid: int) -> None:
        async with self._wlock:
            await send_frame(self._writer, {"op": "ping", "rid": rid})

    def _abort(self) -> None:
        """Tear down from inside the connection's own tasks: cancelling the
        reader fires its ``finally`` (drop sentinels + death callback)."""
        self.alive = False
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass

    async def _read_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    break
                self._last_seen = loop.time()
                op = frame.get("op")
                if op == "pong":
                    continue
                sid = frame.get("sid")
                stream = self._streams.get(sid)
                if stream is None:
                    continue
                if op == "data":
                    payload = frame.get("payload")
                    if "_raw" in frame and isinstance(payload, dict):
                        # two-part frame: surface the raw trailer inside the
                        # payload the handler yielded it with
                        payload["_raw"] = frame["_raw"]
                    stream.queue.put_nowait(("data", payload))
                elif op == "final":
                    stream.queue.put_nowait(("final", None))
                elif op == "err":
                    stream.queue.put_nowait(("err", frame.get("error")))
                elif op == "drop":
                    # server-initiated graceful stream handoff (worker
                    # drain): same terminal state as a dropped connection,
                    # scoped to one stream
                    stream.queue.put_nowait(("drop", None))
                    self._streams.pop(sid, None)
        except ConnectionError:
            pass  # CancelledError must propagate (see utils/aio.reap_task)
        finally:
            self.alive = False
            for stream in list(self._streams.values()):
                stream.queue.put_nowait(("drop", None))
            self._streams.clear()
            if not self._closing and self.on_unexpected_close is not None:
                cb, self.on_unexpected_close = self.on_unexpected_close, None
                try:
                    cb(self)
                except Exception:
                    logger.exception("connection death callback failed")

    async def request(self, endpoint: str, payload: Any,
                      headers: Optional[Dict[str, Any]] = None) -> ResponseStream:
        if not self.alive:
            raise ConnectionError(f"connection to {self.address} is down")
        # trace context rides EVERY hop automatically: the caller's current
        # span (contextvar) becomes the remote hop's parent, so router,
        # disagg, and aux forwards stitch without per-call-site wiring
        trace_ctx = get_tracer().current_headers()
        if trace_ctx:
            merged = dict(trace_ctx)
            merged.update(headers or {})
            headers = merged
        sid = next(self._sids)
        deadline = (headers or {}).get(DEADLINE_HEADER)
        stream = ResponseStream(
            self, sid,
            deadline_unix=float(deadline) if deadline is not None else None)
        self._streams[sid] = stream
        try:
            async with self._wlock:
                await send_frame(self._writer, {
                    "op": "req", "sid": sid, "endpoint": endpoint,
                    "payload": payload, "headers": headers or {}})
        except (ConnectionError, RuntimeError) as e:
            self._streams.pop(sid, None)
            self.alive = False
            raise ConnectionError(str(e)) from e
        return stream

    def spawn_cancel(self, sid: int) -> None:
        """Fire-and-forget cancel frame, tracked so it is reaped at close
        (used by the deadline path, which must not block on the writer)."""
        task = asyncio.ensure_future(self.send_cancel(sid))
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def send_cancel(self, sid: int) -> None:
        if not self.alive:
            return
        try:
            # best-effort and BOUNDED: _wlock may be held by a send blocked
            # against a stuck peer, and cancel rides the deadline path —
            # which must never wait on the very connection that's wedged
            # (keepalive will tear it down)
            await asyncio.wait_for(self._send_cancel(sid), timeout=5.0)
        except asyncio.TimeoutError:
            pass
        except (ConnectionError, RuntimeError):
            self.alive = False

    async def _send_cancel(self, sid: int) -> None:
        async with self._wlock:
            await send_frame(self._writer, {"op": "cancel", "sid": sid})


class RpcClientPool:
    """Connection pool: one live RpcConnection per worker address.

    Every pooled connection runs the keepalive ping loop (interval 0
    disables).  When a connection dies without an explicit ``drop`` — remote
    crash or keepalive expiry — registered down-listeners are notified with
    the address, so endpoint clients can mark the backing instance down ahead
    of lease expiry (frozen-worker detection as fast as crashed-worker
    detection)."""

    def __init__(self, keepalive_interval: Optional[float] = None,
                 keepalive_miss_budget: Optional[int] = None) -> None:
        default_interval, default_budget = keepalive_defaults()
        self.keepalive_interval = (keepalive_interval
                                   if keepalive_interval is not None
                                   else default_interval)
        self.keepalive_miss_budget = (keepalive_miss_budget
                                      if keepalive_miss_budget is not None
                                      else default_budget)
        self._conns: Dict[str, RpcConnection] = {}
        self._locks: Dict[str, asyncio.Lock] = {}
        self._down_listeners: List[Callable[[str], None]] = []
        self._close_tasks: set = set()

    def add_down_listener(self, cb: Callable[[str], None]) -> None:
        """``cb(address)`` fires when a pooled connection dies unexpectedly."""
        self._down_listeners.append(cb)

    def remove_down_listener(self, cb: Callable[[str], None]) -> None:
        try:
            self._down_listeners.remove(cb)
        except ValueError:
            pass

    async def get(self, address: str) -> RpcConnection:
        conn = self._conns.get(address)
        if conn is not None and conn.alive:
            return conn
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and conn.alive:
                return conn
            conn = RpcConnection(
                address, keepalive_interval=self.keepalive_interval,
                keepalive_miss_budget=self.keepalive_miss_budget)
            conn.on_unexpected_close = self._conn_died
            await conn.connect()
            self._conns[address] = conn
            return conn

    def _conn_died(self, conn: RpcConnection) -> None:
        if self._conns.get(conn.address) is conn:
            self._conns.pop(conn.address, None)
        for cb in list(self._down_listeners):
            try:
                cb(conn.address)
            except Exception:
                logger.exception("pool down-listener failed for %s",
                                 conn.address)

    def drop(self, address: str) -> None:
        conn = self._conns.pop(address, None)
        if conn is not None:
            conn.on_unexpected_close = None  # explicit drop, not a death
            # track the close task: an unreferenced ensure_future can be
            # GC'd mid-flight and swallows exceptions silently
            task = asyncio.ensure_future(conn.close())
            self._close_tasks.add(task)
            task.add_done_callback(self._reap_close)

    def _reap_close(self, task: asyncio.Task) -> None:
        self._close_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.warning("pooled connection close failed: %r",
                           task.exception())

    async def close(self) -> None:
        for conn in list(self._conns.values()):
            conn.on_unexpected_close = None
            await conn.close()
        self._conns.clear()
        if self._close_tasks:
            await asyncio.gather(*list(self._close_tasks),
                                 return_exceptions=True)


__all__ = [
    "RpcServer",
    "RpcConnection",
    "RpcClientPool",
    "ResponseStream",
    "RequestContext",
    "StreamEndedError",
    "StreamMigrationSignal",
    "DeadlineExceededError",
    "EndpointStats",
    "Handler",
    "DEADLINE_HEADER",
    "REQUEST_ID_HEADER",
    "deadline_headers",
    "request_headers",
    "keepalive_defaults",
]
