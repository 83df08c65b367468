"""Bulk data plane: raw-socket block transfer beside the RPC plane.

The reference moves KV blocks on a DEDICATED transport (NIXL RDMA —
``lib/llm/src/block_manager/block/transfer/nixl.rs``, the ``nixl_connect``
SDK) rather than its NATS/TCP request plane, because request-plane framing
tops out far below link speed. The same is true here: asyncio stream
framing measures ~1.5 GB/s on loopback while plain sockets do ~6 GB/s. So
bulk KV bytes get their own tiny protocol on blocking sockets in worker
threads, and the RPC plane keeps carrying control traffic.

Protocol (all integers big-endian):

  request:   [u32 len][msgpack {"endpoint": str, "payload": any}]
  response:  frames of [u32 meta_len][msgpack meta][u32 raw_len][raw bytes]
             until a frame whose meta has "final": true (raw_len 0).
             Handler errors arrive as meta {"error": str}.

A server handler is a SYNCHRONOUS callable ``handler(payload) ->
Iterable[(meta_dict, buffer_or_None)]`` run in the connection's thread;
use ``asyncio.run_coroutine_threadsafe`` inside the handler to coordinate
with an event loop (the KV exporter does, via ``engine.run_exclusive``).

The receive side reads raw bytes with ``recv_into`` straight into one
preallocated buffer per frame — one copy off the kernel, no reassembly.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from dynamo_tpu_torch.runtime.codec import (
    MAX_FRAME,
    byte_view,
    buf_get as _buf_get,
    pack,
    release_buffer,
    unpack,
)

logger = logging.getLogger(__name__)

_U32 = struct.Struct(">I")

BulkHandler = Callable[[Any], Iterable[Tuple[Dict[str, Any], Optional[Any]]]]

# Explicit socket buffer sizing, both ends: kernel autotuning starts tiny
# and takes tens of MB to ramp (the cold-connection penalty measured
# below); asking for generous buffers up front starts the connection near
# its steady rate. Best-effort — a kernel may clamp (rmem_max/wmem_max).
_SOCK_BUF_BYTES = 8 * 1024 * 1024


def _tune_socket(s: socket.socket) -> None:
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF_BYTES)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF_BYTES)
    except OSError:
        pass
    if s.family != socket.AF_UNIX:  # TCP of either family
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # pooled connections sit idle between fetches: OS keepalive
            # probes keep NAT/conntrack state alive and surface a dead
            # peer as a pool-eviction instead of a stalled fetch
            s.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        except OSError:
            pass


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("bulk peer closed mid-frame")
        got += r


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


# sanity cap on msgpack meta parts: metas are block lists + a few scalars
# (well under a MB even at thousands of blocks); a corrupted length byte
# must not provoke a multi-hundred-MB allocation before the desync is
# noticed
_MAX_META = 16 * 1024 * 1024


def _read_u32(sock: socket.socket, limit: int = MAX_FRAME) -> int:
    (v,) = _U32.unpack(_recv_exact(sock, 4))
    if v > limit:
        raise ValueError(f"bulk frame length {v} exceeds cap {limit}")
    return v


class BulkServer:
    """Accept-loop in a daemon thread; one thread per connection.

    Connections are sequential request/response — no stream multiplexing.
    A client that wants parallel fetches opens parallel connections.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 unix_path: Optional[str] = None, ident: str = ""):
        self.host = host
        self.port = port
        # identity token (the worker's instance/lease id): clients send the
        # ident they EXPECT with each request, so a connection that landed
        # on the wrong server (e.g. a same-path unix socket of another
        # colocated worker after a PID collision) errors instead of
        # silently serving misses
        self.ident = ident
        # same-host transfers ride AF_UNIX when offered: loopback TCP in
        # virtualized kernels can cap near 1 GB/s while unix sockets do
        # ~6 GB/s (measured here) — and colocated prefill/decode workers
        # are the common single-host disagg topology
        self.unix_path = unix_path
        # built-in warmup endpoint: streams zeros so clients can ramp a
        # fresh connection's kernel buffers before the first real fetch
        self._handlers: Dict[str, BulkHandler] = {"_warm": _warm_handler}
        self._socks: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._stopping = threading.Event()
        self._conns: set = set()
        self.bytes_sent = 0  # diagnostics

    def register(self, endpoint: str, handler: BulkHandler) -> None:
        self._handlers[endpoint] = handler

    def start(self) -> "BulkServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(16)
        self.port = s.getsockname()[1]
        self._socks.append(s)
        if self.unix_path:
            import os
            try:
                os.unlink(self.unix_path)
            except FileNotFoundError:
                pass
            u = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            u.bind(self.unix_path)
            u.listen(16)
            self._socks.append(u)
        for sk in self._socks:
            t = threading.Thread(target=self._accept_loop, args=(sk,),
                                 name="bulk-accept", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stopping.set()
        for sk in self._socks:
            try:
                sk.close()
            except OSError:
                pass
        if self.unix_path:
            import os
            try:
                os.unlink(self.unix_path)
            except OSError:
                pass
        for c in list(self._conns):
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)

    @property
    def address(self) -> str:
        """Comma-separated endpoints, unix (if any) first: clients try the
        same-host fast path and fall back to TCP."""
        tcp = f"{self.host}:{self.port}"
        return f"unix:{self.unix_path},{tcp}" if self.unix_path else tcp

    def _accept_loop(self, listen_sock: socket.socket) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = listen_sock.accept()
            except OSError:
                return  # socket closed
            _tune_socket(conn)
            self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="bulk-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stopping.is_set():
                try:
                    req_len = _read_u32(conn)
                except (ConnectionError, ValueError, OSError):
                    return
                req = unpack(_recv_exact(conn, req_len))
                self._handle_one(conn, req)
        except (ConnectionError, OSError):
            pass
        except Exception:
            logger.exception("bulk connection handler died")
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _send_frame(self, conn: socket.socket, meta: Dict[str, Any],
                    raw: Optional[Any]) -> None:
        mb = pack(meta)
        if raw is None:
            conn.sendall(_U32.pack(len(mb)) + mb + _U32.pack(0))
            return
        view = byte_view(raw)
        conn.sendall(_U32.pack(len(mb)) + mb + _U32.pack(view.nbytes))
        conn.sendall(view)  # zero-copy from the source buffer to the kernel
        self.bytes_sent += view.nbytes

    def _handle_one(self, conn: socket.socket, req: Dict[str, Any]) -> None:
        want = req.get("ident", "")
        if want and self.ident and want != self.ident:
            self._send_frame(conn, {"final": True,
                                    "error": f"bulk ident mismatch: "
                                             f"server={self.ident} "
                                             f"requested={want}"}, None)
            return
        handler = self._handlers.get(req.get("endpoint", ""))
        if handler is None:
            self._send_frame(conn, {"final": True,
                                    "error": "no such bulk endpoint"}, None)
            return
        try:
            for meta, raw in handler(req.get("payload")):
                self._send_frame(conn, meta, raw)
        except Exception as e:  # noqa: BLE001 — relay to the peer
            logger.exception("bulk handler error")
            try:
                self._send_frame(conn, {"final": True, "error": str(e)}, None)
            except (ConnectionError, OSError):
                pass
            return
        self._send_frame(conn, {"final": True}, None)


def _connect(address: str, timeout: float) -> socket.socket:
    """Connect to one endpoint of a bulk address. A comma-separated list is
    tried in order — the unix endpoint (listed first by the server) only
    works on the same machine, so remote clients naturally fall through to
    TCP."""
    last_err: Optional[Exception] = None
    for ep in address.split(","):
        ep = ep.strip()
        try:
            if ep.startswith("unix:"):
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(timeout)
                s.connect(ep[len("unix:"):])
                _tune_socket(s)
                return s
            host, port = ep.rsplit(":", 1)
            s = socket.create_connection((host, int(port)), timeout=timeout)
            _tune_socket(s)
            return s
        except OSError as e:
            last_err = e
    raise ConnectionError(f"no reachable bulk endpoint in {address!r}: "
                          f"{last_err}")


# The receive-buffer freelist lives in runtime/codec.py (shared with the
# RPC plane's large two-part trailers); ``release_buffer`` is re-exported
# here because bulk consumers import it from this module.


# warmup stream: enough bytes to ramp the kernel's per-connection buffer
# autotuning (the first tens of MB through a fresh socket move at ~1/3 of
# the steady rate on this host class), capped so a misbehaving client
# can't turn the endpoint into a bandwidth sink
_WARM_CHUNK = None  # lazily-built 4 MiB zero buffer, shared by all conns
PREWARM_BYTES = 32 * 1024 * 1024
_WARM_MAX_BYTES = 256 * 1024 * 1024


def _warm_handler(payload):
    global _WARM_CHUNK
    if _WARM_CHUNK is None:
        import numpy as _np
        _WARM_CHUNK = _np.zeros(4 * 1024 * 1024, _np.uint8)
    want = min(int((payload or {}).get("nbytes", PREWARM_BYTES)),
               _WARM_MAX_BYTES)
    sent = 0
    while sent < want:
        n = min(want - sent, _WARM_CHUNK.nbytes)
        yield {"warm": True}, _WARM_CHUNK[:n]
        sent += n


def prewarm(address: str, ident: str = "", nbytes: int = PREWARM_BYTES,
            conns: int = 1, timeout: float = 30.0) -> int:
    """Open ``conns`` fresh connections to ``address``, stream ``nbytes``
    of warmup traffic through each (ramping the kernel's per-connection
    buffer autotuning), and PARK them in the client pool — subsequent
    ``bulk_fetch`` calls to the address skip both the connection setup and
    the cold-buffer penalty. Synchronous (run via a thread from async
    code; see ``prewarm_async``). Returns connections successfully warmed
    and pooled.

    A server without the ``_warm`` endpoint (pre-knob builds) answers with
    a clean error frame: the connection is still pooled — connection reuse
    alone is most of the win."""
    ok = 0
    for _ in range(conns):
        try:
            s = _connect(address, timeout)
        except (ConnectionError, OSError):
            break  # peer unreachable: later fetches will report properly
        try:
            def sink(meta, raw):
                if raw is not None and hasattr(raw, "nbytes"):
                    release_buffer(raw)
            _fetch_on(s, "_warm", {"nbytes": int(nbytes)}, ident, sink,
                      None)
        except RuntimeError:
            pass  # old server: error frame arrived on a clean boundary
        except (ConnectionError, OSError, ValueError):
            try:
                s.close()
            except OSError:
                pass
            continue
        _pool_put(address, s)
        ok += 1
    return ok


def prewarm_async(address: str, ident: str = "",
                  nbytes: int = PREWARM_BYTES, conns: int = 1,
                  on_fail: Optional[Callable[[], None]] = None) -> None:
    """Fire-and-forget ``prewarm`` in a daemon thread (callable from any
    context, including the event loop). ``on_fail`` runs (in the thread)
    when not a single connection warmed — callers use it to mark the
    address un-warmed so a later attempt retries."""

    def run():
        ok = 0
        try:
            ok = prewarm(address, ident, nbytes, conns)
        except Exception:  # noqa: BLE001 — warmup must never surface
            logger.debug("bulk prewarm of %s failed", address, exc_info=True)
        if not ok and on_fail is not None:
            try:
                on_fail()
            except Exception:  # noqa: BLE001 — callback best-effort
                pass

    threading.Thread(target=run, name="bulk-prewarm", daemon=True).start()


def _fetch_on(s: socket.socket, endpoint: str, payload: Any, ident: str,
              on_frame, stop) -> List[Tuple[Dict[str, Any], bytes]]:
    """One request/response exchange on an established connection."""
    out: List[Tuple[Dict[str, Any], bytes]] = []
    body = pack({"endpoint": endpoint, "payload": payload, "ident": ident})
    s.sendall(_U32.pack(len(body)) + body)
    while True:
        try:
            mb = _recv_exact(s, _read_u32(s, _MAX_META))
            meta = unpack(mb)
        except ValueError as e:
            # an over-cap length prefix is a desynced/corrupted stream,
            # not a protocol-level error: classify as a transport fault so
            # the caller's retry/resume ladder treats it like a reset
            raise ConnectionError(f"bulk frame desync (bad length): {e}")
        except ConnectionError:
            raise
        except Exception as e:  # noqa: BLE001 — a corrupted byte stream
            # desyncs the framing; same classification as above instead of
            # surfacing a raw msgpack error
            raise ConnectionError(f"bulk frame desync (corrupt meta): {e}")
        if not isinstance(meta, dict):
            raise ConnectionError("bulk frame desync (meta not a map)")
        try:
            raw_len = _read_u32(s)
        except ValueError as e:
            raise ConnectionError(f"bulk frame desync (bad raw length): "
                                  f"{e}")
        raw: Any = b""
        if raw_len:
            raw = _buf_get(raw_len)
            _recv_exact_into(s, memoryview(raw.data).cast("B"))
        if meta.get("error"):
            raise RuntimeError(f"bulk fetch failed: {meta['error']}")
        if meta.get("final"):
            return out
        if stop is not None and stop.is_set():
            # consumer aborted (e.g. injection failed): stop reading
            # instead of streaming the rest into the void
            raise ConnectionError("bulk fetch aborted by consumer")
        if on_frame is not None:
            on_frame(meta, raw)
        else:
            out.append((meta, raw))


# Connection pool, keyed by address. Kernel socket buffers autotune PER
# CONNECTION: the first tens of MB through a fresh unix/TCP socket move at
# ~1/3 of the steady rate (measured 0.7 vs 1.9 GB/s on this class of host),
# and disagg fetches one prefix per request — without reuse every fetch
# pays the warmup. Connections are sequential request/response, so a pooled
# connection is checked OUT for the duration of a fetch; concurrent fetches
# to the same peer each get their own.
_POOL_MAX_PER_ADDR = 4
_pool: Dict[str, List[socket.socket]] = {}
_pool_lock = threading.Lock()


def _pool_get(address: str, timeout: float) -> Tuple[socket.socket, bool]:
    """-> (connection, was_pooled)."""
    with _pool_lock:
        conns = _pool.get(address)
        if conns:
            return conns.pop(), True
    return _connect(address, timeout), False


def _pool_put(address: str, s: socket.socket) -> None:
    with _pool_lock:
        conns = _pool.setdefault(address, [])
        if len(conns) < _POOL_MAX_PER_ADDR:
            conns.append(s)
            return
    try:
        s.close()
    except OSError:
        pass


def bulk_fetch(address: str, endpoint: str, payload: Any,
               ident: str = "", timeout: float = 60.0,
               on_frame: Optional[Callable[[Dict[str, Any], Any], None]]
               = None,
               stop: Optional[threading.Event] = None
               ) -> List[Tuple[Dict[str, Any], bytes]]:
    """Synchronous bulk fetch (run via ``asyncio.to_thread`` from async
    code). ``ident`` is the server identity the caller expects (the
    instance id) — a mismatched server refuses instead of silently serving
    misses.

    With ``on_frame`` set, each data frame is handed to the callback AS IT
    ARRIVES (in this thread) and not accumulated — the caller can overlap
    downstream work (KV injection) with the remaining network transfer
    instead of buffering the whole prefix in RAM. Returns the accumulated
    [(meta, raw_bytes)] list (empty in callback mode); raises on handler
    error.

    Connections are pooled per address and reused across fetches (warm
    kernel buffers); a fetch that errors mid-stream closes its connection
    instead of returning it, and a STALE pooled connection (peer restarted)
    is retried once on a fresh one before the error propagates."""
    frames_seen = 0

    def counting(meta, raw):
        nonlocal frames_seen
        frames_seen += 1
        if on_frame is not None:
            on_frame(meta, raw)

    cb = counting if on_frame is not None else None
    s, was_pooled = _pool_get(address, timeout)
    try:
        out = _fetch_on(s, endpoint, payload, ident, cb, stop)
    except (ConnectionError, OSError):
        try:
            s.close()
        except OSError:
            pass
        # Retry once on a fresh connection ONLY for a stale pooled
        # connection failing before any frame arrived — a mid-stream retry
        # would replay frames into a side-effecting on_frame callback.
        if (not was_pooled or frames_seen
                or (stop is not None and stop.is_set())):
            raise
        s = _connect(address, timeout)
        try:
            out = _fetch_on(s, endpoint, payload, ident, cb, stop)
        except BaseException:
            try:
                s.close()
            except OSError:
                pass
            raise
    except BaseException:
        try:
            s.close()
        except OSError:
            pass
        raise
    _pool_put(address, s)
    return out


__all__ = ["BulkServer", "bulk_fetch", "release_buffer", "BulkHandler",
           "prewarm", "prewarm_async", "PREWARM_BYTES"]
