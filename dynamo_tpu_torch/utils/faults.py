"""Deterministic transport-fault injection for tests and chaos drills.

``ChaosProxy`` is a byte-level TCP proxy that sits between an RPC client and
an ``RpcServer`` (or any TCP service) and injects the faults that are hard to
provoke on a real socket pair:

- ``blackhole()``: stop forwarding in both directions while KEEPING every
  connection open — the alive-but-stuck worker (engine deadlock, GC pause,
  network partition with open TCP).  Stream-drop detection never fires; only
  keepalive probing or request deadlines can catch it.
- ``set_delay(s)``: add latency to every forwarded chunk (slow network).
- ``delay_jitter(p, min_s, max_s)``: tail-latency mode — each CONNECTION
  independently draws (with probability ``p``) a random stall in
  [min_s, max_s] applied to its forwarded chunks, while other connections
  run at full speed.  Distinct from the blanket ``delay``: this is the
  slow-but-alive worker whose victims are only some callers — the case a
  failure-aware router must route around rather than merely detect.
  Seedable for deterministic chaos tests.
- ``heal()``: resume forwarding (bytes held during the blackhole flow again).
- ``corrupt(after_bytes, nbytes)``: flip (XOR 0xFF) ``nbytes`` of the
  forwarded byte stream starting at absolute offset ``after_bytes`` — the
  silently-corrupting link/NIC that only end-to-end checksums can catch.
  One-shot; disarms once the window has been applied.
- ``truncate(after_bytes)``: forward exactly ``after_bytes`` then hard-cut
  both sides of the connection — the mid-transfer socket reset. One-shot.

``corrupt``/``truncate`` take a ``direction`` (``"down"`` = server→client
bytes, the default — where KV frames flow — or ``"up"``) and count bytes
cumulatively per direction across the proxy's lifetime; they work against
any TCP service (the bulk data plane and the RPC plane alike).

Scenarios become deterministic: point the client at ``proxy.address`` instead
of the worker's own, then flip faults mid-stream.  Parity in intent with the
reference's fault-tolerance suite (``tests/fault_tolerance/``), which kills
processes; this adds the fault class process-kills can't express.

``CoordinatorOutage`` is the control-plane sibling: kill an in-process
``Coordinator`` abruptly (clients see a hard TCP close, like ``kill -9``) and
relisten on the SAME port, with or without a state wipe — so chaos tests can
exercise both a blipped connection (state intact, leases still ticking) and a
fresh empty coordinator (the real crash/restart, everything to resync).

``CoordinatorPair`` composes both with a replicated primary + hot-standby
pair whose replication link runs through a ``ChaosProxy``: primary kill -9,
replication-link partition while both halves stay client-reachable (the
dual-primary fencing drill), and standby blips during catch-up.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Optional, Set

from dynamo_tpu_torch.utils.aio import reap_task

logger = logging.getLogger(__name__)


class ChaosProxy:
    """TCP proxy with switchable blackhole/delay fault injection."""

    def __init__(self, upstream: str, host: str = "127.0.0.1", port: int = 0):
        uhost, _, uport = upstream.rpartition(":")
        self.upstream_host = uhost or "127.0.0.1"
        self.upstream_port = int(uport)
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._forwarding = asyncio.Event()
        self._forwarding.set()
        self._delay_s = 0.0
        # tail-latency jitter: (p, min_s, max_s, rng); None = off
        self._jitter: Optional[tuple] = None
        self._tasks: Set[asyncio.Task] = set()
        self._writers: Set[asyncio.StreamWriter] = set()
        self.bytes_forwarded = 0
        # byte-stream faults, armed per direction ("up" client->server,
        # "down" server->client); offsets are cumulative per direction
        self._dir_bytes = {"up": 0, "down": 0}
        self._corrupt: dict = {}   # direction -> (start, nbytes)
        self._truncate: dict = {}  # direction -> cut offset
        self.corruptions = 0
        self.truncations = 0

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def blackholed(self) -> bool:
        return not self._forwarding.is_set()

    async def start(self) -> "ChaosProxy":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=16 * 1024 * 1024)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server:
            self._server.close()
        for t in list(self._tasks):
            await reap_task(t)
        for w in list(self._writers):
            try:
                w.close()
            except Exception:
                pass
        if self._server:
            await self._server.wait_closed()

    # -- fault controls ----------------------------------------------------

    def blackhole(self) -> None:
        """Stop forwarding, keep connections open (the stuck-worker fault)."""
        self._forwarding.clear()

    def heal(self) -> None:
        """Resume forwarding; bytes held during the blackhole flow again."""
        self._forwarding.set()

    def set_delay(self, seconds: float) -> None:
        """Add per-chunk forwarding latency (0 restores full speed)."""
        self._delay_s = max(0.0, seconds)

    def delay_jitter(self, p: float, min_s: float, max_s: float,
                     seed: Optional[int] = None) -> None:
        """Tail-latency mode: each connection draws — with probability
        ``p``, at its first forwarded chunk after arming — a random stall
        in [min_s, max_s] it then applies to every chunk it forwards.
        Unlucky connections are consistently slow, the rest run at full
        speed (per-connection, unlike the blanket ``set_delay``).  Pass
        ``seed`` for a deterministic draw sequence; ``delay_jitter(0, 0,
        0)`` disarms."""
        if p <= 0:
            self._jitter = None
            return
        self._jitter = (min(1.0, p), max(0.0, min_s),
                        max(0.0, min_s, max_s), random.Random(seed))

    def corrupt(self, after_bytes: int = 0, nbytes: int = 1,
                direction: str = "down") -> None:
        """Flip ``nbytes`` of the ``direction`` byte stream starting at
        cumulative offset ``after_bytes`` (XOR 0xFF — the bytes still
        arrive, just wrong). One-shot: disarms once fully applied."""
        self._corrupt[direction] = (int(after_bytes), max(1, int(nbytes)))

    def truncate(self, after_bytes: int, direction: str = "down") -> None:
        """Forward exactly ``after_bytes`` cumulative bytes in
        ``direction`` then hard-close both sides of that connection (a
        mid-transfer reset). One-shot."""
        self._truncate[direction] = int(after_bytes)

    def clear_faults(self) -> None:
        """Disarm any pending corrupt/truncate faults."""
        self._corrupt.clear()
        self._truncate.clear()

    # -- plumbing ----------------------------------------------------------

    async def _handle(self, creader: asyncio.StreamReader,
                      cwriter: asyncio.StreamWriter) -> None:
        try:
            ureader, uwriter = await asyncio.open_connection(
                self.upstream_host, self.upstream_port,
                limit=16 * 1024 * 1024)
        except OSError:
            cwriter.close()
            return
        self._writers.update((cwriter, uwriter))
        # per-connection jitter state, shared by both pump directions so a
        # slow connection is slow both ways (one stall draw per connection)
        conn: dict = {}
        up = asyncio.create_task(self._pump(creader, uwriter, "up", cwriter,
                                            conn))
        down = asyncio.create_task(self._pump(ureader, cwriter, "down",
                                              uwriter, conn))
        for t in (up, down):
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)
        try:
            await asyncio.gather(up, down, return_exceptions=True)
        finally:
            for w in (cwriter, uwriter):
                self._writers.discard(w)
                try:
                    w.close()
                except Exception:
                    pass

    def _apply_faults(self, direction: str, data: bytes):
        """Apply any armed corrupt/truncate fault to one chunk; returns
        (data, cut) where ``cut`` means: write what remains, then hard-
        close the connection."""
        pos = self._dir_bytes[direction]
        armed = self._corrupt.get(direction)
        if armed is not None:
            start, n = armed
            lo, hi = max(start, pos), min(start + n, pos + len(data))
            if lo < hi:
                b = bytearray(data)
                for i in range(lo - pos, hi - pos):
                    b[i] ^= 0xFF
                data = bytes(b)
                self.corruptions += 1
            if start + n <= pos + len(data):  # window fully applied
                self._corrupt.pop(direction, None)
        cut = False
        trunc = self._truncate.get(direction)
        if trunc is not None and pos + len(data) >= trunc:
            data = data[:max(0, trunc - pos)]
            self._truncate.pop(direction, None)
            self.truncations += 1
            cut = True
        self._dir_bytes[direction] += len(data)
        return data, cut

    def _jitter_stall(self, conn: Optional[dict]) -> float:
        """This connection's stall for the armed jitter config.  Drawn
        lazily at the first chunk after arming (a pooled connection opened
        before ``delay_jitter`` still participates), atomically between
        awaits, once per (connection, arming)."""
        jit = self._jitter
        if jit is None or conn is None:
            return 0.0
        key = id(jit)  # re-arming re-draws
        if conn.get("jitter_key") != key:
            p, min_s, max_s, rng = jit
            conn["jitter_key"] = key
            conn["stall"] = (rng.uniform(min_s, max_s)
                             if rng.random() < p else 0.0)
        return conn.get("stall", 0.0)

    async def _pump(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter,
                    direction: str = "down",
                    peer_writer: "asyncio.StreamWriter" = None,
                    conn: Optional[dict] = None) -> None:
        try:
            while True:
                data = await reader.read(64 * 1024)
                if not data:
                    break
                if self._delay_s:
                    await asyncio.sleep(self._delay_s)
                stall = self._jitter_stall(conn)
                if stall:
                    await asyncio.sleep(stall)
                # blackhole: hold the chunk here — the connection stays
                # open and silent, exactly like a frozen remote
                await self._forwarding.wait()
                data, cut = self._apply_faults(direction, data)
                if data:
                    writer.write(data)
                    await writer.drain()
                    self.bytes_forwarded += len(data)
                if cut:
                    # hard-cut BOTH halves: the peer sees a mid-frame
                    # close, exactly like a socket reset under transfer
                    if peer_writer is not None:
                        try:
                            peer_writer.close()
                        except Exception:
                            pass
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass


class CoordinatorOutage:
    """Kill-and-relisten harness around an in-process ``Coordinator``.

    ``kill()`` tears the server down abruptly (live connections get a hard
    close — what a ``kill -9`` looks like from the client side) while
    remembering the bound port; ``restart(wipe_state=...)`` re-binds the
    same port, optionally after wiping every piece of server state (KV,
    leases, watches, subscriptions, queues) to model a fresh process.
    """

    def __init__(self, coordinator):
        self.coordinator = coordinator
        self.outages = 0

    @property
    def address(self) -> str:
        return self.coordinator.address

    async def kill(self) -> None:
        """Stop serving; the port stays reserved for ``restart()``."""
        await self.coordinator.stop()
        self.outages += 1
        logger.info("coordinator %s killed (outage #%d)",
                    self.coordinator.address, self.outages)

    async def restart(self, wipe_state: bool = True) -> None:
        """Relisten on the same host:port; ``wipe_state=True`` models a
        crashed-and-respawned coordinator (empty KV, no leases), False a
        supervisor restart that kept state in memory."""
        c = self.coordinator
        if wipe_state:
            c._kv.clear()
            c._leases.clear()
            c._watches.clear()
            c._subs_exact.clear()
            c._subs_wild.clear()
            c._queue_rr.clear()
            c._queues.clear()
            c._queue_pulls.clear()
            # a genuinely fresh process restarts the id counter at 1, so
            # fresh watch/sub/lease ids COLLIDE with pre-outage ids —
            # resync code must survive that, so the drill reproduces it
            c._next_id = 1
            c._epoch = random.getrandbits(63)  # new process, new boot epoch
            c._term = 0                 # fresh lineage: term restarts too
            c._deposed_term = None
            c._repl_seq = 0
            # a wiped standby has no mirrored state: it must re-attach
            # before auto-promotion trusts it again
            c._ever_attached = False
        await c.start()
        logger.info("coordinator restarted on %s (state %s)", c.address,
                    "wiped" if wipe_state else "kept")

    async def blip(self, downtime_s: float = 0.0,
                   wipe_state: bool = True) -> None:
        """kill -> (optional dwell) -> restart, one call."""
        await self.kill()
        if downtime_s > 0:
            await asyncio.sleep(downtime_s)
        await self.restart(wipe_state=wipe_state)


class CoordinatorPair:
    """Chaos harness for a replicated coordinator pair (primary + hot
    standby) with a controllable replication link.

    The standby attaches to the primary THROUGH a ``ChaosProxy``, so the
    replication link can be partitioned while both processes stay
    client-reachable — the dual-primary drill.  The primary learns the
    standby's REAL listen address from the attach, so its split-brain peer
    probe bypasses the proxy: when the standby promotes behind the
    partition, the deposed primary observes the higher fencing term,
    bounces its writers, and demotes itself into a standby of the winner.

    Drills:

    - ``kill9_primary()`` — abrupt primary death (clients see a hard TCP
      close, like ``kill -9``); the standby self-promotes after its
      promote window and clients walk their address list onto it.
    - ``partition()`` / ``heal()`` — blackhole the replication link (open
      TCP, no bytes) while both coordinators keep serving clients.
    - ``blip_standby()`` — kill the standby mid-catch-up and bring it
      back; it re-attaches with a fresh full snapshot.
    - ``promote()`` — manual promotion (the operator/SIGUSR1 path).
    """

    def __init__(self, promote_after_s: float = 0.6,
                 lease_grace_s: float = 0.5):
        self.promote_after_s = promote_after_s
        self.lease_grace_s = lease_grace_s
        self.primary = None
        self.standby = None
        self.repl_proxy: Optional[ChaosProxy] = None
        self.primary_outage: Optional[CoordinatorOutage] = None
        self.standby_outage: Optional[CoordinatorOutage] = None

    async def start(self) -> "CoordinatorPair":
        from dynamo_tpu_torch.runtime.coordinator import Coordinator

        self.primary = await Coordinator(
            port=0, promote_after_s=self.promote_after_s,
            lease_grace_s=self.lease_grace_s).start()
        self.repl_proxy = await ChaosProxy(self.primary.address).start()
        self.standby = await Coordinator(
            port=0, standby_of=self.repl_proxy.address,
            promote_after_s=self.promote_after_s,
            lease_grace_s=self.lease_grace_s).start()
        self.primary_outage = CoordinatorOutage(self.primary)
        self.standby_outage = CoordinatorOutage(self.standby)
        await self.wait_attached()
        return self

    @property
    def addresses(self) -> str:
        """The multi-address string clients take (primary first)."""
        return f"{self.primary.address},{self.standby.address}"

    async def wait_attached(self, timeout: float = 5.0) -> None:
        """Until the standby has installed the primary's snapshot (mirrored
        boot epoch) and applied the log to the primary's sequence."""
        deadline = asyncio.get_running_loop().time() + timeout
        while (self.standby._epoch != self.primary._epoch
               or self.standby._repl_seq < self.primary._repl_seq):
            if asyncio.get_running_loop().time() >= deadline:
                raise TimeoutError("standby never caught up")
            await asyncio.sleep(0.02)

    wait_caught_up = wait_attached

    async def wait_promoted(self, timeout: float = 10.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while self.standby.role != "primary":
            if asyncio.get_running_loop().time() >= deadline:
                raise TimeoutError("standby never promoted")
            await asyncio.sleep(0.02)

    async def kill9_primary(self) -> None:
        """Abrupt primary death; the port stays available for
        ``primary_outage.restart()`` (which rejoins via the peer probe)."""
        await self.primary_outage.kill()

    def partition(self) -> None:
        """Cut primary<->standby replication while both stay
        client-reachable (the dual-primary drill)."""
        self.repl_proxy.blackhole()

    def heal(self) -> None:
        self.repl_proxy.heal()

    async def blip_standby(self, downtime_s: float = 0.1) -> None:
        """Kill the standby during replication catch-up and bring it back;
        the fresh attach re-snapshots, repairing any missed tail."""
        await self.standby_outage.blip(downtime_s=downtime_s,
                                       wipe_state=True)

    def promote(self, reason: str = "harness") -> None:
        self.standby.promote(reason)

    async def stop(self) -> None:
        for part in (self.standby, self.repl_proxy, self.primary):
            if part is None:
                continue
            try:
                await part.stop()
            except Exception:  # noqa: BLE001 — already-dead halves are fine
                pass


class WorkerDrain:
    """Lifecycle fault harness around one in-process worker: drives the
    SAME staged drain protocol the production worker runs
    (``worker/drain.DrainController``), plus the abrupt deaths chaos
    tests pit it against.

    Scenarios:

    - ``sigterm()`` — the graceful path: announce draining, freeze the
      in-flight streams into resume/replay tokens, wait (bounded) for
      survivors to ack the pinned-KV leases, then tear the worker down.
      What the real worker's SIGTERM handler / ``POST /drain`` does.
    - ``kill9()`` — no drain at all: the runtime closes abruptly; callers
      see connection teardown and the migration operator replays (the
      replay path).
    - ``kill9_mid_drain()`` — the race: announce + freeze complete (resume
      tokens shipped, KV pinned), then the process dies BEFORE survivors
      pull — their resume pulls fail and admission falls back to
      recompute; no stream may be lost and no lease may leak on the
      survivors.
    - ``drain(timeout_s=0)`` — the drain-timeout scenario: exit without
      waiting for lease acks.
    """

    def __init__(self, drt, engine, served=(), resume_extras=None):
        from dynamo_tpu_torch.worker.drain import DrainController

        self.drt = drt
        self.engine = engine
        self.controller = DrainController(engine, served=served,
                                          resume_extras=resume_extras)
        self.dead = False

    async def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful drain WITHOUT tearing the worker down (the post-drain
        window where survivors pull pinned KV); returns the
        resume/replay counts."""
        self.controller.timeout_s = timeout_s
        return await self.controller.drain("WorkerDrain")

    async def sigterm(self, timeout_s: Optional[float] = None) -> dict:
        """Full graceful shutdown: drain, then close the runtime."""
        counts = await self.drain(timeout_s)
        await self._close()
        return counts

    async def kill9(self) -> None:
        """Abrupt death — no announcement, no freeze, streams drop."""
        await self._close()

    async def kill9_mid_drain(self) -> dict:
        """Announce + freeze, then die before any survivor pulls."""
        await self.controller.announce()
        counts = await self.controller.freeze()
        await self._close()
        return counts

    async def _close(self) -> None:
        if self.dead:
            return
        self.dead = True
        try:
            await self.drt.close()
        finally:
            stop = getattr(self.engine, "stop", None)
            if stop is not None:
                await stop()


def stub_worker_cmd(ready_after_s: float = 0.0,
                    exit_after_s: Optional[float] = None,
                    exit_code: int = 1,
                    drain_s: float = 0.0,
                    ignore_term: bool = False,
                    banner: str = "stub worker up") -> list:
    """Command line for a scripted minimal fake worker — the fleet
    supervisor's unit-test counterpart to the mocker.

    The child honors the supervisor contract without importing anything
    heavy: it serves ``/healthz/ready`` on ``DYN_SYSTEM_PORT`` (503 until
    ``ready_after_s`` has elapsed), answers ``POST /drain`` with 202 and
    exits 0 after ``drain_s`` (how long its pretend migration takes),
    treats SIGTERM the same way (or ignores it with ``ignore_term`` — the
    SIGKILL-escalation drill), prints ``banner`` to stdout (log-capture
    assertions), and optionally crashes with ``exit_code`` after
    ``exit_after_s``.
    """
    import sys as _sys
    script = f"""
import http.server, os, signal, sys, threading, time
T0 = time.monotonic()
def bail(code, delay=0.0):
    def run():
        time.sleep(delay); os._exit(code)
    threading.Thread(target=run, daemon=True).start()
class H(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a): pass
    def do_GET(self):
        if self.path == '/healthz/ready':
            ok = time.monotonic() - T0 >= {ready_after_s!r}
            self.send_response(200 if ok else 503); self.end_headers()
            self.wfile.write(b'ready' if ok else b'not ready')
        else:
            self.send_response(404); self.end_headers()
    def do_POST(self):
        if self.path == '/drain':
            self.send_response(202); self.end_headers()
            self.wfile.write(b'draining')
            if not {ignore_term!r}:
                bail(0, {drain_s!r})
        else:
            self.send_response(404); self.end_headers()
port = int(os.environ.get('DYN_SYSTEM_PORT', '0') or 0)
if port:
    srv = http.server.ThreadingHTTPServer(('127.0.0.1', port), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
if {ignore_term!r}:
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
else:
    signal.signal(signal.SIGTERM, lambda *a: bail(0, {drain_s!r}))
print({banner!r}, flush=True)
"""
    if exit_after_s is not None:
        script += f"""
time.sleep({exit_after_s!r})
print('stub worker exiting rc={exit_code}', flush=True)
sys.exit({exit_code!r})
"""
    script += """
while True:
    time.sleep(3600)
"""
    return [_sys.executable, "-c", script]


__all__ = ["ChaosProxy", "CoordinatorOutage", "CoordinatorPair",
           "WorkerDrain", "stub_worker_cmd"]
