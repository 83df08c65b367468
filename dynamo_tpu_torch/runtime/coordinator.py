"""Coordinator: the framework's self-contained control-plane service.

One asyncio TCP server provides what the reference gets from two external
services (SURVEY.md §2.1, L0):

- **KV plane** (etcd-equivalent; reference ``lib/runtime/src/transports/etcd.rs``):
  put/get/delete with prefix queries, *leases* with TTL + keep-alive (all keys
  attached to a lease vanish when it expires — that is the liveness mechanism),
  and *prefix watches* that stream put/delete events to clients.
- **Event plane** (NATS-equivalent; reference ``transports/nats.rs``):
  subject-based pub/sub with trailing-wildcard subscriptions (``a.b.>``), used
  for KV-cache events, metrics broadcasts and the prefill queue.
- **Object store** (reference uses NATS object store for model-card artifacts):
  named buckets of binary blobs, implemented on the KV plane with chunking.
- **Barrier** (reference ``utils/leader_worker_barrier.rs``): implemented
  client-side on KV + watch (see ``LeaderWorkerBarrier`` in barrier.py).

Wire protocol: length-prefixed msgpack frames (codec.py).  Requests carry a
client-assigned ``rid`` and are answered with ``{"rid", "ok", ...}``; server-
initiated traffic (watch events, pub/sub messages) carries ``evt`` instead.

The coordinator is deliberately a single-threaded asyncio process: control
plane operations are low-rate (registrations, watches, metrics) while the hot
request path rides direct worker TCP connections and never touches it.

**Replication & failover** (parity in intent with etcd's Raft replication,
scaled down to a primary + hot-standby pair): a standby coordinator
(``--standby-of host:port``) attaches to the primary over the SAME wire
protocol (``repl_attach``), receives a full state snapshot (KV, leases with
remaining TTLs, queues, boot epoch, id counter, fencing term), then applies
the primary's ordered replication log (put/delete, lease grant/keepalive/
revoke, queue push/pop) streamed as ``evt: "repl"`` frames.  Because the
standby mirrors the primary's *boot epoch and id counter*, promotion looks to
a resyncing ``CoordClient`` like a blip of the same server: the resync takes
the cheap probe path (keepalive each lease — it exists, same id) instead of
the re-grant storm a fresh process forces.  Lease deadlines are rebased by a
grace window at promotion so the fleet doesn't mass-expire mid-failover.

Split-brain safety rides a **monotonic fencing term**: bumped at every
promotion, echoed on ping, stamped on writes by term-aware clients.  A write
stamped with a term the server doesn't hold bounces (``fenced: True`` + the
highest term known) and the client re-points along its address list; a
primary that observes a higher term — via a stamped write or its peer probe
of a lost standby — knows it is deposed, fences its writers, and (when it
knows the new primary's address) demotes itself into a hot standby of it,
restoring redundancy automatically.  Requests without a term field (older
clients) are served exactly as before: fencing is opt-in at the wire level.

``CoordClient`` accepts a comma-separated address list
(``"host:6650,host:6651"``); connect and the reconnect loop walk the
list, skipping standbys/deposed primaries, so failover needs no client
reconfiguration.  With a single address and a non-replicated server the
behavior is bit-for-bit the unreplicated protocol.
"""

from __future__ import annotations

import asyncio
import fnmatch
import itertools
import logging
import os
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, AsyncIterator, Awaitable, Callable, Dict, List,
                    Optional, Tuple)

from dynamo_tpu_torch.runtime.codec import read_frame, send_frame, write_frame
from dynamo_tpu_torch.utils.aio import decorrelated_jitter, reap_task

logger = logging.getLogger(__name__)

LEASE_SCAN_INTERVAL = 0.5  # seconds between lease-expiry scans

# replication / failover knobs (constructor args override)
DEFAULT_PROMOTE_AFTER_S = 2.0       # standby self-promotes after this silence
DEFAULT_PROMOTE_LEASE_GRACE_S = 1.0  # extra lease headroom added at promotion

# ops that mutate replicated state: term-fenced on the server, term-stamped
# by term-aware clients. queue_pull consumes a job, queue_cancel unparks a
# pull — both are state changes a deposed primary must not serve.
_WRITE_OPS = frozenset({
    "put", "put_if_absent", "delete", "delete_prefix", "grant_lease",
    "keepalive", "revoke", "queue_push", "queue_pull", "queue_cancel"})


def _subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style match: exact, or trailing ``>`` wildcard matching the rest."""
    if pattern == subject:
        return True
    if pattern.endswith(".>"):
        return subject.startswith(pattern[:-1])  # keep the dot
    if pattern == ">":
        return True
    return False


@dataclass
class _KvEntry:
    value: bytes
    lease_id: int = 0
    version: int = 1


@dataclass
class _Lease:
    lease_id: int
    ttl: float
    expires_at: float
    keys: set = field(default_factory=set)


@dataclass
class _Watch:
    watch_id: int
    prefix: str
    conn: "_Conn"


@dataclass
class _Subscription:
    sub_id: int
    pattern: str
    conn: "_Conn"
    queue_group: Optional[str] = None


class _StandbyPeer:
    """Server-side handle for one attached standby: an ordered outbound
    queue drained by a pump task, so log entries are emitted synchronously
    at the mutation point (no await between state change and emit) yet sent
    without blocking the dispatcher.  Queue depth is the standby's
    replication lag in ops."""

    def __init__(self, conn: "_Conn", addr: str):
        self.conn = conn
        self.addr = addr
        self.q: "asyncio.Queue" = asyncio.Queue()
        self.task: Optional[asyncio.Task] = None
        # stamped on every frame the standby sends (it pings through the
        # replication connection): a silent-but-open connection — the
        # partitioned link — must not count as a healthy standby
        self.last_contact = time.monotonic()

    async def _pump(self) -> None:
        while True:
            frame = await self.q.get()
            await self.conn.send(frame)
            if not self.conn.alive:
                return


class _Conn:
    """Server-side state for one client connection."""

    def __init__(self, server: "Coordinator", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.watches: Dict[int, _Watch] = {}
        self.subs: Dict[int, _Subscription] = {}
        self.leases: set = set()
        self.alive = True
        self._wlock = asyncio.Lock()

    async def send(self, obj: Any) -> None:
        if not self.alive:
            return
        try:
            async with self._wlock:
                await send_frame(self.writer, obj)
        except (ConnectionError, RuntimeError):
            self.alive = False


class Coordinator:
    """The control-plane server.  ``async with Coordinator(port=0) as c: ...``"""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 standby_of: Optional[str] = None,
                 promote_after_s: Optional[float] = None,
                 lease_grace_s: Optional[float] = None):
        self.host = host
        self.port = port
        env = os.environ.get
        # replication role: None = (acting) primary; "host:port" = hot
        # standby mirroring that primary's state until promotion
        self.standby_of = standby_of
        self.promote_after_s = (float(env("DYN_COORD_PROMOTE_AFTER_S",
                                          str(DEFAULT_PROMOTE_AFTER_S)))
                                if promote_after_s is None
                                else promote_after_s)
        self.lease_grace_s = (float(env("DYN_COORD_PROMOTE_LEASE_GRACE_S",
                                        str(DEFAULT_PROMOTE_LEASE_GRACE_S)))
                              if lease_grace_s is None else lease_grace_s)
        self._kv: Dict[str, _KvEntry] = {}
        self._leases: Dict[int, _Lease] = {}
        self._watches: Dict[int, _Watch] = {}
        # subscriptions indexed for O(matching) publish fan-out: exact
        # subjects in a dict, the (few) trailing-wildcard patterns in a
        # list — per-page KV events at fleet scale must not pay an
        # O(all subscriptions) scan per message
        self._subs_exact: Dict[str, List[_Subscription]] = {}
        self._subs_wild: List[_Subscription] = []
        self._queue_rr: Dict[Tuple[str, str], int] = {}  # (pattern, group) -> rr counter
        # work queues (JetStream-queue role; the reference's prefill queue
        # rides a NATS JetStream consumer group, rust/llm/nats.rs:109):
        # FIFO per name, pulls park until an item arrives
        self._queues: Dict[str, "deque[bytes]"] = {}
        self._queue_pulls: Dict[str, "deque[Tuple[_Conn, Any]]"] = {}
        # id counter as a plain int (not itertools.count): a standby must
        # mirror it from the snapshot/log so ids it grants post-promotion
        # never collide with replicated lease ids
        self._next_id = 1
        # boot epoch: lets a resyncing client tell "same server, state
        # intact" from "fresh/wiped server" — the id counter restarts on a
        # real process restart, so a probed lease id may EXIST yet belong
        # to another client's re-grant; epoch mismatch forces re-grants.
        # A standby MIRRORS the primary's epoch, so promotion presents as
        # a blip of the same server (probe path, no re-grant storm).
        self._epoch = random.getrandbits(63)
        # fencing term: bumped at every promotion, echoed on ping, checked
        # against the term stamped on writes by term-aware clients
        self._term = 0
        self._deposed_term: Optional[int] = None  # > _term once deposed
        self._repl_seq = 0
        self._standbys: Dict["_Conn", _StandbyPeer] = {}
        self._peer_addrs: set = set()  # standby listen addrs (for probing)
        self._primary_last_contact = 0.0
        # has this standby EVER installed a snapshot? Auto-promotion is
        # gated on it: a standby that never reached its primary (started
        # during a blip, partitioned at boot) promoting with EMPTY state
        # and a fresh epoch would split the fleet while the real primary
        # is alive. Manual promotion (admin op / SIGUSR1) stays available
        # for the operator who knows the primary is really gone.
        self._ever_attached = False
        self.failovers_total = 0  # promotions performed by this process
        self._server: Optional[asyncio.base_events.Server] = None
        self._lease_task: Optional[asyncio.Task] = None
        self._standby_task: Optional[asyncio.Task] = None
        self._peer_probe_task: Optional[asyncio.Task] = None
        self._conns: set = set()

    def _next(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    @property
    def role(self) -> str:
        if self.standby_of is not None:
            return "standby"
        return "deposed" if self._deposed_term is not None else "primary"

    @property
    def replication_lag_ops(self) -> int:
        """Ops queued to the slowest attached standby (0 = fully caught up
        or no standby)."""
        return max((p.q.qsize() for p in self._standbys.values()), default=0)

    @property
    def standbys_attached(self) -> int:
        return len(self._standbys)

    @property
    def prefix_index_entries(self) -> int:
        """Live holder snapshots in the fleet prefix index
        (``kvstore/prefix_index/`` keys whose kv-store TTL envelope has
        not expired) — the ``dynamo_coord_prefix_index_entries`` gauge.
        The envelope is the client-side ``_CoordBucket`` format
        ({"e": expiry, "v": value, "t": ttl}); an undecodable entry
        counts as live (the reader, not this gauge, is the authority)."""
        import time as _time

        from dynamo_tpu_torch.runtime import codec as _codec
        n = 0
        now = _time.time()
        for key, e in self._kv.items():
            if not key.startswith("kvstore/prefix_index/"):
                continue
            try:
                env = _codec.unpack(e.value)
                if env.get("e") and env["e"] <= now:
                    continue
            except Exception:  # noqa: BLE001 — count it, don't crash scrape
                pass
            n += 1
        return n

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "Coordinator":
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.standby_of is None:
            # lease expiry is a PRIMARY duty: a standby expiring replicated
            # leases on its own clock would diverge from the source of truth
            self._lease_task = asyncio.create_task(self._lease_scanner())
            if self._peer_addrs:
                # a restarted ex-primary still knows its standbys: probe
                # them so a promotion that happened while we were down
                # deposes (and demotes) us instead of splitting the brain
                self._ensure_peer_probe()
        else:
            self._primary_last_contact = time.monotonic()
            self._standby_task = asyncio.create_task(self._standby_loop())
        logger.info("coordinator listening on %s:%d (%s)",
                    self.host, self.port, self.role)
        return self

    async def stop(self) -> None:
        await reap_task(self._lease_task)
        await reap_task(self._standby_task)
        await reap_task(self._peer_probe_task)
        self._lease_task = self._standby_task = self._peer_probe_task = None
        for peer in list(self._standbys.values()):
            await reap_task(peer.task)
        self._standbys.clear()
        if self._server:
            self._server.close()
        # close live connections BEFORE wait_closed(): on py3.12 wait_closed
        # blocks until every connection handler exits, and handlers sit in
        # read() until their socket dies — the old order deadlocked when a
        # client was still attached (e.g. killing a coordinator under load)
        for conn in list(self._conns):
            conn.alive = False
            try:
                conn.writer.close()
            except Exception:
                pass
        if self._server:
            await self._server.wait_closed()

    async def __aenter__(self) -> "Coordinator":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- connection handling ----------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        conn = _Conn(self, reader, writer)
        self._conns.add(conn)
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                peer = self._standbys.get(conn)
                if peer is not None:
                    peer.last_contact = time.monotonic()
                try:
                    await self._dispatch(conn, frame)
                except Exception as e:  # protocol error -> report, keep conn
                    logger.exception("coordinator dispatch error")
                    rid = frame.get("rid") if isinstance(frame, dict) else None
                    if rid is not None:
                        await conn.send({"rid": rid, "ok": False, "error": str(e)})
        finally:
            conn.alive = False
            self._conns.discard(conn)
            self._drop_standby(conn)
            for w in list(conn.watches.values()):
                self._watches.pop(w.watch_id, None)
            self._drop_conn_subs(conn)
            for pulls in self._queue_pulls.values():
                # drop this connection's parked queue pulls
                for item in [p for p in pulls if p[0] is conn]:
                    pulls.remove(item)
            # leases owned by a dropped connection keep ticking until TTL expiry
            # (matches etcd semantics: reconnect within TTL keeps instances alive)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, conn: _Conn, f: Dict[str, Any]) -> None:
        op = f.get("op")
        rid = f.get("rid")
        if self.standby_of is not None and op not in ("ping", "promote"):
            # a standby serves nothing: clients walk their address list to
            # the primary (the hint), an attaching standby re-points too
            await conn.send({"rid": rid, "ok": False, "standby": True,
                             "term": self._term, "primary": self.standby_of,
                             "error": f"standby; primary at "
                                      f"{self.standby_of}"})
            return
        if op in _WRITE_OPS:
            ft = f.get("term")
            if self._deposed_term is not None:
                # deposed: reads still answer (stale-tolerant, like any
                # outage window) but writes bounce so no divergent state
                # accrues; the term re-points term-aware clients
                await conn.send({
                    "rid": rid, "ok": False, "fenced": True,
                    "term": self._deposed_term,
                    "error": f"deposed: a newer primary holds term "
                             f"{self._deposed_term}"})
                return
            if ft is not None and int(ft) != self._term:
                if int(ft) > self._term:
                    # the client has seen a newer primary than us: we are
                    # the deposed half of a split brain — fence ourselves
                    self._depose(int(ft))
                await conn.send({
                    "rid": rid, "ok": False, "fenced": True,
                    "term": max(int(ft), self._term),
                    "error": f"term mismatch: yours {int(ft)}, "
                             f"server {self._term}"})
                return
        if op == "put":
            await self._op_put(f["key"], f["value"], f.get("lease", 0))
            await conn.send({"rid": rid, "ok": True})
        elif op == "get":
            e = self._kv.get(f["key"])
            await conn.send({"rid": rid, "ok": True,
                             "value": e.value if e else None,
                             "lease": e.lease_id if e else 0})
        elif op == "get_prefix":
            items = [
                {"key": k, "value": e.value, "lease": e.lease_id}
                for k, e in sorted(self._kv.items()) if k.startswith(f["prefix"])
            ]
            await conn.send({"rid": rid, "ok": True, "items": items})
        elif op == "delete":
            n = await self._op_delete(f["key"])
            await conn.send({"rid": rid, "ok": True, "deleted": n})
        elif op == "delete_prefix":
            keys = [k for k in self._kv if k.startswith(f["prefix"])]
            for k in keys:
                await self._op_delete(k)
            await conn.send({"rid": rid, "ok": True, "deleted": len(keys)})
        elif op == "put_if_absent":
            if f["key"] in self._kv:
                await conn.send({"rid": rid, "ok": True, "created": False})
            else:
                await self._op_put(f["key"], f["value"], f.get("lease", 0))
                await conn.send({"rid": rid, "ok": True, "created": True})
        elif op == "grant_lease":
            lease = self._grant_lease(float(f.get("ttl", 10.0)))
            conn.leases.add(lease.lease_id)
            await conn.send({"rid": rid, "ok": True, "lease": lease.lease_id,
                             "ttl": lease.ttl})
        elif op == "keepalive":
            lease = self._leases.get(f["lease"])
            if lease is None:
                await conn.send({"rid": rid, "ok": False, "error": "lease not found"})
            else:
                lease.expires_at = time.monotonic() + lease.ttl
                self._emit("keepalive", lease.lease_id)
                await conn.send({"rid": rid, "ok": True})
        elif op == "revoke":
            await self._revoke_lease(f["lease"])
            await conn.send({"rid": rid, "ok": True})
        elif op == "watch_prefix":
            watch_id = self._next()
            w = _Watch(watch_id=watch_id, prefix=f["prefix"], conn=conn)
            self._watches[watch_id] = w
            conn.watches[watch_id] = w
            # initial snapshot rides the response so watchers never miss state
            items = [
                {"key": k, "value": e.value, "lease": e.lease_id}
                for k, e in sorted(self._kv.items()) if k.startswith(f["prefix"])
            ]
            await conn.send({"rid": rid, "ok": True, "watch_id": watch_id,
                             "items": items})
        elif op == "unwatch":
            w = conn.watches.pop(f["watch_id"], None)
            if w:
                self._watches.pop(w.watch_id, None)
            await conn.send({"rid": rid, "ok": True})
        elif op == "publish":
            n = await self._op_publish(f["subject"], f["payload"])
            await conn.send({"rid": rid, "ok": True, "delivered": n})
        elif op == "subscribe":
            sub_id = self._next()
            sub = _Subscription(sub_id=sub_id, pattern=f["subject"], conn=conn,
                                queue_group=f.get("queue_group"))
            self._add_sub(sub)
            conn.subs[sub_id] = sub
            await conn.send({"rid": rid, "ok": True, "sub_id": sub_id})
        elif op == "unsubscribe":
            sub = conn.subs.pop(f["sub_id"], None)
            if sub:
                self._remove_sub(sub)
            await conn.send({"rid": rid, "ok": True})
        elif op == "queue_push":
            depth = await self._op_queue_push(f["queue"], f["payload"])
            await conn.send({"rid": rid, "ok": True, "depth": depth})
        elif op == "queue_pull":
            await self._op_queue_pull(conn, rid, f["queue"])
        elif op == "queue_cancel":
            pulls = self._queue_pulls.get(f["queue"], deque())
            target = [(c, r) for (c, r) in pulls
                      if c is conn and r == f["pull_rid"]]
            for item in target:
                pulls.remove(item)
            await conn.send({"rid": rid, "ok": True,
                             "cancelled": bool(target)})
        elif op == "queue_depth":
            q = self._queues.get(f["queue"])
            await conn.send({"rid": rid, "ok": True,
                             "depth": len(q) if q else 0,
                             "pullers": len(self._queue_pulls.get(
                                 f["queue"], ()))})
        elif op == "ping":
            resp = {"rid": rid, "ok": True, "time": time.time(),
                    "epoch": self._epoch, "term": self._term,
                    "role": self.role}
            if self.standby_of is not None:
                resp["standby"] = True
            if self._deposed_term is not None:
                resp["deposed"] = True
                resp["deposed_by"] = self._deposed_term
            await conn.send(resp)
        elif op == "promote":
            # manual promotion (admin op; also reachable via SIGUSR1 on a
            # standalone process) — idempotent on an acting primary
            self.promote(reason=str(f.get("reason") or "admin op"))
            await conn.send({"rid": rid, "ok": True, "term": self._term,
                             "role": self.role})
        elif op == "repl_attach":
            if self._deposed_term is not None:
                await conn.send({"rid": rid, "ok": False, "fenced": True,
                                 "term": self._deposed_term,
                                 "error": "deposed; attach to the primary"})
                return
            peer = _StandbyPeer(conn, str(f.get("addr") or ""))
            # snapshot + register with NO await in between: every entry
            # emitted after this point queues behind the snapshot, so the
            # standby's log has no gap and no overlap
            peer.q.put_nowait({"rid": rid, "ok": True,
                               "snapshot": self._snapshot()})
            self._standbys[conn] = peer
            if peer.addr:
                self._peer_addrs.add(peer.addr)
            peer.task = asyncio.create_task(peer._pump())
            self._ensure_peer_probe()
            logger.info("standby %s attached (%d key(s), %d lease(s), "
                        "seq %d)", peer.addr or "<unknown>", len(self._kv),
                        len(self._leases), self._repl_seq)
        else:
            await conn.send({"rid": rid, "ok": False, "error": f"unknown op {op!r}"})

    # -- KV ----------------------------------------------------------------

    async def _op_put(self, key: str, value: bytes, lease_id: int) -> None:
        if lease_id:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise ValueError(f"lease {lease_id} not found")
            lease.keys.add(key)
        prev = self._kv.get(key)
        self._kv[key] = _KvEntry(value=value, lease_id=lease_id,
                                 version=(prev.version + 1) if prev else 1)
        self._emit("put", key, value, lease_id)
        await self._notify_watchers("put", key, value, lease_id)

    async def _op_delete(self, key: str) -> int:
        e = self._kv.pop(key, None)
        if e is None:
            return 0
        if e.lease_id and e.lease_id in self._leases:
            self._leases[e.lease_id].keys.discard(key)
        self._emit("delete", key)
        await self._notify_watchers("delete", key, None, e.lease_id)
        return 1

    async def _notify_watchers(self, etype: str, key: str,
                               value: Optional[bytes], lease_id: int) -> None:
        for w in list(self._watches.values()):
            if key.startswith(w.prefix):
                await w.conn.send({"evt": "watch", "watch_id": w.watch_id,
                                   "type": etype, "key": key, "value": value,
                                   "lease": lease_id})

    # -- leases ------------------------------------------------------------

    def _grant_lease(self, ttl: float) -> _Lease:
        lease_id = self._next()
        lease = _Lease(lease_id=lease_id, ttl=ttl,
                       expires_at=time.monotonic() + ttl)
        self._leases[lease_id] = lease
        self._emit("lease", lease_id, ttl)
        return lease

    async def _revoke_lease(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        # unlease first, then the per-key deletes replicate themselves —
        # the standby applies the same sequence
        self._emit("unlease", lease_id)
        for key in list(lease.keys):
            await self._op_delete(key)

    async def _lease_scanner(self) -> None:
        while True:
            await asyncio.sleep(LEASE_SCAN_INTERVAL)
            if self._deposed_term is not None:
                # deposed: expiry is the new primary's duty now. Keepalives
                # bounce here (fenced), so expiring on our clock would mass-
                # revoke every lease within one TTL and stream spurious
                # delete events to watchers still attached to this half.
                continue
            now = time.monotonic()
            expired = [lid for lid, l in self._leases.items() if l.expires_at < now]
            for lid in expired:
                logger.info("lease %d expired; revoking %d keys",
                            lid, len(self._leases[lid].keys))
                await self._revoke_lease(lid)

    # -- work queues -------------------------------------------------------

    async def _op_queue_push(self, queue: str, payload: bytes) -> int:
        """FIFO push; delivers straight to a parked puller when one waits.

        Delivery is at-most-once (no acks): the prefill flow tolerates a
        lost job because the decode side times out and falls back to local
        prefill. Returns the post-push depth (0 = handed to a puller).

        Each delivery carries ``age_s`` — time spent queued by THE
        COORDINATOR'S clock — so consumers can expire stale jobs without
        comparing wall clocks across hosts (clock skew immune)."""
        pulls = self._queue_pulls.get(queue)
        while pulls:
            conn, rid = pulls.popleft()
            if conn.alive:
                await conn.send({"rid": rid, "ok": True, "payload": payload,
                                 "age_s": 0.0, "depth": 0})
                return 0
        q = self._queues.setdefault(queue, deque())
        q.append((payload, time.monotonic()))
        self._emit("qpush", queue, payload)
        return len(q)

    async def _op_queue_pull(self, conn: _Conn, rid: Any, queue: str) -> None:
        """Answer with the oldest item now, or park until a push arrives.
        A parked pull on a dying connection is skipped at delivery time."""
        q = self._queues.get(queue)
        if q:
            payload, t_in = q.popleft()
            self._emit("qpop", queue)
            await conn.send({"rid": rid, "ok": True, "payload": payload,
                             "age_s": time.monotonic() - t_in,
                             "depth": len(q)})
            return
        self._queue_pulls.setdefault(queue, deque()).append((conn, rid))

    # -- pub/sub -----------------------------------------------------------

    @staticmethod
    def _is_wild(pattern: str) -> bool:
        return pattern == ">" or pattern.endswith(".>")

    def _add_sub(self, sub: _Subscription) -> None:
        if self._is_wild(sub.pattern):
            self._subs_wild.append(sub)
        else:
            self._subs_exact.setdefault(sub.pattern, []).append(sub)

    def _remove_sub(self, sub: _Subscription) -> None:
        if self._is_wild(sub.pattern):
            self._subs_wild = [s for s in self._subs_wild
                               if s.sub_id != sub.sub_id]
        else:
            lst = self._subs_exact.get(sub.pattern, [])
            lst[:] = [s for s in lst if s.sub_id != sub.sub_id]
            if not lst:
                self._subs_exact.pop(sub.pattern, None)

    def _drop_conn_subs(self, conn: _Conn) -> None:
        for sub in list(conn.subs.values()):
            self._remove_sub(sub)

    def _matching_subs(self, subject: str):
        # snapshot copies: fan-out awaits between sends, and an
        # unsubscribe/disconnect during an await mutates these lists —
        # iterating the live list would skip a subscriber
        yield from list(self._subs_exact.get(subject, ()))
        for s in list(self._subs_wild):
            if _subject_matches(s.pattern, subject):
                yield s

    async def _op_publish(self, subject: str, payload: bytes) -> int:
        delivered = 0
        # queue groups: of the members subscribed with the same (pattern, group),
        # exactly one receives each message (NATS queue semantics — the
        # reference uses this for the JetStream prefill queue).
        groups: Dict[Tuple[str, str], List[_Subscription]] = {}
        for s in self._matching_subs(subject):
            if not s.conn.alive:
                continue
            if s.queue_group:
                groups.setdefault((s.pattern, s.queue_group), []).append(s)
            else:
                await s.conn.send({"evt": "msg", "sub_id": s.sub_id,
                                   "subject": subject, "payload": payload})
                delivered += 1
        for gkey, members in groups.items():
            idx = self._queue_rr.get(gkey, 0) % len(members)
            self._queue_rr[gkey] = idx + 1
            s = members[idx]
            await s.conn.send({"evt": "msg", "sub_id": s.sub_id,
                               "subject": subject, "payload": payload})
            delivered += 1
        return delivered

    # -- replication (primary side) ----------------------------------------

    def _emit(self, *entry: Any) -> None:
        """Append one ordered log entry to every attached standby's queue.
        Called synchronously AT the mutation point — never after an await —
        so the log order is exactly the apply order."""
        if not self._standbys:
            return
        self._repl_seq += 1
        frame = {"evt": "repl", "seq": self._repl_seq, "term": self._term,
                 "nid": self._next_id, "entry": list(entry)}
        for peer in self._standbys.values():
            peer.q.put_nowait(frame)

    def _snapshot(self) -> Dict[str, Any]:
        """Full state for a freshly attached standby (sync — must be built
        atomically with registering the standby)."""
        now = time.monotonic()
        return {
            "epoch": self._epoch,
            "term": self._term,
            "next_id": self._next_id,
            "seq": self._repl_seq,
            "kv": [[k, e.value, e.lease_id, e.version]
                   for k, e in self._kv.items()],
            # deadlines travel as REMAINING ttl: monotonic clocks don't
            # compare across hosts
            "leases": [[l.lease_id, l.ttl, max(0.0, l.expires_at - now)]
                       for l in self._leases.values()],
            "queues": [[name, [[p, now - t] for (p, t) in q]]
                       for name, q in self._queues.items() if q],
        }

    def _drop_standby(self, conn: "_Conn") -> None:
        peer = self._standbys.pop(conn, None)
        if peer is not None and peer.task is not None:
            peer.task.cancel()
            # addr stays in _peer_addrs: the probe loop needs it to detect
            # (and join) a standby that promoted while detached from us

    def _ensure_peer_probe(self) -> None:
        if self._peer_probe_task is None or self._peer_probe_task.done():
            self._peer_probe_task = asyncio.create_task(
                self._peer_probe_loop())

    async def _peer_probe_loop(self) -> None:
        """Primary-side split-brain detector: ping known standby addresses
        that are NOT currently attached.  A peer answering as a primary
        with a higher term means a promotion happened behind a partition —
        this process is deposed and demotes itself into a standby of the
        winner, restoring redundancy without an operator."""
        interval = max(min((self.promote_after_s or 2.0) / 2.0, 1.0), 0.1)
        while True:
            await asyncio.sleep(interval)
            if self.standby_of is not None:
                return  # demoted: the standby loop owns liveness now
            # a standby counts as healthy only while it keeps TALKING: an
            # open-but-silent replication connection (partitioned link,
            # blackhole) is exactly the case that splits the brain
            now = time.monotonic()
            stale_after = max(self.promote_after_s or 2.0, 3 * interval)
            attached = {p.addr for p in self._standbys.values()
                        if now - p.last_contact < stale_after}
            for addr in list(self._peer_addrs):
                if addr in attached or addr == self.address:
                    continue
                resp = await self._probe_peer(addr)
                if not resp or resp.get("standby"):
                    continue
                t = int(resp.get("term", 0) or 0)
                if t > self._term or (self._deposed_term is not None
                                      and t >= self._deposed_term):
                    self._depose(t, peer_addr=addr)
                    if self.standby_of is not None:
                        return

    async def _probe_peer(self, addr: str) -> Optional[Dict[str, Any]]:
        host, _, port = addr.rpartition(":")
        writer = None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host or "127.0.0.1", int(port)),
                timeout=0.5)
            await send_frame(writer, {"op": "ping", "rid": 1})
            return await asyncio.wait_for(read_frame(reader), timeout=0.5)
        except (OSError, asyncio.TimeoutError, ValueError):
            return None
        finally:
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass

    def _depose(self, new_term: int,
                peer_addr: Optional[str] = None) -> None:
        """Another coordinator holds a newer term: fence our writers; when
        the winner's address is known, rejoin as its hot standby."""
        if self.standby_of is not None:
            return
        if self._deposed_term is None or new_term > self._deposed_term:
            logger.warning(
                "coordinator %s deposed: observed term %d > ours %d%s",
                self.address, new_term, self._term,
                f" (new primary at {peer_addr})" if peer_addr else "")
            self._deposed_term = new_term
        # attached standbys must re-point to the new primary, not us
        for c in list(self._standbys):
            self._drop_standby(c)
            try:
                c.writer.close()
            except Exception:
                pass
        if peer_addr is not None:
            # demote: primary duties off, mirror the winner (the attach
            # replaces our — possibly divergent — state with its snapshot;
            # until it lands, auto-promotion must not trust this state)
            self._deposed_term = None
            self._ever_attached = False
            self.standby_of = peer_addr
            if self._lease_task is not None:
                self._lease_task.cancel()
            self._primary_last_contact = time.monotonic()
            self._standby_task = asyncio.create_task(self._standby_loop())
            logger.warning("coordinator %s demoted to standby of %s",
                           self.address, peer_addr)

    # -- replication (standby side) ----------------------------------------

    async def _standby_loop(self) -> None:
        """Attach to the primary, mirror its state, promote when it has
        been silent past ``promote_after_s`` (<=0 = manual-only)."""
        sleep_s = 0.05
        while self.standby_of is not None:
            self._maybe_promote()
            if self.standby_of is None:
                return
            phost, _, pport = self.standby_of.rpartition(":")
            writer = None
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(phost or "127.0.0.1",
                                            int(pport)),
                    timeout=max(min(self.promote_after_s or 1.0, 1.0), 0.1))
                sleep_s = 0.05
                await self._standby_attach(reader, writer)
            except asyncio.CancelledError:
                raise
            except (ConnectionError, OSError, asyncio.TimeoutError):
                pass  # primary down/unreachable: retry or promote
            except Exception:
                logger.exception("standby replication error")
            finally:
                if writer is not None:
                    try:
                        writer.close()
                    except Exception:
                        pass
            if self.standby_of is None:
                return
            await asyncio.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, 0.5)

    async def _standby_attach(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        # advertise an address the PRIMARY can actually dial back: bound to
        # a wildcard, self.address would be "0.0.0.0:port" — the primary's
        # peer probe would dial its own host and fencing would silently
        # never fire. The replication socket's local endpoint is our IP on
        # the route to the primary, which is exactly reachable from it.
        addr = self.address
        if self.host in ("", "0.0.0.0", "::"):
            local = writer.get_extra_info("sockname")
            if local:
                addr = f"{local[0]}:{self.port}"
        await send_frame(writer, {"op": "repl_attach", "rid": 1,
                                  "addr": addr})
        ping_interval = (max(min(self.promote_after_s / 3.0, 1.0), 0.05)
                         if self.promote_after_s and self.promote_after_s > 0
                         else 1.0)
        rids = itertools.count(2)
        last_ping = time.monotonic()
        attached = False
        while True:
            self._maybe_promote()
            if self.standby_of is None:
                return  # promoted mid-stream
            now = time.monotonic()
            if now - last_ping >= ping_interval:
                last_ping = now
                # liveness probe on the SAME connection the log rides: a
                # blackholed link (open TCP, no bytes) parks the reads and
                # the missing ping replies trip the promotion deadline
                await send_frame(writer, {"op": "ping", "rid": next(rids)})
            try:
                frame = await asyncio.wait_for(read_frame(reader),
                                               timeout=ping_interval)
            except asyncio.TimeoutError:
                continue
            if frame is None:
                raise ConnectionError("primary closed replication stream")
            self._primary_last_contact = time.monotonic()
            if frame.get("evt") == "repl":
                if attached:
                    await self._apply_repl(frame)
            elif frame.get("rid") == 1:
                if not frame.get("ok"):
                    hint = frame.get("primary")
                    if frame.get("standby") and hint:
                        # our primary demoted: follow it to the winner
                        logger.warning(
                            "replication target %s is itself a standby; "
                            "re-pointing to %s", self.standby_of, hint)
                        self.standby_of = hint
                    raise ConnectionError(
                        f"repl_attach refused: {frame.get('error')}")
                self._install_snapshot(frame["snapshot"])
                attached = True
            # other rids are ping replies: contact stamp above is enough

    def _install_snapshot(self, snap: Dict[str, Any]) -> None:
        now = time.monotonic()
        self._kv = {k: _KvEntry(value=v, lease_id=int(lid),
                                version=int(ver))
                    for k, v, lid, ver in snap.get("kv", [])}
        self._leases = {}
        for lid, ttl, remaining in snap.get("leases", []):
            self._leases[int(lid)] = _Lease(
                lease_id=int(lid), ttl=float(ttl),
                expires_at=now + float(remaining))
        for key, e in self._kv.items():
            if e.lease_id and e.lease_id in self._leases:
                self._leases[e.lease_id].keys.add(key)
        self._queues = {
            name: deque((p, now - float(age)) for p, age in items)
            for name, items in snap.get("queues", [])}
        self._epoch = int(snap["epoch"])
        self._term = int(snap.get("term", 0))
        self._next_id = int(snap.get("next_id", 1))
        self._repl_seq = int(snap.get("seq", 0))
        self._ever_attached = True
        logger.info(
            "standby installed snapshot from %s: %d key(s), %d lease(s), "
            "%d queue(s), seq %d, term %d", self.standby_of, len(self._kv),
            len(self._leases), len(self._queues), self._repl_seq, self._term)

    async def _apply_repl(self, frame: Dict[str, Any]) -> None:
        """Apply one primary log entry.  The mirrored ``nid`` keeps our id
        counter at least the primary's, so ids granted after promotion
        never collide with replicated lease ids."""
        self._term = int(frame.get("term", self._term))
        self._next_id = max(self._next_id, int(frame.get("nid", 0)))
        self._repl_seq = int(frame.get("seq", self._repl_seq))
        e = frame.get("entry") or []
        try:
            kind = e[0]
            if kind == "put":
                await self._op_put(e[1], e[2], int(e[3]))
            elif kind == "delete":
                await self._op_delete(e[1])
            elif kind == "lease":
                lid, ttl = int(e[1]), float(e[2])
                self._leases[lid] = _Lease(
                    lease_id=lid, ttl=ttl,
                    expires_at=time.monotonic() + ttl)
                self._next_id = max(self._next_id, lid + 1)
            elif kind == "keepalive":
                lease = self._leases.get(int(e[1]))
                if lease is not None:
                    lease.expires_at = time.monotonic() + lease.ttl
            elif kind == "unlease":
                # key deletes follow as their own entries
                self._leases.pop(int(e[1]), None)
            elif kind == "qpush":
                self._queues.setdefault(e[1], deque()).append(
                    (e[2], time.monotonic()))
            elif kind == "qpop":
                q = self._queues.get(e[1])
                if q:
                    q.popleft()
            else:
                logger.warning("unknown replication entry %r", kind)
        except Exception:  # noqa: BLE001 — one bad entry must not kill
            # the mirror; the next full-snapshot re-attach repairs drift
            logger.exception("failed to apply replication entry %r", e)

    def _maybe_promote(self) -> None:
        if (self.standby_of is None
                or not self.promote_after_s or self.promote_after_s <= 0
                or time.monotonic() - self._primary_last_contact
                < self.promote_after_s):
            return
        if not self._ever_attached:
            # nothing mirrored: promoting would bring up an EMPTY primary
            # with a fresh epoch next to a possibly-alive real one
            logger.warning(
                "standby %s: primary %s silent past %.1fs but no snapshot "
                "was ever installed; NOT auto-promoting (use the promote "
                "admin op / SIGUSR1 to force)", self.address,
                self.standby_of, self.promote_after_s)
            self._primary_last_contact = time.monotonic()  # re-arm, no spam
            return
        self.promote(reason=f"primary silent "
                            f">= {self.promote_after_s:.1f}s")

    def promote(self, reason: str = "manual") -> None:
        """Become the acting primary: bump the fencing term, rebase lease
        deadlines by the grace window (no mass-expiry mid-failover), start
        primary duties.  Idempotent on an acting primary."""
        if self.standby_of is None and self._deposed_term is None:
            return
        self.standby_of = None
        self._term = max(self._term, self._deposed_term or 0) + 1
        self._deposed_term = None
        self.failovers_total += 1
        # skip the id counter past anything the dead primary may have
        # issued in the replication-lag window before it died: a lease
        # granted there is unknown to us, and re-issuing its NUMBER to a
        # new client would make the victim's same-epoch resync probe adopt
        # the foreign lease (the exact hazard the boot-epoch check exists
        # to prevent — async replication re-opens it under a matching
        # epoch unless the id spaces are kept disjoint)
        self._next_id += 1000
        now = time.monotonic()
        for lease in self._leases.values():
            lease.expires_at = max(lease.expires_at,
                                   now + lease.ttl + self.lease_grace_s)
        if self._lease_task is None or self._lease_task.done():
            self._lease_task = asyncio.create_task(self._lease_scanner())
        logger.warning(
            "coordinator %s promoted to primary (%s): term %d, %d key(s), "
            "%d lease(s) rebased +%.1fs grace, %d queued job(s)",
            self.address, reason, self._term, len(self._kv),
            len(self._leases), self.lease_grace_s,
            sum(len(q) for q in self._queues.values()))


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class NotPrimaryError(ConnectionError):
    """The reached coordinator is alive but not the acting primary (a
    standby awaiting promotion, a deposed/stale primary).  The reconnect
    loop walks on with a SHORT retry cap instead of growing the outage
    backoff: the pair is up, the failover completes within the promote
    window, and waiting out a full backoff cycle would dominate the
    failover-to-ready latency."""


# retry ceiling while bouncing off a live-but-not-primary server
_NOT_PRIMARY_RETRY_CAP_S = 0.25


class WatchEvent:
    __slots__ = ("type", "key", "value", "lease_id")

    def __init__(self, type: str, key: str, value: Optional[bytes], lease_id: int = 0):
        self.type = type
        self.key = key
        self.value = value
        self.lease_id = lease_id

    def __repr__(self) -> str:
        return f"WatchEvent({self.type}, {self.key!r})"


class Watch:
    """A live prefix watch: initial snapshot + async iterator of events.

    The watch survives coordinator reconnects: ``state`` tracks the
    last-delivered view of the prefix, and on resync the client re-scans the
    prefix and diffs against it, synthesizing put/delete events so consumers
    see one consistent stream instead of EOF (see CoordClient._resync)."""

    def __init__(self, client: "CoordClient", watch_id: int,
                 snapshot: List[Dict[str, Any]], prefix: str = ""):
        self._client = client
        self.watch_id = watch_id
        self.prefix = prefix
        self.snapshot = [(i["key"], i["value"]) for i in snapshot]
        # last-known view: key -> (value, lease_id); tuples are stored by
        # identity so the resync grace pass can tell "unchanged since the
        # outage" from "re-put with the same value"
        self.state: Dict[str, Tuple[Optional[bytes], int]] = {
            i["key"]: (i["value"], i.get("lease", 0)) for i in snapshot}
        self.queue: asyncio.Queue = asyncio.Queue()
        self.cancelled = False

    def _deliver(self, ev: WatchEvent) -> None:
        if ev.type == "put":
            self.state[ev.key] = (ev.value, ev.lease_id)
        elif ev.type == "delete":
            self.state.pop(ev.key, None)
        self.queue.put_nowait(ev)

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        ev = await self.queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev

    async def cancel(self) -> None:
        # flag first: a resync running concurrently must not resurrect
        # this watch when it swaps in the re-registered id map
        self.cancelled = True
        await self._client.unwatch(self.watch_id)


class Subscription:
    """A live pub/sub subscription: async iterator of (subject, payload).

    Remembers its subject/queue_group so the client can re-subscribe it
    transparently after a coordinator reconnect."""

    def __init__(self, client: "CoordClient", sub_id: int, subject: str = "",
                 queue_group: Optional[str] = None):
        self._client = client
        self.sub_id = sub_id
        self.subject = subject
        self.queue_group = queue_group
        self.queue: asyncio.Queue = asyncio.Queue()
        self.cancelled = False

    def __aiter__(self) -> "Subscription":
        return self

    async def __anext__(self) -> Tuple[str, bytes]:
        item = await self.queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    async def cancel(self) -> None:
        self.cancelled = True  # see Watch.cancel
        await self._client.unsubscribe(self.sub_id)


class Lease:
    """Client-side lease handle with automatic keep-alive task.

    Robustness contract (vs. the original fail-on-first-error loop):

    - transient keep-alive failures retry within the TTL budget instead of
      declaring the lease lost immediately;
    - a coordinator disconnect parks the loop until the supervised client
      reconnects — the resync protocol re-probes the lease and, if the
      server no longer knows it, re-grants it under a NEW id, mutating
      ``lease_id`` in place and firing ``on_relocated`` callbacks;
    - ``lost`` fires only when the lease is genuinely unrecoverable: the
      client closed (or gave up reconnecting), or keep-alives kept failing
      past a full TTL while connected.
    """

    def __init__(self, client: "CoordClient", lease_id: int, ttl: float):
        self.client = client
        self.lease_id = lease_id
        self.ttl = ttl
        self._task: Optional[asyncio.Task] = None
        self.lost = asyncio.Event()
        self._relocated_cbs: List[Callable[[int, int], None]] = []
        self._last_ok = time.monotonic()

    def on_relocated(self, cb: Callable[[int, int], None]) -> None:
        """Register ``cb(old_id, new_id)``, fired when a coordinator resync
        re-grants this lease under a fresh id."""
        self._relocated_cbs.append(cb)

    def _relocate(self, new_id: int) -> None:
        old, self.lease_id = self.lease_id, new_id
        self._last_ok = time.monotonic()
        logger.info("lease %d relocated to %d by coordinator resync",
                    old, new_id)
        for cb in list(self._relocated_cbs):
            try:
                cb(old, new_id)
            except Exception:
                logger.exception("lease relocated callback failed")

    def _mark_lost(self) -> None:
        # deregister before signalling: a later resync must not re-grant a
        # lease nobody keeps alive any more
        self.client._lease_handles.discard(self)
        self.lost.set()

    def start_keepalive(self) -> None:
        self._task = asyncio.create_task(self._keepalive_loop())

    async def _keepalive_loop(self) -> None:
        # (no CancelledError catch: see utils/aio.reap_task)
        interval = max(self.ttl / 3.0, 0.1)
        retry_sleep = max(min(interval / 4.0, 0.25), 0.02)
        self._last_ok = time.monotonic()
        while True:
            await asyncio.sleep(interval)
            while True:
                if self.client.closed.is_set():
                    self._mark_lost()
                    return
                if not self.client.connected:
                    # outage: the resync protocol re-probes / re-grants this
                    # lease as part of reconnecting, so just wait it out
                    try:
                        await self.client.wait_connected()
                    except ConnectionError:
                        logger.warning("lease %d lost: coordinator client "
                                       "closed", self.lease_id)
                        self._mark_lost()
                        return
                    self._last_ok = time.monotonic()
                    break
                try:
                    # bounded: a half-open connection (blackholed but not
                    # reset — read loop never errors) must not hang the RPC
                    # forever, or the lease silently expires server-side
                    # while this loop still believes it is healthy; a hang
                    # lands in the TTL-budget branch below like any other
                    # transient failure
                    await asyncio.wait_for(
                        self.client.keepalive(self.lease_id),
                        timeout=interval)
                    self._last_ok = time.monotonic()
                    break
                except ConnectionError:
                    # the write side can fail before the read loop marks the
                    # connection down; yield briefly so we land in the
                    # disconnected branch above instead of spinning
                    await asyncio.sleep(retry_sleep)
                    continue
                except Exception:
                    # transient server-side refusal (e.g. "lease not found"
                    # racing an in-flight relocation): retry inside the TTL
                    # budget before giving the lease up for dead
                    if time.monotonic() - self._last_ok >= self.ttl:
                        logger.warning(
                            "lease %d keep-alive failed past its %.1fs TTL "
                            "budget; lost", self.lease_id, self.ttl)
                        self._mark_lost()
                        return
                    await asyncio.sleep(retry_sleep)

    async def revoke(self) -> None:
        if self._task:
            self._task.cancel()
        # deregister first so a concurrent resync can't resurrect it
        self.client._lease_handles.discard(self)
        try:
            await self.client.revoke(self.lease_id)
        except Exception:
            pass


def replay_registry(client: Any, attr: str, factory: Callable[[], Any],
                    replay: Callable[[Any], Awaitable[None]]) -> Any:
    """Owner-replay registry cached on ``client`` under ``attr``, with ONE
    resync hook replaying its contents after every reconnect.

    Handles are constructed per call-site (kv buckets, model registrations),
    so a hook per handle would accumulate on the client forever and replay
    superseded state; a shared registry gives replace-not-accumulate
    semantics. Only the first caller's ``replay`` is attached; ``client``
    may be any duck-typed store — no hook on ones without resync support."""
    reg = getattr(client, attr, None)
    if reg is None:
        reg = factory()
        setattr(client, attr, reg)
        if hasattr(client, "add_resync_hook"):
            async def _replay_hook() -> None:
                await replay(reg)

            client.add_resync_hook(_replay_hook)
    return reg


class CoordClient:
    """Async client for the Coordinator, with a supervised connection.

    A coordinator crash/restart is transparent to consumers (parity with how
    the reference's etcd/NATS clients survive server restarts):

    - on disconnect, in-flight calls fail fast with ``ConnectionError`` but
      watches, subscriptions and leases are KEPT; a background task retries
      the connection with decorrelated-jitter backoff;
    - on reconnect, a **resync protocol** runs: live leases are probed and
      re-granted (new ids) where the server lost them, registered *resync
      hooks* replay owner state (instance registrations, model cards,
      barrier check-ins), every watch re-scans its prefix and diffs against
      its last-known state to synthesize put/delete deltas, and event
      subscriptions are re-established;
    - ``closed`` now means *permanently* closed: ``close()`` was called, or
      the reconnect give-up window (``DYN_COORD_RECONNECT_MAX_S``) elapsed.

    Knobs (env, or constructor overrides): ``DYN_COORD_RECONNECT`` (0
    disables supervision and restores fail-on-first-disconnect),
    ``DYN_COORD_RECONNECT_BASE_S`` / ``_CAP_S`` (backoff),
    ``DYN_COORD_RECONNECT_MAX_S`` (0 = retry forever) and
    ``DYN_COORD_RESYNC_GRACE_S`` (stale-read window before a key missing
    from the post-restart scan is reported deleted).
    """

    def __init__(self, address: str, reconnect: Optional[bool] = None,
                 reconnect_base_s: Optional[float] = None,
                 reconnect_cap_s: Optional[float] = None,
                 reconnect_max_s: Optional[float] = None,
                 resync_grace_s: Optional[float] = None,
                 resync_timeout_s: Optional[float] = None):
        # comma-separated multi-address: "host:6650,host:6651" names a
        # replicated pair; connect and the reconnect loop walk the list,
        # skipping standbys, so failover needs no reconfiguration. A list
        # of one is exactly the single-coordinator behavior.
        self.addresses: List[Tuple[str, int]] = []
        for part in address.split(","):
            part = part.strip()
            if not part:
                continue
            host, _, port = part.rpartition(":")
            self.addresses.append((host or "127.0.0.1", int(port)))
        if not self.addresses:
            raise ValueError(f"no coordinator address in {address!r}")
        self._addr_idx = 0
        self.host, self.port = self.addresses[0]
        env = os.environ.get
        self.reconnect = (env("DYN_COORD_RECONNECT", "1").lower()
                          not in ("0", "false", "no")
                          if reconnect is None else reconnect)
        self.reconnect_base_s = (float(env("DYN_COORD_RECONNECT_BASE_S",
                                           "0.05"))
                                 if reconnect_base_s is None
                                 else reconnect_base_s)
        self.reconnect_cap_s = (float(env("DYN_COORD_RECONNECT_CAP_S", "2.0"))
                                if reconnect_cap_s is None else reconnect_cap_s)
        self.reconnect_max_s = (float(env("DYN_COORD_RECONNECT_MAX_S", "0"))
                                if reconnect_max_s is None else reconnect_max_s)
        self.resync_grace_s = (float(env("DYN_COORD_RESYNC_GRACE_S", "5.0"))
                               if resync_grace_s is None else resync_grace_s)
        self.resync_timeout_s = (float(env("DYN_COORD_RESYNC_TIMEOUT_S",
                                           "30.0"))
                                 if resync_timeout_s is None
                                 else resync_timeout_s)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._rids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watches: Dict[int, Watch] = {}
        self._subs: Dict[int, Subscription] = {}
        self._lease_handles: set = set()
        self._resync_hooks: List[Callable] = []
        # events/messages that raced ahead of watch/subscription registration
        # (the server's response and a first event can share one TCP segment)
        self._orphan_events: Dict[int, list] = {}
        self._orphan_msgs: Dict[int, list] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._resync_task: Optional[asyncio.Task] = None
        # what the last resync attempt re-registered on the live connection;
        # re-swept for late cancels once connected. Objects, not ids: a
        # wiped server's restarted id counter reuses NUMBERS, so an id alone
        # cannot say whose registration it names
        self._resync_watch_objs: List[Watch] = []
        self._resync_sub_objs: List[Subscription] = []
        self._deferred: set = set()  # grace-delayed delete tasks
        self._wlock: Optional[asyncio.Lock] = None
        self._connected = asyncio.Event()
        self._closing = False
        self._disconnected_at: Optional[float] = None
        self._server_epoch: Optional[int] = None
        # highest fencing term seen (ping echo / fenced bounce); stamped on
        # writes. None until a term-aware server is seen — so against a
        # pre-replication server nothing is stamped (fencing disabled)
        self._term: Optional[int] = None
        self._conn_lost_flag = False  # current connection died (see below)
        self.closed = asyncio.Event()
        # observability (exported via http/metrics.CoordClientMetrics)
        self.reconnects_total = 0
        self.resyncs_total = 0
        self.last_outage_s = 0.0

    # -- connection supervision --------------------------------------------

    @property
    def connected(self) -> bool:
        return self._connected.is_set() and not self.closed.is_set()

    async def wait_connected(self, timeout: Optional[float] = None) -> None:
        """Block until the connection is up and resynced; raises
        ``ConnectionError`` when the client is permanently closed (or on
        ``timeout``)."""
        if self.closed.is_set():
            raise ConnectionError("coordinator client closed")
        if self._connected.is_set():
            return
        conn = asyncio.ensure_future(self._connected.wait())
        clo = asyncio.ensure_future(self.closed.wait())
        try:
            done, _ = await asyncio.wait({conn, clo}, timeout=timeout,
                                         return_when=asyncio.FIRST_COMPLETED)
            if conn in done:
                return
            if clo in done:
                raise ConnectionError("coordinator client closed")
            raise ConnectionError(
                "timed out waiting for coordinator reconnect")
        finally:
            conn.cancel()
            clo.cancel()

    def add_resync_hook(self, hook: Callable) -> Callable:
        """Register an async callable invoked after leases are re-established
        on every reconnect, BEFORE watches are re-scanned — re-put owner
        state (instance registrations, model cards, barrier keys) here so
        the resync diff already sees it. Returns ``hook`` for symmetry with
        ``remove_resync_hook``."""
        self._resync_hooks.append(hook)
        return hook

    def remove_resync_hook(self, hook: Callable) -> None:
        try:
            self._resync_hooks.remove(hook)
        except ValueError:
            pass

    async def connect(self) -> "CoordClient":
        last: Optional[BaseException] = None
        for _ in range(len(self.addresses)):
            self.host, self.port = self.addresses[self._addr_idx]
            try:
                await self._connect_one()
                return self
            except asyncio.CancelledError:
                await self.close()
                raise
            except BaseException as e:
                # this address failed (dead, standby, deposed): tear the
                # attempt down WITHOUT closing the client and walk on
                last = e
                await self._abort_conn_attempt()
                self._addr_idx = (self._addr_idx + 1) % len(self.addresses)
        # a half-opened connection (server died mid-handshake) must not
        # leave a background reconnect loop running on an object the
        # caller is about to abandon — connect() either works or is void
        await self.close()
        raise last if last is not None else ConnectionError(
            "no coordinator reachable")

    async def _connect_one(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        self._wlock = asyncio.Lock()
        self._connected.set()
        self._reader_task = asyncio.create_task(self._read_loop(self._reader))
        # baseline boot epoch: resync compares against it to tell a blipped
        # server (state intact, probe leases) from a fresh one (re-grant).
        # bounded like resync: a server that accepts TCP but never
        # answers must not hang startup forever
        resp = await asyncio.wait_for(self._call("ping"),
                                      timeout=self.resync_timeout_s or None)
        if resp.get("standby"):
            raise NotPrimaryError(
                f"{self.host}:{self.port} is a standby coordinator")
        if resp.get("deposed"):
            raise NotPrimaryError(
                f"{self.host}:{self.port} is a deposed coordinator")
        self._server_epoch = resp.get("epoch")
        term = resp.get("term")
        self._term = int(term) if term is not None else None

    async def _abort_conn_attempt(self) -> None:
        """Undo one failed connect() attempt: kill the socket and reader
        task without flipping ``closed`` (the walk continues)."""
        self._connected.clear()
        # null the reader FIRST (sync): any read loop dying from here on
        # sees a superseded connection in _on_conn_lost and cannot start
        # reconnect supervision behind the walk's back
        task, self._reader_task = self._reader_task, None
        self._reader = None
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
        # a read loop that died DURING the attempt (server hung up) may
        # already have started supervision — and that loop may have opened
        # a fresh connection meanwhile: reap it, then sweep again
        if self._reconnect_task is not None:
            reconnect, self._reconnect_task = self._reconnect_task, None
            await reap_task(reconnect)
        if task is not None:
            await reap_task(task)
        # anything the reaped supervision installed before dying
        extra, self._reader_task = self._reader_task, None
        self._reader = None
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
        if extra is not None:
            await reap_task(extra)

    async def close(self) -> None:
        self._closing = True
        if self._reconnect_task is not None:
            await reap_task(self._reconnect_task)
            self._reconnect_task = None
        await reap_task(self._reader_task)
        if self._writer:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
        self._finalize_closed()

    async def __aenter__(self) -> "CoordClient":
        return await self.connect()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def _dispatch_frame(self, frame: Dict[str, Any]) -> None:
        if "rid" in frame and frame["rid"] is not None:
            fut = self._pending.pop(frame["rid"], None)
            if fut and not fut.done():
                fut.set_result(frame)
        elif frame.get("evt") == "watch":
            ev = WatchEvent(frame["type"], frame["key"],
                            frame.get("value"), frame.get("lease", 0))
            w = self._watches.get(frame["watch_id"])
            if w:
                w._deliver(ev)
            else:
                buf = self._orphan_events.setdefault(frame["watch_id"], [])
                if len(buf) < 10_000:
                    buf.append(ev)
        elif frame.get("evt") == "msg":
            item = (frame["subject"], frame["payload"])
            s = self._subs.get(frame["sub_id"])
            if s:
                s.queue.put_nowait(item)
            else:
                buf = self._orphan_msgs.setdefault(frame["sub_id"], [])
                if len(buf) < 10_000:
                    buf.append(item)

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                self._dispatch_frame(frame)
        except (ConnectionError, OSError):
            pass  # CancelledError must propagate (see utils/aio.reap_task)
        finally:
            self._on_conn_lost(reader)

    def _on_conn_lost(self, reader: asyncio.StreamReader) -> None:
        if reader is not self._reader:
            return  # a stale loop from a superseded connection
        # a still-running reconnect task (below we early-return rather than
        # double-supervise) must not declare success on this dead
        # connection: it re-checks this flag after its resync completes
        self._conn_lost_flag = True
        self._connected.clear()
        # in-flight calls fail fast (callers retry or surface the outage);
        # orphan buffers are connection-scoped — clear them so events from a
        # dead watch registration can't accumulate forever (nor leak into a
        # reconnected session whose server assigns fresh ids)
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    ConnectionError("coordinator connection lost"))
        self._pending.clear()
        self._orphan_events.clear()
        self._orphan_msgs.clear()
        # registrations from the dead connection need no undo
        self._resync_watch_objs = []
        self._resync_sub_objs = []
        # a pending grace-window delete must not fire while offline: no
        # events arrive to refute it (the owner may have re-put the key on
        # the server, invisibly to us), and the next resync re-diffs anyway
        for t in list(self._deferred):
            t.cancel()
        if self._closing or not self.reconnect:
            self._finalize_closed()
            return
        if self._reconnect_task is not None and not self._reconnect_task.done():
            return  # supervision already running; it retries on its own
        self._disconnected_at = time.monotonic()
        logger.warning("coordinator connection %s:%d lost; reconnecting",
                       self.host, self.port)
        self._reconnect_task = asyncio.create_task(self._reconnect_loop())

    def _finalize_closed(self) -> None:
        """Permanent teardown: fail everything and end every iterator."""
        if self.closed.is_set():
            return
        self.closed.set()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    ConnectionError("coordinator connection lost"))
        self._pending.clear()
        for t in list(self._deferred):
            t.cancel()
        for w in self._watches.values():
            w.queue.put_nowait(None)
        for s in self._subs.values():
            s.queue.put_nowait(None)

    async def _reconnect_loop(self) -> None:
        sleep_s = self.reconnect_base_s

        def backoff() -> float:
            # a fleet of clients must not stampede the restarted
            # coordinator in lockstep (same helper as push_router failover)
            return decorrelated_jitter(sleep_s, self.reconnect_base_s,
                                       self.reconnect_cap_s)

        while True:
            if self._closing:
                return
            down_for = time.monotonic() - (self._disconnected_at
                                           or time.monotonic())
            if self.reconnect_max_s and down_for > self.reconnect_max_s:
                logger.error(
                    "giving up on coordinator %s:%d after %.1fs offline",
                    self.host, self.port, down_for)
                self._finalize_closed()
                return
            # walk the address list: each failed attempt advances to the
            # next candidate (a single address degenerates to retry-same)
            self.host, self.port = self.addresses[self._addr_idx]
            try:
                # bounded attempt: a blackholed address must not park the
                # loop for the kernel connect timeout (minutes) — backoff
                # pacing and the give-up window only advance between tries
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(self.host, self.port),
                    timeout=max(self.reconnect_cap_s, 1.0))
            except (OSError, asyncio.TimeoutError):
                self._addr_idx = (self._addr_idx + 1) % len(self.addresses)
                sleep_s = backoff()
                await asyncio.sleep(sleep_s)
                continue
            old_writer, self._reader, self._writer = \
                self._writer, reader, writer
            self._conn_lost_flag = False  # tracking the NEW connection now
            if old_writer is not None:
                try:
                    old_writer.close()
                except Exception:
                    pass
            self._reader_task = asyncio.create_task(self._read_loop(reader))
            try:
                # bounded: a server that accepts the connection but never
                # answers (frozen / blackholed half-open) must not park
                # supervision forever — the give-up window is only checked
                # between attempts. wait_for runs _resync in its OWN task,
                # so _call's disconnected-fail-fast exemption tracks it.
                # attempts, not completions: divergence from
                # reconnects_total below is the retried-resync signal
                self.resyncs_total += 1
                self._resync_task = asyncio.ensure_future(self._resync())
                try:
                    await asyncio.wait_for(self._resync_task,
                                           timeout=self.resync_timeout_s
                                           or None)
                finally:
                    self._resync_task = None
                if self._conn_lost_flag:
                    # the connection died during resync, after answering the
                    # last call — the read loop's _on_conn_lost deferred to
                    # this (still-running) task, so the retry is on us:
                    # declaring success would wedge the client forever
                    raise ConnectionError("connection lost during resync")
            except NotPrimaryError as e:
                # a live server that just isn't the primary (yet): walk on
                # with a short retry cap — promotion completes within the
                # promote window and a full outage backoff would dominate
                # the failover-to-ready latency
                logger.info("coordinator resync walked on (%s)", e)
                try:
                    writer.close()
                except Exception:
                    pass
                self._addr_idx = (self._addr_idx + 1) % len(self.addresses)
                sleep_s = min(backoff(), _NOT_PRIMARY_RETRY_CAP_S)
                await asyncio.sleep(sleep_s)
                continue
            except Exception as e:  # noqa: BLE001 — any resync failure
                # (connection died again, server error, landed on a
                # standby/deposed/stale primary) restarts supervision on
                # the next address
                logger.warning("coordinator resync failed (%s); retrying", e)
                try:
                    writer.close()
                except Exception:
                    pass
                self._addr_idx = (self._addr_idx + 1) % len(self.addresses)
                sleep_s = backoff()
                await asyncio.sleep(sleep_s)
                continue
            outage = time.monotonic() - (self._disconnected_at
                                         or time.monotonic())
            self._disconnected_at = None
            self.reconnects_total += 1
            self.last_outage_s = outage
            self._connected.set()
            # re-sweep for cancels that raced the resync after its own
            # cancelled-sweep passed: their unwatch RPC failed fast while
            # the resync held the connection, but the registration is LIVE.
            # Each object's current id was issued to IT on this connection,
            # so this can never hit a sibling (unlike sweeping raw ids —
            # a wiped server's restarted counter reuses numbers); an id the
            # resync's own sweep already dropped errors harmlessly
            for w in self._resync_watch_objs:
                if w.cancelled:
                    self._orphan_events.pop(w.watch_id, None)
                    try:
                        await self._call("unwatch", watch_id=w.watch_id)
                    except Exception:
                        pass
            self._resync_watch_objs = []
            for s in self._resync_sub_objs:
                if s.cancelled:
                    self._orphan_msgs.pop(s.sub_id, None)
                    try:
                        await self._call("unsubscribe", sub_id=s.sub_id)
                    except Exception:
                        pass
            self._resync_sub_objs = []
            logger.info(
                "coordinator %s:%d reconnected after %.2fs outage; resynced "
                "%d lease(s), %d watch(es), %d subscription(s), %d hook(s)",
                self.host, self.port, outage, len(self._lease_handles),
                len(self._watches), len(self._subs),
                len(self._resync_hooks))
            return

    async def _resync(self) -> None:
        """Rebuild server-side session state on a fresh connection.

        Order matters: leases first (hooks attach keys to them), then the
        resync hooks (owners re-put their state so the watch re-scan below
        already includes it), then watches (prefix re-scan + diff against
        each watch's last-known state), then subscriptions."""
        # 0. boot epoch: a changed epoch means a fresh/wiped process whose
        # restarted id counter may have RE-ISSUED our old lease ids to other
        # clients — an existence probe would then adopt a foreign lease
        # (and die with it when its real owner revokes). Same epoch means
        # the server's state survived and probing is trustworthy. A hot
        # standby MIRRORS its primary's epoch, so a failover lands here as
        # the cheap probe path: every replicated lease keeps its id.
        ping = await self._call("ping")
        if ping.get("standby"):
            raise NotPrimaryError("reached a standby coordinator; "
                                  "walking the address list")
        if ping.get("deposed"):
            self._term = max(self._term or 0,
                             int(ping.get("deposed_by", 0) or 0))
            raise NotPrimaryError("reached a deposed coordinator; "
                                  "walking the address list")
        epoch = ping.get("epoch")
        fresh_server = epoch != self._server_epoch
        term = ping.get("term")
        if term is None:
            self._term = None  # pre-replication server: fencing disabled
        elif fresh_server:
            self._term = int(term)  # new lineage, new term sequence
        elif self._term is not None and int(term) < self._term:
            # same lineage but an OLDER term than we've already seen: this
            # is the deposed half of a split brain that hasn't noticed yet
            raise NotPrimaryError(
                f"stale primary: term {int(term)} < {self._term} seen; "
                "walking the address list")
        else:
            self._term = int(term)
        # 1. leases: probe-or-regrant. A lease that survived the outage
        # (connection blip, or restart without state wipe within TTL) keeps
        # its id — zero churn; one the server lost is re-granted under a
        # fresh id and the handle relocates in place.
        for lease in list(self._lease_handles):
            if not fresh_server:
                try:
                    await self._call("keepalive", lease=lease.lease_id)
                    continue
                except ConnectionError:
                    raise
                except Exception:
                    pass  # lease not found -> re-grant below
            resp = await self._call("grant_lease", ttl=lease.ttl)
            lease._relocate(int(resp["lease"]))
        # only now: a retry after a partial lease pass must still see the
        # epoch as fresh and re-grant the remainder
        self._server_epoch = epoch
        # 2. resync hooks: replay owner state under the fresh leases
        for hook in list(self._resync_hooks):
            try:
                await hook()
            except (ConnectionError, OSError):
                raise
            except Exception:
                logger.exception("coordinator resync hook failed")
        # 3. watches: re-register, then diff the fresh snapshot against the
        # watcher's last-known state, synthesizing deltas. A state-wiped
        # server restarts its id counter, so a fresh id routinely collides
        # with a sibling's OLD id: detach the registry up front (events that
        # arrive mid-registration park in the orphan buffer instead of
        # hitting a stale same-id entry) and swap the new map in whole.
        watches = [w for w in self._watches.values() if not w.cancelled]
        self._watches = {}
        scans = []
        try:
            for w in watches:
                resp = await self._call("watch_prefix", prefix=w.prefix)
                w.watch_id = int(resp["watch_id"])
                scans.append(resp.get("items", []))
        except BaseException:
            # keep the watch set for the retry; ids from the failed attempt
            # are dead and may collide, so key uniquely (the next attempt
            # iterates values() and re-registers by prefix)
            self._watches = {-i: w for i, w in enumerate(watches, 1)}
            raise
        self._watches = {w.watch_id: w for w in watches if not w.cancelled}
        self._resync_watch_objs = watches  # for the post-connect re-sweep
        for w, items in zip(watches, scans):
            if w.cancelled:
                continue
            # diff first, then the live events that raced the registration
            # (the server's response and a first event can share one TCP
            # segment — same race watch_prefix() drains after registering)
            self._resync_watch(w, items)
            for ev in self._orphan_events.pop(w.watch_id, []):
                w._deliver(ev)
        for w in watches:
            if w.cancelled:
                # cancelled while this resync was re-registering it: the
                # cancel's own unwatch went to the dead connection, so undo
                # the fresh registration or the server streams the prefix
                # into a dropped id forever
                await self._call("unwatch", watch_id=w.watch_id)
                self._orphan_events.pop(w.watch_id, None)
        # 4. subscriptions: re-subscribe under fresh server-side ids (same
        # detach/swap/drain dance as watches)
        subs = [s for s in self._subs.values() if not s.cancelled]
        self._subs = {}
        try:
            for s in subs:
                resp = await self._call("subscribe", subject=s.subject,
                                        queue_group=s.queue_group)
                s.sub_id = int(resp["sub_id"])
        except BaseException:
            self._subs = {-i: s for i, s in enumerate(subs, 1)}
            raise
        self._subs = {s.sub_id: s for s in subs if not s.cancelled}
        self._resync_sub_objs = subs  # for the post-connect re-sweep
        # drain BEFORE the sweep's awaits: once the swap is live, new
        # messages go straight to the queues, and a message orphaned during
        # re-registration must not be delivered after one that arrived later
        for s in self._subs.values():
            for item in self._orphan_msgs.pop(s.sub_id, []):
                s.queue.put_nowait(item)
        for s in subs:
            if s.cancelled:  # see the watch sweep above
                await self._call("unsubscribe", sub_id=s.sub_id)
                self._orphan_msgs.pop(s.sub_id, None)

    def _resync_watch(self, w: Watch, items: List[Dict[str, Any]]) -> None:
        new = {i["key"]: (i["value"], i.get("lease", 0)) for i in items}
        old = dict(w.state)
        for key in sorted(new):
            value, lease_id = new[key]
            prev = old.get(key)
            if prev is None or prev[0] != value or prev[1] != lease_id:
                w._deliver(WatchEvent("put", key, value, lease_id))
        missing = {k: old[k] for k in old if k not in new}
        if not missing:
            return
        if self.resync_grace_s <= 0:
            for key, (_value, lease_id) in sorted(missing.items()):
                w._deliver(WatchEvent("delete", key, None, lease_id))
            return
        # stale-read window: a key absent right after a restart is usually a
        # peer that simply hasn't resynced yet (its re-put is racing ours) —
        # report the delete only if it stays gone past the grace window, so
        # consumers (instance discovery, model cards) never flap through
        # empty during a restart
        task = asyncio.create_task(self._deferred_deletes(w, missing))
        self._deferred.add(task)
        task.add_done_callback(self._deferred.discard)

    async def _deferred_deletes(
            self, w: Watch,
            missing: Dict[str, Tuple[Optional[bytes], int]]) -> None:
        await asyncio.sleep(self.resync_grace_s)
        for key, stamp in sorted(missing.items()):
            # identity check: a re-put (even of an equal value) stored a new
            # tuple; only untouched-since-the-outage keys get the delete
            if w.state.get(key) is stamp and self._watches.get(w.watch_id) is w:
                w._deliver(WatchEvent("delete", key, None, stamp[1]))

    async def _call(self, op: str, **kw: Any) -> Dict[str, Any]:
        if self._writer is None:
            raise ConnectionError("not connected")
        if self.closed.is_set():
            raise ConnectionError("coordinator connection lost")
        if (not self._connected.is_set()
                and asyncio.current_task() is not self._resync_task):
            # disconnected: fail fast so callers keep serving from cached
            # state instead of hanging on a dead socket (the resync task
            # itself is exempt — it runs before connected is set)
            raise ConnectionError("coordinator disconnected "
                                  "(reconnect in progress)")
        rid = next(self._rids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        frame = {"op": op, "rid": rid, **kw}
        if self._term is not None and op in _WRITE_OPS:
            frame["term"] = self._term  # fencing stamp (see module doc)
        async with self._wlock:
            await send_frame(self._writer, frame)
        # A dead connection may accept the write (TCP buffering) while the
        # read loop has already torn down — or tears down after we register
        # the future but before the reply. Racing against `closed` turns
        # every such case into a prompt ConnectionError instead of a hang.
        closed_wait = asyncio.ensure_future(self.closed.wait())
        try:
            done, _ = await asyncio.wait({fut, closed_wait},
                                         return_when=asyncio.FIRST_COMPLETED)
            if fut not in done:
                self._pending.pop(rid, None)
                raise ConnectionError("coordinator connection lost")
            resp = fut.result()
        finally:
            closed_wait.cancel()
            if not fut.done():
                # cancelled from outside (e.g. a wait_for-bounded caller):
                # drop the entry or a half-open connection accrues one per
                # attempt; the read loop tolerates replies to unknown rids
                self._pending.pop(rid, None)
        if not resp.get("ok"):
            self._raise_rejection(op, resp)
        return resp

    def _raise_rejection(self, op: str, resp: Dict[str, Any]) -> None:
        """Turn a not-ok response into the right exception.  A fenced or
        standby bounce means this server is no longer the primary: adopt
        the newer term, drop the connection so supervision walks the
        address list, and surface a ConnectionError (callers already treat
        those as a survivable outage)."""
        if resp.get("fenced") or resp.get("standby"):
            t = resp.get("term")
            if t is not None:
                self._term = max(self._term or 0, int(t))
            kind = "fenced" if resp.get("fenced") else "standby"
            logger.warning(
                "coordinator %s:%d bounced %s (%s, term %s); re-pointing",
                self.host, self.port, op, kind, t)
            if self._writer is not None:
                try:
                    self._writer.close()  # read loop EOF -> reconnect walk
                except Exception:
                    pass
            raise ConnectionError(
                f"coordinator re-pointed ({kind}): {resp.get('error')}")
        raise RuntimeError(f"coordinator {op} failed: {resp.get('error')}")

    # -- KV API ------------------------------------------------------------

    async def put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self._call("put", key=key, value=value, lease=lease_id)

    async def put_if_absent(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        resp = await self._call("put_if_absent", key=key, value=value, lease=lease_id)
        return bool(resp["created"])

    async def get(self, key: str) -> Optional[bytes]:
        resp = await self._call("get", key=key)
        return resp.get("value")

    async def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        resp = await self._call("get_prefix", prefix=prefix)
        return [(i["key"], i["value"]) for i in resp["items"]]

    async def delete(self, key: str) -> int:
        return (await self._call("delete", key=key))["deleted"]

    async def delete_prefix(self, prefix: str) -> int:
        return (await self._call("delete_prefix", prefix=prefix))["deleted"]

    # -- leases ------------------------------------------------------------

    async def grant_lease(self, ttl: float = 10.0, keepalive: bool = True) -> Lease:
        resp = await self._call("grant_lease", ttl=ttl)
        lease = Lease(self, resp["lease"], resp["ttl"])
        self._lease_handles.add(lease)  # resync re-probes / re-grants it
        if keepalive:
            lease.start_keepalive()
        return lease

    async def keepalive(self, lease_id: int) -> None:
        await self._call("keepalive", lease=lease_id)

    async def revoke(self, lease_id: int) -> None:
        await self._call("revoke", lease=lease_id)

    # -- watches -----------------------------------------------------------

    async def watch_prefix(self, prefix: str) -> Watch:
        resp = await self._call("watch_prefix", prefix=prefix)
        w = Watch(self, resp["watch_id"], resp.get("items", []), prefix=prefix)
        self._watches[w.watch_id] = w
        # drain events that arrived between the server registering the watch
        # and us registering the Watch object (no await between these lines)
        for ev in self._orphan_events.pop(w.watch_id, []):
            w._deliver(ev)
        return w

    async def unwatch(self, watch_id: int) -> None:
        self._watches.pop(watch_id, None)
        self._orphan_events.pop(watch_id, None)  # drop in-flight stragglers
        try:
            await self._call("unwatch", watch_id=watch_id)
        except ConnectionError:
            pass  # disconnected: the dead server session is gone anyway,
            # and the resync protocol won't re-establish a popped watch; a
            # cancel racing a mid-flight resync (which may already hold a
            # LIVE registration for this watch) is undone by the
            # post-connect re-sweep of _resync_watch_objs

    # -- pub/sub -----------------------------------------------------------

    async def publish(self, subject: str, payload: bytes) -> int:
        return (await self._call("publish", subject=subject, payload=payload))["delivered"]

    async def subscribe(self, subject: str,
                        queue_group: Optional[str] = None) -> Subscription:
        resp = await self._call("subscribe", subject=subject, queue_group=queue_group)
        s = Subscription(self, resp["sub_id"], subject=subject,
                         queue_group=queue_group)
        self._subs[s.sub_id] = s
        for item in self._orphan_msgs.pop(s.sub_id, []):
            s.queue.put_nowait(item)
        return s

    async def unsubscribe(self, sub_id: int) -> None:
        self._subs.pop(sub_id, None)
        self._orphan_msgs.pop(sub_id, None)
        try:
            await self._call("unsubscribe", sub_id=sub_id)
        except ConnectionError:
            pass  # popped subs are not resynced; see unwatch for the
            # mid-resync race the post-connect re-sweep covers

    # -- object store ------------------------------------------------------
    # (reference: NATS object store carrying model-card artifacts,
    # ``transports/nats.rs:123-176``.) Implemented client-side on the KV
    # plane: ``obj/{bucket}/{name}/meta`` + ``/c{i}`` chunk keys. Chunking
    # keeps any single KV value (and coordinator frame) small even for
    # multi-MB artifacts like inlined tokenizers.

    OBJ_CHUNK = 1 << 20  # 1 MiB per chunk

    @staticmethod
    def _obj_prefix(bucket: str, name: str) -> str:
        return f"obj/{bucket}/{name}/"

    async def obj_put(self, bucket: str, name: str, data: bytes,
                      lease_id: int = 0) -> int:
        """Store an object as chunked KV entries; returns chunk count.
        Attach a lease to make the object vanish with its owner."""
        prefix = self._obj_prefix(bucket, name)
        n = max(1, -(-len(data) // self.OBJ_CHUNK))
        for i in range(n):
            chunk = data[i * self.OBJ_CHUNK:(i + 1) * self.OBJ_CHUNK]
            await self.put(f"{prefix}c{i:06d}", chunk, lease_id=lease_id)
        import json as _json
        await self.put(f"{prefix}meta",
                       _json.dumps({"size": len(data),
                                    "chunks": n}).encode(),
                       lease_id=lease_id)
        return n

    async def obj_get(self, bucket: str, name: str) -> Optional[bytes]:
        """Fetch a stored object, or None when absent/incomplete."""
        prefix = self._obj_prefix(bucket, name)
        meta_raw = await self.get(f"{prefix}meta")
        if meta_raw is None:
            return None
        import json as _json
        meta = _json.loads(meta_raw)
        parts = []
        for i in range(int(meta["chunks"])):
            c = await self.get(f"{prefix}c{i:06d}")
            if c is None:
                return None  # torn write/expiry mid-read
            parts.append(c)
        data = b"".join(parts)
        return data if len(data) == int(meta["size"]) else None

    async def obj_delete(self, bucket: str, name: str) -> int:
        return await self.delete_prefix(self._obj_prefix(bucket, name))

    # -- work queues -------------------------------------------------------

    async def queue_push(self, queue: str, payload: bytes) -> int:
        """Push one job; returns post-push depth (0 = a puller took it)."""
        return (await self._call("queue_push", queue=queue,
                                 payload=payload))["depth"]

    async def queue_pull(self, queue: str,
                         timeout: Optional[float] = None
                         ) -> Optional[Tuple[bytes, float]]:
        """Pull the oldest job, parking server-side until one arrives;
        returns (payload, age_s) — ``age_s`` is time spent queued by the
        coordinator's clock — or None on timeout.

        Timeout protocol: the parked pull is explicitly cancelled
        (``queue_cancel``). If the cancel races a delivery already in
        flight, the client waits for it and pushes the job BACK, so a
        timed-out puller can never swallow a job. External CANCELLATION of
        this coroutine fires the same best-effort server-side cancel so a
        parked pull on a still-live connection cannot swallow a later push
        into an orphaned future."""
        if self._writer is None:
            raise ConnectionError("not connected")
        if self.closed.is_set() or not self._connected.is_set():
            raise ConnectionError("coordinator connection lost")
        rid = next(self._rids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        frame = {"op": "queue_pull", "rid": rid, "queue": queue}
        if self._term is not None:
            frame["term"] = self._term
        async with self._wlock:
            await send_frame(self._writer, frame)
        closed_wait = asyncio.ensure_future(self.closed.wait())
        try:
            done, _ = await asyncio.wait(
                {fut, closed_wait}, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
            if fut in done:
                resp = fut.result()
                if not resp.get("ok"):
                    self._raise_rejection("queue_pull", resp)
                return resp["payload"], float(resp.get("age_s", 0.0))
            if closed_wait in done:
                self._pending.pop(rid, None)
                raise ConnectionError("coordinator connection lost")
            # timeout: cancel the parked pull server-side
            resp = await self._call("queue_cancel", queue=queue,
                                    pull_rid=rid)
            if not resp.get("cancelled", False):
                # delivery already in flight — take it and give it back
                payload = (await fut)["payload"]
                await self.queue_push(queue, payload)
            self._pending.pop(rid, None)
            return None
        except asyncio.CancelledError:
            self._pending.pop(rid, None)
            if not self.closed.is_set():
                # fire-and-forget: unpark server-side (conn teardown covers
                # the closing case)
                asyncio.get_running_loop().create_task(
                    self._queue_cancel_quiet(queue, rid))
            raise
        finally:
            closed_wait.cancel()

    async def _queue_cancel_quiet(self, queue: str, pull_rid: int) -> None:
        try:
            await self._call("queue_cancel", queue=queue, pull_rid=pull_rid)
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass

    async def queue_depth(self, queue: str) -> Tuple[int, int]:
        """(queued jobs, parked pullers) — the planner's prefill-pressure
        signal (reference: JetStream consumer info on the prefill queue)."""
        resp = await self._call("queue_depth", queue=queue)
        return resp["depth"], resp.get("pullers", 0)

    async def ping(self) -> float:
        return (await self._call("ping"))["time"]


def main() -> None:
    """Standalone coordinator process (``python -m
    dynamo_tpu_torch.runtime.coordinator --port 6650``).

    Running the control plane as its own process is what makes the
    crash/restart drills in docs/deployment.md ("Control-plane outages")
    real: kill -9 this and start a fresh one on the same port — every
    supervised ``CoordClient`` reconnects and resyncs its state.

    Replication: run a second process with ``--standby-of host:6650`` (its
    own ``--port``) and give clients both addresses; the standby
    self-promotes after ``--promote-after`` seconds of primary silence
    (SIGUSR1 promotes immediately — the manual-failover path).  With
    ``DYN_SYSTEM_ENABLED=1`` a system server exposes ``dynamo_coord_role``/
    ``dynamo_coord_failovers_total``/``dynamo_coord_replication_lag_ops``
    on /metrics (port ``DYN_SYSTEM_PORT``)."""
    import argparse
    import contextlib
    import signal

    from dynamo_tpu_torch.utils.logging import configure_logging

    parser = argparse.ArgumentParser(description="dynamo_tpu coordinator")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6650)
    parser.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                        help="run as a hot standby replicating this "
                             "primary; promotes on its failure")
    parser.add_argument("--promote-after", type=float, default=None,
                        help="standby self-promotes after this many "
                             "seconds of primary silence (default "
                             "DYN_COORD_PROMOTE_AFTER_S or "
                             f"{DEFAULT_PROMOTE_AFTER_S}; <=0 = manual "
                             "promotion only)")
    args = parser.parse_args()
    configure_logging()

    async def _run() -> None:
        coord = await Coordinator(host=args.host, port=args.port,
                                  standby_of=args.standby_of,
                                  promote_after_s=args.promote_after).start()
        loop = asyncio.get_running_loop()
        with contextlib.suppress(NotImplementedError, AttributeError):
            loop.add_signal_handler(
                signal.SIGUSR1, lambda: coord.promote("SIGUSR1"))
        system = None
        try:
            from prometheus_client import CollectorRegistry

            from dynamo_tpu_torch.http.metrics import CoordinatorMetrics
            from dynamo_tpu_torch.runtime.system_server import SystemServer
            registry = CollectorRegistry()
            CoordinatorMetrics(coord, registry=registry)
            system = SystemServer.from_env(registry=registry)
            if system is not None:
                system.attach_coord(coord)
                await system.start()
        except Exception:  # noqa: BLE001 — observability never gates serving
            logger.exception("coordinator system server unavailable")
        print(f"coordinator listening on {coord.address} ({coord.role})",
              flush=True)
        try:
            await asyncio.Event().wait()  # serve until killed
        finally:
            if system is not None:
                await system.stop()
            await coord.stop()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()


__all__ = ["Coordinator", "CoordClient", "Watch", "WatchEvent", "Subscription",
           "Lease", "NotPrimaryError"]
