"""Runtime and DistributedRuntime: process harness + node-level singleton.

Parity: reference ``lib/runtime/src/{runtime,distributed,worker}.rs`` —
``Runtime`` (cancellation tree, task spawning), ``DistributedRuntime`` (etcd +
NATS clients, lazy TCP server, component registry), ``Worker::execute``.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import signal
from typing import Any, Awaitable, Callable, Dict, Optional

from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.component import Namespace
from dynamo_tpu_torch.runtime.coordinator import CoordClient, Coordinator, Lease, Subscription
from dynamo_tpu_torch.runtime.rpc import RpcClientPool, RpcServer

logger = logging.getLogger(__name__)

DEFAULT_COORDINATOR = os.environ.get("DYN_COORDINATOR", "127.0.0.1:6650")
DEFAULT_LEASE_TTL = float(os.environ.get("DYN_LEASE_TTL", "5.0"))


class Runtime:
    """Process-local runtime: shutdown token + supervised background tasks."""

    def __init__(self) -> None:
        self._shutdown = asyncio.Event()
        self._tasks: set = set()

    @property
    def is_shutdown(self) -> bool:
        return self._shutdown.is_set()

    def shutdown(self) -> None:
        self._shutdown.set()

    async def wait_shutdown(self) -> None:
        await self._shutdown.wait()

    def spawn(self, coro: Awaitable[Any], name: Optional[str] = None) -> asyncio.Task:
        task = asyncio.create_task(coro, name=name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def spawn_critical(self, coro: Awaitable[Any],
                       name: Optional[str] = None) -> asyncio.Task:
        """Supervised task: if it raises, the whole runtime shuts down.

        Parity: reference ``CriticalTaskExecutionHandle``
        (``lib/runtime/src/utils/task.rs``).
        """
        async def _wrapped() -> None:
            try:
                await coro
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.exception("critical task %s failed; shutting down", name)
                self.shutdown()
        return self.spawn(_wrapped(), name=name)

    async def drain(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)


class DistributedRuntime:
    """Node-level singleton: coordinator client, lease, RPC server, event bus.

    ``DistributedRuntime.create()`` connects to an existing coordinator (or, in
    ``standalone=True`` mode, embeds one in-process — handy for tests and
    single-node deployments; the reference instead requires external
    etcd+NATS).
    """

    def __init__(self, runtime: Runtime, coord: CoordClient,
                 embedded: Optional[Coordinator] = None):
        self.runtime = runtime
        self.coord = coord
        self._embedded = embedded
        self.rpc_server: Optional[RpcServer] = None
        self.rpc_pool = RpcClientPool()
        self._primary_lease: Optional[Lease] = None
        self._rpc_host = os.environ.get("DYN_RPC_HOST", "127.0.0.1")
        # serialize lazy init: concurrent serve() calls must share one lease
        # and one RpcServer
        self._init_lock = asyncio.Lock()
        # live ServedEndpoints, re-announced on coordinator resync: a
        # restarted (possibly state-wiped) coordinator learns every
        # instance again under the re-established primary lease
        self._served: set = set()
        # instance keys whose shutdown-time delete failed (outage in
        # progress); retried by the resync hook AFTER the re-puts, so a
        # shutdown racing the hook's _served snapshot still wins
        self._pending_deletes: set = set()
        coord.add_resync_hook(self._resync_registrations)

    @classmethod
    async def create(cls, coordinator: str = DEFAULT_COORDINATOR,
                     runtime: Optional[Runtime] = None,
                     standalone: bool = False) -> "DistributedRuntime":
        runtime = runtime or Runtime()
        embedded = None
        if standalone:
            # honor the requested address so other processes can join with
            # the same --coordinator value; a replicated address list embeds
            # the FIRST entry (the primary slot)
            first = coordinator.split(",")[0].strip()
            host, _, port = first.rpartition(":")
            embedded = await Coordinator(host=host or "127.0.0.1",
                                         port=int(port)).start()
            coordinator = embedded.address
        coord = await CoordClient(coordinator).connect()
        return cls(runtime, coord, embedded)

    async def close(self) -> None:
        if self._primary_lease is not None:
            await self._primary_lease.revoke()
            self._primary_lease = None
        await self.rpc_pool.close()
        if self.rpc_server is not None:
            await self.rpc_server.stop()
            self.rpc_server = None
        await self.coord.close()
        if self._embedded is not None:
            await self._embedded.stop()
            self._embedded = None
        await self.runtime.drain()

    async def __aenter__(self) -> "DistributedRuntime":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- naming ------------------------------------------------------------

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    # -- serving infra -----------------------------------------------------

    async def ensure_rpc_server(self) -> RpcServer:
        async with self._init_lock:
            if self.rpc_server is None:
                port = int(os.environ.get("DYN_RPC_PORT", "0"))
                self.rpc_server = await RpcServer(host=self._rpc_host, port=port).start()
                logger.info("rpc server listening on %s", self.rpc_server.address)
            return self.rpc_server

    async def primary_lease(self) -> Lease:
        """The process's liveness lease: all instance registrations attach to
        it, so losing it (crash, hang) deregisters everything within TTL.
        Parity: reference primary lease (``distributed.rs:45-136``)."""
        async with self._init_lock:
            if self._primary_lease is None:
                self._primary_lease = await self.coord.grant_lease(
                    ttl=DEFAULT_LEASE_TTL, keepalive=True)
                self.runtime.spawn_critical(
                    self._watch_lease(self._primary_lease), name="primary-lease-watch")
            return self._primary_lease

    async def _watch_lease(self, lease: Lease) -> None:
        await lease.lost.wait()
        raise ConnectionError("primary lease lost")

    async def _resync_registrations(self) -> None:
        """Coordinator resync hook: re-announce every served endpoint.

        The primary lease may have been re-granted under a NEW id during the
        resync, and instance ids == lease ids — so each instance record is
        rebuilt against the current lease before the re-put. Clients absorb
        the id churn through their watches (put of the new key now; the old
        key's delete after the stale-read grace window)."""
        lease = self._primary_lease
        if lease is not None:
            for se in list(self._served):
                if se not in self._served:
                    continue  # shut down while we iterated; its own delete
                    # (or _pending_deletes) targets the pre-relocation key
                se._reannounce(lease.lease_id)
                await self.coord.put(se.instance.etcd_key,
                                     se.instance.to_json(),
                                     lease_id=lease.lease_id)
                if se not in self._served:
                    # shutdown raced the put: it parked the OLD key, but we
                    # just re-announced under the relocated id — park the
                    # NEW key too or the live lease sustains a ghost forever
                    self._pending_deletes.add(se.instance.etcd_key)
                    continue
                logger.info("re-registered %s as instance %x after "
                            "coordinator resync", se.endpoint.path,
                            se.instance.instance_id)
        # deletes LAST: a shutdown that raced the snapshot above (or whose
        # delete failed mid-outage) must not leave its ghost behind
        for key in list(self._pending_deletes):
            await self.coord.delete(key)
            self._pending_deletes.discard(key)

    # -- typed event bus ---------------------------------------------------

    def kv_store(self):
        """The pluggable key-value store surface (reference
        ``storage/key_value_store.rs`` trait): buckets with optional TTL,
        backed by the coordinator KV plane."""
        from dynamo_tpu_torch.runtime.kv_store import CoordKeyValueStore
        return CoordKeyValueStore(self.coord)

    async def publish_event(self, subject: str, obj: Any) -> int:
        """Publish a msgpack-encoded event object."""
        return await self.coord.publish(subject, codec.pack(obj))

    async def subscribe_events(self, subject: str,
                               queue_group: Optional[str] = None) -> "TypedSubscription":
        sub = await self.coord.subscribe(subject, queue_group=queue_group)
        return TypedSubscription(sub)


class TypedSubscription:
    """Wraps a raw Subscription, msgpack-decoding payloads."""

    def __init__(self, sub: Subscription):
        self._sub = sub

    def __aiter__(self) -> "TypedSubscription":
        return self

    async def __anext__(self):
        subject, payload = await self._sub.__anext__()
        return subject, codec.unpack(payload)

    async def cancel(self) -> None:
        await self._sub.cancel()


async def worker_main(app: Callable[[DistributedRuntime], Awaitable[None]],
                      coordinator: str = DEFAULT_COORDINATOR,
                      standalone: bool = False) -> None:
    """Process harness: build the DRT, install signal handlers, run ``app``,
    drain on shutdown.  Parity: reference ``Worker::execute`` +
    ``@dynamo_worker()`` decorator."""
    drt = await DistributedRuntime.create(coordinator, standalone=standalone)
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, drt.runtime.shutdown)
    try:
        app_task = asyncio.create_task(app(drt))
        shutdown_task = asyncio.create_task(drt.runtime.wait_shutdown())
        done, _pending = await asyncio.wait(
            {app_task, shutdown_task}, return_when=asyncio.FIRST_COMPLETED)
        if app_task in done:
            app_task.result()  # propagate app errors
        else:
            app_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await app_task
    finally:
        await drt.close()


__all__ = ["Runtime", "DistributedRuntime", "TypedSubscription", "worker_main",
           "DEFAULT_COORDINATOR"]
