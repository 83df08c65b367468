"""Endpoint client: watches live instances and issues streamed requests.

Parity: reference ``lib/runtime/src/component/client.rs`` (264 LoC) —
``Client::new_dynamic`` with an etcd prefix watch keeping an atomic snapshot of
instance ids, plus ``report_instance_down`` local pruning ahead of lease
expiry.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Dict, List, Optional

from dynamo_tpu_torch.runtime.component import Endpoint, Instance
from dynamo_tpu_torch.runtime.rpc import ResponseStream
from dynamo_tpu_torch.utils.aio import reap_task

logger = logging.getLogger(__name__)


class Client:
    """Dynamic client for one endpoint."""

    def __init__(self, drt, endpoint: Endpoint):
        self._drt = drt
        self.endpoint = endpoint
        self._instances: Dict[int, Instance] = {}
        self._down: set = set()  # locally-reported-down instance ids
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None
        self._changed = asyncio.Event()
        # instance-id down listeners (router policy breakers): fired once per
        # report, from both the keepalive path and explicit error reports
        self._down_listeners: List[Callable[[int], None]] = []

    @classmethod
    async def create(cls, drt, endpoint: Endpoint, static: bool = False) -> "Client":
        self = cls(drt, endpoint)
        if static:
            for inst in await endpoint.list_instances():
                self._instances[inst.instance_id] = inst
        else:
            self._watch = await drt.coord.watch_prefix(endpoint.instance_prefix)
            for _key, value in self._watch.snapshot:
                inst = Instance.from_json(value)
                self._instances[inst.instance_id] = inst
            self._watch_task = asyncio.create_task(self._watch_loop())
        # keepalive/conn-death notifications from the shared pool: a
        # connection that dies without an explicit drop marks its backing
        # instance(s) down here, ahead of lease expiry
        drt.rpc_pool.add_down_listener(self._on_address_down)
        return self

    async def _watch_loop(self) -> None:
        # NOTE: never catch CancelledError here — swallowing it breaks
        # cancellation of any task awaiting this one (asyncio delegates
        # A.cancel() to B.cancel() when A awaits B).
        #
        # A coordinator crash does NOT end this stream: the supervised
        # CoordClient re-establishes the watch on reconnect and synthesizes
        # put/delete deltas from a prefix re-scan (including the instance-id
        # churn of re-granted leases). While the coordinator is down, no
        # events arrive and routing continues from the cached ``_instances``
        # snapshot. The stream ends only when the client is permanently
        # closed — at that point discovery is frozen on the last snapshot.
        async for ev in self._watch:
            if ev.type == "put" and ev.value is not None:
                inst = Instance.from_json(ev.value)
                self._instances[inst.instance_id] = inst
                self._down.discard(inst.instance_id)
            elif ev.type == "delete":
                iid = self._id_from_key(ev.key)
                if iid is not None:
                    self._instances.pop(iid, None)
                    self._down.discard(iid)
            self._changed.set()
            self._changed = asyncio.Event()
        logger.warning(
            "instance watch for %s ended (coordinator client closed); "
            "discovery frozen on %d cached instance(s)",
            self.endpoint.path, len(self._instances))

    @staticmethod
    def _id_from_key(key: str) -> Optional[int]:
        _, _, hexid = key.rpartition(":")
        try:
            return int(hexid, 16)
        except ValueError:
            return None

    # -- instance visibility ----------------------------------------------

    def instance_ids(self) -> List[int]:
        # draining instances are excluded from SELECTION (routers stop
        # sending new work the moment the drain announcement lands) but
        # stay directly addressable via get_instance/direct — in-flight
        # migrations still pull their pinned KV from them
        return [i for i, v in self._instances.items()
                if i not in self._down and not v.draining]

    def instances(self) -> List[Instance]:
        return [v for k, v in self._instances.items()
                if k not in self._down and not v.draining]

    def get_instance(self, instance_id: int) -> Optional[Instance]:
        if instance_id in self._down:
            return None
        return self._instances.get(instance_id)

    def report_instance_down(self, instance_id: int) -> None:
        """Locally mark an instance dead before the lease expiry catches up."""
        if instance_id in self._instances:
            logger.warning("instance %x of %s reported down",
                           instance_id, self.endpoint.path)
            self._down.add(instance_id)
            inst = self._instances.get(instance_id)
            if inst is not None:
                self._drt.rpc_pool.drop(inst.address)
            for cb in list(self._down_listeners):
                try:
                    cb(instance_id)
                except Exception:
                    logger.exception("instance-down listener failed")

    def add_down_listener(self, cb: Callable[[int], None]) -> None:
        """Subscribe to instance-down reports (called with the instance id).
        Both keepalive miss-budget exhaustion and router error reports
        funnel through ``report_instance_down``, so one hook sees both."""
        self._down_listeners.append(cb)

    def remove_down_listener(self, cb: Callable[[int], None]) -> None:
        try:
            self._down_listeners.remove(cb)
        except ValueError:
            pass

    def _on_address_down(self, address: str) -> None:
        """Pool notification: a connection died unexpectedly (remote crash or
        keepalive miss-budget exhaustion) — mark the instance(s) at that
        address down.  ``report_instance_down``'s pool drop is a no-op here
        (the pool already evicted the dead connection), so no recursion."""
        for iid, inst in list(self._instances.items()):
            if inst.address == address and iid not in self._down:
                self.report_instance_down(iid)

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> List[Instance]:
        """Block until at least ``n`` instances are visible."""
        deadline = asyncio.get_running_loop().time() + timeout
        while len(self.instance_ids()) < n:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"timed out waiting for {n} instances of {self.endpoint.path} "
                    f"(have {len(self.instance_ids())})")
            changed = self._changed
            try:
                await asyncio.wait_for(changed.wait(), timeout=min(remaining, 0.5))
            except asyncio.TimeoutError:
                pass
        return self.instances()

    # -- request issuing ---------------------------------------------------

    async def scrape_stats(self) -> Dict[int, Any]:
        """Poll the ``__stats__`` plane of every live instance (queue depth /
        in-flight for the routing cost model).  Unreachable instances are
        simply absent from the result — the scorer treats missing stats as
        unknown, and the request path's own error handling marks them down."""
        out: Dict[int, Any] = {}
        for inst in self.instances():
            try:
                conn = await self._drt.rpc_pool.get(inst.address)
                stream = await conn.request("__stats__", None)
                async for item in stream:
                    out[inst.instance_id] = item
                    break
                if not stream.finished:
                    await stream.cancel()
            except Exception:
                continue
        return out

    async def direct(self, payload: Any, instance_id: int,
                     headers: Optional[Dict[str, Any]] = None) -> ResponseStream:
        """Issue a request to a specific instance."""
        inst = self._instances.get(instance_id)
        if inst is None or instance_id in self._down:
            raise ConnectionError(
                f"instance {instance_id:x} of {self.endpoint.path} not available")
        conn = await self._drt.rpc_pool.get(inst.address)
        return await conn.request(f"{self.endpoint.path}", payload, headers)

    async def close(self) -> None:
        self._drt.rpc_pool.remove_down_listener(self._on_address_down)
        await reap_task(self._watch_task)
        if self._watch is not None:
            try:
                await self._watch.cancel()
            except Exception:
                pass


__all__ = ["Client"]
