"""Component model: Namespace -> Component -> Endpoint naming tree + instances.

Parity: reference ``lib/runtime/src/component.rs`` (633 LoC) and
``component/{endpoint,namespace,client}.rs``.  We mirror the instance-key
scheme: a served endpoint writes
``instances/{namespace}/{component}/{endpoint}:{lease_id:x}`` into the
coordinator KV under its primary lease; clients discover instances by prefix
watch on ``instances/{namespace}/{component}/{endpoint}``.  Event subjects use
``{namespace}.{component}.{endpoint}`` dotted naming.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, TYPE_CHECKING

from dynamo_tpu_torch.runtime.rpc import Handler

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import Client

logger = logging.getLogger(__name__)

INSTANCE_ROOT = "instances/"
MODEL_ROOT = "models/"  # ModelEntry registrations (reference MODEL_ROOT_PATH)


@dataclass(frozen=True)
class Instance:
    """One live served endpoint (serialized into the coordinator KV)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int  # == lease id, like the reference (component.rs:379-386)
    address: str  # host:port of the worker's RpcServer
    # endpoints of the worker's bulk data plane (runtime/bulk.py) when it
    # serves one — the NIXL-role transport KV blocks ride instead of RPC
    bulk_address: str = ""
    # jax transfer-server address (engine/transfer.DeviceTransferPlane)
    # when the worker serves device-direct KV pulls — blocks move
    # device-to-device with no host bounce (the NIXL RDMA role proper)
    direct_address: str = ""
    # graceful drain: a draining instance stops receiving NEW requests
    # (routers exclude it from selection the moment their watch delivers
    # the re-put) but stays directly addressable — its in-flight streams
    # are migrating out and survivors still pull its pinned KV from it
    draining: bool = False

    @property
    def etcd_key(self) -> str:
        return (f"{INSTANCE_ROOT}{self.namespace}/{self.component}/"
                f"{self.endpoint}:{self.instance_id:x}")

    @property
    def subject(self) -> str:
        return f"{self.namespace}.{self.component}.{self.endpoint}"

    def to_json(self) -> bytes:
        d = {
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "instance_id": self.instance_id,
            "address": self.address,
        }
        if self.bulk_address:
            d["bulk_address"] = self.bulk_address
        if self.direct_address:
            d["direct_address"] = self.direct_address
        if self.draining:
            d["draining"] = True
        return json.dumps(d).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Instance":
        d = json.loads(data)
        return cls(
            namespace=d["namespace"], component=d["component"],
            endpoint=d["endpoint"], instance_id=d["instance_id"],
            address=d["address"], bulk_address=d.get("bulk_address", ""),
            direct_address=d.get("direct_address", ""),
            draining=bool(d.get("draining", False)))


class Namespace:
    def __init__(self, drt: "DistributedRuntime", name: str):
        self._drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self._drt, self.name, name)

    def event_subject(self, suffix: str) -> str:
        return f"{self.name}.{suffix}"

    def __repr__(self) -> str:
        return f"Namespace({self.name})"


class Component:
    def __init__(self, drt: "DistributedRuntime", namespace: str, name: str):
        self._drt = drt
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._drt, self.namespace, self.name, name)

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.name}"

    def event_subject(self, suffix: str) -> str:
        """Subject for component-scoped events, e.g. ``kv_events``."""
        return f"{self.namespace}.{self.name}.{suffix}"

    async def list_instances(self) -> List[Instance]:
        """All live instances of all endpoints of this component."""
        items = await self._drt.coord.get_prefix(f"{INSTANCE_ROOT}{self.path}/")
        return [Instance.from_json(v) for _, v in items]

    async def scrape_stats(self) -> Dict[int, Dict[str, Any]]:
        """Scrape ``__stats__`` from every live instance of this component.

        Parity: NATS ``$SRV.STATS`` scraping (reference
        ``kv_router/metrics_aggregator.rs``). Returns {instance_id: stats}.
        """
        out: Dict[int, Dict[str, Any]] = {}
        for inst in await self.list_instances():
            try:
                conn = await self._drt.rpc_pool.get(inst.address)
                stream = await conn.request("__stats__", None)
                async for payload in stream:
                    out[inst.instance_id] = payload
            except (ConnectionError, RuntimeError) as e:
                logger.debug("stats scrape of %s failed: %s", inst.address, e)
        return out

    def __repr__(self) -> str:
        return f"Component({self.path})"


class Endpoint:
    def __init__(self, drt: "DistributedRuntime", namespace: str,
                 component: str, name: str):
        self._drt = drt
        self.namespace = namespace
        self.component = component
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    @property
    def instance_prefix(self) -> str:
        # the trailing ':' stops a watch for endpoint "gen" from also matching
        # a sibling endpoint named "generate"
        return f"{INSTANCE_ROOT}{self.path}:"

    @property
    def subject(self) -> str:
        return f"{self.namespace}.{self.component}.{self.name}"

    async def serve(self, handler: Handler,
                    stats_provider: Optional[Callable[[], Any]] = None,
                    graceful_shutdown: bool = True,
                    bulk_address: str = "",
                    direct_address: str = "") -> "ServedEndpoint":
        """Register the handler on the local RpcServer and announce the
        instance in the coordinator under the primary lease.

        Parity: reference ``component/endpoint.rs:25-120``
        (``EndpointConfigBuilder::start``) + PushEndpoint.
        """
        drt = self._drt
        server = await drt.ensure_rpc_server()
        rpc_name = f"{self.path}"
        server.register(rpc_name, handler, stats_provider)
        lease = await drt.primary_lease()
        # DYN_RPC_ADVERTISE lets a worker announce an address other than its
        # listening socket — e.g. a ChaosProxy in front of it (fault drills)
        # or a NAT'd / port-forwarded address in containerized deployments
        advertise = os.environ.get("DYN_RPC_ADVERTISE") or server.address
        inst = Instance(
            namespace=self.namespace, component=self.component,
            endpoint=self.name, instance_id=lease.lease_id,
            address=advertise, bulk_address=bulk_address,
            direct_address=direct_address)
        await drt.coord.put(inst.etcd_key, inst.to_json(), lease_id=lease.lease_id)
        logger.info("serving endpoint %s as instance %x at %s",
                    self.path, inst.instance_id, inst.address)
        se = ServedEndpoint(self, inst, rpc_name)
        # tracked for coordinator resync: a restarted (possibly state-wiped)
        # coordinator re-learns this instance via drt._resync_registrations
        drt._served.add(se)
        return se

    async def client(self, **kw: Any) -> "Client":
        from dynamo_tpu_torch.runtime.client import Client
        return await Client.create(self._drt, self, **kw)

    async def list_instances(self) -> List[Instance]:
        items = await self._drt.coord.get_prefix(self.instance_prefix)
        return [Instance.from_json(v) for _, v in items]

    def __repr__(self) -> str:
        return f"Endpoint({self.path})"


async def _delete_when_connected(drt: Any, key: str) -> None:
    """Land a shutdown-time instance delete that failed mid-outage.

    Idempotent against the resync hook's own pending-delete pass (deleting
    a missing key is a no-op); gives up when the client closes for good."""
    while key in drt._pending_deletes:
        try:
            await drt.coord.wait_connected()
            await drt.coord.delete(key)
            drt._pending_deletes.discard(key)
            return
        except ConnectionError:
            if drt.coord.closed.is_set():
                return
            await asyncio.sleep(0.05)  # reconnect raced us; re-park


class ServedEndpoint:
    """Handle for a live served endpoint; ``shutdown()`` deregisters it."""

    def __init__(self, endpoint: Endpoint, instance: Instance, rpc_name: str):
        self.endpoint = endpoint
        self.instance = instance
        self._rpc_name = rpc_name

    def _reannounce(self, lease_id: int) -> None:
        """Rebuild the instance record against the (possibly re-granted)
        primary lease before a resync re-put: instance ids == lease ids, so
        a new lease id means a new instance id and a new KV key."""
        if self.instance.instance_id != lease_id:
            self.instance = dataclasses.replace(self.instance,
                                                instance_id=lease_id)

    async def announce_draining(self) -> None:
        """Re-put the instance record with ``draining`` set so routers
        route around it. The flag lives on ``self.instance``, so a
        coordinator resync racing the drain re-announces it draining too —
        the announcement survives a control-plane blip. Idempotent; a
        put failure is swallowed (the drain proceeds regardless — in the
        worst case racing requests are refused and replayed)."""
        if self.instance.draining:
            return
        self.instance = dataclasses.replace(self.instance, draining=True)
        drt = self.endpoint._drt
        try:
            await drt.coord.put(self.instance.etcd_key,
                                self.instance.to_json(),
                                lease_id=self.instance.instance_id)
            logger.info("instance %x of %s announced draining",
                        self.instance.instance_id, self.endpoint.path)
        except Exception:  # noqa: BLE001 — drain must proceed regardless
            logger.warning("drain announcement for %s failed; routers "
                           "fall back to refusal-and-replay",
                           self.endpoint.path, exc_info=True)

    async def shutdown(self) -> None:
        drt = self.endpoint._drt
        # untrack first so a racing coordinator resync can't re-announce a
        # deliberately shut-down instance; park the key as pending-delete
        # until the delete actually lands — shutting down mid-outage must
        # not leave a ghost instance the (still-alive) primary lease would
        # sustain forever after reconnect
        drt._served.discard(self)
        drt._pending_deletes.add(self.instance.etcd_key)
        try:
            await drt.coord.delete(self.instance.etcd_key)
            drt._pending_deletes.discard(self.instance.etcd_key)
        except Exception:
            # the resync hook retries pending deletes — but a shutdown
            # racing the TAIL of a resync (hooks already ran, connection
            # not yet up) would wait a whole extra outage for the next
            # one, so also retry as soon as the client reconnects
            drt.runtime.spawn(_delete_when_connected(drt, self.instance.etcd_key),
                              name=f"pending-delete-{self.instance.instance_id:x}")
        if drt.rpc_server is not None:
            drt.rpc_server.unregister(self._rpc_name)


__all__ = ["Namespace", "Component", "Endpoint", "Instance", "ServedEndpoint",
           "INSTANCE_ROOT", "MODEL_ROOT"]
