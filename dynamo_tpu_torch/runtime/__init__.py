"""Core distributed runtime: coordination, discovery, streaming RPC, routing.

Parity: reference ``lib/runtime/`` (Rust, ~19k LoC) — see SURVEY.md §2.1.  The
reference composes external etcd (discovery/lease/watch) + NATS (request
transport, events) + raw TCP (response streams).  This runtime is
self-contained: a single ``Coordinator`` service provides the etcd-equivalent
KV/lease/watch plane *and* the NATS-equivalent pub/sub event plane, and the
request/response data plane is direct duplex TCP between clients and workers
(``dynamo_tpu_torch.runtime.rpc``).
"""

from dynamo_tpu_torch.runtime.coordinator import Coordinator, CoordClient
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime, Runtime
from dynamo_tpu_torch.runtime.component import Component, Endpoint, Instance, Namespace
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode

__all__ = [
    "Coordinator",
    "CoordClient",
    "Runtime",
    "DistributedRuntime",
    "Namespace",
    "Component",
    "Endpoint",
    "Instance",
    "PushRouter",
    "RouterMode",
]
