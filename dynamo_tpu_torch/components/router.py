"""Standalone KV-router service.

Parity: reference ``components/router/src/main.rs:59-97`` — host the KV
router behind its own runtime endpoint so any client (not just the OpenAI
frontend) gets KV-aware placement: requests sent to
``{namespace}/{router_component}/generate`` are forwarded to the best worker
and the response stream is relayed back. A custom ``WorkerSelector`` can be
injected by importing and wrapping ``serve_router``.

Run: ``python -m dynamo_tpu_torch.components.router --namespace ns --component tpu``
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.kv_router import KvPushRouter
from dynamo_tpu_torch.kv_router.scheduler import WorkerSelector
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime.runtime import DEFAULT_COORDINATOR, DistributedRuntime
from dynamo_tpu_torch.utils.logging import configure_logging

logger = logging.getLogger(__name__)


def router_handler(router: KvPushRouter):
    async def handler(payload: Any, ctx) -> AsyncIterator[Any]:
        async for item in router.generate_stream(payload):
            yield item
    return handler


async def serve_router(drt: DistributedRuntime, namespace: str,
                       worker_component: str, router_component: str,
                       block_size: int = 16,
                       selector: Optional[WorkerSelector] = None,
                       **router_kwargs) -> KvPushRouter:
    """Wire a KvPushRouter over the worker component and serve it."""
    worker_ep = (drt.namespace(namespace).component(worker_component)
                 .endpoint("generate"))
    client = await worker_ep.client()
    card = ModelDeploymentCard(name=f"{worker_component}-router",
                               kv_cache_block_size=block_size)
    router = await KvPushRouter.create(drt, client, card,
                                       selector=selector, **router_kwargs)
    serve_ep = (drt.namespace(namespace).component(router_component)
                .endpoint("generate"))
    await serve_ep.serve(router_handler(router))
    logger.info("kv router serving %s/%s/generate -> %s/%s",
                namespace, router_component, namespace, worker_component)
    return router


async def amain(args: argparse.Namespace) -> None:
    drt = await DistributedRuntime.create(coordinator=args.coordinator)
    router = await serve_router(
        drt, args.namespace, args.component, args.router_component,
        block_size=args.block_size,
        overlap_score_weight=args.kv_overlap_score_weight,
        temperature=args.router_temperature)
    print(f"router component serving "
          f"{args.namespace}/{args.router_component}/generate", flush=True)
    try:
        await drt.runtime.wait_shutdown()
    finally:
        await router.close()
        await drt.close()


def main() -> None:
    p = argparse.ArgumentParser(description="dynamo_tpu standalone KV router")
    p.add_argument("--coordinator", default=DEFAULT_COORDINATOR)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="tpu",
                   help="worker component to route over")
    p.add_argument("--router-component", default="router")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    configure_logging()
    try:
        asyncio.run(amain(p.parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
