"""Model manager + discovery watcher.

Parity: reference ``lib/llm/src/discovery/{model_manager.rs,watcher.rs}`` —
``ModelWatcher`` watches the coordinator's ``models/`` prefix; on Put it
builds the client pipeline (PushRouter [+ KV router] + Migration) and
registers it with the ``ModelManager``; on Delete (last instance gone) it
removes the model.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional

from dynamo_tpu_torch.llm.pipeline import RemotePipeline, ServicePipeline
from dynamo_tpu_torch.model_card import MODEL_ROOT_PREFIX, ModelEntry
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.utils.aio import reap_task

logger = logging.getLogger(__name__)


class ModelManager:
    """Name -> pipeline registry used by the HTTP service."""

    def __init__(self) -> None:
        self._pipelines: Dict[str, ServicePipeline] = {}
        self._entries: Dict[str, ModelEntry] = {}

    def add(self, name: str, pipeline: ServicePipeline,
            entry: Optional[ModelEntry] = None) -> None:
        self._pipelines[name] = pipeline
        if entry is not None:
            self._entries[name] = entry

    def remove(self, name: str) -> None:
        self._pipelines.pop(name, None)
        self._entries.pop(name, None)

    def get(self, name: str) -> Optional[ServicePipeline]:
        return self._pipelines.get(name)

    def names(self) -> List[str]:
        return sorted(self._pipelines)

    def __contains__(self, name: str) -> bool:
        return name in self._pipelines


class ModelWatcher:
    """Watches model registrations and keeps the ModelManager in sync."""

    def __init__(self, drt: DistributedRuntime, manager: ModelManager,
                 router_mode: RouterMode = RouterMode.ROUND_ROBIN,
                 kv_router_config: Optional[dict] = None,
                 policy_config=None):
        self.drt = drt
        self.manager = manager
        self.router_mode = router_mode
        self.kv_router_config = kv_router_config or {}
        # RouterPolicyConfig for the failure-aware modes (cost, kv); the
        # legacy round-robin/random modes never build a policy, keeping the
        # fallback path byte-stable
        self.policy_config = policy_config
        self._task: Optional[asyncio.Task] = None
        self._watch = None
        self._model_instances: Dict[str, set] = {}
        self._clients: Dict[str, object] = {}
        self._routers: Dict[str, object] = {}
        self.ready = asyncio.Event()

    async def start(self) -> "ModelWatcher":
        self._watch = await self.drt.coord.watch_prefix(MODEL_ROOT_PREFIX)
        for key, value in self._watch.snapshot:
            try:
                await self._handle_put(key, value)
            except Exception:
                # a bad registration must not take the frontend down at boot
                # (the watch loop below tolerates the same entry arriving live)
                logger.exception("ignoring bad model registration %s", key)
        self.ready.set()
        self._task = asyncio.create_task(self._loop())
        return self

    async def stop(self) -> None:
        await reap_task(self._task)
        if self._watch is not None:
            try:
                await self._watch.cancel()
            except Exception:
                pass
        for name, router in list(self._routers.items()):
            # PushRouter.close reaps the cost-mode stats loop; the KV
            # router's own close is driven via its client below
            if isinstance(router, PushRouter):
                await router.close()
        self._routers.clear()
        for client in self._clients.values():
            await client.close()  # type: ignore[attr-defined]
        self._clients.clear()

    async def _loop(self) -> None:
        async for ev in self._watch:
            try:
                if ev.type == "put" and ev.value is not None:
                    await self._handle_put(ev.key, ev.value)
                elif ev.type == "delete":
                    await self._handle_delete(ev.key)
            except Exception:
                logger.exception("model watcher failed handling %s", ev)

    async def _handle_put(self, key: str, value: bytes) -> None:
        entry = ModelEntry.from_json(value)
        if entry.model_type in ("prefill", "decode"):
            # disagg-internal workers: "prefill" (decode-first flow) and
            # "decode" (prefill-first flow) are discovered by component by
            # their peer role; frontends must not route chat traffic there
            return
        instances = self._model_instances.setdefault(entry.name, set())
        instances.add(key)
        if entry.name in self.manager:
            return
        if entry.card is None:
            logger.warning("model %s registered without a card; skipping", entry.name)
            return
        pipeline = await self._build_pipeline(entry)
        self.manager.add(entry.name, pipeline, entry)
        logger.info("model %s discovered (endpoint %s/%s/%s)",
                    entry.name, entry.namespace, entry.component, entry.endpoint)

    async def _build_pipeline(self, entry: ModelEntry) -> ServicePipeline:
        endpoint = (self.drt.namespace(entry.namespace)
                    .component(entry.component).endpoint(entry.endpoint))
        client = await endpoint.client()
        self._clients[entry.name] = client
        policy = None
        if self.router_mode in (RouterMode.KV, RouterMode.COST):
            from dynamo_tpu_torch.runtime.resilience import (
                RouterPolicy,
                RouterPolicyConfig,
            )
            policy = RouterPolicy(self.policy_config or RouterPolicyConfig())
        if self.router_mode == RouterMode.KV:
            from dynamo_tpu_torch.kv_router import KvPushRouter
            router = await KvPushRouter.create(
                self.drt, client, entry.card, policy=policy,
                **self.kv_router_config)
        else:
            router = PushRouter(client, self.router_mode, policy=policy)
        self._routers[entry.name] = router
        from dynamo_tpu_torch.llm.register import AUX_ENDPOINT
        aux_ep = (self.drt.namespace(entry.namespace)
                  .component(entry.component).endpoint(AUX_ENDPOINT))
        return RemotePipeline(entry.card, router, aux_endpoint=aux_ep)

    async def _handle_delete(self, key: str) -> None:
        # key: models/{name}/{instance:x}
        parts = key[len(MODEL_ROOT_PREFIX):].rsplit("/", 1)
        if len(parts) != 2:
            return
        name = parts[0]
        instances = self._model_instances.get(name)
        if instances is not None:
            instances.discard(key)
            if not instances:
                logger.info("last instance of model %s gone; removing", name)
                self.manager.remove(name)
                self._model_instances.pop(name, None)
                router = self._routers.pop(name, None)
                if isinstance(router, PushRouter):
                    await router.close()
                client = self._clients.pop(name, None)
                if client is not None:
                    await client.close()  # type: ignore[attr-defined]


__all__ = ["ModelManager", "ModelWatcher"]
