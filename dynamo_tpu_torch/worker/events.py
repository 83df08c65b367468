"""Ordered KV-event publication for workers.

The allocator emits ``KvCacheEvent``s with strictly increasing ``event_id``;
the router's indexer relies on that order (its gap detector treats a reorder
as loss and resyncs the whole worker). A task-per-batch publisher interleaves
at publish awaits, so all workers publish through ONE long-lived consumer
task fed by a queue — wire order matches allocator emission order.

Parity in role: the reference's per-worker NATS ``kv_events`` publisher
(``lib/llm/src/kv_router/publisher.rs:57-99``), which is likewise a single
sender per worker.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, List, Tuple

# canonical subject definition lives with the subscriber
from dynamo_tpu_torch.kv_router.router import kv_events_subject  # noqa: F401
from dynamo_tpu_torch.protocols.events import KvCacheEvent, RouterEvent

logger = logging.getLogger(__name__)


def ordered_kv_publisher(
    drt, subject: str, worker_id: int,
) -> Tuple[Callable[[List[KvCacheEvent]], None], asyncio.Task]:
    """Returns (callback, pump_task). Install the callback as
    ``engine.kv_event_cb``; cancel the task on shutdown."""
    q: asyncio.Queue = asyncio.Queue()

    async def _pump() -> None:
        while True:
            ev = await q.get()
            rev = RouterEvent(worker_id=worker_id, event=ev)
            try:
                await drt.publish_event(subject, rev.to_dict())
            except Exception:  # noqa: BLE001 — one lost event must not kill
                # the pump; the indexer's gap detector resyncs the worker
                logger.exception("kv event publish failed (event %s dropped)",
                                 ev.event_id)

    task = asyncio.create_task(_pump())

    def publish(events: List[KvCacheEvent]) -> None:
        for ev in events:
            q.put_nowait(ev)

    return publish, task


__all__ = ["ordered_kv_publisher", "kv_events_subject"]
