"""Small asyncio helpers."""

from __future__ import annotations

import asyncio
import random
from typing import Optional


def decorrelated_jitter(prev_s: float, base_s: float, cap_s: float) -> float:
    """Next backoff sleep: uniform between the base and 3x the previous
    sleep, capped — retries from many callers spread out instead of
    arriving at the recovering server in lockstep."""
    return min(cap_s, random.uniform(base_s, max(prev_s, base_s) * 3))


async def reap_task(task: Optional[asyncio.Task]) -> None:
    """Cancel a child task and await it, without eating the caller's own
    cancellation.

    ``try: await task except CancelledError: pass`` is subtly wrong: if the
    *caller* is cancelled while awaiting the child, the same exception type is
    raised and gets swallowed — the caller keeps running and (since asyncio
    delivers cancellation once) can never be cancelled again.
    """
    if task is None:
        return
    task.cancel()
    # ``await task`` cannot distinguish the child's CancelledError from the
    # caller's own (pre-3.11 there is no Task.cancelling()), so use
    # asyncio.wait: it never propagates the child's exception, meaning a
    # CancelledError out of it is only ever OURS — on every version.
    await asyncio.wait({task})
    if not task.cancelled():
        exc = task.exception()
        if exc is not None:
            raise exc


__all__ = ["reap_task"]
