"""Leader/worker barrier: multi-host engine bring-up rendezvous.

Parity: reference ``lib/runtime/src/utils/leader_worker_barrier.rs:16-80`` —
the leader publishes shared bring-up data under ``barrier/{id}/data``, waits
for N workers to check in under ``barrier/{id}/workers/...``, then publishes
``complete``; workers post their check-in and block on the completion marker.
Used to coordinate multi-host jax slice start-up (host 0 = leader owning the
serving endpoint, other hosts join the mesh) the way the reference gates
multi-node sglang/trtllm launches over etcd.

Keys carry the caller's lease so a crashed participant's check-in vanishes
with its lease instead of wedging the next rendezvous.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Optional

logger = logging.getLogger(__name__)


def _data_key(barrier_id: str) -> str:
    return f"barrier/{barrier_id}/data"


def _worker_prefix(barrier_id: str) -> str:
    return f"barrier/{barrier_id}/workers/"


def _status_key(barrier_id: str) -> str:
    return f"barrier/{barrier_id}/status"


class BarrierError(RuntimeError):
    pass


class _ResyncPuts:
    """Replays this participant's barrier keys across a coordinator restart.

    Barrier keys ride the primary lease, so a state-wiped coordinator loses
    them; while a rendezvous is in flight each participant keeps its own
    puts here and re-issues them from a resync hook (under the lease's
    CURRENT id — the resync may have re-granted it). Peers' watches then see
    the re-puts as synthesized events and the rendezvous completes instead
    of deadlocking."""

    def __init__(self, drt: Any, lease: Any):
        self._drt = drt
        self._lease = lease
        self._keys: dict = {}
        drt.coord.add_resync_hook(self._replay)

    async def put(self, key: str, value: bytes) -> None:
        self._keys[key] = value
        await self._drt.coord.put(key, value,
                                  lease_id=self._lease.lease_id)

    async def _replay(self) -> None:
        for key, value in self._keys.items():
            await self._drt.coord.put(key, value,
                                      lease_id=self._lease.lease_id)
        if self._keys:
            logger.info("re-published %d barrier key(s) after coordinator "
                        "resync", len(self._keys))

    def close(self) -> None:
        self._drt.coord.remove_resync_hook(self._replay)


async def leader_barrier(drt, barrier_id: str, data: Any, num_workers: int,
                         timeout: float = 60.0) -> None:
    """Publish data, await ``num_workers`` check-ins, mark complete.

    On timeout the barrier is marked aborted (workers waiting on it fail
    fast) and ``BarrierError`` raises.
    """
    lease = await drt.primary_lease()
    puts = _ResyncPuts(drt, lease)
    watch = None
    try:  # from here: puts.close() must run even if the first put fails
        await puts.put(_data_key(barrier_id), json.dumps(data).encode())
        watch = await drt.coord.watch_prefix(_worker_prefix(barrier_id))
        seen = {key for key, _v in watch.snapshot}
        deadline = asyncio.get_running_loop().time() + timeout
        while len(seen) < num_workers:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                await puts.put(_status_key(barrier_id), b"abort")
                raise BarrierError(
                    f"barrier {barrier_id}: {len(seen)}/{num_workers} workers "
                    f"after {timeout}s")
            try:
                ev = await asyncio.wait_for(watch.__anext__(),
                                            timeout=remaining)
            except asyncio.TimeoutError:
                continue
            if ev.type == "put":
                seen.add(ev.key)
        await puts.put(_status_key(barrier_id), b"complete")
    finally:
        puts.close()
        if watch is not None:
            try:
                await watch.cancel()
            except Exception:
                pass


async def worker_barrier(drt, barrier_id: str, worker_name: str,
                         timeout: float = 60.0) -> Any:
    """Check in and wait for completion; returns the leader's data."""
    lease = await drt.primary_lease()
    puts = _ResyncPuts(drt, lease)
    watch = None
    try:  # from here: puts.close() must run even if the first put fails
        await puts.put(f"{_worker_prefix(barrier_id)}{worker_name}",
                       worker_name.encode())
        watch = await drt.coord.watch_prefix(_status_key(barrier_id))
        status: Optional[bytes] = None
        for _key, value in watch.snapshot:
            status = value
        deadline = asyncio.get_running_loop().time() + timeout
        while status not in (b"complete", b"abort"):
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise BarrierError(
                    f"barrier {barrier_id}: no completion after {timeout}s")
            try:
                ev = await asyncio.wait_for(watch.__anext__(),
                                            timeout=remaining)
            except asyncio.TimeoutError:
                continue
            if ev.type == "put" and ev.value is not None:
                status = ev.value
        if status == b"abort":
            raise BarrierError(f"barrier {barrier_id} aborted by leader")
        raw = await drt.coord.get(_data_key(barrier_id))
        if raw is None:
            raise BarrierError(f"barrier {barrier_id}: data vanished")
        return json.loads(raw)
    finally:
        puts.close()
        if watch is not None:
            try:
                await watch.cancel()
            except Exception:
                pass


__all__ = ["leader_barrier", "worker_barrier", "BarrierError"]
