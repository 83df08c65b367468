"""Pluggable key-value store abstraction (buckets with optional TTL).

Parity: reference ``lib/runtime/src/storage/key_value_store.rs`` — a
``KeyValueStore`` trait with etcd / NATS-KV / in-memory backends, used for
model-card storage and TTL buckets. Here the two backends that exist in
this runtime's world:

- ``MemoryKeyValueStore`` — in-process (static mode, tests);
- ``CoordKeyValueStore`` — namespaced onto the coordinator KV plane
  (``kvstore/{bucket}/{key}``), TTL carried in-band per entry (msgpack
  envelope) with lazy expiry, so it needs no coordinator-side support
  beyond plain put/get/delete.

Both present the same ``KeyValueBucket`` surface, so components written
against it (model-card storage, planner state, user extensions) are
backend-agnostic — the reference's reason for the trait.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.coordinator import replay_registry


class KeyValueBucket:
    """One named bucket. Values are opaque bytes. ``ttl`` (seconds, set at
    bucket creation) applies per entry from its last put."""

    async def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    async def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    async def delete(self, key: str) -> bool:
        raise NotImplementedError

    async def entries(self) -> List[Tuple[str, bytes]]:
        raise NotImplementedError


class KeyValueStore:
    async def bucket(self, name: str,
                     ttl: Optional[float] = None) -> KeyValueBucket:
        raise NotImplementedError


# ---------------------------------------------------------------- memory


class _MemoryBucket(KeyValueBucket):
    def __init__(self, ttl: Optional[float],
                 data: Dict[str, Tuple[bytes, float]]):
        self.ttl = ttl
        self._data = data  # key -> (val, exp); shared per bucket name

    def _live(self, key: str) -> Optional[bytes]:
        item = self._data.get(key)
        if item is None:
            return None
        val, exp = item
        if exp and exp <= time.monotonic():
            del self._data[key]
            return None
        return val

    async def put(self, key: str, value: bytes) -> None:
        exp = (time.monotonic() + self.ttl) if self.ttl else 0.0
        self._data[key] = (bytes(value), exp)

    async def get(self, key: str) -> Optional[bytes]:
        return self._live(key)

    async def delete(self, key: str) -> bool:
        return self._data.pop(key, None) is not None

    async def entries(self) -> List[Tuple[str, bytes]]:
        out = []
        for k in list(self._data):
            v = self._live(k)
            if v is not None:
                out.append((k, v))
        return out


class MemoryKeyValueStore(KeyValueStore):
    def __init__(self) -> None:
        self._datas: Dict[str, Dict[str, Tuple[bytes, float]]] = {}

    async def bucket(self, name: str,
                     ttl: Optional[float] = None) -> KeyValueBucket:
        # handle semantics match the coordinator backend: the DATA is
        # shared per name, the TTL is per handle (each call's ttl applies
        # to the entries written through it)
        data = self._datas.setdefault(name, {})
        return _MemoryBucket(ttl, data)


# ------------------------------------------------------------- coordinator


class _ReplayRegistry(dict):
    """key -> (expiry, raw envelope) this PROCESS wrote. An amortized sweep
    on write keeps it bounded by LIVE entries even for TTL'd keys written
    once and never read again (entries()'s lazy collection never sees
    those)."""

    def __init__(self) -> None:
        super().__init__()
        self._puts = 0

    def record(self, key: str, exp: float, raw: bytes) -> None:
        self[key] = (exp, raw)
        self._puts += 1
        if self._puts >= max(64, len(self)):
            self._puts = 0
            now = time.time()
            for k in [k for k, (e, _raw) in self.items() if e and e <= now]:
                self.pop(k, None)


def _replay_registry(coord) -> _ReplayRegistry:
    """The client's resync-replay registry: entries re-put after a
    coordinator restart (a state-wiped coordinator loses unleased keys
    too). Writer-side ownership keeps replay conflict-free: each process
    re-puts only what it wrote last."""
    async def _replay(reg: _ReplayRegistry) -> None:
        now = time.time()
        for key, (exp, raw) in list(reg.items()):
            if exp and exp <= now:
                reg.pop(key, None)  # expired while we were away
                continue
            await coord.put(key, raw)

    return replay_registry(coord, "_kvstore_replay", _ReplayRegistry, _replay)


class _CoordBucket(KeyValueBucket):
    def __init__(self, coord, name: str, ttl: Optional[float]):
        self._coord = coord
        self._prefix = f"kvstore/{name}/"
        self.ttl = ttl
        self._written = _replay_registry(coord)

    def _wrap(self, value: bytes) -> Tuple[float, bytes]:
        exp = (time.time() + self.ttl) if self.ttl else 0.0
        # the WRITER's ttl rides in the envelope: readers use it as the
        # collection grace window, so a no-TTL read handle can't collect
        # a just-expired entry out from under a racing re-put
        return exp, codec.pack({"e": exp, "v": bytes(value),
                                "t": float(self.ttl or 0.0)})

    def _unwrap(self, raw: bytes) -> Optional[bytes]:
        d = codec.unpack(raw)
        if d["e"] and d["e"] <= time.time():
            return None
        return d["v"]

    async def put(self, key: str, value: bytes) -> None:
        exp, raw = self._wrap(value)
        full = self._prefix + key
        self._written.record(full, exp, raw)
        await self._coord.put(full, raw)

    async def get(self, key: str) -> Optional[bytes]:
        raw = await self._coord.get(self._prefix + key)
        if raw is None:
            return None
        # expired entries are SKIPPED here, not deleted: an unguarded
        # read-then-delete races a concurrent re-put and could drop the
        # fresh value; collection happens in entries() behind a full-TTL
        # grace window instead
        return self._unwrap(raw)

    async def delete(self, key: str) -> bool:
        self._written.pop(self._prefix + key, None)
        return (await self._coord.delete(self._prefix + key)) > 0

    async def entries(self) -> List[Tuple[str, bytes]]:
        out = []
        for k, raw in await self._coord.get_prefix(self._prefix):
            d = codec.unpack(raw)
            # writer's ttl; legacy envelopes (no "t") fall back to this
            # handle's ttl so they keep their pre-upgrade protection
            grace = float(d.get("t", self.ttl or 0.0))
            if d["e"] and d["e"] <= time.time():
                # lazy collection (a bucket used only via entries() must
                # not leak forever), but only past a full extra TTL of
                # grace — a racing re-put within that window would have
                # rewritten the envelope, so the delete-vs-put race is
                # confined to entries dead for >= 2x their TTL
                if d["e"] + grace <= time.time():
                    self._written.pop(k, None)
                    await self._coord.delete(k)
                continue
            out.append((k[len(self._prefix):], d["v"]))
        return out


class CoordKeyValueStore(KeyValueStore):
    def __init__(self, coord) -> None:
        self._coord = coord

    async def bucket(self, name: str,
                     ttl: Optional[float] = None) -> KeyValueBucket:
        return _CoordBucket(self._coord, name, ttl)


__all__ = ["KeyValueStore", "KeyValueBucket", "MemoryKeyValueStore",
           "CoordKeyValueStore"]
