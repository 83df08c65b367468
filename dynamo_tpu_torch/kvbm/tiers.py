"""Host-RAM and disk block pools: byte-budgeted LRU keyed by block hash.

Parity in role with the reference's G2/G3 pools (``block_manager/pool/*``,
``storage/{cuda,disk}.rs``): bounded capacity, LRU eviction, lookup by
sequence/content hash. Demotion (G2 overflow -> G3) is the offload manager's
job (``manager.py``); each tier only stores and evicts.

Thread model: ``HostTier`` is NOT thread-safe — the manager's tier lock
guards it. ``DiskTier`` locks internally (index/byte accounting under its
own lock, file reads outside it) so promotion reads from the prefetch
scheduler's worker thread never serialize host-tier lookups behind disk IO.

Integrity: every ``DiskTier.put`` stamps a crc32 of the block bytes into
its index entry (the wire-v4 checksum discipline, ``engine/transfer``);
``get`` verifies length AND checksum before returning — a truncated or
corrupted file (crash mid-write, bit rot) is treated as a MISS and the
entry evicted, never injected as garbage KV. ``DYN_KV_DISK_CRC=0``
disables the stamp/verify (length is still checked).
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from dynamo_tpu_torch.engine.transfer import BlockPayload, host_dtype

logger = logging.getLogger(__name__)


def disk_crc_enabled() -> bool:
    """Per-entry crc32 on disk-tier blocks (``DYN_KV_DISK_CRC=0``
    disables — entries written without a checksum skip verification)."""
    return os.environ.get("DYN_KV_DISK_CRC", "1") not in ("0", "false", "")


class HostTier:
    """G2: host-RAM LRU of block payloads."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.used = 0
        self._blocks: "OrderedDict[int, BlockPayload]" = OrderedDict()

    def __contains__(self, block_hash: int) -> bool:
        return block_hash in self._blocks

    def __len__(self) -> int:
        return len(self._blocks)

    def put(self, block: BlockPayload) -> List[BlockPayload]:
        """Insert; returns demoted blocks evicted to make room."""
        size = block.data.nbytes
        if size > self.budget:
            return [block]  # doesn't fit at all: demote immediately
        if block.block_hash in self._blocks:
            self._blocks.move_to_end(block.block_hash)
            return []
        demoted: List[BlockPayload] = []
        while self.used + size > self.budget and self._blocks:
            _h, old = self._blocks.popitem(last=False)
            self.used -= old.data.nbytes
            demoted.append(old)
        self._blocks[block.block_hash] = block
        self.used += size
        return demoted

    def get(self, block_hash: int) -> Optional[BlockPayload]:
        blk = self._blocks.get(block_hash)
        if blk is not None:
            self._blocks.move_to_end(block_hash)
        return blk

    def pop(self, block_hash: int) -> Optional[BlockPayload]:
        blk = self._blocks.pop(block_hash, None)
        if blk is not None:
            self.used -= blk.data.nbytes
        return blk


class DiskTier:
    """G3: one ``.kvblk`` file per block under a directory, LRU by
    insertion/access order, byte-budgeted, crc-checked on read."""

    def __init__(self, path: str, budget_bytes: int):
        self.path = path
        self.budget = budget_bytes
        self.used = 0
        os.makedirs(path, exist_ok=True)
        # hash -> (filename, nbytes, local_hash, parent_hash, dtype,
        #          shape, crc32|None)
        self._index: "OrderedDict[int, Tuple]" = OrderedDict()
        # guards _index/used; file reads happen OUTSIDE it so a slow disk
        # only stalls the reader, not every other tier operation
        self._lock = threading.RLock()
        self.corrupt_dropped = 0

    def __contains__(self, block_hash: int) -> bool:
        with self._lock:
            return block_hash in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def _file(self, block_hash: int) -> str:
        return os.path.join(self.path, f"{block_hash:016x}.kvblk")

    def put(self, block: BlockPayload) -> None:
        size = block.data.nbytes
        if size > self.budget:
            return
        with self._lock:
            if block.block_hash in self._index:
                self._index.move_to_end(block.block_hash)
                return
            evict: List[str] = []
            while self.used + size > self.budget and self._index:
                h, (fn, nbytes, *_rest) = self._index.popitem(last=False)
                self.used -= nbytes
                evict.append(fn)
            # reserve the bytes BEFORE the write so a concurrent put can't
            # overshoot the budget while this file is still streaming out
            self.used += size
        for fn in evict:
            try:
                os.unlink(fn)
            except OSError:
                pass
        raw = block.data.tobytes()
        crc = (zlib.crc32(raw) & 0xFFFFFFFF) if disk_crc_enabled() else None
        fn = self._file(block.block_hash)
        try:
            with open(fn, "wb") as f:
                f.write(raw)
        except OSError:
            logger.exception("disk tier write failed; block dropped")
            with self._lock:
                self.used -= size
            return
        with self._lock:
            if block.block_hash in self._index:
                # raced another writer of the same content-addressed block
                # (spill thread vs promotion write-back): one file, one
                # entry — give back this writer's byte reservation
                self.used -= size
                self._index.move_to_end(block.block_hash)
                return
            self._index[block.block_hash] = (
                fn, size, block.local_hash, block.parent_hash,
                block.dtype, block.data.shape, crc)

    def _evict_entry(self, block_hash: int, unlink: bool = True) -> None:
        with self._lock:
            meta = self._index.pop(block_hash, None)
            if meta is None:
                return
            self.used -= meta[1]
        if unlink:
            try:
                os.unlink(meta[0])
            except OSError:
                pass

    def get(self, block_hash: int) -> Optional[BlockPayload]:
        with self._lock:
            meta = self._index.get(block_hash)
        if meta is None:
            return None
        fn, nbytes, local, parent, dtype, shape, crc = meta
        try:
            with open(fn, "rb") as f:  # slow IO: outside the index lock
                raw = f.read()
        except OSError:
            self._evict_entry(block_hash, unlink=False)
            return None
        if len(raw) != nbytes or (
                crc is not None
                and (zlib.crc32(raw) & 0xFFFFFFFF) != crc):
            # truncated (crash mid-write) or corrupted on disk: a MISS,
            # never injected — evict the entry so it can't hit again
            logger.warning(
                "disk tier entry %016x corrupt (%d bytes, want %d, crc "
                "%s): dropped", block_hash, len(raw), nbytes,
                "mismatch" if len(raw) == nbytes else "n/a")
            self.corrupt_dropped += 1
            self._evict_entry(block_hash)
            return None
        with self._lock:
            if block_hash in self._index:
                self._index.move_to_end(block_hash)
        arr = np.frombuffer(raw, dtype=host_dtype(dtype))
        return BlockPayload(block_hash=block_hash, local_hash=local,
                            parent_hash=parent, data=arr.reshape(shape),
                            dtype=dtype)


__all__ = ["HostTier", "DiskTier", "disk_crc_enabled"]
