"""Length-prefixed msgpack framing over asyncio streams.

Every frame on a control- or data-plane connection is ``<u32 big-endian
length><msgpack payload>``.  Parity in spirit with the reference's two-part
codec (``lib/runtime/src/pipeline/network/codec/two_part.rs``): a frame is a
msgpack map whose "header" fields (op, ids) and "payload" (bin) travel
together; msgpack bin avoids a second length-prefix layer.

TWO-PART frames carry bulk binary (KV block transfers) without msgpack
re-copies: the u32 length has its high bit set, the msgpack part holds the
metadata, and a ``<u32 raw length><raw bytes>`` trailer follows. The raw
bytes are written straight from the source buffer (a numpy view — no
``tobytes``/msgpack/concat copies on the send side) and surface on the
receive side under the ``"_raw"`` key of the decoded map — as a POOLED
uint8 buffer for multi-MB trailers (chunked reads skip the StreamReader
join copy; consumers may ``release_buffer`` it for warm reuse). This is
the replacement for the reference codec's header+payload split that
NIXL-bound block data rode (``block/transfer/nixl.rs``).

Ceiling note: even pooled, asyncio stream framing
tops out ~1.3-1.5 GB/s on loopback; the bulk plane (``runtime/bulk.py``,
raw sockets + recv_into) does ~2+ GB/s and is ALWAYS advertised by
prefill workers — this RPC path is the control plane and the cross-host
fallback, not the default KV data plane.
"""

from __future__ import annotations

import asyncio
import struct
import threading
from typing import Any, Dict, List, Optional

import msgpack

MAX_FRAME = 512 * 1024 * 1024  # 512 MiB hard cap (KV block transfers ride this)

_LEN = struct.Struct(">I")
_RAW_BIT = 0x8000_0000

# Receive-buffer freelist, shared by this codec's large-trailer reads and
# the bulk plane (runtime/bulk.py). Faulting in fresh anonymous pages for
# every multi-MB frame costs more than the socket itself (measured:
# 1.9 GB/s into a warm buffer vs 0.7 into a fresh one on this host class).
# Buffers are np.empty so pages are NOT memset; a consumer that is done
# with a frame calls ``release_buffer(raw)`` and the next receive of the
# same frame size reuses the warm pages. Unreleased buffers are simply
# garbage-collected — release is an optimization, never a correctness
# requirement.
_BUF_POOL_PER_SIZE = 4
_buf_pool: Dict[int, List[Any]] = {}
_buf_lock = threading.Lock()


def buf_get(nbytes: int):
    import numpy as _np

    with _buf_lock:
        free = _buf_pool.get(nbytes)
        if free:
            return free.pop()
    return _np.empty(nbytes, _np.uint8)


def release_buffer(raw: Any) -> None:
    """Return a frame buffer (from ``bulk_fetch`` or a two-part RPC frame's
    ``_raw``) to the freelist after the consumer has fully copied/used it.
    Double-releasing the same buffer is ignored — pooling one ndarray twice
    would hand it to two concurrent fetches and interleave their frames."""
    if not hasattr(raw, "nbytes"):
        return
    with _buf_lock:
        free = _buf_pool.setdefault(raw.nbytes, [])
        if len(free) < _BUF_POOL_PER_SIZE \
                and not any(b is raw for b in free):
            free.append(raw)


# trailers at least this large read into a pooled buffer via chunked
# ``reader.read`` instead of ``readexactly`` — skipping the StreamReader's
# join copy is worth ~25% of wire throughput at KV-block sizes (the small
# frames stay plain bytes: hashable, cheap, and pooling them would churn)
_POOLED_RAW_MIN = 1024 * 1024
_POOLED_READ_CHUNK = 4 * 1024 * 1024


class Raw:
    """A stream item whose bulk bytes should ride a two-part frame.

    Handlers yield ``Raw(meta_dict, buffer)``; the RPC layer sends the
    metadata as the msgpack part and the buffer as the raw trailer. The
    receiving side sees ``meta_dict`` with ``"_raw"`` holding the bytes.
    """

    __slots__ = ("obj", "raw")

    def __init__(self, obj: Any, raw: Any):
        self.obj = obj
        self.raw = raw


def byte_view(raw: Any) -> memoryview:
    """Flat byte view of any buffer, including numpy arrays of extension
    dtypes (bfloat16 etc.) that reject the buffer protocol — those are
    reinterpreted as uint8 first (zero-copy for contiguous arrays)."""
    try:
        return memoryview(raw).cast("B")
    except (TypeError, ValueError):
        import numpy as np

        arr = np.ascontiguousarray(np.asarray(raw))
        return memoryview(arr.view(np.uint8)).cast("B")


def pack(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


async def read_frame(reader: asyncio.StreamReader) -> Optional[Any]:
    """Read one frame; returns None on clean EOF. A two-part frame's raw
    trailer is attached to the decoded map as ``obj["_raw"]``."""
    try:
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(hdr)
    raw_follows = bool(length & _RAW_BIT)
    length &= ~_RAW_BIT
    if length > MAX_FRAME:
        raise ValueError(f"frame length {length} exceeds cap {MAX_FRAME}")
    try:
        body = await reader.readexactly(length)
        obj = unpack(body)
        if raw_follows:
            (raw_len,) = _LEN.unpack(await reader.readexactly(4))
            if raw_len > MAX_FRAME:
                raise ValueError(f"raw length {raw_len} exceeds cap")
            if raw_len >= _POOLED_RAW_MIN:
                # large trailer: chunked reads straight into a pooled
                # uint8 buffer (consumers may release_buffer() it back)
                buf = buf_get(raw_len)
                mv = memoryview(buf)
                got = 0
                while got < raw_len:
                    chunk = await reader.read(
                        min(raw_len - got, _POOLED_READ_CHUNK))
                    if not chunk:
                        return None  # mid-frame EOF, like IncompleteRead
                    mv[got:got + len(chunk)] = chunk
                    got += len(chunk)
                obj["_raw"] = buf
            else:
                obj["_raw"] = await reader.readexactly(raw_len)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return obj


def write_frame(writer: asyncio.StreamWriter, obj: Any,
                raw: Optional[Any] = None) -> None:
    """Queue one frame on the writer (call ``await writer.drain()`` for
    backpressure). ``raw`` (bytes/memoryview/numpy buffer) rides as a
    two-part trailer with zero intermediate copies on this side."""
    body = pack(obj)
    if raw is None:
        writer.write(_LEN.pack(len(body)))
        writer.write(body)
        return
    view = byte_view(raw)
    writer.write(_LEN.pack(len(body) | _RAW_BIT))
    writer.write(body)
    writer.write(_LEN.pack(view.nbytes))
    writer.write(view)


async def send_frame(writer: asyncio.StreamWriter, obj: Any,
                     raw: Optional[Any] = None) -> None:
    write_frame(writer, obj, raw)
    await writer.drain()


__all__ = ["pack", "unpack", "read_frame", "write_frame", "send_frame",
           "MAX_FRAME", "Raw", "byte_view", "buf_get", "release_buffer"]
