"""KV block export/inject: the worker-side half of disaggregated P/D, on
PyTorch.

The port of ``dynamo_tpu/engine/transfer.py``. The same three planes move
the same wire frames:

- the host planes: gather the named blocks from the device cache to host,
  ship them over the runtime's RPC plane or the raw-socket bulk plane
  (``runtime/bulk.py``), scatter them into the destination cache;
- the device-direct plane (``DeviceTransferPlane``): on one host, the
  gathered blocks are offered through a CUDA IPC handle of their device
  memory, and the puller copies them card to card with no host bounce.

Blocks are addressed by their chained content hash (``tokens.py``), so the
destination commits them straight into its prefix cache and admission
picks them up as if it had computed the prefix itself.

Wire frames are byte for byte the reference's, meta dict included
(``"dtype": "bfloat16"``, ``block_shape``, ``layout``). numpy has no
bfloat16, so host copies of a bfloat16 cache carry its bits as ``uint16``
(``host_array`` / ``host_tensor``) under the dtype name the reference
writes (``wire_dtype``).

Every write into a cache is in place (``TorchEngine.scatter_pages_*``): the
fused blocks' CUDA graphs hold the cache's address. Work that runs beside
the loop (the inject pipeline's uploads, a direct pull) runs on a CUDA
stream of its own and leaves the loop's stream alone; anything that reads
or writes the cache runs on the loop's exclusive lane, on the steps' own
stream.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import threading
import time
import warnings
import zlib
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Optional,
                    Tuple)

import numpy as np
import torch

from dynamo_tpu_torch.runtime.codec import Raw, byte_view

if TYPE_CHECKING:  # pragma: no cover
    from dynamo_tpu_torch.engine.torch_engine import TorchEngine

logger = logging.getLogger(__name__)

# kv_transfer_params keys (wire schema):
#   blocks: [[block_hash, local_hash, parent_hash|0], ...]  (prefix order)
#   page_size, num_tokens_cached


# -- dtypes on the wire and on the host ----------------------------------------

BF16 = "bfloat16"


def wire_dtype(x) -> str:
    """The dtype name the reference writes for ``x`` (a tensor or a numpy
    array): ``str(np.dtype)``, ``"bfloat16"`` for bfloat16."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(x.dtype)


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a ``name`` block's bytes on the host:
    bfloat16 rides as ``uint16``."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view (bfloat16 as its uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# the torch dtype of a host carrier's bytes (uint16 carries bfloat16)
_TORCH_CARRIER = {np.dtype(np.uint16): torch.int16,
                  np.dtype(np.float32): torch.float32,
                  np.dtype(np.float16): torch.float16}


def host_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` over (or converted from) host values: a
    uint16 array into a bfloat16 cache is reinterpreted, bit for bit."""
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        # a wire buffer received as bytes is read-only: the tensor over it
        # is only ever read
        warnings.simplefilter("ignore", UserWarning)
        if arr.dtype == np.uint16:  # bfloat16 bits
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            return t if dtype == torch.bfloat16 else t.to(dtype)
        return torch.from_numpy(arr).to(dtype)


@dataclass
class BlockPayload:
    """One transferred block: [L, 2, Hkv, page_size, Dh] of cache content.
    ``dtype`` is the wire name of ``data``'s values (``"bfloat16"`` for a
    uint16-carried block); it defaults to ``str(data.dtype)``."""

    block_hash: int
    local_hash: int
    parent_hash: Optional[int]
    data: np.ndarray
    dtype: str = ""

    def __post_init__(self):
        if not self.dtype:
            self.dtype = str(self.data.dtype)

    def to_wire(self) -> Dict[str, Any]:
        # msgpack packs any buffer-protocol object as bin: a flat byte VIEW
        # of the block ships with no ``tobytes`` copy
        return {
            "block_hash": self.block_hash,
            "local_hash": self.local_hash,
            "parent_hash": self.parent_hash,
            "dtype": self.dtype,
            "shape": list(self.data.shape),
            "data": byte_view(self.data),
        }

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "BlockPayload":
        arr = np.frombuffer(d["data"], dtype=host_dtype(d["dtype"]))
        return cls(block_hash=d["block_hash"], local_hash=d["local_hash"],
                   parent_hash=d.get("parent_hash"),
                   data=arr.reshape(d["shape"]), dtype=d["dtype"])


# Gathers and scatters live on the ENGINE (``dispatch_gather_pages`` /
# ``scatter_pages_host`` / ``scatter_pages_device``, torch_engine.py).


def export_blocks(engine: "TorchEngine",
                  block_hashes: List[int]) -> List[BlockPayload]:
    """Extract resident blocks by hash as host payloads (the RPC path).
    Missing hashes break the chain (the destination recomputes the rest)."""
    metas, data = _export_device(engine, block_hashes)
    if not metas:
        return []
    name = wire_dtype(data)
    host = engine.fetch_host(data[:, :len(metas)])
    return [BlockPayload(block_hash=h, local_hash=local, parent_hash=parent,
                         data=host[:, i], dtype=name)
            for i, (h, local, parent) in enumerate(metas)]


def _inject_data(engine: "TorchEngine",
                 metas: List[Tuple[int, int, Optional[int]]],
                 data, window: Optional[int] = None) -> int:
    """Core injection: ``metas[i] = (block_hash, local_hash, parent_hash)``
    describes page slice ``data[:, i]`` ([L, n, 2, Hkv, ps, Dh], a host
    array or a tensor). Fresh blocks are scattered into the cache in place
    and registered; they land in the prefix-cache LRU, so the next
    admission of the matching prompt revives them. Returns blocks
    actually injected."""
    alloc = engine.allocator
    fresh = [i for i, m in enumerate(metas) if m[0] not in alloc._by_hash]
    if len(fresh) > alloc.num_free:
        # not worth evicting live cache for a partial chain; inject what fits
        fresh = fresh[:alloc.num_free]
    if not fresh:
        return 0
    pages = alloc.allocate(len(fresh))
    if not isinstance(data, torch.Tensor):
        # host values (the wire path); a world's device values go through
        # the host in the engine's scatter, fanned out with its values
        host = np.asarray(data)
        if len(fresh) != len(metas):
            host = host[:, np.asarray(fresh, np.int64)]
        engine.scatter_pages_chunked(pages, host, window)
    else:
        if len(fresh) != len(metas):
            data = data[:, torch.as_tensor(fresh, device=data.device)]
        engine.scatter_pages_device(pages, data)
    for page, i in zip(pages, fresh):
        h, local, parent = metas[i]
        alloc.commit(page, h, local, parent)
    alloc.release(pages)  # refcount 0 -> LRU, matchable by admission
    return len(fresh)


def inject_blocks(engine: "TorchEngine", blocks: List[BlockPayload]) -> int:
    """Inject host-side block payloads (the RPC path)."""
    if not blocks:
        return 0
    metas = [(b.block_hash, b.local_hash, b.parent_hash) for b in blocks]
    data = np.stack([b.data for b in blocks], axis=1)  # [L,n,2,Hkv,ps,Dh]
    return _inject_data(engine, metas, data)


def _export_device(engine: "TorchEngine", block_hashes: List[int],
                   sharded: bool = False):
    """Extract resident blocks by hash as (metas, device tensor) — no host
    round trip. Missing hashes break the chain (later blocks are useless
    without their parents). ``sharded`` is the reference's per-shard flag;
    a one-device cache has one shard."""
    alloc = engine.allocator
    claimed: List[Tuple[int, int]] = []
    try:
        for h in block_hashes:
            page = alloc._by_hash.get(h)
            if page is None:
                break
            alloc.incref(page)
            claimed.append((h, page))
        if not claimed:
            return [], None
        data = engine.dispatch_gather_pages([p for _h, p in claimed])
        metas = []
        for h, page in claimed:
            info = alloc._info[page]
            metas.append((h, info.local_hash, info.parent_hash))
        return metas, data
    finally:
        alloc.release([p for _h, p in claimed])


def cache_shard_layout(engine) -> Tuple[int, int]:
    """``(shard_count, axis)`` of the engine cache's stacked transport
    array ``[L, n, 2, Hkv, ps, Dh]``: ``(1, -1)`` for a one-device or
    replicated cache, ``(tp, 3)`` for a rank world's head-split one (the
    reference's ``shard_layout`` of its placement)."""
    return engine.cache_layout


def kv_shard_payload(engine) -> Dict[str, int]:
    """The shard-negotiation keys a puller merges into its wire-v5 pull
    payload: its own cache's shard layout. Empty for single-device caches
    and rank worlds (per-shard frames carry no fanout — followers could
    not join), so exporters serve merged frames."""
    n, ax = cache_shard_layout(engine)
    if n < 2 or engine.world:
        return {}
    return {"shards": n, "shard_axis": ax}


# blocks per wire frame on the batched export path. Default;
# ``kv_transfer_defaults`` resolves the configured value
# (DYN_KV_FRAME_BLOCKS / RuntimeConfig.kv_frame_blocks).
BLOCKS_PER_FRAME = 16

# max blocks committed per exclusive-window scatter on the inject side.
# Default; DYN_KV_SCATTER_BLOCKS / RuntimeConfig.kv_scatter_blocks override.
SCATTER_WINDOW_BLOCKS = 64

# wire schema: 1 = per-block msgpack dicts (``BlockPayload``), 2 = batched
# block-major two-part frames, 3 = batched LAYER-major frames, 4 = v3
# frames carrying a per-frame ``crc32`` of the raw bytes (verified BEFORE
# staging), 5 = v4 frames that may be shard-sliced when the puller
# advertises a matching cache shard layout. Pullers advertise the highest
# version they speak; exporters serve the min of that and their own. A
# one-device cache advertises no shard layout, so the port serves and
# pulls merged frames.
FRAME_WIRE_VERSION = 5


class FrameIntegrityError(ValueError):
    """A wire frame's bytes do not match its advertised crc32 — the frame
    was truncated or corrupted in transit and must not be injected."""


# TOML-layer cache for kv_transfer_defaults, keyed by (path, mtime): with
# DYN_CONFIG_PATH set, RuntimeConfig.load() parses the file, blocking IO
# that must not run per pull on the event loop.
_cfg_cache: Tuple[Any, Any] = (None, None)


def _runtime_cfg():
    global _cfg_cache
    from dynamo_tpu_torch.utils.config import CONFIG_PATH_ENV, RuntimeConfig

    path = os.environ.get(CONFIG_PATH_ENV)
    if not path:
        return RuntimeConfig.load()  # env scan only — no file IO
    try:
        key = (path, os.stat(path).st_mtime_ns)
    except OSError:
        key = (path, None)
    cfg, ck = _cfg_cache
    if cfg is None or ck != key:
        cfg = RuntimeConfig.load()
        _cfg_cache = (cfg, key)
    return cfg


def kv_transfer_defaults() -> Tuple[int, int]:
    """(frame blocks, scatter window blocks): RuntimeConfig (dataclass ->
    TOML -> DYN_RUNTIME_* env), then the short-form DYN_KV_FRAME_BLOCKS /
    DYN_KV_SCATTER_BLOCKS env wins. Resolved per pull, not at import."""
    frame, window = BLOCKS_PER_FRAME, SCATTER_WINDOW_BLOCKS
    try:
        cfg = _runtime_cfg()
        frame, window = cfg.kv_frame_blocks, cfg.kv_scatter_blocks
    except Exception:  # a bad TOML/env must not break a KV pull
        logger.warning("bad runtime config; kv transfer falls back to "
                       "%d/%d blocks", frame, window, exc_info=True)
    raw_frame = os.environ.get("DYN_KV_FRAME_BLOCKS")
    raw_window = os.environ.get("DYN_KV_SCATTER_BLOCKS")
    try:
        frame = int(raw_frame) if raw_frame is not None else frame
    except (TypeError, ValueError):
        logger.warning("malformed DYN_KV_FRAME_BLOCKS %r; using %d",
                       raw_frame, frame)
    try:
        window = int(raw_window) if raw_window is not None else window
    except (TypeError, ValueError):
        logger.warning("malformed DYN_KV_SCATTER_BLOCKS %r; using %d",
                       raw_window, window)
    return max(1, frame), max(1, window)


def frame_crc_enabled() -> bool:
    """Per-frame crc32 on wire-v4 exports (``DYN_KV_FRAME_CRC=0``
    disables — the inject side simply sees no ``crc32`` key)."""
    return os.environ.get("DYN_KV_FRAME_CRC", "1") not in ("0", "false", "")


def resolve_wire(payload: Any, default_wire: int
                 ) -> Tuple[str, int, bool, Optional[Tuple[int, int]]]:
    """(frame layout, frame blocks, checksum, shards) for an export
    request's advertised wire version. ``default_wire`` is what a client
    that omits the key speaks: 1 on the RPC plane, 2 on the bulk plane.
    ``checksum`` is True when the puller speaks wire v4+ (and the exporter
    hasn't disabled crc); ``shards`` is the puller's advertised cache shard
    layout when it speaks v5+ and sent one."""
    payload = payload or {}
    wire = int(payload.get("wire", default_wire))
    layout = "layer" if wire >= 3 else "block"
    checksum = wire >= 4 and frame_crc_enabled()
    shards = None
    if wire >= 5:
        try:
            n = int(payload.get("shards", 0) or 0)
            if n >= 2:
                shards = (n, int(payload.get("shard_axis", -1)))
        except (TypeError, ValueError):
            shards = None
    return layout, kv_transfer_defaults()[0], checksum, shards


def export_frames(engine: "TorchEngine", block_hashes: List[int],
                  layout: str = "layer",
                  frame_blocks: Optional[int] = None,
                  shards: Optional[Tuple[int, int]] = None) -> List[Raw]:
    """Extract resident blocks as batched two-part wire frames.

    ``layout="layer"`` (wire v3) keeps the gather's layer-major
    ``[L, k, 2, Hkv, ps, Dh]`` order per frame; ``layout="block"`` (wire
    v2 compat) is block-major ``[k, L, ...]``. The frames are laid out
    back to back on the device (one copy), fetched to pinned host memory
    in one transfer, and shipped as views of it. Runs under
    ``run_exclusive``.

    ``shards`` (wire v5) is the puller's cache shard layout. Per-shard
    frames are not served: a one-device cache has one shard, and a rank
    world's leader serves merged frames (a shard read would need its
    followers outside the step fanout); the export logs why and serves
    the merged frames every puller understands."""
    if shards is not None:
        logger.info(
            "per-shard KV export unavailable (engine layout %s vs puller "
            "%s%s%s); serving merged frames", cache_shard_layout(engine),
            tuple(shards),
            "; multihost" if engine.world else "",
            "; block-major" if layout != "layer" else "")
    metas, data = _export_device(engine, block_hashes)
    if not metas:
        return []
    n = len(metas)
    per = int(frame_blocks) if frame_blocks else kv_transfer_defaults()[0]
    data = data[:, :n]
    bounds = [(i, min(n, i + per)) for i in range(0, n, per)]
    if layout == "layer":
        flat = torch.cat([data[:, a:b].reshape(-1) for a, b in bounds])
    else:
        flat = data.transpose(0, 1).reshape(-1)
    host = engine.fetch_host(flat)
    name = wire_dtype(data)
    block = list(data.shape[:1]) + list(data.shape[2:])  # [L, 2, Hkv, ps, Dh]
    per_block = int(np.prod(block))
    frames: List[Raw] = []
    for a, b in bounds:
        k = b - a
        blocks = [[h, local, parent] for h, local, parent in metas[a:b]]
        if layout == "layer":
            chunk = host[a * per_block:b * per_block].reshape(
                [block[0], k] + block[1:])
            meta = {"blocks": blocks, "dtype": name, "block_shape": block,
                    "layout": "layer"}
        else:
            chunk = host[a * per_block:b * per_block].reshape([k] + block)
            meta = {"blocks": blocks, "dtype": name,
                    "block_shape": list(block)}
        frames.append(Raw(meta, chunk))
    # wire-v4 checksums are stamped by the serving handlers AFTERWARD via
    # ``stamp_frame_crcs`` — outside the exclusive window this runs under
    return frames


def stamp_frame_crcs(frames: List[Raw]) -> List[Raw]:
    """Stamp the wire-v4 per-frame crc32 onto already-exported frames,
    outside the engine's exclusive window."""
    for f in frames:
        f.obj["crc32"] = zlib.crc32(byte_view(f.raw)) & 0xFFFFFFFF
    return frames


def verify_frame(meta: Dict[str, Any], raw: Any) -> None:
    """Check a wire frame's bytes against its advertised ``crc32`` (wire
    v4); frames from older exporters carry no checksum and pass. Raises
    ``FrameIntegrityError`` on mismatch."""
    want = meta.get("crc32")
    if want is None:
        return
    got = zlib.crc32(byte_view(raw)) & 0xFFFFFFFF
    if got != int(want):
        raise FrameIntegrityError(
            f"KV frame checksum mismatch: crc32 {got:#010x} != advertised "
            f"{int(want):#010x} over {len(memoryview(byte_view(raw)))} "
            f"bytes ({len(meta.get('blocks', []))} blocks) — frame "
            f"corrupted or truncated in transit")


def frame_arrays(meta: Dict[str, Any]
                 ) -> Tuple[List[Tuple[int, int, Optional[int]]],
                            np.ndarray]:
    """Decode one wire frame into ``(metas, values)`` where ``values`` is a
    layer-major ``[L, n, 2, Hkv, ps, Dh]`` ndarray VIEW aliasing
    ``meta["_raw"]`` (bfloat16 as uint16) — callers must copy (stage)
    before releasing the wire buffer. Handles both the v3 layer-major and
    v2 block-major layouts, and verifies wire-v4 checksums first."""
    raw = meta["_raw"]
    verify_frame(meta, raw)
    bs = list(meta["block_shape"])
    n = len(meta["blocks"])
    arr = np.frombuffer(raw, dtype=host_dtype(meta["dtype"]))
    if meta.get("layout") == "layer":
        arr = arr.reshape([bs[0], n] + bs[1:])
    else:
        arr = np.moveaxis(arr.reshape([n] + bs), 0, 1)
    metas = [(b[0], b[1], b[2]) for b in meta["blocks"]]
    return metas, arr


def inject_frame(engine: "TorchEngine", meta: Dict[str, Any]) -> int:
    """Inject one wire frame (either ``export_frames`` layout) directly.
    Runs under ``run_exclusive``. Returns blocks injected. The scatter
    copies the values before this returns, so the caller may release the
    wire buffer at once."""
    if meta.get("shard") is not None:
        raise ValueError("per-shard wire frames require the inject "
                         "pipeline (InjectPipeline.add_frame)")
    metas, arr = frame_arrays(meta)
    n = _inject_data(engine, metas, arr.copy())
    _sync_cache(engine)
    return n


def _sync_cache(engine: "TorchEngine") -> None:
    """Wait until the cache writes queued on this thread's stream ran: a
    host-values scatter may read pinned host memory asynchronously, and
    its caller reuses that memory next."""
    if engine.pages.is_cuda:
        torch.cuda.current_stream(engine.pages.device).synchronize()


def _commit_staged(engine: "TorchEngine", metas, data, inner) -> int:
    """One batched commit inside the exclusive window. Device values were
    uploaded (and waited for) before the window; host values are read by
    the scatter's own upload, which must finish before the caller refills
    the staging buffer."""
    n = inner(engine, metas, data)
    if not isinstance(data, torch.Tensor):
        _sync_cache(engine)
    return n


class InjectPipeline:
    """Staged KV inject: recv -> stage -> upload -> commit.

    Wire frames (either schema) and legacy per-block payloads are STAGED
    into one of two preallocated layer-major host buffers (pinned on the
    GPU); when a buffer reaches the scatter window it is UPLOADED to the
    card (a non-blocking copy on the pipeline's own CUDA stream, outside
    any exclusive window — overlapping the socket) and COMMITTED with one
    batched in-place ``index_copy_`` inside a minimal exclusive window.
    Double buffering lets frame k+1 stage while window k uploads/commits;
    the window knob (``DYN_KV_SCATTER_BLOCKS``) bounds how long any one
    commit can stall the decode loop, and decode steps run between
    windows.

    Callers may release each wire buffer as soon as ``add_frame`` returns
    (staging copies the bytes). Not thread-safe; drive from one task, then
    ``await finish()``. Per-phase wall time accumulates in ``timings``
    (``stage_s``/``upload_s``/``scatter_s``).

    On a rank world's leader (``engine.world``) the upload phase is
    skipped: the scatter is fanned out WITH its host values so every rank
    writes its part — commits stay batched, host-side.
    """

    def __init__(self, engine: "TorchEngine", window: Optional[int] = None,
                 commit: Optional[Callable] = None):
        self.engine = engine
        self.window = int(window) if window else kv_transfer_defaults()[1]
        self.injected = 0
        self.blocks_staged = 0
        self.timings: Dict[str, float] = {
            "stage_s": 0.0, "upload_s": 0.0, "scatter_s": 0.0}
        if commit is not None:
            self._inner = commit
        else:
            # pass the already-resolved window down so the host-path
            # chunked scatter never re-reads the config inside a commit
            self._inner = (lambda eng, metas, data:
                           _inject_data(eng, metas, data, self.window))
        # a world's leader commits host values (no upload, no pinning)
        self._world = engine.world
        self._cuda = engine.pages.is_cuda and not self._world
        self._stream = (torch.cuda.Stream(engine.pages.device)
                        if self._cuda else None)
        # per slot: (pinned tensor or None, its numpy staging view)
        self._bufs: List[Optional[Tuple[Any, np.ndarray]]] = [None, None]
        self._cur = 0
        self._fill = 0
        self._metas: List[Tuple[int, int, Optional[int]]] = []
        self._pending: List[Optional[asyncio.Task]] = [None, None]
        self._direct: Optional[asyncio.Task] = None
        # commit-order chain: uploads overlap freely, but windows COMMIT
        # in arrival order — under a near-full allocator, _inject_data
        # truncates to the free-page budget, and out-of-order commits
        # could keep a chain's tail while dropping its head
        self._commit_order: Optional[asyncio.Future] = None

    async def add_frame(self, meta: Dict[str, Any],
                        release: Optional[Callable] = None) -> None:
        """Stage one wire frame; commits whenever a window fills.

        Without ``release``, the bytes are copied out of ``meta["_raw"]``
        before this returns and the caller keeps ownership of the buffer.
        With ``release``, the pipeline OWNS the wire buffer and calls
        ``release(raw)`` once its bytes are consumed — which enables the
        zero-copy frame path: a layer-major frame spanning at least one
        full scatter window uploads straight from the wire buffer."""
        try:
            metas, arr = frame_arrays(meta)
            if meta.get("shard") is not None:
                # a one-device destination has no shard to place a slice
                # on (the reference refuses a mismatched layout the same
                # way); pullers here never advertise one
                raise ValueError(
                    f"shard frame layout ({meta['shard'].get('count')}, "
                    f"{meta['shard'].get('axis')}) does not match the "
                    f"destination cache {cache_shard_layout(self.engine)}")
        except Exception:
            # ownership contract: even a malformed frame's buffer goes
            # back to the pool
            if release is not None:
                release(meta["_raw"])
            raise
        if (release is not None and not self._world
                and meta.get("layout") == "layer"
                and len(metas) >= self.window and self._fill == 0):
            await self._direct_frame(metas, arr, meta["_raw"], release)
            return
        try:
            await self._stage(metas, arr)
        finally:
            if release is not None:
                release(meta["_raw"])

    async def add_blocks(self, blocks: List["BlockPayload"]) -> None:
        """Legacy per-block payloads ride the same staged/batched path."""
        for b in blocks:
            await self._stage(
                [(b.block_hash, b.local_hash, b.parent_hash)],
                b.data[:, None])

    async def finish(self) -> int:
        """Flush the partial window and wait out in-flight commits.
        Returns total blocks injected."""
        self._start_flush()
        tasks = [t for t in self._pending if t is not None]
        if self._direct is not None:
            tasks.append(self._direct)
        self._pending = [None, None]
        self._direct = None
        results = await asyncio.gather(*tasks, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return self.injected

    async def drain(self) -> int:
        """Best-effort ``finish`` for failure paths: waits out in-flight
        commits without raising. Returns blocks injected so far —
        content-addressed blocks that landed from a broken stream are
        still good prefix."""
        try:
            return await self.finish()
        except Exception:  # noqa: BLE001 — the caller's branch already
            # failed; this must only reap
            logger.debug("staged KV commit failed during cleanup",
                         exc_info=True)
        return self.injected

    # -- internals ---------------------------------------------------------

    def _order_ticket(self) -> Tuple[Optional[asyncio.Future],
                                     asyncio.Future]:
        """(previous window's commit-done future, this window's) — taken
        synchronously at flush-start so task scheduling can't reorder."""
        prev = self._commit_order
        done: asyncio.Future = asyncio.get_running_loop().create_future()
        self._commit_order = done
        return prev, done

    async def _stage(self, metas, arr) -> None:
        pos, n = 0, len(metas)
        while pos < n:
            if self._fill >= self.window:
                await self._rotate()
            buf = self._ensure_buf(arr)
            take = min(n - pos, self.window - self._fill)
            t0 = time.perf_counter()
            buf[:, self._fill:self._fill + take] = arr[:, pos:pos + take]
            self.timings["stage_s"] += time.perf_counter() - t0
            self._metas.extend(metas[pos:pos + take])
            self._fill += take
            self.blocks_staged += take
            pos += take
        if self._fill >= self.window:
            # flush eagerly: the upload overlaps the NEXT frame's recv
            await self._rotate()

    def _ensure_buf(self, arr) -> np.ndarray:
        shape = (arr.shape[0], self.window) + tuple(arr.shape[2:])
        slot = self._bufs[self._cur]
        buf = None if slot is None else slot[1]
        if buf is None or buf.shape != shape or buf.dtype != arr.dtype:
            if self._fill:
                raise ValueError("frame geometry changed mid-window: "
                                 f"{buf.shape}/{buf.dtype} vs "
                                 f"{shape}/{arr.dtype}")
            if self._cuda:
                pinned = torch.empty(int(np.prod(shape)) * arr.itemsize,
                                     dtype=torch.uint8, pin_memory=True)
                buf = pinned.numpy().view(arr.dtype).reshape(shape)
                self._bufs[self._cur] = (pinned, buf)
            else:
                buf = np.empty(shape, arr.dtype)
                self._bufs[self._cur] = (None, buf)
        return buf

    async def _rotate(self) -> None:
        self._start_flush()
        self._cur ^= 1
        # double buffer: the slot being switched into must have finished
        # its upload+commit before its bytes are overwritten (this await
        # is also the backpressure on the recv side)
        prev = self._pending[self._cur]
        if prev is not None:
            self._pending[self._cur] = None
            await prev

    def _start_flush(self) -> None:
        if not self._fill:
            return
        idx = self._cur
        slot, metas, fill = self._bufs[idx], self._metas, self._fill
        self._metas, self._fill = [], 0
        prev, done = self._order_ticket()
        self._pending[idx] = asyncio.create_task(
            self._flush(slot, metas, fill, prev, done))

    def _dispatch_upload(self, vals):
        """Start the host->device copy of ``vals`` (a host array, or a
        pinned tensor) on the pipeline's own stream; returns (device
        tensor, completion event or None). On the CPU the values are the
        tensor (the commit copies them)."""
        t = vals if isinstance(vals, torch.Tensor) \
            else host_tensor(vals, self.engine.pages.dtype)
        if not self._cuda:
            return t, None
        with torch.cuda.stream(self._stream):
            dev = t.to(self.engine.pages.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return dev, ev

    @staticmethod
    async def _wait_upload(ev) -> None:
        # wait OUTSIDE any exclusive window: the commit must be the bare
        # scatter (skip the thread hop when the copy already finished)
        if ev is not None and not ev.query():
            await asyncio.to_thread(ev.synchronize)

    async def _upload(self, vals):
        t0 = time.perf_counter()
        dev, ev = self._dispatch_upload(vals)
        await self._wait_upload(ev)
        self.timings["upload_s"] += time.perf_counter() - t0
        return dev

    async def _commit_vals(self, metas, vals) -> None:
        t0 = time.perf_counter()
        # assign AFTER the await: ``self.injected += await ...`` loads the
        # attribute before suspending, so two in-flight flushes would lose
        # one commit's count
        n = await self.engine.run_exclusive(
            _commit_staged, self.engine, metas, vals, self._inner)
        self.injected += n
        self.timings["scatter_s"] += time.perf_counter() - t0

    async def _flush(self, slot, metas, fill, prev, done) -> None:
        pinned, buf = slot
        try:
            if self._world:
                vals = buf[:, :fill]
            elif pinned is not None:
                # the whole pinned slot uploads as one async copy (a
                # partial window is a strided view the copy would stage
                # through pageable memory)
                src = pinned.view(_TORCH_CARRIER[buf.dtype]).view(buf.shape)
                if buf.dtype == np.uint16:
                    src = src.view(torch.bfloat16)
                vals = (await self._upload(src))[:, :fill]
            else:
                vals = await self._upload(buf[:, :fill])
            if prev is not None:
                # uploads overlap; COMMITS go in window order (the chain
                # future resolves even when the prior commit failed)
                await prev
            await self._commit_vals(metas, vals)
        finally:
            if not done.done():
                done.set_result(None)

    async def _direct_frame(self, metas, arr, raw, release) -> None:
        """Zero-copy frame path: upload the whole layer-major frame
        straight from the wire buffer (its copy overlaps the next frame's
        recv AND the previous frame's scatter), then commit it in
        window-bounded scatters from a background task; the buffer is
        released only after the upload has read it."""
        try:
            t0 = time.perf_counter()
            dev, ev = self._dispatch_upload(arr)
            self.timings["upload_s"] += time.perf_counter() - t0
        except BaseException:
            # ownership contract: a failure before the commit task exists
            # must still return the wire buffer
            release(raw)
            raise
        self.blocks_staged += len(metas)
        order_prev, order_done = self._order_ticket()

        async def commit():
            try:
                t1 = time.perf_counter()
                await self._wait_upload(ev)
                self.timings["upload_s"] += time.perf_counter() - t1
                if order_prev is not None:
                    await order_prev  # commit in window order
                if len(metas) <= self.window:
                    await self._commit_vals(metas, dev)
                    return
                for i in range(0, len(metas), self.window):
                    chunk = metas[i:i + self.window]
                    await self._commit_vals(chunk,
                                            dev[:, i:i + len(chunk)])
            finally:
                if not order_done.done():
                    order_done.set_result(None)
                release(raw)

        prev, self._direct = self._direct, asyncio.create_task(commit())
        if prev is not None:  # bound in-flight commits (backpressure)
            await prev


async def inject_device_windowed(engine: "TorchEngine",
                                 metas: List[Tuple[int, int, Optional[int]]],
                                 data, window: Optional[int] = None) -> int:
    """Commit an already-on-device tensor in windows of at most ``window``
    blocks, one minimal exclusive scatter each — decode steps interleave
    between windows (the device-direct plane's batched inject)."""
    window = int(window) if window else kv_transfer_defaults()[1]
    injected = 0
    for i in range(0, len(metas), window):
        chunk = metas[i:i + window]
        injected += await engine.run_exclusive(
            _inject_data, engine, chunk, data[:, i:i + len(chunk)],
            window)
    return injected


async def pump_bulk_frames(pipe: InjectPipeline, address: str,
                           endpoint: str, payload: Any, ident: str = "",
                           timeout: float = 60.0,
                           on_meta: Optional[Callable] = None,
                           inflight: int = 4) -> float:
    """Drive one bulk fetch's frames into an inject pipeline from the
    event loop: frames hop from the fetch thread through a bounded queue
    (at most ``inflight`` un-staged frames) and stage/commit while later
    frames are still on the wire. Wire buffers are owned by the pipeline.
    ``on_meta(meta, nbytes)`` runs per frame before staging. Returns
    seconds spent waiting on the socket/queue; raises on transport,
    handler or commit error AFTER reaping the fetch thread, the queue get
    and in-flight commits — the caller reads ``pipe.injected`` for what
    landed, then calls ``pipe.finish()`` itself on success."""
    from dynamo_tpu_torch.runtime.bulk import bulk_fetch
    from dynamo_tpu_torch.runtime.codec import release_buffer

    loop = asyncio.get_running_loop()
    frame_q: asyncio.Queue = asyncio.Queue()
    abort = threading.Event()
    window = threading.Semaphore(inflight)
    recv_s = 0.0

    def on_frame(meta, raw):
        while not window.acquire(timeout=0.5):
            if abort.is_set():
                raise ConnectionError("bulk fetch aborted")
        loop.call_soon_threadsafe(frame_q.put_nowait, (meta, raw))

    async def stage_one(meta, raw):
        meta = dict(meta)
        meta["_raw"] = raw
        try:
            try:
                if on_meta is not None:
                    on_meta(meta, len(raw))
            except BaseException:
                release_buffer(raw)  # add_frame never took ownership
                raise
            await pipe.add_frame(meta, release=release_buffer)
        finally:
            window.release()

    fetch = asyncio.create_task(asyncio.to_thread(
        bulk_fetch, address, endpoint, payload, ident, timeout, on_frame,
        abort))
    get = None
    try:
        while True:
            get = asyncio.ensure_future(frame_q.get())
            t0 = time.perf_counter()
            done, _ = await asyncio.wait(
                {get, fetch}, return_when=asyncio.FIRST_COMPLETED)
            recv_s += time.perf_counter() - t0
            if get in done:
                meta, raw = get.result()
                await stage_one(meta, raw)
                continue
            get.cancel()
            await fetch  # raises on transport/handler error
            while not frame_q.empty():  # drain the tail
                meta, raw = frame_q.get_nowait()
                await stage_one(meta, raw)
            return recv_s
    except BaseException:
        # reap BEFORE propagating — including on task CancelledError
        # (client disconnect): a to_thread task only completes when its
        # thread exits, and the thread exits via the abort check
        abort.set()
        if get is not None:
            get.cancel()
        if not fetch.done():
            fetch.cancel()
        try:
            await fetch
        except (Exception, asyncio.CancelledError):  # noqa: BLE001
            pass
        while not frame_q.empty():  # un-staged frames: pool their buffers
            _m, raw = frame_q.get_nowait()
            release_buffer(raw)
        await pipe.drain()
        raise
    finally:
        abort.set()


def serve_kv_export_bulk(engine: "TorchEngine", loop):
    """Bulk-plane handler (``runtime/bulk.py``): synchronous, runs in the
    bulk connection's thread, coordinates with the engine loop via
    ``run_coroutine_threadsafe`` so the gather still happens inside an
    exclusive window. Yields (meta, buffer) pairs in the same schema as
    ``export_frames``."""

    def handler(payload):
        payload = payload or {}
        hashes = list(payload.get("block_hashes", []))
        # clients that predate wire v3 omit the key and get the block-major
        # v2 frames they expect (mixed-version pulls keep working)
        layout, per, crc, shards = resolve_wire(payload, 2)
        fut = asyncio.run_coroutine_threadsafe(
            engine.run_exclusive(export_frames, engine, hashes, layout,
                                 per, shards),
            loop)
        frames = fut.result(timeout=120.0)
        if crc:  # checksummed in THIS (bulk connection) thread
            stamp_frame_crcs(frames)
        for f in frames:
            yield f.obj, f.raw

    return handler


def serve_kv_export(engine: "TorchEngine"):
    """RPC handler factory: serves block fetches for disagg decode workers
    and drain survivors.

    Endpoint payload: {"block_hashes": [...], "wire": N}; clients that
    advertise ``wire >= 3`` get layer-major two-part frames, ``wire == 2``
    the block-major v2 frames, and older clients the per-block msgpack
    schema. ``{"ack_lease": id}`` releases an export lease. The export
    runs via ``run_exclusive`` so it never races an engine step."""

    async def handler(payload: Any, ctx):
        payload = payload or {}
        if payload.get("ack_lease") is not None:
            ok = await release_export_lease(engine,
                                            int(payload["ack_lease"]))
            yield {"acked": bool(ok)}
            return
        hashes = list(payload.get("block_hashes", []))
        wire = int(payload.get("wire", 1))
        if wire >= 2:
            layout, per, crc, shards = resolve_wire(payload, 1)
            frames = await engine.run_exclusive(export_frames, engine,
                                                hashes, layout, per,
                                                shards)
            if crc:  # outside the exclusive window
                stamp_frame_crcs(frames)
            for f in frames:
                yield f
        else:
            blocks = await engine.run_exclusive(export_blocks, engine,
                                                hashes)
            for b in blocks:
                yield b.to_wire()

    return handler


# ---------------------------------------------------------------------------
# Export leases: TTL-bounded pinning of advertised KV blocks
# ---------------------------------------------------------------------------

# default lease lifetime; env DYN_KV_EXPORT_TTL_S overrides per grant
EXPORT_TTL_S = 120.0


def export_ttl_s() -> float:
    raw = os.environ.get("DYN_KV_EXPORT_TTL_S")
    if raw is None:
        return EXPORT_TTL_S
    try:
        return max(0.1, float(raw))
    except (TypeError, ValueError):
        logger.warning("malformed DYN_KV_EXPORT_TTL_S %r; using %.0f",
                       raw, EXPORT_TTL_S)
        return EXPORT_TTL_S


class ExportLeaseManager:
    """TTL'd pins on KV pages a worker has advertised for pull.

    A lease pins the pages (``PageAllocator.claim_blocks``) until the
    puller acks (``{"ack_lease": id}`` on the kv_export endpoint) or the
    TTL (``DYN_KV_EXPORT_TTL_S``) expires and a GC sweep reclaims them —
    so orphaned KV from crashed decoders is bounded and observable
    (``dynamo_worker_kv_exports_active`` / ``_reclaimed_total``). Pinned
    pages are capped at half the allocator so a flood of un-acked exports
    can never starve prefill admission."""

    def __init__(self, engine: "TorchEngine"):
        self._engine = engine
        # lease_id -> (deadline, pages, kind); kind "export" = a disagg
        # pull's advertised prefix, "prefetch" = tier blocks the KVBM
        # prefetch scheduler promoted ahead of a request's prefill cursor
        self._leases: Dict[int, Tuple[float, List[int], str]] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._sweep_tasks: set = set()
        self.granted_total = 0
        self.reclaimed_total = 0
        self.max_pinned_pages = max(1,
                                    (engine.allocator.num_pages - 1) // 2)

    # -- observers ---------------------------------------------------------

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._leases)

    @property
    def pinned_pages(self) -> int:
        with self._lock:
            return sum(len(p) for _dl, p, _k in self._leases.values())

    def active_kind(self, kind: str) -> int:
        with self._lock:
            return sum(1 for _dl, _p, k in self._leases.values()
                       if k == kind)

    def pinned_pages_kind(self, kind: str) -> int:
        with self._lock:
            return sum(len(p) for _dl, p, k in self._leases.values()
                       if k == kind)

    def holds(self, lease_id: int) -> bool:
        """Whether a lease is still live (not released, not TTL-swept)."""
        with self._lock:
            return lease_id in self._leases

    def _gauge(self) -> None:
        try:
            from dynamo_tpu_torch.worker.metrics import get_worker_metrics
            get_worker_metrics().kv_exports_active.set(
                self.active_kind("export"))
        except Exception:  # noqa: BLE001 — metrics must not fail the grant
            pass

    # -- allocator-side halves (run under run_exclusive) -------------------

    def grant_sync(self, hashes: List[int], ttl: Optional[float] = None,
                   kind: str = "export") -> Tuple[Optional[int], int]:
        """Synchronous grant for callers ALREADY inside an exclusive
        window. Returns ``(lease_id, pages_pinned)``; the caller must
        ``arm_sweep(ttl)`` from the event loop afterwards."""
        ttl = export_ttl_s() if ttl is None else float(ttl)
        self._sweep_sync()  # reclaim expired pins before the cap check
        alloc = self._engine.allocator
        with self._lock:
            pinned = sum(len(p) for _dl, p, _k in self._leases.values())
            budget = self.max_pinned_pages - pinned
            if budget <= 0:
                if kind == "export":
                    logger.warning(
                        "export lease refused: %d pages already pinned "
                        "(cap %d) — decode pulls failing or not acking?",
                        pinned, self.max_pinned_pages)
                else:
                    logger.debug(
                        "%s lease refused: %d pages pinned (cap %d)",
                        kind, pinned, self.max_pinned_pages)
                return None, 0
            pages = alloc.claim_blocks(hashes)
            if len(pages) > budget:
                # the cap is a hard bound, not a pre-check: trim the claim
                # (a head-of-chain pin is still worth having)
                alloc.release(pages[budget:])
                pages = pages[:budget]
            if not pages:
                return None, 0
            lease_id = self._next_id
            self._next_id += 1
            self._leases[lease_id] = (time.monotonic() + ttl, pages, kind)
            self.granted_total += 1
            n = len(pages)
        self._gauge()
        return lease_id, n

    def _grant_sync(self, hashes: List[int], ttl: float,
                    kind: str = "export") -> Optional[int]:
        return self.grant_sync(hashes, ttl, kind)[0]

    def _release_sync(self, lease_id: int) -> bool:
        with self._lock:
            ent = self._leases.pop(lease_id, None)
        if ent is None:
            return False
        self._engine.allocator.release(ent[1])
        self._gauge()
        return True

    def _sweep_sync(self) -> int:
        now = time.monotonic()
        with self._lock:
            expired = [(i, self._leases[i])
                       for i, (dl, _p, _k) in list(self._leases.items())
                       if dl <= now]
            for i, _e in expired:
                del self._leases[i]
            self.reclaimed_total += len(expired)
        for _i, (_dl, pages, _k) in expired:
            self._engine.allocator.release(pages)
        if expired:
            logger.warning("reclaimed %d orphaned KV lease(s) "
                           "(%d pages) past TTL", len(expired),
                           sum(len(p) for _i, (_d, p, _k) in expired))
            self._gauge()
            try:
                from dynamo_tpu_torch.worker.metrics import (
                    get_worker_metrics)
                get_worker_metrics().kv_exports_reclaimed.inc(len(expired))
            except Exception:  # noqa: BLE001
                pass
        return len(expired)

    # -- async surface (event loop) ----------------------------------------

    async def grant(self, hashes: List[int],
                    ttl: Optional[float] = None,
                    kind: str = "export") -> Optional[int]:
        """Pin the resident chain of ``hashes`` for one pull; returns the
        lease id (wire-safe) or None when nothing is resident / the pin
        cap is hit (the export still works, it just isn't protected)."""
        ttl = export_ttl_s() if ttl is None else float(ttl)
        lease = await self._engine.run_exclusive(self._grant_sync,
                                                 list(hashes), ttl, kind)
        if lease is not None:
            self.arm_sweep(ttl)
        return lease

    async def release(self, lease_id: int) -> bool:
        return await self._engine.run_exclusive(self._release_sync,
                                                int(lease_id))

    def release_detached(self, lease_id: int) -> bool:
        """Release without touching the engine loop: for teardown paths
        where the loop is stopped/dead (``run_exclusive`` would restart
        it). Safe there because nothing races the allocator anymore."""
        try:
            return self._release_sync(int(lease_id))
        except Exception:  # noqa: BLE001 — TTL covers a failed release
            logger.debug("detached lease release failed", exc_info=True)
            return False

    def arm_sweep(self, ttl: float) -> None:
        # one timer per grant, firing just past that lease's deadline: a
        # sweep reclaims EVERY expired lease
        loop = asyncio.get_running_loop()
        loop.call_later(ttl + 0.02, self._sweep_soon, loop)

    def _sweep_soon(self, loop) -> None:
        with self._lock:
            if not self._leases:
                return
        task = loop.create_task(self._sweep_async())
        self._sweep_tasks.add(task)
        task.add_done_callback(self._sweep_tasks.discard)

    async def _sweep_async(self) -> None:
        eng = self._engine
        try:
            if (getattr(eng, "_stopping", False)
                    or eng._loop_task is None or eng._loop_task.done()):
                # engine loop is gone: nothing races the allocator anymore
                self._sweep_sync()
            else:
                await eng.run_exclusive(self._sweep_sync)
        except Exception:  # noqa: BLE001 — GC is best-effort
            logger.debug("export lease sweep failed", exc_info=True)


def _lease_engine(engine) -> Optional["TorchEngine"]:
    """The engine whose allocator holds the advertised blocks, or None
    when ``engine`` has no page allocator. Unwraps one wrapper layer
    (``TieredEngine.engine``)."""
    for cand in (engine, getattr(engine, "engine", None)):
        if (cand is not None and hasattr(cand, "allocator")
                and hasattr(cand, "run_exclusive")):
            return cand
    return None


def get_export_leases(engine) -> Optional[ExportLeaseManager]:
    """The per-engine lease manager (created on first use), or None when
    the engine cannot pin pages."""
    eng = _lease_engine(engine)
    if eng is None:
        return None
    mgr = getattr(eng, "_export_leases", None)
    if mgr is None:
        mgr = ExportLeaseManager(eng)
        eng._export_leases = mgr
    return mgr


async def grant_export_lease(engine, hashes: List[int],
                             ttl: Optional[float] = None) -> Optional[int]:
    """Pin ``hashes`` on ``engine`` under a TTL'd export lease; returns
    the lease id for the puller to ack, or None. Never raises — an
    unprotected export beats a failed prefill."""
    mgr = get_export_leases(engine)
    if mgr is None or not hashes:
        return None
    try:
        return await mgr.grant(hashes, ttl)
    except Exception:  # noqa: BLE001 — lease is protection, not a gate
        logger.exception("export lease grant failed")
        return None


async def stamp_export_lease(engine, params: Optional[Dict[str, Any]],
                             span=None) -> Optional[int]:
    """Grant an export lease for ``params["blocks"]`` and stamp the id
    into ``params["lease"]`` (+ a ``kv_export_lease`` span attr)."""
    blocks = (params or {}).get("blocks")
    if not blocks:
        return None
    lease = await grant_export_lease(engine, [b[0] for b in blocks])
    if lease is not None:
        params["lease"] = lease
        if span is not None:
            span.set_attr("kv_export_lease", lease)
    return lease


async def release_export_lease(engine, lease_id: int) -> bool:
    """Ack one export lease (puller-side commit/abandon signal)."""
    eng = _lease_engine(engine)
    mgr = getattr(eng, "_export_leases", None) if eng is not None else None
    if mgr is None:
        return False
    try:
        return await mgr.release(lease_id)
    except Exception:  # noqa: BLE001 — TTL covers a failed release
        logger.debug("export lease release failed", exc_info=True)
        return False


# ---------------------------------------------------------------------------
# Device-direct cross-process transfer (CUDA IPC)
# ---------------------------------------------------------------------------

# offered device tensors are dropped if nobody pulled them in this window
OFFER_TTL_S = 120.0


def _ipc_handle(t: torch.Tensor) -> Dict[str, Any]:
    """The wire-safe CUDA IPC description of ``t``: its storage's IPC
    handle and offset (``UntypedStorage._share_cuda_``, what
    ``torch.multiprocessing`` sends), the view's geometry, and the event
    recorded behind the work that wrote it on this thread's stream."""
    storage = t.untyped_storage()
    (device, handle, size_bytes, offset_bytes, ref_handle, ref_offset,
     event_handle, event_sync) = storage._share_cuda_()
    return {"device": int(device), "handle": bytes(handle),
            "size_bytes": int(size_bytes),
            "offset_bytes": int(offset_bytes),
            "ref_handle": bytes(ref_handle), "ref_offset": int(ref_offset),
            "event_handle": bytes(event_handle) if event_handle else b"",
            "event_sync": bool(event_sync),
            "shape": list(t.shape), "stride": list(t.stride()),
            "storage_offset": int(t.storage_offset()),
            "dtype": wire_dtype(t)}


def _ipc_open(desc: Dict[str, Any]) -> torch.Tensor:
    """Map a peer's ``_ipc_handle`` on this process's card (the current
    stream waits for the peer's event); ``torch.multiprocessing``'s own
    rebuild, so the mapping is shared and reference-counted as when a
    tensor crosses processes there."""
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    return rebuild_cuda_tensor(
        torch.Tensor, torch.Size(desc["shape"]), tuple(desc["stride"]),
        desc["storage_offset"], torch.UntypedStorage,
        getattr(torch, desc["dtype"]), desc["device"], desc["handle"],
        desc["size_bytes"], desc["offset_bytes"], False,
        desc["ref_handle"], desc["ref_offset"],
        desc["event_handle"] or None, desc["event_sync"])


class DeviceTransferPlane:
    """Cross-process card-to-card KV block pulls — the NIXL RDMA role
    (reference ``transfer.py`` ``DeviceTransferPlane`` on
    ``jax.experimental.transfer``), over CUDA IPC.

    The prefill worker OFFERS a gathered device tensor under a uuid: the
    offer dict carries its CUDA IPC handle, offset, shape, dtype and the
    block hashes, and travels over the ordinary RPC control plane
    (``serve_kv_export_direct``). The decode worker opens the handle,
    copies the blocks into memory of its own on a stream of its own,
    drops the mapping and, after committing them into its cache in place,
    acks; the producer keeps the tensor referenced until the ack or
    ``OFFER_TTL_S``. The bytes never leave the card.

    Scope: processes on one host (an IPC handle does not cross hosts; an
    offer from another host, or from this process — CUDA refuses to open
    a handle in the process that made it — fails the pull, and the puller
    falls down the transport ladder to the bulk plane).
    """

    # bound on remembered peers (one entry per offering address: prefill
    # restarts advertise fresh addresses)
    MAX_CONNS = 8
    # bound on offers awaiting a pull/ack: each pins one gathered tensor
    # in HBM; past the cap offer() refuses (returns None) and the decode
    # falls down the transport ladder while still being served
    MAX_OUTSTANDING_OFFERS = 32

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self._node = socket.gethostname()
        self._conns: Dict[str, Dict[str, Any]] = {}
        self._offers: Dict[int, Tuple[float, Any]] = {}
        self._next_uuid = int(time.time() * 1000) % (1 << 40)
        # offers mutate from the engine's exclusive worker thread AND the
        # ack handler on the event loop; conns from concurrent pull threads
        self._lock = threading.Lock()
        self._streams: Dict[int, torch.cuda.Stream] = {}

    # -- common ------------------------------------------------------------

    @property
    def address(self) -> str:
        """This process's rendezvous name: host and pid (an IPC plane has
        no listening socket; offers travel on the RPC control plane)."""
        return f"cuda-ipc://{self.host}/{self._node}/{os.getpid()}"

    # -- source (prefill) side ---------------------------------------------

    def _prune_offers_locked(self, now: float) -> None:
        self._offers = {u: (t, a) for u, (t, a) in self._offers.items()
                        if now - t < OFFER_TTL_S}

    def offer_array(self, data: torch.Tensor) -> Dict[str, Any]:
        """Register one device tensor for a single pull and return the
        rendezvous dict (no ``blocks`` metadata — callers add their own).
        Raises RuntimeError past ``MAX_OUTSTANDING_OFFERS``."""
        if not data.is_cuda:
            raise RuntimeError("the device-direct plane offers CUDA "
                               "tensors only")
        now = time.time()
        with self._lock:
            self._prune_offers_locked(now)
            if len(self._offers) >= self.MAX_OUTSTANDING_OFFERS:
                raise RuntimeError(
                    f"{len(self._offers)} un-acked offers outstanding — "
                    f"refusing to pin more HBM (decode pulls failing?)")
            uuid = self._next_uuid
            self._next_uuid += 1
            # keep the tensor referenced until acked or TTL
            self._offers[uuid] = (now, data)
        try:
            ipc = _ipc_handle(data)
        except Exception:
            with self._lock:  # failed registration must not eat a slot
                self._offers.pop(uuid, None)
            raise
        return {
            "uuid": uuid,
            "address": self.address,
            "shape": list(data.shape),
            "dtype": wire_dtype(data),
            "ipc": ipc,
        }

    def offer(self, engine: "TorchEngine", block_hashes: List[int]
              ) -> Optional[Dict[str, Any]]:
        """Gather the resident blocks ON DEVICE and offer them for one
        pull. Runs under ``run_exclusive`` (the IPC event is recorded
        behind the gather on the steps' stream). Returns the rendezvous
        dict (wire-safe) or None when nothing is resident / the offer
        table is full (the decode side falls down the transport ladder)."""
        metas, data = _export_device(engine, block_hashes)
        if not metas:
            return None
        try:
            out = self.offer_array(data[:, :len(metas)])
        except RuntimeError as e:
            logger.warning("direct offer refused: %s", e)
            return None
        out["blocks"] = [[h, local, parent] for h, local, parent in metas]
        return out

    def ack(self, uuid: int) -> None:
        """Drop a pulled offer's device tensor (and any expired ones)."""
        with self._lock:
            self._offers.pop(uuid, None)
            self._prune_offers_locked(time.time())

    def evict_expired_offers(self) -> int:
        """Drop every offer past ``OFFER_TTL_S``; returns how many were
        reclaimed."""
        now = time.time()
        with self._lock:
            before = len(self._offers)
            self._prune_offers_locked(now)
            return before - len(self._offers)

    # -- destination (decode) side -----------------------------------------

    def _connect(self, offer: Dict[str, Any]) -> None:
        """Check the offer can be opened here (same host, another
        process) and remember the peer."""
        addr = offer["address"]
        with self._lock:
            if addr in self._conns:
                return
        _scheme, rest = addr.split("://", 1)
        _host, node, pid = rest.split("/")
        if node != self._node:
            raise ConnectionError(f"{addr}: a CUDA IPC offer from another "
                                  f"host ({node}) cannot be opened here")
        if int(pid) == os.getpid():
            raise ConnectionError(f"{addr}: CUDA IPC cannot open a handle "
                                  "in the process that made it")
        with self._lock:
            while len(self._conns) >= self.MAX_CONNS:
                self._conns.pop(next(iter(self._conns)), None)
            self._conns[addr] = {"pid": int(pid)}

    def _stream(self, device: int) -> torch.cuda.Stream:
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device)
            return s

    def pull(self, offer: Dict[str, Any],
             device: Optional[torch.device] = None) -> torch.Tensor:
        """Copy an offered tensor card to card into memory of this
        process; returns the copy. Touches NO engine state — callers run
        it on any thread (with their own timeout) and commit the copy
        afterwards (``inject_device_windowed``). The copy runs on the
        plane's own stream and is waited for; the peer's mapping is
        dropped before this returns. A failed pull evicts the remembered
        peer."""
        addr = offer["address"]
        try:
            self._connect(offer)
            dev = torch.device(device if device is not None else "cuda")
            index = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            torch.cuda.set_device(index)
            stream = self._stream(index)
            with torch.cuda.stream(stream):
                peer = _ipc_open(offer["ipc"])
                data = torch.empty(peer.shape, dtype=peer.dtype,
                                   device=dev)
                data.copy_(peer, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
            del peer
        except Exception:
            self.evict(addr)
            raise
        return data

    def evict(self, address: str) -> None:
        """Forget a remembered peer (failed/stalled — the next pull from
        the address checks it again)."""
        with self._lock:
            self._conns.pop(address, None)


def serve_kv_export_direct(engine: "TorchEngine",
                           plane: DeviceTransferPlane):
    """RPC handler serving device-direct rendezvous offers: payload
    ``{"block_hashes": [...]}`` -> one offer dict (or an empty frame when
    nothing is resident); ``{"ack": uuid}`` releases a pulled offer's
    device tensor. Registered beside the frame/bulk exports."""

    async def handler(payload: Any, ctx):
        payload = payload or {}
        if payload.get("ack") is not None:
            plane.ack(int(payload["ack"]))
            yield {"acked": True}
            return
        hashes = list(payload.get("block_hashes", []))
        offer = await engine.run_exclusive(plane.offer, engine, hashes)
        yield offer if offer is not None else {}

    return handler


KV_EXPORT_DIRECT_ENDPOINT = "kv_export_direct"


__all__ = ["BlockPayload", "export_blocks", "inject_blocks",
           "export_frames", "inject_frame", "frame_arrays",
           "verify_frame", "FrameIntegrityError",
           "InjectPipeline", "inject_device_windowed", "pump_bulk_frames",
           "serve_kv_export",
           "serve_kv_export_bulk", "BLOCKS_PER_FRAME",
           "SCATTER_WINDOW_BLOCKS", "FRAME_WIRE_VERSION",
           "kv_transfer_defaults", "resolve_wire", "frame_crc_enabled",
           "cache_shard_layout", "kv_shard_payload",
           "ExportLeaseManager", "get_export_leases", "grant_export_lease",
           "release_export_lease", "stamp_export_lease",
           "stamp_frame_crcs", "export_ttl_s", "EXPORT_TTL_S",
           "DeviceTransferPlane", "serve_kv_export_direct",
           "KV_EXPORT_DIRECT_ENDPOINT", "wire_dtype", "host_dtype",
           "host_array", "host_tensor"]
