"""The port's KV transfer (``dynamo_tpu_torch/engine/transfer.py``) against
the reference's, on the CPU.

- Within the port: export/inject round trips through every wire schema
  (v1 per-block dicts, v2 block-major, v3 layer-major, v4 checksummed),
  through the real RPC server and the bulk plane; a corrupted v4 frame is
  rejected before anything reaches the cache; bfloat16 and MLA latent
  caches move through the same frames; export leases pin, ack, expire and
  respect their cap; the staged pipeline commits in at most
  ceil(blocks / window) scatters; old and new schemas mix.
- Across frameworks: ``JaxEngine``'s frames inject into ``TorchEngine``
  through the port's ``InjectPipeline`` and the port's frames into
  ``JaxEngine`` through the reference's, and the reference's own
  ``serve_kv_export`` (RPC) and ``serve_kv_export_bulk`` handlers are
  pulled by the port's ``KvBlockPuller``. The meta dicts are equal and the
  injected pages' bytes equal the bytes the sender sent.

Tolerance: none. Every comparison of KV is byte for byte (bfloat16 as its
uint16 bits), and the cache's address never changes across an inject.
"""

import asyncio
import zlib

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.engine.transfer import (
    BlockPayload, FrameIntegrityError, InjectPipeline, export_blocks,
    export_frames, inject_blocks, inject_frame, serve_kv_export,
    stamp_frame_crcs)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                               SamplingOptions,
                                               StopConditions)

torch.set_num_threads(2)

SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=128, min_prefill_bucket=4)
PROMPT = list(range(1, 14))  # 13 tokens -> 3 full blocks


@pytest.fixture(scope="module")
def weights():
    """One tiny Llama's float32 weights, for both engines."""
    jcfg = JModelConfig.tiny()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     params)
    return jcfg, params, np_tree


def teng(weights=None, dtype="float32", **kw) -> TorchEngine:
    cfg = ModelConfig.tiny(dtype=dtype)
    sizes = {**SIZES, **kw}
    if weights is None:
        return TorchEngine.random_init(cfg, TorchEngineConfig(**sizes),
                                       device="cpu")
    return TorchEngine(cfg, tllama.params_from_jax(weights[2], cfg,
                                                   device="cpu"),
                       TorchEngineConfig(**sizes), device="cpu")


def jeng(weights=None, dtype="float32", **kw) -> JaxEngine:
    sizes = {**SIZES, **kw}
    if weights is None:
        return JaxEngine.random_init(JModelConfig.tiny(dtype=dtype),
                                     JaxEngineConfig(attn_impl="scan",
                                                     **sizes))
    return JaxEngine(weights[0], weights[1],
                     JaxEngineConfig(attn_impl="scan", **sizes))


def make_req(tokens, rid, max_tokens=6, cls=PreprocessedRequest):
    return cls(token_ids=list(tokens), request_id=rid,
               stop_conditions=StopConditions(max_tokens=max_tokens),
               sampling_options=SamplingOptions(temperature=0.0))


async def prefill(engine, prompt, rid="p", cls=PreprocessedRequest):
    req = make_req(prompt, rid, cls=cls)
    req.prefill_only = True
    frames = [f async for f in engine.generate(req)]
    return [blk[0] for blk in frames[-1].kv_transfer_params["blocks"]]


async def cached_tokens(engine, prompt, cls=PreprocessedRequest):
    out = [f async for f in engine.generate(make_req(prompt, "d", cls=cls))]
    return out[-1].cached_tokens


def page_bytes(engine, hashes) -> np.ndarray:
    """The resident blocks of ``hashes`` as raw bytes ``[L, n, ...]``
    (uint8), from either engine."""
    pages = [engine.allocator._by_hash[h] for h in hashes]
    host = np.ascontiguousarray(engine.gather_pages_host(pages))
    return host.view(np.uint8)


def wire_bytes(frame) -> bytes:
    return bytes(memoryview(frame.raw).cast("B")) \
        if isinstance(frame.raw, (bytes, bytearray)) \
        else np.ascontiguousarray(frame.raw).view(np.uint8).tobytes()


def received(frame) -> dict:
    meta = dict(frame.obj)
    meta["_raw"] = wire_bytes(frame)
    return meta


# -- within the port -------------------------------------------------------------


async def test_export_inject_roundtrip():
    a, b = teng(), teng()
    ptr = b.pages.data_ptr()
    try:
        hashes = await prefill(a, PROMPT)
        payloads = export_blocks(a, hashes)
        assert len(payloads) == 3 and payloads[0].dtype == "float32"
        assert inject_blocks(b, payloads) == 3
        assert b.page_scatter_dispatches == 1
        assert await cached_tokens(b, PROMPT) == 12
        np.testing.assert_array_equal(page_bytes(b, hashes),
                                      page_bytes(a, hashes))
        assert b.pages.data_ptr() == ptr
    finally:
        await a.stop()
        await b.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
async def test_block_payload_wire_roundtrip(dtype):
    a = teng(dtype=dtype)
    try:
        hashes = await prefill(a, range(1, 10))
        payloads = export_blocks(a, hashes)
        wired = [BlockPayload.from_wire(p.to_wire()) for p in payloads]
        assert wired[0].dtype == payloads[0].dtype == dtype
        assert wired[0].block_hash == payloads[0].block_hash
        assert wired[0].data.tobytes() == payloads[0].data.tobytes()
    finally:
        await a.stop()


@pytest.mark.parametrize("wire", [1, 2, 3, 4])
async def test_frames_over_rpc_every_schema(wire):
    """The port's ``serve_kv_export`` on a real RPC server: each
    advertised wire version gets its schema (v1 per-block dicts, v2
    block-major without ``layout``, v3 layer-major without ``crc32``, v4
    with a ``crc32`` matching the bytes), and each injects through the
    staged pipeline byte for byte."""
    from dynamo_tpu_torch.runtime.codec import release_buffer
    from dynamo_tpu_torch.runtime.rpc import RpcConnection, RpcServer
    a, b = teng(), teng()
    ptr = b.pages.data_ptr()
    server = await RpcServer().start()
    client = None
    try:
        prompt = list(range(1, 18))  # 4 full blocks
        hashes = await prefill(a, prompt)
        server.register("kv_export", serve_kv_export(a))
        client = await RpcConnection(server.address).connect()
        stream = await client.request(
            "kv_export", {"block_hashes": hashes, "wire": wire})
        pipe = InjectPipeline(b)
        async for frame in stream:
            if wire == 1:
                assert "_raw" not in frame and frame["dtype"] == "float32"
                await pipe.add_blocks([BlockPayload.from_wire(frame)])
                continue
            assert frame["dtype"] == "float32"
            assert ("layout" in frame) == (wire >= 3)
            assert ("crc32" in frame) == (wire >= 4)
            if wire >= 4:
                raw = frame["_raw"]
                got = zlib.crc32(raw if isinstance(raw, (bytes, bytearray))
                                 else memoryview(raw).cast("B"))
                assert got & 0xFFFFFFFF == frame["crc32"]
            await pipe.add_frame(frame, release=release_buffer)
        assert await pipe.finish() == 4
        assert await cached_tokens(b, prompt) == 16
        np.testing.assert_array_equal(page_bytes(b, hashes),
                                      page_bytes(a, hashes))
        assert b.pages.data_ptr() == ptr
    finally:
        if client is not None:
            await client.close()
        await server.stop()
        await a.stop()
        await b.stop()


async def test_checksummed_frame_corruption_rejected():
    a, b, c = teng(), teng(), teng()
    try:
        hashes = await prefill(a, PROMPT)
        wire = stamp_frame_crcs(
            await a.run_exclusive(export_frames, a, hashes, "layer"))
        assert wire and "crc32" in wire[0].obj
        pipe = InjectPipeline(b)
        await pipe.add_frame(received(wire[0]))
        assert await pipe.finish() == 3
        assert await cached_tokens(b, PROMPT) == 12
        # a flipped byte is rejected BEFORE staging — never injected
        bad = received(wire[0])
        raw = bytearray(bad["_raw"])
        raw[len(raw) // 2] ^= 0xFF
        bad["_raw"] = bytes(raw)
        pipe = InjectPipeline(c)
        with pytest.raises(FrameIntegrityError):
            await pipe.add_frame(bad)
        assert await pipe.finish() == 0
        assert not c.allocator._by_hash
        assert c.page_scatter_dispatches == 0
    finally:
        await a.stop()
        await b.stop()
        await c.stop()


def test_resolve_wire_version_map(monkeypatch):
    from dynamo_tpu_torch.engine.transfer import resolve_wire
    assert resolve_wire({"wire": 1}, 1)[::2] == ("block", False)
    assert resolve_wire({"wire": 2}, 1)[::2] == ("block", False)
    assert resolve_wire({"wire": 3}, 1)[::2] == ("layer", False)
    assert resolve_wire({"wire": 4}, 1)[::2] == ("layer", True)
    assert resolve_wire({"wire": 5}, 1)[::2] == ("layer", True)
    assert resolve_wire({}, 2)[::2] == ("block", False)
    monkeypatch.setenv("DYN_KV_FRAME_CRC", "0")
    assert resolve_wire({"wire": 4}, 1)[2] is False


def test_kv_transfer_knobs_resolve_env(monkeypatch):
    from dynamo_tpu_torch.engine.transfer import (BLOCKS_PER_FRAME,
                                                  SCATTER_WINDOW_BLOCKS,
                                                  kv_transfer_defaults)
    monkeypatch.delenv("DYN_KV_FRAME_BLOCKS", raising=False)
    monkeypatch.delenv("DYN_KV_SCATTER_BLOCKS", raising=False)
    assert kv_transfer_defaults() == (BLOCKS_PER_FRAME,
                                      SCATTER_WINDOW_BLOCKS)
    monkeypatch.setenv("DYN_KV_FRAME_BLOCKS", "3")
    monkeypatch.setenv("DYN_KV_SCATTER_BLOCKS", "bogus")
    assert kv_transfer_defaults() == (3, SCATTER_WINDOW_BLOCKS)


async def test_bf16_frames_over_both_planes():
    """A bfloat16 cache ships ``"dtype": "bfloat16"`` frames whose bytes
    are the cache's bits, over the bulk plane and as a standalone frame."""
    from dynamo_tpu_torch.runtime.bulk import BulkServer, bulk_fetch
    a, b = teng(dtype="bfloat16"), teng(dtype="bfloat16")
    ptr = b.pages.data_ptr()
    try:
        hashes = await prefill(a, PROMPT)
        wire = export_frames(a, hashes)
        assert wire and wire[0].obj["dtype"] == "bfloat16"
        assert wire[0].raw.dtype == np.uint16
        loop = asyncio.get_running_loop()

        def handler(payload):
            fut = asyncio.run_coroutine_threadsafe(
                a.run_exclusive(export_frames, a, payload["block_hashes"]),
                loop)
            for f in fut.result(timeout=30):
                yield f.obj, f.raw

        srv = BulkServer().start()
        srv.register("kv", handler)
        try:
            got = await asyncio.to_thread(bulk_fetch, srv.address, "kv",
                                          {"block_hashes": hashes})
        finally:
            srv.stop()
        assert len(got) == 1
        meta = dict(got[0][0])
        meta["_raw"] = got[0][1]
        assert await b.run_exclusive(inject_frame, b, meta) == 3
        assert await cached_tokens(b, PROMPT) == 12
        np.testing.assert_array_equal(page_bytes(b, hashes),
                                      page_bytes(a, hashes))
        assert page_bytes(a, hashes).tobytes() == wire_bytes(wire[0])
        assert b.pages.data_ptr() == ptr
    finally:
        await a.stop()
        await b.stop()


def mla_cfg():
    return ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=1, head_dim=128,
        model_type="deepseek_v2", dtype="float32", q_lora_rank=0,
        kv_lora_rank=128, qk_rope_head_dim=16, qk_nope_head_dim=32,
        v_head_dim=32, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, n_shared_experts=2,
        first_k_dense_replace=1, routed_scaling_factor=1.0,
        max_position_embeddings=512)


async def test_mla_latent_cache_frames():
    """An MLA engine's latent cache ``[L, N, 2, 1, ps, dkv]`` moves through
    the same layer-major frames."""
    cfg = TorchEngineConfig(**SIZES)
    a = TorchEngine.random_init(mla_cfg(), cfg, device="cpu")
    b = TorchEngine.random_init(mla_cfg(), cfg, device="cpu")
    ptr = b.pages.data_ptr()
    try:
        hashes = await prefill(a, PROMPT)
        wire = await a.run_exclusive(export_frames, a, hashes, "layer")
        assert wire[0].obj["block_shape"] == [2, 2, 1, 4, 128]
        pipe = InjectPipeline(b)
        for f in wire:
            await pipe.add_frame(received(f))
        assert await pipe.finish() == 3
        assert await cached_tokens(b, PROMPT) == 12
        np.testing.assert_array_equal(page_bytes(b, hashes),
                                      page_bytes(a, hashes))
        assert b.pages.data_ptr() == ptr
    finally:
        await a.stop()
        await b.stop()


# -- export leases ---------------------------------------------------------------


async def _prefill_via_handler(engine, prompt):
    """A prefill_only request through the port's serving handler — the
    path that grants the lease."""
    from dynamo_tpu_torch.llm.register import engine_handler
    req = make_req(prompt, f"p-{prompt[0]}")
    req.prefill_only = True
    frames = [f async for f in engine_handler(engine)(req.to_dict(), None)]
    return frames[-1]["kv_transfer_params"]


async def test_lease_pins_blocks_and_ack_releases():
    from dynamo_tpu_torch.engine.transfer import get_export_leases
    a = teng()
    try:
        params = await _prefill_via_handler(a, PROMPT)
        lease = params.get("lease")
        assert lease is not None
        mgr = get_export_leases(a)
        assert mgr.active == 1 and mgr.pinned_pages == 3
        for blk in params["blocks"]:
            page = a.allocator._by_hash[blk[0]]
            assert a.allocator._info[page].refcount >= 1
            assert blk[0] not in a.allocator._lru
        handler = serve_kv_export(a)
        out = [f async for f in handler({"ack_lease": lease}, None)]
        assert out == [{"acked": True}]
        assert mgr.active == 0 and mgr.pinned_pages == 0
        assert mgr.reclaimed_total == 0
        for blk in params["blocks"]:
            page = a.allocator._by_hash[blk[0]]
            assert a.allocator._info[page].refcount == 0
            assert blk[0] in a.allocator._lru
        out = [f async for f in handler({"ack_lease": lease}, None)]
        assert out == [{"acked": False}]
    finally:
        await a.stop()


async def test_unacked_lease_reclaimed_within_ttl(monkeypatch):
    from dynamo_tpu_torch.engine.transfer import get_export_leases
    monkeypatch.setenv("DYN_KV_EXPORT_TTL_S", "0.4")
    a = teng()
    try:
        params = await _prefill_via_handler(a, PROMPT)
        assert params.get("lease") is not None
        mgr = get_export_leases(a)
        assert mgr.active == 1
        for _ in range(100):
            if mgr.active == 0:
                break
            await asyncio.sleep(0.05)
        assert mgr.active == 0 and mgr.reclaimed_total == 1
        for blk in params["blocks"]:
            page = a.allocator._by_hash[blk[0]]
            assert a.allocator._info[page].refcount == 0
    finally:
        await a.stop()


async def test_pin_cap_refuses_not_breaks():
    from dynamo_tpu_torch.engine.transfer import get_export_leases
    a = teng()
    try:
        mgr = get_export_leases(a)
        mgr.max_pinned_pages = 1
        params = await _prefill_via_handler(a, PROMPT)
        assert params.get("lease") is not None
        assert mgr.pinned_pages == 1  # 3 blocks advertised, 1 pinned
        params2 = await _prefill_via_handler(a, list(range(2, 15)))
        assert params2.get("lease") is None
        assert params2["blocks"]  # the export is still advertised
    finally:
        await a.stop()


# -- the staged pipeline -----------------------------------------------------------


async def test_dispatch_count_regression_guard(monkeypatch):
    """6 frames of 4 blocks with a 16-block window commit in at most 2
    scatters (``page_scatter_dispatches``), where per-frame commits would
    take 6."""
    monkeypatch.setenv("DYN_KV_FRAME_BLOCKS", "4")
    a = teng(num_pages=96, max_context=256, max_prefill_chunk=128)
    b = teng(num_pages=96)
    ptr = b.pages.data_ptr()
    try:
        prompt = list(range(1, 98))  # 24 blocks
        hashes = await prefill(a, prompt)
        assert len(hashes) == 24
        wire = await a.run_exclusive(export_frames, a, hashes, "layer")
        assert len(wire) == 6
        pipe = InjectPipeline(b, window=16)
        base = b.page_scatter_dispatches
        for f in wire:
            await pipe.add_frame(received(f))
        assert await pipe.finish() == 24
        assert b.page_scatter_dispatches - base <= 2
        assert await cached_tokens(b, prompt) == 96
        np.testing.assert_array_equal(page_bytes(b, hashes),
                                      page_bytes(a, hashes))
        assert b.pages.data_ptr() == ptr
    finally:
        await a.stop()
        await b.stop()


async def test_mixed_schema_old_frames_and_blocks():
    """An old exporter's block-major v2 frame and per-block payloads both
    inject through the staged pipeline, and a layer-major frame through
    the standalone ``inject_frame`` — byte-identical each time."""
    a = teng()
    try:
        hashes = await prefill(a, PROMPT)
        want = page_bytes(a, hashes)
        b = teng()
        try:
            wire = await a.run_exclusive(export_frames, a, hashes, "block")
            assert "layout" not in wire[0].obj
            pipe = InjectPipeline(b)
            for f in wire:
                await pipe.add_frame(received(f))
            assert await pipe.finish() == 3
            assert await cached_tokens(b, PROMPT) == 12
            np.testing.assert_array_equal(page_bytes(b, hashes), want)
        finally:
            await b.stop()
        c = teng()
        try:
            payloads = [BlockPayload.from_wire(p.to_wire())
                        for p in export_blocks(a, hashes)]
            pipe = InjectPipeline(c, window=2)
            await pipe.add_blocks(payloads)
            assert await pipe.finish() == 3
            assert await cached_tokens(c, PROMPT) == 12
            np.testing.assert_array_equal(page_bytes(c, hashes), want)
        finally:
            await c.stop()
        d = teng()
        try:
            wire = await a.run_exclusive(export_frames, a, hashes, "layer")
            assert wire[0].obj["layout"] == "layer"
            assert await d.run_exclusive(inject_frame, d,
                                         received(wire[0])) == 3
            assert await cached_tokens(d, PROMPT) == 12
            np.testing.assert_array_equal(page_bytes(d, hashes), want)
        finally:
            await d.stop()
    finally:
        await a.stop()


async def test_device_direct_plane_absent_on_cpu():
    """On the CPU there are no IPC handles: the worker builds no direct
    plane (the reference's answer without its transfer API), and a plane
    refuses to open an offer made in its own process."""
    from dynamo_tpu_torch.engine.transfer import (OFFER_TTL_S,
                                                  DeviceTransferPlane)
    from dynamo_tpu_torch.worker.disagg import make_device_transfer_plane
    import time as _time
    a = teng()
    try:
        assert make_device_transfer_plane(a) is None
    finally:
        await a.stop()
    plane = DeviceTransferPlane()
    with pytest.raises(ConnectionError):
        plane.pull({"address": plane.address, "uuid": 1})
    plane._offers[1] = (_time.time() - OFFER_TTL_S - 1.0, object())
    plane._offers[2] = (_time.time(), object())
    assert plane.evict_expired_offers() == 1
    assert set(plane._offers) == {2}
    plane._offers[3] = (_time.time() - OFFER_TTL_S - 1.0, object())
    plane.ack(2)
    assert not plane._offers


# -- across frameworks -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
async def test_jax_frames_inject_into_torch(weights, dtype):
    """``JaxEngine.export_frames`` -> the port's ``InjectPipeline``: the
    port's own export of the injected blocks has the reference's meta and
    the bytes the reference sent."""
    from dynamo_tpu.engine import transfer as jtr
    from dynamo_tpu.protocols.common import (
        PreprocessedRequest as JRequest)
    src = jeng(weights if dtype == "float32" else None, dtype=dtype)
    dst = teng(weights if dtype == "float32" else None, dtype=dtype)
    ptr = dst.pages.data_ptr()
    try:
        hashes = await prefill(src, PROMPT, cls=JRequest)
        sent = jtr.stamp_frame_crcs(
            await src.run_exclusive(jtr.export_frames, src, hashes,
                                    "layer"))
        pipe = InjectPipeline(dst)
        for f in sent:
            await pipe.add_frame(received(f))
        assert await pipe.finish() == 3
        assert await cached_tokens(dst, PROMPT) == 12
        mine = stamp_frame_crcs(
            await dst.run_exclusive(export_frames, dst, hashes, "layer"))
        assert [f.obj for f in mine] == [f.obj for f in sent]
        assert [wire_bytes(f) for f in mine] == \
            [wire_bytes(f) for f in sent]
        assert dst.pages.data_ptr() == ptr
    finally:
        await src.stop()
        await dst.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
async def test_torch_frames_inject_into_jax(weights, dtype):
    """The port's frames -> the reference's ``InjectPipeline`` on
    ``JaxEngine``: same meta as the reference's own export of the
    injected blocks, and its pages hold the bytes the port sent."""
    from dynamo_tpu.engine import transfer as jtr
    src = teng(weights if dtype == "float32" else None, dtype=dtype)
    dst = jeng(weights if dtype == "float32" else None, dtype=dtype)
    try:
        hashes = await prefill(src, PROMPT)
        sent = stamp_frame_crcs(
            await src.run_exclusive(export_frames, src, hashes, "layer"))
        pipe = jtr.InjectPipeline(dst)
        for f in sent:
            await pipe.add_frame(received(f))
        assert await pipe.finish() == 3
        back = jtr.stamp_frame_crcs(
            await dst.run_exclusive(jtr.export_frames, dst, hashes,
                                    "layer"))
        assert [f.obj for f in back] == [f.obj for f in sent]
        assert [wire_bytes(f) for f in back] == \
            [wire_bytes(f) for f in sent]
        assert page_bytes(dst, hashes).tobytes() == wire_bytes(sent[0])
    finally:
        await src.stop()
        await dst.stop()


async def test_jax_mla_frames_inject_into_torch():
    """The reference's MLA engine exports its latent cache in the same
    frames; the port injects them byte for byte."""
    from dynamo_tpu.engine import transfer as jtr
    from dynamo_tpu.models.config import ModelConfig as JCfg
    from dynamo_tpu.protocols.common import (
        PreprocessedRequest as JRequest)
    d = {k: getattr(mla_cfg(), k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "model_type", "dtype",
        "q_lora_rank", "kv_lora_rank", "qk_rope_head_dim",
        "qk_nope_head_dim", "v_head_dim", "num_experts",
        "num_experts_per_tok", "moe_intermediate_size", "n_shared_experts",
        "first_k_dense_replace", "routed_scaling_factor",
        "max_position_embeddings")}
    src = JaxEngine.random_init(JCfg(**d), JaxEngineConfig(attn_impl="scan",
                                                          **SIZES))
    dst = TorchEngine.random_init(mla_cfg(), TorchEngineConfig(**SIZES),
                                  device="cpu")
    ptr = dst.pages.data_ptr()
    try:
        hashes = await prefill(src, PROMPT, cls=JRequest)
        sent = await src.run_exclusive(jtr.export_frames, src, hashes,
                                       "layer")
        assert sent[0].obj["block_shape"] == [2, 2, 1, 4, 128]
        pipe = InjectPipeline(dst)
        for f in sent:
            await pipe.add_frame(received(f))
        assert await pipe.finish() == 3
        assert page_bytes(dst, hashes).tobytes() == wire_bytes(sent[0])
        assert dst.pages.data_ptr() == ptr
    finally:
        await src.stop()
        await dst.stop()


@pytest.mark.parametrize("plane", ["rpc", "bulk"])
async def test_reference_export_handler_pulled_by_port_puller(weights,
                                                              plane):
    """The reference's own ``serve_kv_export`` (and bulk handler), served
    by the reference's runtime, pulled by the port's ``KvBlockPuller``
    over the port's runtime: the runtimes' wires interoperate and the
    pulled pages hold the reference's bytes."""
    from dynamo_tpu.engine import transfer as jtr
    from dynamo_tpu.protocols.common import (
        PreprocessedRequest as JRequest)
    from dynamo_tpu.runtime.bulk import BulkServer as JBulkServer
    from dynamo_tpu.runtime.coordinator import Coordinator as JCoordinator
    from dynamo_tpu.runtime.runtime import (
        DistributedRuntime as JRuntime)
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    from dynamo_tpu_torch.worker.disagg import (KV_EXPORT_ENDPOINT,
                                                KvBlockPuller)
    coord = await JCoordinator(port=0).start()
    src = jeng(weights)
    dst = teng(weights)
    jdrt = drt = bulk = None
    try:
        hashes = await prefill(src, PROMPT, cls=JRequest)
        sent = await src.run_exclusive(jtr.export_frames, src, hashes,
                                       "layer")
        jdrt = await JRuntime.create(coordinator=coord.address)
        ep = jdrt.namespace("ns").component("prefill").endpoint(
            KV_EXPORT_ENDPOINT)
        kw = {}
        if plane == "bulk":
            bulk = JBulkServer().start()
            bulk.register(KV_EXPORT_ENDPOINT, jtr.serve_kv_export_bulk(
                src, asyncio.get_running_loop()))
            kw["bulk_address"] = bulk.address
        await ep.serve(jtr.serve_kv_export(src), **kw)
        drt = await DistributedRuntime.create(coordinator=coord.address)
        client = await drt.namespace("ns").component("prefill").endpoint(
            KV_EXPORT_ENDPOINT).client()
        await client.wait_for_instances(1, timeout=10)
        iid = client.instance_ids()[0]
        puller = KvBlockPuller(dst, kv_client=client)
        await puller.pull_blocks(hashes, iid)
        assert puller.last_pull_stats["injected"] == 3
        if plane == "bulk":
            assert bulk.bytes_sent > 0
        assert page_bytes(dst, hashes).tobytes() == wire_bytes(sent[0])
        assert await cached_tokens(dst, PROMPT) == 12
    finally:
        if drt is not None:
            await drt.close()
        if bulk is not None:
            bulk.stop()
        if jdrt is not None:
            await jdrt.close()
        await src.stop()
        await dst.stop()
        await coord.stop()
