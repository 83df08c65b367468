"""The KVBM tiers on the port (``dynamo_tpu_torch/kvbm/``), on the CPU: the
reference's ``tests/test_kvbm.py`` cases with ``TieredEngine`` over
``TorchEngine``.

- The tiers: host LRU budget, disk round trip, budget and crc; a bfloat16
  block keeps its dtype name and bits through the disk tier; a block file
  written by the reference's ``DiskTier`` is read by the port's and the
  other way round, byte for byte.
- Offload on eviction and onboard on admission: a prompt whose blocks
  fell out of a page pool smaller than the working set (into host, and
  through a one-block host tier onto disk) serves the tokens of a hot
  cache, which equal ``JaxEngine``'s on the same weights; the cache's
  address never changes.
- The prefetch scheduler: a long prefix promotes ahead of the prefill
  cursor and matches the hot run; promoted windows stay pinned under
  eviction pressure until the request closes.
- G4: a cold worker onboards a prompt from a peer's tiers over the peer's
  ``kv_export`` endpoint.
"""

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.engine.transfer import BlockPayload, get_export_leases
from dynamo_tpu_torch.kvbm import (DiskTier, HostTier, TieredEngine,
                                   TieredKvConfig)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                               SamplingOptions,
                                               StopConditions)
from dynamo_tpu_torch.tokens import compute_block_hash_for_seq

torch.set_num_threads(2)

SMALL = dict(num_pages=10, page_size=4, max_num_seqs=2, max_prefill_chunk=8,
             max_context=32, min_prefill_bucket=4)
PROMPT = list(range(1, 14))
PRESSURE = list(range(101, 114))


def make_req(tokens, rid, max_tokens=4):
    return PreprocessedRequest(
        token_ids=list(tokens), request_id=rid,
        stop_conditions=StopConditions(max_tokens=max_tokens),
        sampling_options=SamplingOptions(temperature=0.0))


def payload(h, nbytes=64, parent=None):
    return BlockPayload(block_hash=h, local_hash=h, parent_hash=parent,
                        data=np.zeros(nbytes, np.uint8))


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     params)
    return jcfg, params, np_tree


def teng(weights, **kw) -> TorchEngine:
    cfg = ModelConfig.tiny()
    return TorchEngine(cfg, tllama.params_from_jax(weights[2], cfg,
                                                   device="cpu"),
                       TorchEngineConfig(**{**SMALL, **kw}), device="cpu")


def tiered(weights, disk_path=None, host_bytes=1 << 20, disk_bytes=0,
           **kw):
    eng = teng(weights, **kw)
    return TieredEngine(eng, TieredKvConfig(
        host_budget_bytes=host_bytes, disk_budget_bytes=disk_bytes,
        disk_path=disk_path or "/nonexistent")), eng


async def collect(engine, req):
    return [f async for f in engine.generate(req)]


def toks(frames):
    return [t for f in frames for t in f.token_ids]


async def hot_tokens(weights, prompt, max_tokens=4, **kw):
    """The prompt served twice on a hot ``TorchEngine`` (second serve),
    equal to ``JaxEngine``'s stream on the same weights."""
    from dynamo_tpu.protocols.common import (
        PreprocessedRequest as JRequest, SamplingOptions as JSampling,
        StopConditions as JStop)
    hot = teng(weights, num_pages=64, **kw)
    jeng = JaxEngine(weights[0], weights[1], JaxEngineConfig(
        attn_impl="scan", **{**SMALL, "num_pages": 64, **kw}))
    try:
        await collect(hot, make_req(prompt, "w", max_tokens))
        want = toks(await collect(hot, make_req(prompt, "hot", max_tokens)))
        jr = JRequest(token_ids=list(prompt), request_id="j",
                      stop_conditions=JStop(max_tokens=max_tokens),
                      sampling_options=JSampling(temperature=0.0))
        assert toks(await collect(jeng, jr)) == want
        return want
    finally:
        await hot.stop()
        await jeng.stop()


class TestTiers:
    def test_host_lru_budget(self):
        t = HostTier(budget_bytes=128)
        assert t.put(payload(1)) == []
        assert t.put(payload(2)) == []
        assert [b.block_hash for b in t.put(payload(3))] == [1]
        assert 1 not in t and 2 in t and 3 in t

    def test_disk_roundtrip_budget_and_crc(self, tmp_path):
        d = DiskTier(str(tmp_path), budget_bytes=128)
        d.put(payload(1))
        d.put(payload(2))
        d.put(payload(3))  # evicts 1
        assert 1 not in d and d.get(1) is None
        assert d.get(2).data.nbytes == 64
        with open(d._file(2), "r+b") as f:
            f.seek(17)
            b = f.read(1)
            f.seek(17)
            f.write(bytes([b[0] ^ 0xFF]))
        assert d.get(2) is None and d.corrupt_dropped == 1

    def test_bf16_block_keeps_dtype_through_disk(self, tmp_path):
        bits = np.arange(2 * 2 * 2 * 4 * 16, dtype=np.uint16).reshape(
            2, 2, 2, 4, 16)
        d = DiskTier(str(tmp_path), budget_bytes=1 << 20)
        d.put(BlockPayload(7, 7, None, bits, dtype="bfloat16"))
        blk = d.get(7)
        assert blk.dtype == "bfloat16" and blk.data.dtype == np.uint16
        np.testing.assert_array_equal(blk.data, bits)
        assert blk.to_wire()["dtype"] == "bfloat16"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disk_files_cross_frameworks(tmp_path, dtype):
    """A block file written by the reference's ``DiskTier`` is read by the
    port's (handed the reference's index entry), and the other way round:
    the files are the block's raw bytes in both."""
    import ml_dtypes
    from dynamo_tpu.engine.transfer import BlockPayload as JPayload
    from dynamo_tpu.kvbm.tiers import DiskTier as JDiskTier
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((2, 2, 2, 4, 16)).astype(np.float32)
    ref_arr = vals.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" \
        else vals
    bits = ref_arr.view(np.uint16) if dtype == "bfloat16" else ref_arr

    jd = JDiskTier(str(tmp_path / "ref"), budget_bytes=1 << 20)
    jd.put(JPayload(11, 11, None, ref_arr))
    pd = DiskTier(str(tmp_path / "ref"), budget_bytes=1 << 20)
    pd._index[11] = jd._index[11]
    pd.used = jd.used
    blk = pd.get(11)
    assert blk.dtype == dtype
    assert blk.data.tobytes() == ref_arr.tobytes()

    pd2 = DiskTier(str(tmp_path / "port"), budget_bytes=1 << 20)
    pd2.put(BlockPayload(12, 12, 11, bits, dtype=dtype))
    jd2 = JDiskTier(str(tmp_path / "port"), budget_bytes=1 << 20)
    jd2._index[12] = pd2._index[12]
    jd2.used = pd2.used
    jblk = jd2.get(12)
    assert str(jblk.data.dtype) == dtype
    assert jblk.data.tobytes() == ref_arr.tobytes()


class TestTieredEngine:
    async def test_onboarded_tokens_match_hot_cache(self, weights):
        """Fill a 9-page pool, evict the prompt's blocks into the host
        tier, serve it again: the blocks onboard (a prefix hit) and the
        tokens equal a hot cache's."""
        want = await hot_tokens(weights, PROMPT)
        t, eng = tiered(weights)
        ptr = eng.pages.data_ptr()
        try:
            await collect(t, make_req(PROMPT, "a"))
            await collect(t, make_req(PRESSURE, "b", max_tokens=20))
            t.flush_spills()
            assert t.offloaded >= 3
            hashes = compute_block_hash_for_seq(PROMPT, 4)
            assert any(h not in eng.allocator._by_hash for h in hashes)
            assert any(h in t.host for h in hashes)
            frames = await collect(t, make_req(PROMPT, "a2"))
            assert t.onboarded >= 1 and frames[-1].cached_tokens > 0
            assert toks(frames) == want
            assert eng.pages.data_ptr() == ptr
        finally:
            await t.stop()

    async def test_stop_ends_the_spill_thread_and_frees_the_engine(
            self, weights):
        """After blocks spilled, ``stop()`` lands the pending batches and
        ends the spill thread (its frame held the tiered engine): a weak
        reference to the engine's cache dies once the engine is dropped."""
        import gc
        import weakref
        t, eng = tiered(weights)
        try:
            await collect(t, make_req(PROMPT, "a"))
            await collect(t, make_req(PRESSURE, "b", max_tokens=20))
        finally:
            await t.stop()
        assert t.offloaded >= 3 and not t._spill_thread.is_alive()
        cache = weakref.ref(eng.pages)
        del t, eng
        gc.collect()
        assert cache() is None

    async def test_disk_spill_then_onboard(self, weights, tmp_path):
        """A one-block host tier demotes to disk; the prompt onboards back
        from host and disk with the hot cache's tokens."""
        want = await hot_tokens(weights, PROMPT)
        cfg = ModelConfig.tiny()
        block_bytes = cfg.num_layers * 2 * cfg.num_kv_heads * 4 \
            * cfg.head_dim * 4
        t, eng = tiered(weights, disk_path=str(tmp_path),
                        host_bytes=block_bytes, disk_bytes=1 << 20)
        ptr = eng.pages.data_ptr()
        try:
            await collect(t, make_req(PROMPT, "a"))
            await collect(t, make_req(PRESSURE, "b", max_tokens=20))
            t.flush_spills()
            assert t.offloaded >= 3
            assert len(t.host) == 1 and len(t.disk) >= 1
            frames = await collect(t, make_req(PROMPT, "a2"))
            assert toks(frames) == want
            assert t.onboarded >= 1
            assert eng.pages.data_ptr() == ptr
            s = t.kvbm_stats()
            assert s["kvbm_offloaded_blocks"] >= 3
            assert s["kvbm_pending_spills"] == 0
            # the spill thread's copies, in bytes and seconds
            assert s["kvbm_offload_bytes"] == \
                s["kvbm_offloaded_blocks"] * block_bytes
            assert s["kvbm_offload_seconds"] > 0
        finally:
            await t.stop()


def seed_chain(t, tokens, host_blocks=None):
    """The content-addressed chain of ``tokens`` put straight into the
    tiers (zeros of the cache's block geometry)."""
    eng = t.engine
    shape = (eng.pages.shape[0],) + tuple(eng.pages.shape[-4:])
    hashes = compute_block_hash_for_seq(tokens, eng.allocator.page_size)
    parent = None
    for i, h in enumerate(hashes):
        blk = BlockPayload(block_hash=h, local_hash=h, parent_hash=parent,
                           data=np.zeros(shape, np.float32))
        if host_blocks is None or i < host_blocks:
            t.host.put(blk)
        else:
            t.disk.put(blk)
        parent = h
    return hashes


class TestPrefetchScheduler:
    async def test_long_prefix_matches_hot(self, weights):
        prompt = list(range(1, 102))  # 25 full blocks
        want = await hot_tokens(weights, prompt, max_context=256)
        t, eng = tiered(weights, num_pages=40, max_context=256)
        assert t.prefetch is not None
        ptr = eng.pages.data_ptr()
        try:
            await collect(t, make_req(prompt, "a"))
            await collect(t, make_req(list(range(1001, 1102)), "b",
                                      max_tokens=20))
            t.flush_spills()
            assert any(h in t.host
                       for h in compute_block_hash_for_seq(prompt, 4))
            frames = await collect(t, make_req(prompt, "a2"))
            assert toks(frames) == want
            assert t.onboarded >= 2
            assert get_export_leases(eng).pinned_pages_kind("prefetch") == 0
            assert t.prefetch.evicted_pinned == 0
            assert eng.pages.data_ptr() == ptr
        finally:
            await t.stop()

    async def test_admit_promotes_pins_and_survives_pressure(self, weights):
        t, eng = tiered(weights, num_pages=32, max_context=256)
        try:
            prompt = list(range(1, 50))  # 12 blocks
            hashes = seed_chain(t, prompt)
            handle = await t.prefetch.admit(make_req(prompt, "pf"))
            assert handle is not None
            await handle.wait()
            resident = eng.allocator._by_hash
            plan = hashes[2:12]  # beyond the first-chunk fast path
            assert all(h in resident for h in plan)
            mgr = get_export_leases(eng)
            assert mgr.pinned_pages_kind("prefetch") == len(plan)
            assert t.prefetch.hits == len(plan)
            pressure = eng.allocator.allocate(eng.allocator.num_free)
            assert all(h in resident for h in plan)
            await handle.close()
            assert mgr.pinned_pages_kind("prefetch") == 0
            evict = eng.allocator.allocate(eng.allocator.num_free)
            assert any(h not in resident for h in plan)
            eng.allocator.release(pressure + evict)
        finally:
            await t.stop()


class TestG4PeerTier:
    async def test_tier_miss_fetches_from_peer_worker(self, weights):
        from dynamo_tpu_torch.kvbm.manager import serve_tiered_kv_export
        from dynamo_tpu_torch.runtime.coordinator import Coordinator
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
        from dynamo_tpu_torch.worker.disagg import KV_EXPORT_ENDPOINT
        want = await hot_tokens(weights, PROMPT)
        coord = await Coordinator(port=0).start()
        drts, a_t, b_t = [], None, None
        try:
            a_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(a_drt)
            a_t, _ = tiered(weights, num_pages=32)
            await collect(a_t, make_req(PROMPT, "warm"))
            await a_drt.namespace("ns").component("tpu").endpoint(
                KV_EXPORT_ENDPOINT).serve(serve_tiered_kv_export(a_t))
            b_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(b_drt)
            b_t, b_eng = tiered(weights, num_pages=32)
            ptr = b_eng.pages.data_ptr()
            ep_b = b_drt.namespace("ns").component("tpu").endpoint(
                KV_EXPORT_ENDPOINT)
            await ep_b.serve(serve_tiered_kv_export(b_t))
            b_lease = await b_drt.primary_lease()
            client = await ep_b.client()
            await client.wait_for_instances(2, timeout=10)
            b_t.enable_peer_fetch(client, self_instance_id=b_lease.lease_id)
            frames = await collect(b_t, make_req(PROMPT, "cold"))
            assert toks(frames) == want
            assert b_t.peer_onboarded >= 3
            assert frames[-1].cached_tokens == 12
            assert b_t.onboard_recompute_blocks == 0
            assert b_eng.pages.data_ptr() == ptr
            await client.close()
        finally:
            for d in drts:
                await d.close()
            await coord.stop()
            for x in (a_t, b_t):
                if x is not None:
                    await x.stop()
