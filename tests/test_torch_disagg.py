"""Disaggregated prefill/decode on the port, on the CPU: the reference's
``tests/test_disagg.py`` end-to-end cases with ``TorchEngine`` workers
(``dynamo_tpu_torch/worker/disagg.py``, the port's runtime and
coordinator).

Every greedy stream served disaggregated — decode-first over the RPC and
the bulk planes, prefill-first, and through the prefill work queue under a
burst — equals both an aggregated ``TorchEngine``'s and an aggregated
``JaxEngine``'s stream on the same float32 weights, token for token, and
the decode engine demonstrably admitted the transferred prefix. A decode
worker with no prefill worker serves locally, and the local-prefill
threshold hot-reloads from the coordinator.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.engine.transfer import serve_kv_export
from dynamo_tpu_torch.llm.register import engine_handler, serve_engine
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (FinishReason,
                                               PreprocessedRequest,
                                               SamplingOptions,
                                               StopConditions)
from dynamo_tpu_torch.runtime.coordinator import Coordinator
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.worker.disagg import (KV_EXPORT_ENDPOINT,
                                            DisaggDecodeHandler,
                                            disagg_conf_key)

torch.set_num_threads(2)

SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=128, min_prefill_bucket=4)
PROMPT = list(range(1, 14))
QUEUE_PROMPTS = [list(range(1 + i, 14 + i)) for i in range(6)]


def make_req(tokens, rid, max_tokens=6, cls=PreprocessedRequest):
    return cls(token_ids=list(tokens), request_id=rid,
               stop_conditions=StopConditions(max_tokens=max_tokens),
               sampling_options=SamplingOptions(temperature=0.0))


async def collect(gen):
    return [f async for f in gen]


def tokens(frames):
    return [t for f in frames for t in f.token_ids]


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
                       TorchEngineConfig(**{**SIZES, **kw}), device="cpu")


@pytest.fixture(scope="module")
def aggregated(weights):
    """Each prompt's greedy stream from an aggregated ``JaxEngine`` and an
    aggregated ``TorchEngine`` on the same weights (which agree)."""
    async def run():
        from dynamo_tpu.protocols.common import (
            SamplingOptions as JSampling, StopConditions as JStop)
        jeng = JaxEngine(weights[0], weights[1],
                         JaxEngineConfig(attn_impl="scan", **SIZES))
        solo = teng(weights)
        out = {}
        try:
            for i, p in enumerate([PROMPT] + QUEUE_PROMPTS):
                jreq = JRequest(token_ids=list(p), request_id=f"j{i}",
                                stop_conditions=JStop(max_tokens=6),
                                sampling_options=JSampling(temperature=0.0))
                want = tokens(await collect(jeng.generate(jreq)))
                got = tokens(await collect(solo.generate(
                    make_req(p, f"t{i}"))))
                assert got == want, (p, got, want)
                out[tuple(p)] = want
        finally:
            await jeng.stop()
            await solo.stop()
        return out
    return asyncio.run(run())


class TestDisaggE2E:
    async def test_disagg_matches_aggregated(self, weights, aggregated):
        """Prefill worker + decode worker over the port's runtime: the
        greedy stream equals the aggregated ones, the decode engine
        admitted the pulled prefix and the prefill engine computed it."""
        coord = await Coordinator(port=0).start()
        drts, handler = [], None
        try:
            pre_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(pre_drt)
            pre_engine = teng(weights)
            comp = pre_drt.namespace("ns").component("prefill")
            await serve_engine(comp.endpoint("generate"), pre_engine)
            await comp.endpoint(KV_EXPORT_ENDPOINT).serve(
                serve_kv_export(pre_engine))
            dec_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(dec_drt)
            dec_engine = teng(weights)
            ptr = dec_engine.pages.data_ptr()
            handler = await DisaggDecodeHandler(
                dec_engine, dec_drt, "ns", "prefill").start()
            await handler._gen_client.wait_for_instances(1, timeout=10)
            frames = await collect(handler.generate(make_req(PROMPT, "r1")))
            assert tokens(frames) == aggregated[tuple(PROMPT)]
            assert frames[-1].completion_tokens == 6
            assert dec_engine.allocator.hits >= 3
            assert pre_engine.allocator.misses >= 3
            assert dec_engine.page_scatter_dispatches >= 1
            assert dec_engine.pages.data_ptr() == ptr
        finally:
            if handler is not None:
                await handler.stop()
            for d in drts:
                await d.close()
            await coord.stop()

    async def test_local_fallback_no_prefill_workers(self, weights):
        coord = await Coordinator(port=0).start()
        try:
            drt = await DistributedRuntime.create(coordinator=coord.address)
            engine = teng(weights)
            handler = await DisaggDecodeHandler(
                engine, drt, "ns", "prefill").start()
            frames = await collect(handler.generate(
                make_req(range(1, 10), "x")))
            assert frames[-1].finish_reason == FinishReason.LENGTH
            await handler.stop()
            await engine.stop()
            await drt.close()
        finally:
            await coord.stop()

    async def test_conf_hot_reload_local_threshold(self, weights):
        coord = await Coordinator(port=0).start()
        try:
            drt = await DistributedRuntime.create(coordinator=coord.address)
            engine = teng(weights)
            handler = await DisaggDecodeHandler(
                engine, drt, "ns", "prefill").start()
            await drt.coord.put(
                disagg_conf_key("ns"),
                json.dumps({"max_local_prefill_length": 64}).encode())
            for _ in range(50):
                if handler.conf.max_local_prefill_length == 64:
                    break
                await asyncio.sleep(0.05)
            assert handler.conf.max_local_prefill_length == 64
            assert handler._use_remote_prefill(
                make_req(range(1, 10), "short")) is False
            await handler.stop()
            await engine.stop()
            await drt.close()
        finally:
            await coord.stop()


class TestPrefillFirst:
    async def test_prefill_first_matches_aggregated(self, weights,
                                                    aggregated):
        from dynamo_tpu_torch.worker.disagg import PrefillFirstHandler
        coord = await Coordinator(port=0).start()
        drts, handlers = [], []
        try:
            dec_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(dec_drt)
            dec_engine = teng(weights)
            dec_handler = await DisaggDecodeHandler(
                dec_engine, dec_drt, "ns", "prefill", use_queue=False,
                strategy="prefill_first").start()
            handlers.append(dec_handler)
            await dec_drt.namespace("ns").component("tpu").endpoint(
                "generate").serve(engine_handler(dec_handler))
            pre_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(pre_drt)
            pre_engine = teng(weights)
            await pre_drt.namespace("ns").component("prefill").endpoint(
                KV_EXPORT_ENDPOINT).serve(serve_kv_export(pre_engine))
            pre_lease = await pre_drt.primary_lease()
            pf_handler = await PrefillFirstHandler(
                pre_engine, pre_drt, "ns", "tpu",
                instance_id=pre_lease.lease_id).start()
            handlers.append(pf_handler)
            await pf_handler._decode_client.wait_for_instances(1,
                                                               timeout=10)
            await dec_handler._kv_client.wait_for_instances(1, timeout=10)
            frames = await collect(pf_handler.generate(
                make_req(PROMPT, "r1")))
            assert tokens(frames) == aggregated[tuple(PROMPT)]
            assert frames[-1].completion_tokens == 6
            assert dec_engine.allocator.hits >= 3
            assert pre_engine.allocator.misses >= 3
        finally:
            for h in handlers:
                await h.stop()
            for d in drts:
                await d.close()
            await coord.stop()

    async def test_prefill_first_no_decode_workers_serves_local(self,
                                                                weights):
        from dynamo_tpu_torch.worker.disagg import PrefillFirstHandler
        coord = await Coordinator(port=0).start()
        try:
            drt = await DistributedRuntime.create(coordinator=coord.address)
            engine = teng(weights)
            handler = await PrefillFirstHandler(engine, drt, "ns",
                                                "tpu").start()
            frames = await collect(handler.generate(
                make_req(range(1, 10), "x")))
            assert frames[-1].finish_reason == FinishReason.LENGTH
            assert sum(len(f.token_ids) for f in frames) == 6
            await handler.stop()
            await engine.stop()
            await drt.close()
        finally:
            await coord.stop()


class TestBulkPlaneDisagg:
    async def test_disagg_over_bulk_plane(self, weights, aggregated):
        """The prefill worker advertises a bulk address; the decode side
        pulls over it (not the RPC plane)."""
        from dynamo_tpu_torch.engine.transfer import serve_kv_export_bulk
        from dynamo_tpu_torch.runtime.bulk import BulkServer
        coord = await Coordinator(port=0).start()
        drts, handler, bulk = [], None, None
        try:
            pre_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(pre_drt)
            pre_engine = teng(weights)
            comp = pre_drt.namespace("ns").component("prefill")
            await serve_engine(comp.endpoint("generate"), pre_engine)
            bulk = BulkServer().start()
            bulk.register(KV_EXPORT_ENDPOINT, serve_kv_export_bulk(
                pre_engine, asyncio.get_running_loop()))
            await comp.endpoint(KV_EXPORT_ENDPOINT).serve(
                serve_kv_export(pre_engine), bulk_address=bulk.address)
            dec_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(dec_drt)
            dec_engine = teng(weights)
            handler = await DisaggDecodeHandler(
                dec_engine, dec_drt, "ns", "prefill").start()
            await handler._gen_client.wait_for_instances(1, timeout=10)
            await handler._kv_client.wait_for_instances(1, timeout=10)
            insts = handler._kv_client.instances()
            assert insts and insts[0].bulk_address
            frames = await collect(handler.generate(make_req(PROMPT, "r1")))
            assert tokens(frames) == aggregated[tuple(PROMPT)]
            assert dec_engine.allocator.hits >= 3
            assert bulk.bytes_sent > 0
        finally:
            if handler is not None:
                await handler.stop()
            if bulk is not None:
                bulk.stop()
            for d in drts:
                await d.close()
            await coord.stop()


class TestPrefillQueue:
    async def test_burst_drains_across_two_prefill_workers(self, weights,
                                                           aggregated):
        """Prefill jobs ride the coordinator work queue: under a burst
        both prefill workers take jobs, the queue drains to zero, and
        every stream equals the aggregated ones."""
        from dynamo_tpu_torch.worker.disagg import (PrefillQueueWorker,
                                                    prefill_queue_name)
        coord = await Coordinator(port=0).start()
        drts, handler, queue_workers = [], None, []
        try:
            for _w in range(2):
                drt = await DistributedRuntime.create(
                    coordinator=coord.address)
                drts.append(drt)
                eng = teng(weights)
                comp = drt.namespace("ns").component("prefill")
                await serve_engine(comp.endpoint("generate"), eng)
                await comp.endpoint(KV_EXPORT_ENDPOINT).serve(
                    serve_kv_export(eng))
                lease = await drt.primary_lease()
                queue_workers.append(await PrefillQueueWorker(
                    eng, drt, "ns", instance_id=lease.lease_id,
                    concurrency=1).start())
            dec_drt = await DistributedRuntime.create(
                coordinator=coord.address)
            drts.append(dec_drt)
            dec_engine = teng(weights, num_pages=128)
            handler = await DisaggDecodeHandler(
                dec_engine, dec_drt, "ns", "prefill").start()
            await handler._gen_client.wait_for_instances(2, timeout=10)
            results = await asyncio.gather(*[
                collect(handler.generate(make_req(p, f"r{i}")))
                for i, p in enumerate(QUEUE_PROMPTS)])
            assert [tokens(f) for f in results] == \
                [aggregated[tuple(p)] for p in QUEUE_PROMPTS]
            done = [qw.jobs_done for qw in queue_workers]
            assert sum(done) == 6
            assert all(d > 0 for d in done), done
            depth, pullers = await dec_drt.coord.queue_depth(
                prefill_queue_name("ns"))
            assert depth == 0 and pullers == 2
        finally:
            for qw in queue_workers:
                await qw.stop()
            if handler is not None:
                await handler.stop()
            for d in drts:
                await d.close()
            await coord.stop()


def test_worker_scratch_paths_follow_tmpdir(tmp_path, monkeypatch):
    """The prefill worker's bulk socket and the default KVBM directory lie
    under ``TMPDIR`` and carry the process id, so two checkouts (or two
    workers with the same lease id) never share one; a socket path past
    the 107 bytes a unix address holds leaves the bulk plane on TCP."""
    import os
    import tempfile

    from dynamo_tpu_torch.kvbm.manager import TieredKvConfig
    from dynamo_tpu_torch.worker.main import build_parser, bulk_unix_path
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    pid = os.getpid()
    assert bulk_unix_path(1) == str(tmp_path / f"dynamo_tpu_bulk_{pid}_1.sock")
    assert TieredKvConfig().disk_path == str(tmp_path
                                             / f"dynamo_tpu_kvbm_{pid}")
    assert build_parser().parse_args(
        ["--model-path", "m"]).disk_cache_path is None
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / ("d" * 100)))
    assert bulk_unix_path(1) is None
