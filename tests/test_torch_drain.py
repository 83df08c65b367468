"""Graceful drain and live decode migration on the port
(``dynamo_tpu_torch/worker/drain.py``), on the CPU: the reference's
``tests/test_drain.py`` lifecycle cases with ``TorchEngine`` workers.

- Clean drain: two workers behind the migration operator; the busy one is
  drained mid-stream. Every stream finishes at full length (zero lost),
  the drained worker hands its streams off as resumes, the survivor admits
  each resumed stream with its whole prompt cached (no recomputed
  prefill, by its prefix-hit counters), every export lease is acked, and
  every stream — greedy and seeded — equals an undrained ``TorchEngine``'s
  and ``JaxEngine``'s, token for token.
- ``kill -9`` mid-drain: the worker dies after freezing, before any pull;
  the survivor's resume pulls fail and it recomputes — every stream still
  completes, equal to the undrained run, and no lease leaks.
- A reused ``request_id`` on one engine is refused with a clear error and
  leaves the first stream unharmed.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.engine.transfer import (get_export_leases,
                                              serve_kv_export)
from dynamo_tpu_torch.llm.pipeline import RemotePipeline
from dynamo_tpu_torch.llm.register import register_llm, serve_engine
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (FinishReason,
                                               PreprocessedRequest,
                                               SamplingOptions,
                                               StopConditions)
from dynamo_tpu_torch.runtime.coordinator import Coordinator
from dynamo_tpu_torch.runtime.push_router import PushRouter
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.utils.testing import make_test_card
from dynamo_tpu_torch.worker.disagg import KV_EXPORT_ENDPOINT
from dynamo_tpu_torch.worker.drain import DrainController, ResumeAdmission
from dynamo_tpu_torch.worker.metrics import get_worker_metrics

torch.set_num_threads(2)

SIZES = dict(num_pages=128, page_size=4, max_num_seqs=8, max_prefill_chunk=64,
             max_context=512, min_prefill_bucket=4, decode_multistep=1)


def make_req(tokens, rid, max_tokens=20, seed=None, temperature=0.0,
             cls=PreprocessedRequest, so=SamplingOptions, sc=StopConditions):
    return cls(token_ids=list(tokens), request_id=rid,
               stop_conditions=sc(max_tokens=max_tokens, ignore_eos=True),
               sampling_options=so(temperature=temperature, seed=seed))


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     params)
    return jcfg, params, np_tree


def teng(weights) -> TorchEngine:
    cfg = ModelConfig.tiny()
    return TorchEngine(cfg, tllama.params_from_jax(weights[2], cfg,
                                                   device="cpu"),
                       TorchEngineConfig(**SIZES), device="cpu")


def _pace(engine, seconds: float) -> None:
    """Slow every step so a drain lands mid-stream deterministically."""
    for name in ("_execute_plan", "_dispatch_step"):
        orig = getattr(engine, name)

        def paced(*a, _orig=orig):
            time.sleep(seconds)
            return _orig(*a)

        setattr(engine, name, paced)


class _Worker:
    """One in-process worker with ``worker/main.py``'s drain wiring:
    kv_export served, ``ResumeAdmission`` on the generate handler, and the
    production ``DrainController``."""

    def __init__(self, drt, engine, served, lease_id):
        self.drt = drt
        self.engine = engine
        self.controller = DrainController(
            engine, served=served, resume_extras={"instance_id": lease_id})
        self.dead = False

    @classmethod
    async def start(cls, coordinator, weights, name="m", component="w",
                    pace=0.02):
        drt = await DistributedRuntime.create(coordinator=coordinator)
        engine = teng(weights)
        _pace(engine, pace)
        comp = drt.namespace("ns").component(component)
        await comp.endpoint(KV_EXPORT_ENDPOINT).serve(
            serve_kv_export(engine))
        ra = ResumeAdmission(
            engine,
            kv_client=await comp.endpoint(KV_EXPORT_ENDPOINT).client())
        served = await serve_engine(comp.endpoint("generate"), engine,
                                    resume_admission=ra)
        await register_llm(drt, comp.endpoint("generate"),
                           make_test_card(name=name, kv_cache_block_size=4))
        lease = await drt.primary_lease()
        return cls(drt, engine, [served], lease.lease_id)

    async def sigterm(self) -> dict:
        counts = await self.controller.drain("test")
        await self.close()
        return counts

    async def kill9_mid_drain(self) -> dict:
        await self.controller.announce()
        counts = await self.controller.freeze()
        await self.close()
        return counts

    async def close(self) -> None:
        if self.dead:
            return
        self.dead = True
        try:
            await self.drt.close()
        finally:
            await self.engine.stop()


async def _undrained(weights, reqs):
    """Each request served alone on a fresh ``TorchEngine`` and a fresh
    ``JaxEngine`` (same weights); the two must agree."""
    from dynamo_tpu.protocols.common import (
        PreprocessedRequest as JRequest, SamplingOptions as JSampling,
        StopConditions as JStop)
    solo = teng(weights)
    jeng = JaxEngine(weights[0], weights[1], JaxEngineConfig(
        attn_impl="scan", **SIZES))
    try:
        out = []
        for req in reqs:
            so = req.sampling_options
            r = make_req(req.token_ids, f"{req.request_id}-solo",
                         req.stop_conditions.max_tokens, so.seed,
                         so.temperature)
            jr = make_req(req.token_ids, f"{req.request_id}-jax",
                          req.stop_conditions.max_tokens, so.seed,
                          so.temperature, JRequest, JSampling, JStop)
            got = [t async for f in solo.generate(r) for t in f.token_ids]
            want = [t async for f in jeng.generate(jr) for t in f.token_ids]
            assert got == want, req.request_id
            out.append(got)
        return out
    finally:
        await solo.stop()
        await jeng.stop()


async def _drive(pipeline, req, started: asyncio.Event, after=2):
    frames = []
    async for out in pipeline.engine_stream(req):
        frames.append(out)
        if sum(len(f.token_ids) for f in frames) >= after:
            started.set()
    started.set()
    return frames


async def _pair(coord, weights):
    w1 = await _Worker.start(coord.address, weights)
    w2 = await _Worker.start(coord.address, weights)
    fe = await DistributedRuntime.create(coordinator=coord.address)
    client = await (fe.namespace("ns").component("w")
                    .endpoint("generate").client())
    await client.wait_for_instances(2, timeout=10)
    card = make_test_card(name="m", kv_cache_block_size=4)
    return w1, w2, fe, RemotePipeline(card, PushRouter(client),
                                      migration_limit=3)


class TestCleanDrain:
    async def test_zero_lost_streams_bit_identical_no_recomputed_prefill(
            self, weights, monkeypatch):
        monkeypatch.setenv("DYN_DRAIN_TIMEOUT_S", "10")
        wm = get_worker_metrics()
        resumes0 = wm.migration_replays.labels("resume")._value.get()
        migrated0 = wm.migrated_sequences.labels("ok")._value.get()
        coord = await Coordinator(port=0).start()
        workers, fe = [], None
        try:
            w1, w2, fe, pipeline = await _pair(coord, weights)
            workers = [w1, w2]
            reqs = [make_req(range(1 + i, 14 + i), f"r{i}", max_tokens=16)
                    for i in range(3)]
            reqs.append(make_req(range(5, 18), "r-seed", max_tokens=16,
                                 seed=1234, temperature=0.8))
            events = [asyncio.Event() for _ in reqs]
            tasks = [asyncio.ensure_future(_drive(pipeline, r, ev))
                     for r, ev in zip(reqs, events)]
            await asyncio.gather(*[asyncio.wait_for(ev.wait(), 30)
                                   for ev in events])
            busy = w1 if w1.engine.scheduler.active else w2
            survivor = w2 if busy is w1 else w1
            assert busy.engine.scheduler.active
            hits0 = survivor.engine.allocator.hits
            counts = await busy.sigterm()
            all_frames = await asyncio.gather(*tasks)
            for req, frames in zip(reqs, all_frames):
                toks = [t for f in frames for t in f.token_ids]
                assert len(toks) == 16, (req.request_id, len(toks))
                assert frames[-1].finish_reason == FinishReason.LENGTH
            assert counts["resume"] >= 1
            assert wm.migrated_sequences.labels("ok")._value.get() \
                >= migrated0 + counts["resume"]
            assert wm.migration_replays.labels("resume")._value.get() \
                >= resumes0 + 1
            assert get_export_leases(busy.engine).active_kind("export") == 0
            # no recomputed prefill: each resumed stream was admitted with
            # its whole prompt cached, and the survivor's prefix hits grew
            resumed = [fr[-1] for r, fr in zip(reqs, all_frames)
                       if (fr[-1].cached_tokens or 0) >= len(r.token_ids)]
            assert len(resumed) >= counts["resume"]
            assert survivor.engine.allocator.hits - hits0 >= \
                3 * counts["resume"]
            solo = await _undrained(weights, reqs)
            for req, frames, ref in zip(reqs, all_frames, solo):
                assert [t for f in frames for t in f.token_ids] == ref, \
                    req.request_id
        finally:
            for w in workers:
                try:
                    await w.close()
                except Exception:
                    pass
            if fe is not None:
                await fe.close()
            await coord.stop()


@pytest.mark.chaos
class TestKill9MidDrain:
    async def test_survivors_fall_back_to_replay_no_lost_streams(self,
                                                                 weights):
        coord = await Coordinator(port=0).start()
        workers, fe = [], None
        try:
            w1, w2, fe, pipeline = await _pair(coord, weights)
            workers = [w1, w2]
            reqs = [make_req(range(1 + i, 12 + i), f"k{i}", max_tokens=14)
                    for i in range(2)]
            events = [asyncio.Event() for _ in reqs]
            tasks = [asyncio.ensure_future(_drive(pipeline, r, ev))
                     for r, ev in zip(reqs, events)]
            await asyncio.gather(*[asyncio.wait_for(ev.wait(), 30)
                                   for ev in events])
            busy = w1 if w1.engine.scheduler.active else w2
            survivor = w2 if busy is w1 else w1
            counts = await busy.kill9_mid_drain()
            assert counts["resume"] >= 1
            all_frames = await asyncio.gather(*tasks)
            for req, frames in zip(reqs, all_frames):
                assert len([t for f in frames for t in f.token_ids]) == 14
            solo = await _undrained(weights, reqs)
            for req, frames, ref in zip(reqs, all_frames, solo):
                assert [t for f in frames for t in f.token_ids] == ref, \
                    req.request_id
            smgr = getattr(survivor.engine, "_export_leases", None)
            assert smgr is None or smgr.active == 0
        finally:
            for w in workers:
                try:
                    await w.close()
                except Exception:
                    pass
            if fe is not None:
                await fe.close()
            await coord.stop()


class TestDuplicateRequestId:
    async def test_duplicate_rid_refused_with_clear_error(self, weights):
        engine = teng(weights)
        _pace(engine, 0.02)
        try:
            first_frames = []

            async def consume():
                async for f in engine.generate(
                        make_req(range(1, 8), "dup", max_tokens=30)):
                    first_frames.append(f)

            t1 = asyncio.ensure_future(consume())
            for _ in range(200):
                if first_frames:
                    break
                await asyncio.sleep(0.02)
            assert first_frames, "first stream never started"
            dup = [f async for f in engine.generate(
                make_req(range(1, 8), "dup", max_tokens=30))]
            assert dup[-1].finish_reason == FinishReason.ERROR
            assert "duplicate request_id" in dup[-1].error
            await t1
            assert sum(len(f.token_ids) for f in first_frames) == 30
        finally:
            await engine.stop()
