"""``TorchEngine``'s pipelined and fused decode against its own per-step
decode, and the fused path on DeepSeek against ``JaxEngine``'s, on the CPU.

- Fused vs per-step, inside the port: the same workload through the
  default engine (fused blocks, pipelined) and through
  ``pipeline_decode=False`` (one step, one fetch) gives the same tokens and
  logprobs bit for bit, and writes the same KV bytes: each request's cache
  rows, read logically through its page table when it finishes. (The
  prompts prefill in one step: a prompt set split over steps differently
  runs other step shapes, which round differently.)
- Pipelined vs unpipelined: with fusion off (``decode_multistep=1``), the
  chained per-step path gives the unpipelined tokens, and the same chained
  and dispatch counts as ``JaxEngine``'s pipelined path.
- Cancellation mid-block reclaims the row's pages, and the next dispatch
  drops it from the composition-keyed caches.
- ``TorchEngineConfig``'s defaults are ``JaxEngineConfig``'s.
- DeepSeek (MLA + MoE): the fused blocks stream ``JaxEngine``'s fused
  tokens, greedy and seeded, with equal counters.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import jax_engine as jeng_mod
from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu_torch.engine.torch_engine import (DECODE_MULTISTEP,
                                                  TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from tests.test_torch_deepseek import _both as deepseek_weights
from tests.test_torch_multistep import (JAX, PORT, SIZES, _serve,
                                        _weights, assert_same, counters,
                                        engines, req, staggered)

torch.set_num_threads(2)


def port_engine(**kw) -> TorchEngine:
    _params, np_tree = _weights()
    cfg = ModelConfig.tiny()
    return TorchEngine(cfg, tllama.params_from_jax(np_tree, cfg,
                                                   device="cpu"),
                       TorchEngineConfig(**SIZES, **kw), device="cpu")


def record_kv(eng) -> dict:
    """Wrap the scheduler's ``finish`` to keep each request's KV rows of
    its computed positions, read through its page table before its pages
    are released: ``{rid: [L, 2, Hkv, n, Dh]}``."""
    kept = {}
    finish = eng.scheduler.finish
    ps = eng.cfg.page_size

    def keep(seq, *a, **kw):
        n = seq.num_computed
        ids = torch.tensor(seq.page_ids[:-(-n // ps)], dtype=torch.long)
        rows = eng.pages[:, ids]                   # [L, np, 2, Hkv, ps, D]
        L, npg, two, H, _ps, D = rows.shape
        rows = rows.permute(0, 2, 3, 1, 4, 5).reshape(L, two, H, npg * ps, D)
        kept[seq.request.request_id] = rows[..., :n, :].clone()
        return finish(seq, *a, **kw)

    eng.scheduler.finish = keep
    return kept


def mixed_rows(c):
    """Greedy, seeded and penalized rows of staggered lengths whose prompts
    (16 tokens) prefill in one step, so both paths run the same decode
    shapes after it."""
    return [req(c, "m0", [1, 2, 3, 4, 5], 5),
            req(c, "m1", [2, 3, 4, 5, 6], 11),
            req(c, "s", [9, 8, 7], 13, samp=dict(temperature=1.0, seed=5)),
            req(c, "p", [4, 4, 4], 10,
                samp=dict(temperature=0.0, frequency_penalty=0.7,
                          logit_bias={3: 2.0}))]


def test_fused_equals_per_step_bit_for_bit():
    runs = {}
    for name, kw in (("fused", {}), ("per_step",
                                     dict(pipeline_decode=False))):
        eng = port_engine(**kw)
        kv = record_kv(eng)
        out = asyncio.run(_serve(eng, mixed_rows(PORT)))
        runs[name] = (out, kv, counters(eng))
    (fo, fkv, fc), (so, skv, sc) = runs["fused"], runs["per_step"]
    assert fc["multistep_blocks"] > 0 and sc["multistep_blocks"] == 0
    assert sc["chained_steps"] == 0
    for (ft, fl, ff), (st, sl, sf) in zip(fo, so):
        assert (ft, ff) == (st, sf)
        assert np.array_equal(np.array(fl, np.float32),
                              np.array(sl, np.float32))
    assert fkv.keys() == skv.keys() == {"m0", "m1", "s", "p"}
    for rid in fkv:
        assert fkv[rid].shape == skv[rid].shape, rid
        assert torch.equal(fkv[rid], skv[rid]), rid


def test_pipelined_equals_unpipelined_and_chains_as_the_reference():
    build = staggered(samp=dict(temperature=1.0, seed=77))
    jeng, teng = engines(decode_multistep=1)
    ref = asyncio.run(_serve(jeng, build(JAX)))
    got = asyncio.run(_serve(teng, build(PORT)))
    cref, cgot = counters(jeng), counters(teng)
    assert cgot["chained_steps"] > 0 and cgot["multistep_blocks"] == 0
    assert cgot == cref
    for (rt, rl, rf), (gt, gl, gf) in zip(ref, got):
        assert (gt, gf) == (rt, rf)
    flat = port_engine(decode_multistep=1, pipeline_decode=False)
    base = asyncio.run(_serve(flat, build(PORT)))
    assert flat.chained_steps == 0
    assert [(t, f) for t, _l, f in base] == [(t, f) for t, _l, f in got]


class _Ctx:
    cancelled = False


@pytest.mark.parametrize("samp", [dict(temperature=0.0),
                                  dict(temperature=0.0,
                                       frequency_penalty=0.9)],
                         ids=["plain", "penalized"])
async def test_cancel_mid_block_reclaims_pages(samp):
    eng = port_engine()
    free0 = eng.allocator.num_free
    try:
        ctx = _Ctx()
        frames = []
        async for out in eng.generate(req(PORT, "cx", [1, 2, 3], 1000,
                                          samp=samp), ctx=ctx):
            frames.append(out)
            ctx.cancelled = True          # cancel after the first frame
        assert frames[-1].finish_reason.value == "cancelled"
        for _ in range(100):
            if eng.allocator.num_free == free0:
                break
            await asyncio.sleep(0.02)
        assert eng.allocator.num_free == free0
        # the engine still serves, and its next dispatch dropped the
        # cancelled row from the composition cache
        toks = []
        async for out in eng.generate(req(PORT, "after", [4, 5, 6], 6,
                                          samp=samp)):
            toks += out.token_ids
        assert len(toks) == 6
        assert eng.multistep_blocks > 0
        with eng._released_lock:
            assert "cx" not in eng._released
        if eng._samp_cache is not None:
            assert all(rid != "cx" for rid, _s in eng._samp_cache[0][1])
    finally:
        await eng.stop()


def test_config_defaults_are_the_reference_defaults():
    # the decode knobs stay None in both configs and resolve when the
    # engine is built (RuntimeConfig, then the short-form env, then the
    # reference's defaults): no DYN_* variable is set here
    port, ref = TorchEngineConfig(), JaxEngineConfig()
    names = {f.name for f in dataclasses.fields(ref)}
    shared = [f.name for f in dataclasses.fields(port) if f.name in names]
    assert {"pipeline_decode", "decode_multistep", "mixed_batch",
            "decode_progress_every", "min_decode_bucket",
            "guided_table_bytes", "score_max_tokens"} <= set(shared)
    for name in shared:
        assert getattr(port, name) == getattr(ref, name), name
    assert DECODE_MULTISTEP == jeng_mod.DECODE_MULTISTEP
    eng = port_engine()
    assert eng.supports_pipelining and eng.supports_multistep
    assert eng.multistep == DECODE_MULTISTEP
    assert eng.scheduler.cfg.decode_multistep == DECODE_MULTISTEP
    assert eng.scheduler.cfg.mixed_batch == jeng_mod.MIXED_BATCH
    assert eng.scheduler.cfg.decode_progress_every == \
        jeng_mod.DECODE_PROGRESS_EVERY
    assert eng.scheduler.cfg.guided_fuse_check is not None


def test_prime_multistep_writes_only_the_garbage_page():
    eng = port_engine()
    before = eng.pages.clone()
    packed = eng.prime_multistep(4)
    assert packed.shape == (4, 2, 2 + 2 * eng.cfg.num_top_logprobs)
    assert torch.equal(eng.pages[:, 1:], before[:, 1:])
    assert eng.drain_compile_events() == []


@pytest.mark.parametrize("samp", [dict(temperature=0.0),
                                  dict(temperature=1.0, seed=4242)],
                         ids=["greedy", "seeded"])
def test_deepseek_fused_matches_jax_engine(samp):
    jcfg, jparams, cfg, tparams = deepseek_weights()
    sizes = dict(num_pages=64, page_size=8, max_num_seqs=4,
                 max_prefill_chunk=16, max_context=64, min_prefill_bucket=4)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        attn_impl="scan", pipeline_decode=True, decode_multistep=8,
        **sizes))
    teng = TorchEngine(cfg, tparams, TorchEngineConfig(**sizes),
                       device="cpu")
    build = staggered(samp=samp)
    ref = asyncio.run(_serve(jeng, build(JAX)))
    got = asyncio.run(_serve(teng, build(PORT)))
    assert_same(ref, got, counters(jeng), counters(teng))
    assert all(n > 0 for n in teng.kernel_launches.values())
