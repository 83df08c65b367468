"""Speculative decoding on ``TorchEngine`` against ``JaxEngine``, on the CPU.

The reference's engine tests (``tests/test_spec_decode.py``), run on the
port, with the reference's streams as the expectation. Both engines take
one float32 weight tree (``params_from_jax``) and the reference's sizes.

- Greedy output is identical with speculation on or off, and equal to
  ``JaxEngine(spec_tokens=3)``'s; fusion is off under speculation (reason
  ``"spec"``) while plain steps still chain. (Random weights rarely
  continue the prompt's pattern, so the n-gram proposer seldom drafts:
  the tests that need verify steps feed the proposer.)
- Forced perfect drafts (the proposer fed the greedy continuation) are
  accepted, with the acceptance counters equal to the reference's; a stop
  token inside an accepted run truncates there; a row within K of
  ``max_context`` falls back to plain decode; any chain-break cadence
  gives the same tokens; ``max_tokens`` is exact.
- Logprobs and top alternatives ride verify steps: the same ids as the
  reference's, values within 2e-6 relative (ROADMAP Queue C: PyTorch's
  logsumexp sums in another order than XLA's).
- ``_guided_spec_masks`` gives the reference's per-slot masks along legal,
  refused, EOS and special drafts.
- A penalized request falls back to plain decode; rows with and without
  drafts ride one verify step; a cancel mid-speculation leaves the engine
  serving.
- Sampled streams (temperature, top-k, top-p; the engine's seed keys the
  verify draws) are token-equal with the reference's, every step a verify
  step.
- Gemma-2 and DeepSeek (latent attention, MoE) speculate with the same
  greedy tokens as without, and with the reference's acceptance counts.
"""

import asyncio
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import dynamo_tpu.engine.scheduler as jsched
import dynamo_tpu_torch.engine.scheduler as tsched
from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import gemma as jgemma
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import gemma as tgemma
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)
from tests.test_torch_guided import EOS, SCHEMA, byte_vocab

torch.set_num_threads(2)

LOGPROB_RTOL = 2e-6
PROMPT = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7]  # repetitive -> n-gram hits
SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=64, min_prefill_bucket=4, spec_ngram_min=1)
GEMMA = dict(model_type="gemma2", num_layers=2, sliding_window=8,
             attn_logit_softcap=40.0, final_logit_softcap=25.0)
API = {"jax": (JRequest, JSampling, JStop),
       "torch": (TRequest, TSampling, TStop)}


def _weights(cfg_kw=None, seed=0):
    """(reference cfg, reference params, port cfg, port params)."""
    cfg_kw = cfg_kw or {}
    jcfg, cfg = JModelConfig.tiny(**cfg_kw), ModelConfig.tiny(**cfg_kw)
    jfam, tfam = ((jgemma, tgemma) if cfg.model_type == "gemma2"
                  else (jllama, tllama))
    tree = jfam.init_params(jcfg, jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    return jcfg, tree, cfg, tfam.params_from_jax(np_tree, cfg, device="cpu")


WEIGHTS = {}


def _llama():
    if "llama" not in WEIGHTS:
        WEIGHTS["llama"] = _weights()
    return WEIGHTS["llama"]


def jax_engine(spec_tokens=3, weights=None, **kw):
    jcfg, jp, _cfg, _tp = weights or _llama()
    return JaxEngine(jcfg, jp, JaxEngineConfig(
        attn_impl="scan", spec_tokens=spec_tokens, **dict(SIZES, **kw)))


def torch_engine(spec_tokens=3, weights=None, **kw):
    _jcfg, _jp, cfg, tp = weights or _llama()
    return TorchEngine(cfg, tp, TorchEngineConfig(
        spec_tokens=spec_tokens, **dict(SIZES, **kw)), device="cpu")


def make_req(api, tokens, rid="r1", max_tokens=8, temperature=0.0,
             sampling=None, **stop):
    Req, Samp, Stop = API[api]
    return Req(token_ids=list(tokens), request_id=rid,
               stop_conditions=Stop(max_tokens=max_tokens, **stop),
               sampling_options=Samp(**dict({"temperature": temperature},
                                            **(sampling or {}))),
               eos_token_ids=[])


async def collect(engine, req, ctx=None):
    return [out async for out in engine.generate(req, ctx=ctx)]


async def greedy(engine, api, prompt=PROMPT, rid="g", max_tokens=10,
                 stop=True):
    try:
        frames = await collect(engine, make_req(api, prompt, rid,
                                                max_tokens))
    finally:
        if stop:
            await engine.stop()
    assert frames[-1].finish_reason.value == "length"
    return [t for f in frames for t in f.token_ids]


@pytest.fixture(scope="module")
def base_stream():
    """The reference's greedy stream of PROMPT without speculation (16
    tokens; shorter runs are its prefixes)."""
    return asyncio.run(greedy(jax_engine(spec_tokens=0), "jax",
                              max_tokens=16))


def oracle_for(full):
    """A proposer that drafts the true greedy continuation of ``full``."""
    def oracle(tokens, k, max_n=4, min_n=2):
        n = len(tokens)
        if n >= len(full) or list(tokens) != full[:n]:
            return None
        cont = full[n:n + k]
        while len(cont) < k:
            cont.append(cont[-1])
        return cont
    return oracle


def _stats(engine):
    s = engine.stats().spec_decode_stats
    return (s.num_drafts, s.num_draft_tokens, s.num_accepted_tokens)


async def test_greedy_identical_with_and_without_spec(base_stream):
    want = base_stream[:10]
    assert await greedy(torch_engine(spec_tokens=0), "torch") == want
    eng = torch_engine(spec_tokens=3)
    assert not eng.supports_multistep
    assert eng.multistep_unsupported_reason == "spec"
    assert await greedy(eng, "torch") == want
    assert await greedy(jax_engine(spec_tokens=3), "jax") == want


@pytest.mark.async_timeout(120)
async def test_forced_perfect_drafts_accept_and_match(base_stream,
                                                      monkeypatch):
    want = base_stream[:9]
    oracle = oracle_for(list(PROMPT) + want)
    monkeypatch.setattr(tsched, "propose_ngram", oracle)
    monkeypatch.setattr(jsched, "propose_ngram", oracle)
    stats = {}
    for api, make in (("torch", torch_engine), ("jax", jax_engine)):
        eng = make(spec_tokens=3)
        try:
            assert await greedy(eng, api, max_tokens=9, stop=False) == want
            stats[api] = _stats(eng)
        finally:
            await eng.stop()
    drafts, draft_tokens, accepted = stats["torch"]
    assert accepted > 0 and draft_tokens >= accepted
    assert stats["torch"] == stats["jax"]


async def test_stop_token_truncates_inside_accepted_run(base_stream,
                                                        monkeypatch):
    want = base_stream[:8]
    monkeypatch.setattr(tsched, "propose_ngram",
                        oracle_for(list(PROMPT) + want))
    eng = torch_engine(spec_tokens=3)
    try:
        frames = await collect(eng, make_req("torch", PROMPT, "stop",
                                             max_tokens=8,
                                             stop_token_ids=[want[4]]))
        assert [t for f in frames for t in f.token_ids] == want[:5]
        assert frames[-1].finish_reason == FinishReason.STOP
        assert _stats(eng)[2] > 0
    finally:
        await eng.stop()


async def test_context_ceiling_falls_back_to_plain_decode():
    eng = torch_engine(spec_tokens=3, max_context=16)
    try:
        frames = await collect(eng, make_req("torch", PROMPT, "ceil",
                                             max_tokens=32))
        toks = [t for f in frames for t in f.token_ids]
        assert frames[-1].finish_reason == FinishReason.LENGTH
        assert len(PROMPT) + len(toks) == 16
    finally:
        await eng.stop()


@pytest.mark.parametrize("chain_break", [0, 1, 8])
async def test_chained_and_spec_steps_interleave_identically(
        base_stream, chain_break):
    eng = torch_engine(spec_tokens=3, spec_chain_break=chain_break)
    assert await greedy(eng, "torch", max_tokens=12) == base_stream[:12]


async def test_max_tokens_exact_under_spec(base_stream):
    got = await greedy(torch_engine(spec_tokens=3), "torch", max_tokens=5)
    assert got == base_stream[:5]


@pytest.mark.async_timeout(120)
async def test_logprobs_ride_spec_steps(base_stream, monkeypatch):
    """With forced drafts, verify steps return several tokens each; their
    logprobs and top alternatives are the reference's: the same tokens
    and alternative ids, values within 2e-6 relative."""
    want_toks = base_stream[:9]
    oracle = oracle_for(list(PROMPT) + want_toks)
    monkeypatch.setattr(tsched, "propose_ngram", oracle)
    monkeypatch.setattr(jsched, "propose_ngram", oracle)
    out = {}
    for api, make in (("torch", torch_engine), ("jax", jax_engine)):
        eng = make(spec_tokens=3)
        req = make_req(api, PROMPT, "lp", max_tokens=9)
        req.sampling_options.logprobs = 3
        try:
            frames = await collect(eng, req)
            assert _stats(eng)[2] > 0
        finally:
            await eng.stop()
        out[api] = ([t for f in frames for t in f.token_ids],
                    [x for f in frames for x in (f.log_probs or [])],
                    [d for f in frames for d in (f.top_logprobs or [])])
    (tt, tl, ttop), (jt, jl, jtop) = out["torch"], out["jax"]
    assert tt == jt == want_toks
    np.testing.assert_allclose(tl, jl, rtol=LOGPROB_RTOL, atol=0)
    assert len(ttop) == len(jtop) == 9
    for g, w in zip(ttop, jtop):
        assert list(g) == list(w)
        np.testing.assert_allclose([g[t] for t in g], [w[t] for t in w],
                                   rtol=LOGPROB_RTOL, atol=0)


def _seq(rid, guided, generated):
    req = SimpleNamespace(request_id=rid, sampling_options=SimpleNamespace(
        guided=guided))
    return SimpleNamespace(request=req, generated=list(generated))


def test_guided_spec_masks_match_jax_engine():
    V = 256
    toks = byte_vocab(V)
    jeng, teng = jax_engine(spec_tokens=3), torch_engine(spec_tokens=3)
    for eng in (jeng, teng):
        eng.enable_guided(toks, [EOS])
    doc = list(json.dumps({"ok": True, "n": 42}).encode())
    special = next(i for i, b in enumerate(toks) if b is None and i != EOS)
    cases = [
        ([], doc[:3]),                      # a legal draft path
        (doc[:2], doc[2:4] + [ord("}")]),   # refused mid-path
        (doc[:6], [EOS] + doc[6:8]),        # a drafted EOS
        (doc[:1], [special, doc[1], doc[2]]),
        (doc[:-1], doc[-1:] + [EOS, EOS]),  # the document completes
    ]
    for gen, drafts in cases:
        rows = [_seq("g", SCHEMA, gen)]
        want = jeng._guided_spec_masks(rows[0], np.asarray(drafts), 4)
        got = teng._guided_spec_masks(rows[0], np.asarray(drafts), 4)
        assert got.dtype == np.uint32 and got.shape == (4, V // 32)
        np.testing.assert_array_equal(got, want, err_msg=str(drafts))
    assert teng._guided_spec_masks(_seq("p", None, []),
                                   np.asarray(doc[:3]), 4) is None


async def test_penalized_request_falls_back_to_plain_decode():
    eng = torch_engine(spec_tokens=3)
    try:
        frames = await collect(eng, make_req(
            "torch", PROMPT, "pen", max_tokens=5,
            sampling={"frequency_penalty": 0.5}))
        assert len([t for f in frames for t in f.token_ids]) == 5
        assert eng.stats().spec_decode_stats.num_drafts == 0
    finally:
        await eng.stop()


async def test_rows_without_draft_ride_along(base_stream, monkeypatch):
    other = [9, 3, 1, 4, 2]
    solo = await greedy(torch_engine(spec_tokens=0), "torch", other, "b", 6)
    # row a drafts its true continuation, row b never drafts
    monkeypatch.setattr(tsched, "propose_ngram",
                        oracle_for(list(PROMPT) + base_stream))
    eng = torch_engine(spec_tokens=3)
    try:
        fa, fb = await asyncio.gather(
            collect(eng, make_req("torch", PROMPT, "a", 6)),
            collect(eng, make_req("torch", other, "b", 6)))
        assert [t for f in fa for t in f.token_ids] == base_stream[:6]
        assert [t for f in fb for t in f.token_ids] == solo
        assert eng.stats().spec_decode_stats.num_drafts > 0
    finally:
        await eng.stop()


async def test_cancel_mid_speculation_leaves_engine_healthy(base_stream,
                                                            monkeypatch):
    monkeypatch.setattr(tsched, "propose_ngram",
                        oracle_for(list(PROMPT) + base_stream))
    eng = torch_engine(spec_tokens=3)
    ctx = SimpleNamespace(cancelled=False)
    try:
        frames = []
        async for out in eng.generate(make_req("torch", PROMPT, "cx", 64),
                                      ctx=ctx):
            frames.append(out)
            if sum(len(f.token_ids) for f in frames) >= 4:
                ctx.cancelled = True
        assert frames[-1].finish_reason == FinishReason.CANCELLED
        assert eng.stats().spec_decode_stats.num_drafts > 0
        assert await greedy(eng, "torch", rid="fw", max_tokens=6,
                            stop=False) == base_stream[:6]
    finally:
        await eng.stop()


SAMPLED = {"t": dict(temperature=0.8, top_p=0.9),
           "k": dict(temperature=1.0, top_k=20)}


def repeat_last(tokens, k, max_n=4, min_n=2):
    """A proposer that always drafts: the context's last ``k`` tokens."""
    return list(tokens[-k:])


@pytest.mark.async_timeout(120)
async def test_sampled_spec_streams_match_jax_engine(monkeypatch):
    """Unseeded sampled requests under speculation (every step drafts):
    the verify step's uniform and Gumbel draws come from the engine's seed
    and the step count, so both engines accept and replace the same
    drafts."""
    monkeypatch.setattr(tsched, "propose_ngram", repeat_last)
    monkeypatch.setattr(jsched, "propose_ngram", repeat_last)
    out = {}
    for api, make in (("torch", torch_engine), ("jax", jax_engine)):
        eng = make(spec_tokens=3, seed=7)
        try:
            frames = await asyncio.gather(*(
                collect(eng, make_req(api, PROMPT + [i], rid, 12,
                                      sampling=so))
                for i, (rid, so) in enumerate(SAMPLED.items())))
            out[api] = ([[t for f in fr for t in f.token_ids]
                         for fr in frames], _stats(eng))
        finally:
            await eng.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][1][0] > 0          # verify steps ran


FAMILIES = {
    "gemma2": GEMMA,
    "deepseek": dict(num_heads=4, num_kv_heads=1, head_dim=32,
                     model_type="deepseek_v2", q_lora_rank=0,
                     kv_lora_rank=32, qk_rope_head_dim=16,
                     qk_nope_head_dim=32, v_head_dim=32, num_experts=4,
                     num_experts_per_tok=2, moe_intermediate_size=32,
                     n_shared_experts=2, first_k_dense_replace=1,
                     routed_scaling_factor=1.0),
}


def _family_weights(name):
    cfg_kw = FAMILIES[name]
    if name == "gemma2":
        return _weights(cfg_kw)
    from dynamo_tpu.models import deepseek as jds
    from dynamo_tpu_torch.models import deepseek as tds
    jcfg, cfg = JModelConfig.tiny(**cfg_kw), ModelConfig.tiny(**cfg_kw)
    tree = jds.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    return jcfg, tree, cfg, tds.params_from_jax(np_tree, cfg, device="cpu")


@pytest.mark.async_timeout(240)
@pytest.mark.parametrize("family", list(FAMILIES))
async def test_family_greedy_identical_with_and_without_spec(family,
                                                             monkeypatch):
    """Without speculation, then with the proposer fed the greedy
    continuation (so verify steps run and accept), in both engines."""
    w = _family_weights(family)
    want = await greedy(torch_engine(spec_tokens=0, weights=w), "torch")
    oracle = oracle_for(list(PROMPT) + want)
    monkeypatch.setattr(tsched, "propose_ngram", oracle)
    monkeypatch.setattr(jsched, "propose_ngram", oracle)
    stats = {}
    for api, make in (("torch", torch_engine), ("jax", jax_engine)):
        eng = make(spec_tokens=3, weights=w)
        try:
            assert await greedy(eng, api, stop=False) == want, api
            stats[api] = _stats(eng)
        finally:
            await eng.stop()
    assert stats["torch"][2] > 0 and stats["torch"] == stats["jax"]
