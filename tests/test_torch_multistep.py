"""``TorchEngine``'s fused multi-step decode against ``JaxEngine``'s, on the
CPU.

Both engines serve with the reference's decode defaults: pipelined decode
and fused blocks of up to 8 steps (``JaxEngine(attn_impl="scan",
pipeline_decode=True, decode_multistep=8)``, ``TorchEngineConfig()``'s
defaults), from the same tiny Llama weights. Each case submits its requests
at once and must stream the same token ids and finish reasons from both,
with logprobs within 2e-6 relative (PyTorch's ``logsumexp`` sums in
another order than XLA's), and must leave the same dispatch counters
(``decode_dispatches``, ``multistep_blocks``, ``chained_steps``) and
fallback reasons (``scheduler.multistep_fallbacks``). The cases mirror
``tests/test_multistep.py``: greedy rows of staggered lengths, seeded and
unseeded sampling, EOS / a stop token under ``min_tokens`` / ``max_tokens``
landing mid-block, penalties and bias that must bite inside the block, a
guided row riding the block on its device table, and a grammar whose
table is over ``guided_table_bytes``, which decodes per step with the
reason ``guided_table``.
"""

import asyncio
import functools

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)
from tests.test_torch_guided import EOS, SCHEMA, byte_vocab

# small CPU shapes: keep torch off the cores other test workers time on
torch.set_num_threads(2)

SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4,
             max_prefill_chunk=16, max_context=64, min_prefill_bucket=4)
# logprobs: the documented difference of the two logsumexps (ROADMAP
# Queue C)
LOGPROB_RTOL = 2e-6
JAX = (JRequest, JSampling, JStop)
PORT = (TRequest, TSampling, TStop)


@functools.lru_cache(maxsize=None)
def _weights():
    """The tiny Llama's reference params and their numpy tree."""
    params = jllama.init_params(JModelConfig.tiny(), jax.random.PRNGKey(0))
    return params, jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), params)


def engines(**kw):
    """(JaxEngine, TorchEngine) over the same weights, fused and pipelined
    as the reference defaults; ``kw`` goes to both configs."""
    params, np_tree = _weights()
    jcfg, cfg = JModelConfig.tiny(), ModelConfig.tiny()
    jkw = dict(attn_impl="scan", pipeline_decode=True, decode_multistep=8,
               **SIZES)
    jkw.update(kw)
    jeng = JaxEngine(jcfg, params, JaxEngineConfig(**jkw))
    teng = TorchEngine(cfg, tllama.params_from_jax(np_tree, cfg,
                                                   device="cpu"),
                       TorchEngineConfig(**SIZES, **kw), device="cpu")
    return jeng, teng


def req(classes, rid, prompt, max_tokens, eos=(), samp=None, **stop_kw):
    Req, Samp, Stop = classes
    return Req(token_ids=list(prompt), request_id=rid,
               stop_conditions=Stop(max_tokens=max_tokens, **stop_kw),
               sampling_options=Samp(**(samp or dict(temperature=0.0))),
               eos_token_ids=list(eos))


def staggered(lens=(5, 11, 18), samp=None, **kw):
    """The reference tests' staggered rows, as a request builder."""
    return lambda c: [req(c, f"m{i}", [i + 1, i + 2, i + 3, i + 4, i + 5],
                          n, samp=samp, **kw)
                      for i, n in enumerate(lens)]


async def _serve(eng, reqs):
    async def one(r):
        toks, lps, last = [], [], None
        async for frame in eng.generate(r):
            toks += frame.token_ids
            lps += list(frame.log_probs or [])
            last = frame
        return toks, lps, last.finish_reason.value

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await eng.stop()


def counters(eng) -> dict:
    return {"decode_dispatches": eng.decode_dispatches,
            "multistep_blocks": eng.multistep_blocks,
            "chained_steps": eng.chained_steps,
            "fallbacks": dict(eng.scheduler.multistep_fallbacks)}


def serve_both(build, guided=False, **kw):
    """Serve ``build``'s requests on both engines; returns (reference
    results, port results, reference counters, port counters, port)."""
    jeng, teng = engines(**kw)
    if guided:
        toks = byte_vocab(ModelConfig.tiny().vocab_size)
        for eng in (jeng, teng):
            eng.enable_guided(toks, [EOS])
    ref = asyncio.run(_serve(jeng, build(JAX)))
    got = asyncio.run(_serve(teng, build(PORT)))
    return ref, got, counters(jeng), counters(teng), teng


def assert_same(ref, got, cref, cgot):
    for (rt, rl, rf), (gt, gl, gf) in zip(ref, got):
        assert gt == rt and gf == rf, (ref, got)
        np.testing.assert_allclose(gl, rl, rtol=LOGPROB_RTOL, atol=0)
    assert cgot == cref
    assert cgot["multistep_blocks"] > 0, cgot       # the fused path ran


@functools.lru_cache(maxsize=None)
def greedy_probe():
    """The greedy staggered streams (16 tokens a row), from which the EOS
    and stop-token cases pick a token that lands mid-block."""
    ref, got, cref, cgot, _ = serve_both(staggered(lens=(16, 16, 16)))
    assert_same(ref, got, cref, cgot)
    return [t for t, _l, _f in got]


def test_greedy_staggered_lengths():
    ref, got, cref, cgot, _ = serve_both(staggered())
    assert_same(ref, got, cref, cgot)
    assert [len(t) for t, _l, _f in got] == [5, 11, 18]


@pytest.mark.parametrize("samp", [dict(temperature=1.0, seed=4242),
                                  dict(temperature=0.9, top_p=0.9)],
                         ids=["seeded", "unseeded"])
def test_sampling(samp):
    ref, got, cref, cgot, _ = serve_both(staggered(samp=samp))
    assert_same(ref, got, cref, cgot)
    assert [len(t) for t, _l, _f in got] == [5, 11, 18]


def test_eos_mid_block():
    eos_tok = greedy_probe()[0][4]        # the 5th token: mid-block
    ref, got, cref, cgot, _ = serve_both(
        staggered(lens=(16, 16, 16), eos=[eos_tok]))
    assert_same(ref, got, cref, cgot)
    toks, _l, fin = got[0]
    assert toks[-1] == eos_tok and fin == "eos" and len(toks) <= 5


def test_stop_token_mid_block_with_min_tokens():
    probe = greedy_probe()[0]
    stop_tok = probe[2]
    early = probe.index(stop_tok)
    ref, got, cref, cgot, _ = serve_both(
        staggered(lens=(16,), stop_token_ids=[stop_tok],
                  min_tokens=early + 2))
    assert_same(ref, got, cref, cgot)
    toks, _l, fin = got[0]
    assert len(toks) >= early + 2
    if fin == "stop":
        assert toks[-1] == stop_tok


def test_max_tokens_mid_block():
    ref, got, cref, cgot, _ = serve_both(staggered(lens=(3, 9, 13)))
    assert_same(ref, got, cref, cgot)
    assert [len(t) for t, _l, _f in got] == [3, 9, 13]
    assert {f for _t, _l, f in got} == {"length"}


def constrained(seeded):
    t = 0.9 if seeded else 0.0
    kw = dict(seed=11) if seeded else {}
    rows = [("plain", {}), ("freq", dict(frequency_penalty=0.9)),
            ("rep", dict(repetition_penalty=1.4)),
            ("bias", dict(logit_bias={17: 3.5, 41: -100.0}))]
    return lambda c: [req(c, rid, [i + 1, i + 2, i + 3, i + 4, i + 5], 14,
                          samp=dict(temperature=t, **kw, **o))
                      for i, (rid, o) in enumerate(rows)]


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_penalties_and_bias_ride_the_block(seeded):
    ref, got, cref, cgot, _ = serve_both(constrained(seeded))
    assert_same(ref, got, cref, cgot)
    assert not {"penalties", "penalty_window"} & set(cgot["fallbacks"])
    assert all(len(t) == 14 for t, _l, _f in got)


def test_penalty_bites_inside_the_block():
    """A +100 bias forces the first greedy pick, then a presence penalty of
    200 must ban that token for the rest of the block: the window is
    updated inside the block, not once per dispatch."""
    ref, got, cref, cgot, _ = serve_both(
        lambda c: [req(c, "b", [1, 2, 3], 12,
                       samp=dict(temperature=0.0, presence_penalty=200.0,
                                 logit_bias={7: 100.0}))])
    assert_same(ref, got, cref, cgot)
    toks = got[0][0]
    assert toks[0] == 7 and 7 not in toks[1:]


def _guided_rows(c):
    return [req(c, "g", [3, 4, 5], 24, eos=[EOS],
                samp=dict(temperature=0.7, guided=SCHEMA)),
            req(c, "p", [6, 7, 8, 9], 20, samp=dict(temperature=0.0))]


def test_guided_row_rides_the_block():
    ref, got, cref, cgot, teng = serve_both(_guided_rows, guided=True)
    assert_same(ref, got, cref, cgot)
    assert not {"guided", "guided_table"} & set(cgot["fallbacks"])
    assert teng.guided_parity_mismatches == 0


def test_guided_grammar_over_the_table_cap_falls_back():
    ref, got, cref, cgot, teng = serve_both(_guided_rows, guided=True,
                                            guided_table_bytes=1024)
    assert cgot["fallbacks"].get("guided_table", 0) > 0
    for (rt, rl, rf), (gt, gl, gf) in zip(ref, got):
        assert (gt, gf) == (rt, rf)
        np.testing.assert_allclose(gl, rl, rtol=LOGPROB_RTOL, atol=0)
    assert cgot == cref
