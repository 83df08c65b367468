"""Int8 W8A8 (``dynamo_tpu_torch/ops/quant.py``) against the reference's
``dynamo_tpu/ops/quant.py``, on the CPU.

- ``quantize_weight`` / ``quantize_params``: int8 leaves and float32
  scales equal to the reference's, bit for bit; tied embeddings untouched.
- ``qdot``: equal to the reference's bit for bit in float32 (the same
  rounding of the activations, exact int32 products, the rescale in the
  reference's order), all-zero rows finite.
- The int8 forward of the Llama tree and of Gemma-2 (``params_from_jax``
  carrying the ``_q`` / ``_scale`` leaves) within 1e-5 of the reference's
  logits.
- ``TorchEngine(quantize="int8")`` streams the greedy tokens of
  ``JaxEngine(quantize="int8")`` on the Llama tree and on Gemma-2, both
  quantizing the same float32 weights themselves, and refuses what the
  reference refuses.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import gemma as jgemma
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops import quant as jquant
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
from dynamo_tpu_torch.ops import quant as tquant
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)

torch.set_num_threads(2)

LOGITS_TOL = 1e-5
SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=64, min_prefill_bucket=4, decode_multistep=1,
             pipeline_decode=False)
GEMMA = dict(model_type="gemma2", sliding_window=8, attn_logit_softcap=50.0,
             final_logit_softcap=30.0, query_pre_attn_scalar=24.0)


def _cfgs(**kw):
    base = dict(tie_word_embeddings=False)
    base.update(kw)
    return JModelConfig.tiny(**base), ModelConfig.tiny(**base)


def _tree_np(tree):
    """A JAX parameter tree as numpy, int8 leaves kept as int8."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) if a.dtype == jnp.int8
        else np.array(a, np.float32), tree)


def _family(cfg):
    return (jgemma, tgemma) if cfg.model_type == "gemma2" else \
        (jllama, tllama)


def _weights(jcfg, seed):
    jfam, _ = _family(jcfg)
    return jfam.init_params(jcfg, jax.random.PRNGKey(seed))


def test_quantize_weight_equals_reference():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 64, 48)) * 0.05).astype(np.float32)
    w[1, :, 5] = 0.0                    # an all-zero channel: scale EPS
    for axis in (0, 1, 2):
        jw8, js = jquant.quantize_weight(jnp.asarray(w), axis)
        tw8, ts = tquant.quantize_weight(torch.from_numpy(w), axis)
        assert tw8.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tw8.numpy(), np.asarray(jw8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_params_equals_reference(tied):
    jcfg, cfg = _cfgs(tie_word_embeddings=tied)
    jp = _weights(jcfg, 1)
    jq = _tree_np(jquant.quantize_params(jp))
    tq = tquant.quantize_params(
        tllama.params_from_jax(_tree_np(jp), cfg, device="cpu"))
    assert ("lm_head_q" in tq) == (not tied) and "lm_head" not in tq
    assert set(tq) == set(jq) and set(tq["layers"]) == set(jq["layers"])
    for name in tquant.LAYER_WEIGHTS:
        assert name not in tq["layers"]
        assert tq["layers"][name + "_q"].dtype == torch.int8
        assert tq["layers"][name + "_scale"].dtype == torch.float32
    flat_t = {k: v for k, v in tq.items() if k != "layers"}
    flat_t.update(tq["layers"])
    flat_j = {k: v for k, v in jq.items() if k != "layers"}
    flat_j.update(jq["layers"])
    for k, v in flat_t.items():
        np.testing.assert_array_equal(v.numpy(), flat_j[k], err_msg=k)


@pytest.mark.parametrize("shape", [(4, 7, 64), (3, 64), (1, 1, 64)])
def test_qdot_bit_equal_to_reference(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, ..., :] *= 40.0                # rows of very different scale
    w = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    jw8, js = jquant.quantize_weight(jnp.asarray(w), 0)
    want = np.asarray(jquant.qdot(jnp.asarray(x), jw8, js))
    got = tquant.qdot(torch.from_numpy(x), torch.from_numpy(np.array(jw8)),
                      torch.from_numpy(np.array(js)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the logits sites' float32 output from a float32 operand is the same
    np.testing.assert_array_equal(
        tquant.qdot(torch.from_numpy(x), torch.from_numpy(np.array(jw8)),
                    torch.from_numpy(np.array(js)),
                    out_dtype=torch.float32).numpy(), want)


def test_qdot_zero_rows_finite():
    w8, scale = tquant.quantize_weight(torch.ones((8, 4)), 0)
    y = tquant.qdot(torch.zeros((2, 8)), w8, scale)
    assert torch.isfinite(y).all() and (y == 0).all()


def _step_inputs(B=2, S=12, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    table = np.tile(np.arange(1, 5, dtype=np.int32), (B, 1))
    table[1] += 4
    lens = np.full(B, S, np.int32)
    return toks, pos, table, lens


@pytest.mark.parametrize("kind", ["llama", "gemma2"])
def test_int8_forward_matches_reference(kind):
    jcfg, cfg = _cfgs(**(GEMMA if kind == "gemma2" else {}))
    jfam, tfam = _family(jcfg)
    jq = jquant.quantize_params(_weights(jcfg, 4))
    tq = tfam.params_from_jax(_tree_np(jq), cfg, device="cpu")
    assert tq["layers"]["wq_q"].dtype == torch.int8
    toks, pos, table, lens = _step_inputs()
    want, _ = jfam.forward(jq, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                           jfam.make_pages(jcfg, 9, 4), jnp.asarray(table),
                           jnp.asarray(lens), jnp.asarray(lens))
    t = torch.from_numpy
    got, _ = tfam.forward(tq, cfg, t(toks), t(pos),
                          tfam.make_pages(cfg, 9, 4, device="cpu"),
                          t(table), t(lens), t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_TOL)


PROMPTS = {"a": [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
           "b": [40, 3, 77, 1, 200, 9],
           "c": list(range(100, 121))}
MAX_TOKENS = {"a": 8, "b": 6, "c": 5}


async def _greedy(engine, Req, Samp, Stop):
    out = {}

    async def run(rid):
        req = Req(token_ids=PROMPTS[rid], request_id=rid,
                  stop_conditions=Stop(max_tokens=MAX_TOKENS[rid]),
                  sampling_options=Samp(temperature=0.0))
        toks = []
        async for frame in engine.generate(req):
            toks += frame.token_ids
        out[rid] = toks

    try:
        await asyncio.gather(*(run(r) for r in PROMPTS))
    finally:
        await engine.stop()
    return out


@pytest.mark.async_timeout(120)
@pytest.mark.parametrize("kind", ["llama", "gemma2"])
async def test_int8_engine_streams_match_jax_engine(kind):
    jcfg, cfg = _cfgs(**(GEMMA if kind == "gemma2" else {}))
    _jfam, tfam = _family(jcfg)
    jp = _weights(jcfg, 5)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="scan",
                                               quantize="int8", **SIZES))
    teng = TorchEngine(cfg, tfam.params_from_jax(_tree_np(jp), cfg,
                                                 device="cpu"),
                       TorchEngineConfig(quantize="int8", **SIZES),
                       device="cpu")
    assert teng.params["layers"]["w_up_q"].dtype == torch.int8
    assert "w_up" not in teng.params["layers"]
    want = await _greedy(jeng, JRequest, JSampling, JStop)
    got = await _greedy(teng, TRequest, TSampling, TStop)
    assert got == want
    assert all(len(got[r]) == MAX_TOKENS[r] for r in PROMPTS)


def test_int8_refusals_match_reference():
    """Another mode, and a family whose matmuls do not go through
    ``quant.mm`` (DeepSeek here), are refused by both engines alike."""
    from tests.test_torch_deepseek import _both
    jcfg, cfg = _cfgs()
    jp = _weights(jcfg, 6)
    tp = tllama.params_from_jax(_tree_np(jp), cfg, device="cpu")
    base = dict(num_pages=16, page_size=4, max_num_seqs=2, max_context=32)
    for mode, match in (("int4", "int8"),):
        with pytest.raises(ValueError, match=match):
            JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="scan",
                                                quantize=mode, **base))
        with pytest.raises(ValueError, match=match):
            TorchEngine(cfg, tp, TorchEngineConfig(quantize=mode, **base),
                        device="cpu")
    djcfg, djp, dcfg, dtp = _both()
    with pytest.raises(ValueError, match="llama family"):
        JaxEngine(djcfg, djp, JaxEngineConfig(attn_impl="scan",
                                              quantize="int8", **base))
    with pytest.raises(ValueError, match="llama family"):
        TorchEngine(dcfg, dtp, TorchEngineConfig(quantize="int8", **base),
                    device="cpu")
