"""The geometries the port's GQA kernels take since they were widened: head
dims 64, 128 and 256, and 1 .. 16 query heads per kv head, on the CPU.

- The kernels' plain versions (what B1, B2 and B3's wrappers compute on a
  CPU tensor) at head_dim 256 and at groups of 12 and 16 against the
  reference's Pallas kernels run in interpret mode (they take any
  head_dim % 128 == 0 and any group); at head_dim 64, which the Pallas
  kernels do not take, against the reference's XLA attention
  (``dynamo_tpu/ops/attention.py`` ``paged_attention``), as ``JaxEngine``
  serves it. bf16 pages, within 2e-2 (p rounds to bf16 at other points).
- ``TorchEngine(device="cpu")`` against ``JaxEngine(attn_impl="scan")`` in
  float32, greedy, per step and fused: a tiny Gemma-2 at head_dim 256 and
  a tiny Llama at head_dim 64 with 16 query heads over one kv head, token
  for token, every kernel wrapper called.
- The new presets (Gemma-2-9B, Gemma-2-2B, Llama-3.2-1B) field by field
  equal to the reference's ``ModelConfig.from_hf`` of the same published
  ``config.json`` values.
- ``gqa_geometry_error``: exactly head_dim 64 / 128 / 256 with groups of
  1 .. 16 pass, and the rest are refused with their reason.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import gemma as jgemma
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops.attention import paged_attention as xla_attention
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import gemma as tgemma
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.kernels._wrap import (GROUPS, HEAD_DIMS,
                                                gqa_geometry_error)
from dynamo_tpu_torch.ops.kernels.decode import paged_decode_attention_stacked
from dynamo_tpu_torch.ops.kernels.prefill import \
    paged_prefill_attention_stacked
from dynamo_tpu_torch.ops.kernels.ragged import ragged_mixed_attention_stacked
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)

torch.set_num_threads(2)

BF16_TOL = 2e-2


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a, dtype=None):
    x = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)
                                  if dtype else a))
    return x.to(dtype) if dtype else x


def _case(seed, Hq, Hkv, Dh, q_lens, ctxs, S, ps=8, P=8):
    """bf16 pages [2, N, 2, Hkv, ps, Dh] on distinct random pages, the
    table, and bf16 queries at each row's last q_len positions."""
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    N = B * P + 1
    pages = _bf16(rng.normal(size=(2, N, 2, Hkv, ps, Dh)))
    table = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P).astype(
        np.int32)
    q = np.zeros((B, S, Hq, Dh), np.float32)
    positions = np.zeros((B, S), np.int32)
    for i, (ql, c) in enumerate(zip(q_lens, ctxs)):
        q[i, :ql] = rng.normal(size=(ql, Hq, Dh))
        positions[i, :ql] = np.arange(c - ql, c)
    return (_bf16(q), pages, table, positions,
            np.asarray(ctxs, np.int32), Dh ** -0.5)


def _run_port(fn, case, **kw):
    q, pages, table, positions, total, scale = case
    return fn(_t(q, torch.bfloat16), _t(pages, torch.bfloat16), 1,
              torch.from_numpy(table), torch.from_numpy(positions),
              torch.from_numpy(total), scale, **kw).float().numpy()


def _close(ref, out, q_lens):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    for i, ql in enumerate(q_lens):
        err = float(np.abs(ref[i, :ql] - out[i, :ql]).max())
        assert err <= BF16_TOL, (i, err)


# (Hq, Hkv, Dh, window + softcap?): Gemma-2-9B's 16/8 and -2B's 8/4 at
# head_dim 256, a group of 12 (Mistral-Large-2's 96/8) and of 16
# (Qwen3-235B-A22B's 64/4) at 128; head_dim 64 at Llama-3.2-1B's 32/8 and
# a group of 16; each with or without Gemma's window and softcap
PALLAS = [(16, 8, 256, True), (8, 4, 256, False), (24, 2, 128, True),
          (32, 2, 128, False)]
XLA = [(32, 8, 64, True), (16, 1, 64, False)]


def _kw(capped):
    return dict(window=12, softcap=30.0) if capped else {}


@pytest.mark.parametrize("Hq,Hkv,Dh,capped", PALLAS)
def test_plain_versions_match_pallas(Hq, Hkv, Dh, capped):
    kw = _kw(capped)
    from dynamo_tpu.ops.pallas.decode import (
        paged_decode_attention_stacked as pallas_decode)
    from dynamo_tpu.ops.pallas.prefill import (
        paged_prefill_attention_stacked as pallas_prefill)
    from dynamo_tpu.ops.pallas.ragged import (
        ragged_mixed_attention_stacked as pallas_ragged)
    dec = _case(Dh + Hq, Hq, Hkv, Dh, [1] * 3, [1, 17, 60], 1)
    q, pages, table, positions, total, scale = dec
    ref = pallas_decode(q, pages, 1, jnp.asarray(table),
                        jnp.asarray(positions), jnp.asarray(total), scale,
                        interpret=True, **kw)
    _close(ref, _run_port(paged_decode_attention_stacked, dec, **kw),
           [1] * 3)
    # a fresh prompt, a prefix hit, a partial chunk over a hit; then the
    # ragged mix with a decode row
    for fn, pallas, q_lens, ctxs in (
            (paged_prefill_attention_stacked, pallas_prefill,
             [16, 16, 9], [16, 36, 45]),
            (ragged_mixed_attention_stacked, pallas_ragged,
             [7, 1, 16], [23, 9, 40])):
        case = _case(Dh + Hq + 1, Hq, Hkv, Dh, q_lens, ctxs, 16)
        q, pages, table, positions, total, scale = case
        ref = pallas(q, pages, 1, jnp.asarray(table), jnp.asarray(positions),
                     jnp.asarray(total), scale, interpret=True, **kw)
        _close(ref, _run_port(fn, case, **kw), q_lens)


@pytest.mark.parametrize("Hq,Hkv,Dh,capped", XLA)
def test_plain_versions_match_xla_at_head_dim_64(Hq, Hkv, Dh, capped):
    kw = _kw(capped)
    for fn, q_lens, ctxs, S in (
            (paged_decode_attention_stacked, [1] * 3, [1, 17, 60], 1),
            (paged_prefill_attention_stacked, [16, 16, 9], [16, 36, 45], 16),
            (ragged_mixed_attention_stacked, [7, 1, 16], [23, 9, 40], 16)):
        case = _case(Hq + S, Hq, Hkv, Dh, q_lens, ctxs, S)
        q, pages, table, positions, total, scale = case
        ref = xla_attention(q, pages, 1, jnp.asarray(table),
                            jnp.asarray(positions), jnp.asarray(total),
                            scale, **kw)
        _close(ref, _run_port(fn, case, **kw), q_lens)


# -- engines ------------------------------------------------------------------

SIZES = dict(num_pages=64, page_size=8, max_num_seqs=4, max_prefill_chunk=16,
             max_context=64, min_prefill_bucket=4)
PROMPTS = {"a": list(range(1, 21)), "b": [9, 3, 1, 4, 2, 7, 7, 5, 11, 30],
           "c": [100 + (i * 7) % 50 for i in range(26)]}
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


def _gemma_256():
    kw = dict(model_type="gemma2", num_layers=2, num_heads=2, num_kv_heads=1,
              head_dim=256, sliding_window=8, attn_logit_softcap=40.0,
              final_logit_softcap=25.0, query_pre_attn_scalar=256.0)
    jcfg, cfg = JModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    tree = jgemma.init_params(jcfg, jax.random.PRNGKey(4))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    rng = np.random.default_rng(4)
    for name in ("attn_norm", "post_attn_norm", "pre_ffw_norm",
                 "post_ffw_norm"):
        lay = np_tree["layers"]
        lay[name] = rng.normal(scale=0.2, size=lay[name].shape).astype(
            np.float32)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, np_tree), cfg,
            tgemma.params_from_jax(np_tree, cfg, device="cpu"))


def _llama_64_g16():
    kw = dict(num_layers=2, num_heads=16, num_kv_heads=1, head_dim=64,
              hidden_size=128)
    jcfg, cfg = JModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    tree = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    return (jcfg, tree, cfg, tllama.params_from_jax(np_tree, cfg,
                                                    device="cpu"))


@pytest.mark.async_timeout(180)
@pytest.mark.parametrize("build", [_gemma_256, _llama_64_g16],
                         ids=["gemma2_dh256", "llama_dh64_g16"])
async def test_engine_streams_match_jax_engine(build):
    jcfg, jp, cfg, tp = build()
    per_step = dict(decode_multistep=1, pipeline_decode=False)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="scan", **SIZES,
                                               **per_step))
    want = await _greedy(jeng, JRequest, JSampling, JStop)
    assert all(len(want[r]) == MAX_TOKENS[r] for r in PROMPTS)
    for kw in (per_step, dict(decode_multistep=4)):
        teng = TorchEngine(cfg, tp, TorchEngineConfig(**SIZES, **kw),
                           device="cpu")
        got = await _greedy(teng, TRequest, TSampling, TStop)
        assert got == want, kw
        assert all(n > 0 for n in teng.kernel_launches.values()), \
            teng.kernel_launches


# -- presets and the geometry check ----------------------------------------

PRESETS = {
    "gemma2_9b": dict(
        model_type="gemma2", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_hidden_layers=42,
        num_attention_heads=16, num_key_value_heads=8, head_dim=256,
        query_pre_attn_scalar=256, sliding_window=4096,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=8192,
        tie_word_embeddings=True, hidden_activation="gelu_pytorch_tanh"),
    "gemma2_2b": dict(
        model_type="gemma2", vocab_size=256000, hidden_size=2304,
        intermediate_size=9216, num_hidden_layers=26,
        num_attention_heads=8, num_key_value_heads=4, head_dim=256,
        query_pre_attn_scalar=256, sliding_window=4096,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=8192,
        tie_word_embeddings=True, hidden_activation="gelu_pytorch_tanh"),
    "llama32_1b": dict(
        model_type="llama", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8, head_dim=64,
        rms_norm_eps=1e-5, rope_theta=500000.0,
        max_position_embeddings=131072, tie_word_embeddings=True,
        rope_scaling=dict(factor=32.0, high_freq_factor=4.0,
                          low_freq_factor=1.0,
                          original_max_position_embeddings=8192,
                          rope_type="llama3")),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_equal_reference_from_hf(name):
    got = dataclasses.asdict(getattr(ModelConfig, name)())
    want = dataclasses.asdict(JModelConfig.from_hf(PRESETS[name]))
    assert got == want
    assert gqa_geometry_error(got["num_heads"], got["num_kv_heads"],
                              got["head_dim"], 16) is None


def test_geometry_error_accepts_exactly_the_kernels_geometries():
    taken = {(Hq, Hkv, Dh) for Dh in range(32, 545, 32)
             for Hkv in (1, 2, 4, 8) for Hq in range(1, 40 * Hkv)
             if gqa_geometry_error(Hq, Hkv, Dh, 16) is None}
    assert taken == {(G * Hkv, Hkv, Dh) for Dh in HEAD_DIMS
                     for Hkv in (1, 2, 4, 8) for G in GROUPS}
    assert GROUPS == tuple(range(1, 17)) and HEAD_DIMS == (64, 128, 256)
    for args, why in (((16, 8, 96, 16), "head_dim"),
                      ((16, 8, 384, 16), "head_dim"),
                      ((16, 8, 512, 16), "head_dim"),
                      ((34, 2, 128, 16), "17 is not|34/2"),
                      ((128, 4, 128, 16), "128/4"),
                      ((12, 8, 128, 16), "12/8"),
                      ((16, 8, 256, 12), "page_size")):
        err = gqa_geometry_error(*args)
        assert err is not None
        assert any(w in err for w in why.split("|")), (args, err)


@pytest.mark.parametrize("Dh,window,softcap,spans", [
    (64, 0, 0.0, None), (256, 40, 50.0, None),
    (64, 0, 0.0, [(0, 64), (64, 136), (136, 150)]),
    (256, 40, 50.0, [(0, 64), (64, 136), (136, 150)])])
def test_chunked_rounding_mirror(Dh, window, softcap, spans):
    """``plain.online_attention_rows``, the mirror of the prefill kernel's
    rounding that ``chip_smoke.py`` holds B2/B3's rows against, at head
    dims 64 and 256 with a window and softcap: one chunk over the whole
    context rounds p against the row's final max, as the plain version
    does (within 1 ulp a row); split ranges, each its own online softmax
    merged as the ragged kernel merges its partials, within 2."""
    from dynamo_tpu_torch.ops.kernels.plain import (online_attention_rows,
                                                    plain_paged_attention,
                                                    row_ulp_error)
    ctx, ql, G, ps = 150, 20, 4, 8
    n = -(-ctx // ps)
    g = torch.Generator().manual_seed(Dh + window)
    pages = torch.randn((1, n + 1, 2, 1, ps, Dh), generator=g).bfloat16()
    q = torch.randn((1, ql, G, Dh), generator=g).bfloat16()
    scale = Dh ** -0.5
    want = plain_paged_attention(
        q, pages, 0, torch.arange(1, n + 1, dtype=torch.int32)[None],
        torch.tensor([ctx - ql]), torch.tensor([ctx]), scale,
        window or None, softcap or None)[0]
    k = pages[0, 1:, 0, 0].reshape(n * ps, Dh)
    v = pages[0, 1:, 1, 0].reshape(n * ps, Dh)
    qs = (q[0].float() * scale).bfloat16().reshape(ql * G, Dh)
    qpos = torch.arange(ctx - ql, ctx).repeat_interleave(G)
    got = online_attention_rows(qs, k, v, qpos, ctx, chunk=1024,
                                window=window, softcap=softcap,
                                spans=spans).reshape(ql, G, Dh)
    assert torch.isfinite(got.float()).all()
    assert float(row_ulp_error(got, want).max()) <= (2.0 if spans else 1.0)
