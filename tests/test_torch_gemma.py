"""The port's Gemma-2 (``dynamo_tpu_torch/models/gemma.py``) against the
reference's ``dynamo_tpu/models/gemma.py``, on the CPU, in float32.

- Family routing: ``gemma2`` maps to the port's module, any other gemma
  is refused as the reference refuses it.
- A tiny ``Gemma2ForCausalLM`` written by transformers, read by the port's
  loader: the logits of a prompt longer than the sliding window within
  1e-5 of the reference's forward on the reference loader's weights (and
  within the reference test's 3e-3 of transformers' own).
- Token-by-token decode through the paged cache equals a full prefill
  (the window is position-based, so it holds from cached pages).
- Prefill, mixed and decode steps through the kernel wrappers (their plain
  versions on the CPU) with ``sliding_window`` 8 over contexts past it,
  against the reference's forward: logits within 1e-4, the real pages
  within 1e-5.
- ``TorchEngine`` greedy streams, per step and fused, equal to
  ``JaxEngine``'s per-step streams on the same weights.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import gemma as jgemma
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import (ATTENTION, TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import gemma as tgemma
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)

torch.set_num_threads(2)

LOGIT_TOL = 1e-4
PAGE_TOL = 1e-5
GEMMA = dict(model_type="gemma2", num_layers=4, sliding_window=8,
             attn_logit_softcap=40.0, final_logit_softcap=25.0,
             query_pre_attn_scalar=24.0)


def _both(seed=0, **kw):
    """(reference cfg, reference params, port cfg, port params), the norms
    perturbed away from their zero init so that they matter."""
    d = dict(GEMMA, **kw)
    jcfg, cfg = JModelConfig.tiny(**d), ModelConfig.tiny(**d)
    tree = jgemma.init_params(jcfg, jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    rng = np.random.default_rng(seed)
    lay = np_tree["layers"]
    for name in ("attn_norm", "post_attn_norm", "pre_ffw_norm",
                 "post_ffw_norm"):
        lay[name] = rng.normal(scale=0.2,
                               size=lay[name].shape).astype(np.float32)
    np_tree["final_norm"] = rng.normal(
        scale=0.2, size=np_tree["final_norm"].shape).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return jcfg, jparams, cfg, tgemma.params_from_jax(np_tree, cfg,
                                                      device="cpu")


def test_family_routing():
    assert get_family(ModelConfig.tiny(model_type="gemma2")) is tgemma
    with pytest.raises(NotImplementedError, match="only gemma2"):
        get_family(ModelConfig.tiny(model_type="gemma3"))
    cfg = ModelConfig.gemma2_27b()
    assert (cfg.num_layers, cfg.hidden_size, cfg.head_dim,
            cfg.num_kv_heads, cfg.sliding_window) == (46, 4608, 128, 16, 4096)
    assert tgemma.layer_windows(cfg)[:3] == [4096, 0, 4096]


def test_hf_checkpoint_matches_reference(tmp_path):
    from transformers import Gemma2Config, Gemma2ForCausalLM

    from dynamo_tpu.models.hf_loader import load_hf_params as jload
    from dynamo_tpu_torch.models.hf_loader import load_hf_params as tload
    hf_cfg = Gemma2Config(
        vocab_size=160, hidden_size=64, intermediate_size=96,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, rms_norm_eps=1e-6,
        rope_theta=10000.0, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, query_pre_attn_scalar=24,
        sliding_window=8, attn_implementation="eager")
    torch.manual_seed(0)
    model = Gemma2ForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:             # zero-init norms: make them matter
                p.normal_(0.0, 0.2)
    model.save_pretrained(tmp_path, safe_serialization=True)
    jcfg = JModelConfig.from_pretrained(str(tmp_path), dtype="float32")
    cfg = ModelConfig.from_pretrained(str(tmp_path), dtype="float32")
    assert cfg.model_type == "gemma2" and cfg.sliding_window == 8
    assert cfg.tie_word_embeddings and cfg.query_pre_attn_scalar == 24
    jp = jload(jcfg, str(tmp_path))
    tp = tload(cfg, str(tmp_path), device="cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    prompt = np.random.RandomState(7).randint(1, 159, size=20).tolist()
    with torch.no_grad():
        hf = model(torch.tensor([prompt])).logits[0, -1].numpy()
    toks = np.asarray([prompt], np.int32)
    pos = np.arange(len(prompt), dtype=np.int32)[None]
    table = np.arange(1, 6, dtype=np.int32)[None]
    lens = np.asarray([len(prompt)], np.int32)
    want, _ = jgemma.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                             jgemma.make_pages(jcfg, 8, 4, jnp.float32),
                             jnp.asarray(table), jnp.asarray(lens),
                             jnp.asarray(lens))
    t = torch.from_numpy
    got, _ = tgemma.forward(tp, cfg, t(toks), t(pos),
                            tgemma.make_pages(cfg, 8, 4, device="cpu"),
                            t(table), t(lens), t(lens))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), hf, rtol=3e-3, atol=3e-3)


def test_decode_matches_full_prefill():
    _jcfg, _jp, cfg, tp = _both(seed=2, sliding_window=6)
    prompt = list(np.random.RandomState(1).randint(1, 255, size=13))
    t = lambda x: torch.tensor(x, dtype=torch.int32)
    table = t([[1, 2, 3, 4]])
    ref, _ = tgemma.forward(tp, cfg, t([prompt]), t([list(range(13))]),
                            tgemma.make_pages(cfg, 8, 8, device="cpu"),
                            table, t([13]), t([13]))
    pages = tgemma.make_pages(cfg, 8, 8, device="cpu")
    for i, tok in enumerate(prompt):
        logits, _ = tgemma.forward(tp, cfg, t([[tok]]), t([[i]]), pages,
                                   table, t([i + 1]), t([1]))
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def _steps(vocab):
    """(kernel, tokens, positions, table, total, new): a prefill of two
    rows (one of 12 tokens, one of 5), a mixed step (row 0's next 10
    tokens, which reach past the window over its cached prefix, next to
    row 1 decoding) and a decode step."""
    rng = np.random.default_rng(3)
    P = 16
    table = np.zeros((2, P), np.int32)
    table[0, :7] = np.arange(1, 8)
    table[1, :7] = np.arange(8, 15)
    prompt = rng.integers(0, vocab, size=(2, 22)).astype(np.int32)
    toks = np.zeros((2, 12), np.int32)
    pos = np.zeros((2, 12), np.int32)
    toks[0] = prompt[0, :12]
    pos[0] = np.arange(12)
    toks[1, :5] = prompt[1, :5]
    pos[1, :5] = np.arange(5)
    out = [("paged_prefill", toks, pos, table, [12, 5], [12, 5])]
    toks = np.zeros((2, 10), np.int32)
    pos = np.zeros((2, 10), np.int32)
    toks[0] = prompt[0, 12:22]
    pos[0] = np.arange(12, 22)
    toks[1, 0] = prompt[1, 5]
    pos[1, 0] = 5
    out.append(("ragged_mixed", toks, pos, table, [22, 6], [10, 1]))
    out.append(("paged_decode", np.array([[3], [4]], np.int32),
                np.array([[22], [6]], np.int32), table, [23, 7], [1, 1]))
    return out


def test_forward_through_kernel_wrappers_matches_reference():
    """The engine's three attention wrappers (plain versions on CPU
    tensors) carry each layer's window and the softcap: prefill, mixed and
    decode steps past the window agree with the reference's forward."""
    jcfg, jp, cfg, tp = _both(seed=5)
    jpages = jgemma.make_pages(jcfg, 16, 4, jnp.float32)
    tpages = tgemma.make_pages(cfg, 16, 4, device="cpu")
    for kernel, toks, pos, table, total, new in _steps(cfg.vocab_size):
        arrs = [np.asarray(x, np.int32) for x in (toks, pos, table, total,
                                                  new)]
        want, jpages = jgemma.forward(jp, jcfg, *map(jnp.asarray, arrs[:2]),
                                      jpages, *map(jnp.asarray, arrs[2:]))
        got, _ = tgemma.forward(tp, cfg, *map(torch.from_numpy, arrs[:2]),
                                tpages, *map(torch.from_numpy, arrs[2:]),
                                attn_impl=ATTENTION[kernel])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL, err_msg=kernel)
        # every real page; the garbage page 0 holds pad slots' K/V, which
        # differ once pad query slots come out zero from the kernels
        np.testing.assert_allclose(tpages.numpy()[:, 1:],
                                   np.asarray(jpages)[:, 1:], rtol=0,
                                   atol=PAGE_TOL, err_msg=kernel)


SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=64, min_prefill_bucket=4)
PROMPTS = {"a": list(range(1, 21)), "b": [9, 3, 1, 4, 2, 7, 7, 5, 11, 30],
           "c": [100 + (i * 7) % 50 for i in range(26)]}
MAX_TOKENS = {"a": 10, "b": 8, "c": 6}


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


@pytest.mark.async_timeout(180)
async def test_engine_streams_match_jax_engine():
    jcfg, jp, cfg, tp = _both(seed=7)
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
    assert teng.multistep_blocks > 0
    with pytest.raises(NotImplementedError, match="no embedding path"):
        await teng.embed([[1, 2, 3]])
