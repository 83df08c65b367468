"""The port's DeepSeek (MLA + MoE) family against ``dynamo_tpu``'s, on the
CPU.

Inputs come from numpy seeds (or the reference's own ``init_params``,
handed over as numpy) and go through both packages in one process:

- ``yarn_freqs`` and ``rope_interleaved`` (both conventions) in float32,
  within 1e-6 / 2e-5;
- the three gate methods: the same expert ids, ties included, and weights
  within 1e-6;
- ``plain_mla_attention`` (what both MLA kernel wrappers compute on a CPU
  tensor) against the Pallas kernels it replaces, run in interpret mode, on
  the real query slots: within 1e-4 in float32, and within 2 bf16 ulps per
  (query, head) row with bf16 pages (the chip's gate; online vs global
  softmax round p to bf16 at different points);
- the forward on a prefill, a mixed and a decode step, in float32, with
  experts, a dense first layer and yarn rope, on the oracle (XLA) path and
  through the kernel wrappers against the reference's Pallas path: logits
  within 1e-4 and the cache pages outside the garbage page within 1e-5;
- the ``dispatch`` expert backend's forward against the reference's,
  its dropped assignments equal, at an ample and an overflowing capacity;
- ``TorchEngine(device="cpu")`` against ``JaxEngine(attn_impl="scan")``:
  identical greedy streams, with a prefix-cache hit and mixed steps, on
  both expert backends, with equal drop counts in ``stats()``;
- ``params_from_jax`` keeps ``router_bias`` float32, and ``init_params``
  builds the reference's tree.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import deepseek as jds
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.llama import make_pages as jmake_pages
from dynamo_tpu.ops.pallas.decode import (
    paged_decode_attention_stacked as jpallas_decode)
from dynamo_tpu.ops.pallas.mla_decode import (
    mla_paged_decode_stacked as jmla_decode)
from dynamo_tpu.ops.pallas.mla_prefill import (
    mla_paged_prefill_stacked as jmla_prefill)
from dynamo_tpu.ops.pallas.prefill import (
    paged_prefill_attention_stacked as jpallas_prefill)
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import (MLA_ATTENTION, TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import deepseek as tds
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.kernels.mla_decode import (mla_decode_plain,
                                                     mla_paged_decode_layer,
                                                     mla_paged_decode_stacked)
from dynamo_tpu_torch.ops.kernels.mla_prefill import (
    mla_paged_prefill_stacked)
from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)

# small CPU shapes: keep torch off the cores other test workers time on
torch.set_num_threads(2)

LOGIT_TOL = 1e-4
PAGE_TOL = 1e-5
F32_TOL = 1e-4
ULP_TOL = 2.0


def cfg_kw(**kw):
    """``tests/test_deepseek.py``'s ``ds_cfg(kv_lora_rank=128,
    head_dim=128)``, with yarn rope on (V2-Lite's factor and mscales)."""
    d = dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=1, head_dim=128,
        model_type="deepseek_v2", dtype="float32",
        q_lora_rank=0, kv_lora_rank=128, qk_rope_head_dim=16,
        qk_nope_head_dim=32, v_head_dim=32,
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
        n_shared_experts=2, first_k_dense_replace=1,
        routed_scaling_factor=1.0, rope_scaling_factor=40.0,
        rope_orig_max_position=64, rope_mscale=0.707,
        rope_mscale_all_dim=0.707, max_position_embeddings=2560)
    d.update(kw)
    return d


def _both(**kw):
    """(reference cfg, reference params, port cfg, port params)."""
    d = cfg_kw(**kw)
    jcfg, cfg = JModelConfig(**d), ModelConfig(**d)
    tree = jds.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    return jcfg, tree, cfg, tds.params_from_jax(np_tree, cfg, device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


# -- rope ---------------------------------------------------------------------


@pytest.mark.parametrize("yarn", [True, False])
def test_yarn_freqs_match_jax(yarn):
    kw = cfg_kw() if yarn else cfg_kw(rope_scaling_factor=0.0)
    jinv, jscale = jds.yarn_freqs(JModelConfig(**kw))
    inv, scale = tds.yarn_freqs(ModelConfig(**kw))
    assert inv.dtype == np.float32
    assert np.max(np.abs(inv - jinv)) <= 1e-6
    assert abs(scale - jscale) <= 1e-6


@pytest.mark.parametrize("interleaved", [True, False])
def test_rope_interleaved_matches_jax(interleaved):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 5)).astype(np.int32)
    inv, scale = jds.yarn_freqs(JModelConfig(**cfg_kw()))
    for kw in ({}, {"inv_freq": inv, "scale": scale}):
        ref = jds.rope_interleaved(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                                   interleaved=interleaved, **kw)
        got = tds.rope_interleaved(t(x), t(pos), 10000.0,
                                   interleaved=interleaved, **kw)
        assert float(np.max(np.abs(np.asarray(ref) - got.numpy()))) <= 2e-5


# -- gate ---------------------------------------------------------------------


@pytest.mark.parametrize("method", ["greedy", "group_limited_greedy",
                                    "noaux_tc"])
def test_gate_matches_jax(method):
    """Expert ids equal (ties included: duplicated router columns score
    exactly alike, and both packages take the lower id first), weights
    within 1e-6."""
    kw = cfg_kw(num_experts=8, num_experts_per_tok=3, n_group=4,
                topk_group=2, topk_method=method,
                norm_topk_prob=method == "noaux_tc",
                routed_scaling_factor=2.5)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(scale=0.3, size=(64, 8)).astype(np.float32)
    w[:, 5] = w[:, 2]          # exact ties across groups
    w[:, 7] = w[:, 6]          # and inside one
    x[0, 0] = 0.0              # all-equal scores on one token
    lp = {"w_router": w,
          "router_bias": rng.normal(scale=0.05, size=8).astype(np.float32)}
    jw, ji = jds._gate(jcfg, {k: jnp.asarray(v) for k, v in lp.items()},
                       jnp.asarray(x))
    tw, ti = tds._gate(cfg, {k: t(v) for k, v in lp.items()}, t(x))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert float(np.max(np.abs(np.asarray(jw) - tw.numpy()))) <= 1e-6


# -- the MLA kernels' plain version against the Pallas kernels ----------------


def _mla_case(dtype, seed=0, B=4, S=1):
    """``tests/test_deepseek.py:450``'s geometry: dkv=128, dr=16, nh=4,
    ps=8; slot 1 holds k_pe zero-padded to dkv."""
    rng = np.random.default_rng(seed)
    L, N, ps, dkv, dr, nh = 2, 40, 8, 128, 16, 4
    pages = rng.normal(size=(L, N, 2, 1, ps, dkv)).astype(np.float32)
    pages[:, :, 1, :, :, dr:] = 0.0
    if dtype == "bfloat16":
        pages = np.array(jnp.asarray(pages, jnp.bfloat16)
                         .astype(jnp.float32))
    P = 8
    table = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P)
    q_lat = rng.normal(size=(B, S, nh, dkv)).astype(np.float32)
    q_pe = rng.normal(size=(B, S, nh, dr)).astype(np.float32)
    tp = torch.from_numpy(pages).to(getattr(torch, dtype))
    return (pages, tp, q_lat, q_pe, table.astype(np.int32))


def _agree(ref, got, dtype, real=None):
    ref = torch.from_numpy(np.array(ref, np.float32))
    if real is not None:
        ref, got = ref[real], got[real]
    if dtype == "float32":
        assert float((ref - got).abs().max()) <= F32_TOL
    else:
        assert float(row_ulp_error(got, ref).max()) <= ULP_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_plain_matches_pallas(dtype):
    pages, tp, q_lat, q_pe, table = _mla_case(dtype)
    total = np.array([9, 17, 1, 64], np.int32)   # ctx 1 and a full table
    jpages = jnp.asarray(pages, jnp.dtype(dtype))
    for layer in range(2):
        ref = jmla_decode(jnp.asarray(q_lat), jnp.asarray(q_pe), jpages,
                          layer, jnp.asarray(table), jnp.asarray(total), 0.1,
                          interpret=True)
        got = mla_paged_decode_stacked(t(q_lat), t(q_pe), tp, layer,
                                       t(table), t(total), 0.1)
        assert got.dtype == torch.float32 and got.shape == (4, 1, 4, 128)
        _agree(ref, got, dtype)
    # the per-layer variant is the same function on one layer's buffer
    one = mla_paged_decode_layer(t(q_lat), t(q_pe), tp[1], t(table),
                                 t(total), 0.1)
    assert torch.equal(one, mla_decode_plain(t(q_lat), t(q_pe), tp, 1,
                                             t(table), t(total), 0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_plain_matches_pallas(dtype):
    """A fresh prompt, a deep-prefix continuation, a ragged short row and a
    decode row (q_len 1) in one batch; real slots compared, pad slots zero
    in the port (the Pallas kernel leaves finite garbage there)."""
    S = 16
    pages, tp, q_lat, q_pe, table = _mla_case(dtype, seed=1, S=S)
    start = np.array([0, 40, 3, 50], np.int32)
    new = np.array([S, S, 9, 1], np.int32)
    positions = (start[:, None] + np.arange(S)[None, :]).astype(np.int32)
    total = start + new
    jpages = jnp.asarray(pages, jnp.dtype(dtype))
    real = torch.arange(S)[None, :] < torch.from_numpy(new)[:, None]
    for layer in range(2):
        ref = jmla_prefill(jnp.asarray(q_lat), jnp.asarray(q_pe), jpages,
                           layer, jnp.asarray(table), jnp.asarray(positions),
                           jnp.asarray(total), 0.1, interpret=True)
        got = mla_paged_prefill_stacked(t(q_lat), t(q_pe), tp, layer,
                                        t(table), t(positions), t(total),
                                        0.1)
        _agree(ref, got, dtype, real)
        assert float(got[~real].abs().max()) == 0.0


def test_mla_plain_selects_away_nan_in_the_garbage_page():
    pages, tp, q_lat, q_pe, table = _mla_case("bfloat16", seed=2)
    tp[:, 0] = float("nan")
    table[:, 4:] = 0                       # unused entries -> page 0
    total = np.array([9, 17, 1, 32], np.int32)
    out = mla_paged_decode_stacked(t(q_lat), t(q_pe), tp, 1, t(table),
                                   t(total), 0.1)
    assert bool(torch.isfinite(out).all())


# -- the forward --------------------------------------------------------------


PS, P, N = 8, 16, 40


def _steps(vocab):
    """(name, tokens, positions, table, total, new): a prefill of two rows
    (one short, padded), a mixed step (row 0's next chunk over its cached
    prefix, which spans more than PAGES_PER_CHUNK pages of the table, next
    to row 1 decoding) and a decode step."""
    rng = np.random.default_rng(3)
    table = np.zeros((2, P), np.int32)
    table[0, :6] = np.arange(1, 7)
    table[1, :6] = np.arange(7, 13)
    prompt = rng.integers(0, vocab, size=(2, 40)).astype(np.int32)
    out = []
    toks = np.zeros((2, 24), np.int32)
    toks[0] = prompt[0, :24]
    toks[1, :13] = prompt[1, :13]
    pos = np.zeros((2, 24), np.int32)
    pos[0] = np.arange(24)
    pos[1, :13] = np.arange(13)
    out.append(("prefill", toks, pos, table, [24, 13], [24, 13]))
    toks = np.zeros((2, 16), np.int32)
    toks[0] = prompt[0, 24:40]
    toks[1, 0] = prompt[1, 13]
    pos = np.zeros((2, 16), np.int32)
    pos[0] = np.arange(24, 40)
    pos[1, 0] = 13
    out.append(("mixed", toks, pos, table, [40, 14], [16, 1]))
    out.append(("decode", np.array([[3], [4]], np.int32),
                np.array([[40], [14]], np.int32), table, [41, 15], [1, 1]))
    return out


@pytest.mark.parametrize("kernels", [False, True], ids=["oracle", "kernels"])
def test_forward_matches_jax(kernels):
    """Oracle: the port's ``_mla_attend``/``_mla_attend_blockwise`` against
    the reference's XLA path. Kernels: the engine's MLA wrappers (their
    plain versions on CPU tensors) against the reference's Pallas path
    (interpret mode), opted in by a GQA Pallas kernel's marker as the
    reference's engine does."""
    jcfg, jparams, cfg, tparams = _both()
    jpages = jmake_pages(jcfg, N, PS, dtype=jnp.float32)
    tpages = tds.make_pages(cfg, N, PS)
    for name, toks, pos, table, total, new in _steps(cfg.vocab_size):
        a = [np.asarray(x, np.int32) for x in (toks, pos, table, total, new)]
        jimpl = timpl = None
        if kernels:
            jimpl = jpallas_decode if name == "decode" else jpallas_prefill
            timpl = MLA_ATTENTION["mla_decode" if name == "decode"
                                  else "mla_prefill"]
        jl, jpages, _aux = jds.forward(
            jparams, jcfg, jnp.asarray(a[0]), jnp.asarray(a[1]), jpages,
            *(jnp.asarray(x) for x in a[2:]), attn_impl=jimpl)
        with torch.no_grad():
            tl, tpages, aux = tds.forward(
                tparams, cfg, *(torch.from_numpy(x) for x in a[:2]), tpages,
                *(torch.from_numpy(x) for x in a[2:]), attn_impl=timpl)
        assert int(aux["moe_dropped_assignments"]) == 0     # dense backend
        assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
        err = float(np.max(np.abs(np.asarray(jl) - tl.numpy())))
        assert err <= LOGIT_TOL, (name, err)
        # pages outside the garbage page 0, which holds pad slots' rows
        perr = float(np.max(np.abs(np.asarray(jpages)[:, 1:]
                                   - tpages.numpy()[:, 1:])))
        assert perr <= PAGE_TOL, (name, perr)


def test_forward_group_limited_gate_and_q_lora():
    """The other V2 parameterisation: a low-rank query (q_lora_rank) and the
    group-limited gate, on the oracle path, one prefill step."""
    jcfg, jparams, cfg, tparams = _both(
        q_lora_rank=48, topk_method="group_limited_greedy", n_group=2,
        topk_group=1, rope_interleave=False)
    name, toks, pos, table, total, new = _steps(cfg.vocab_size)[0]
    a = [np.asarray(x, np.int32) for x in (toks, pos, table, total, new)]
    jl, _, _ = jds.forward(jparams, jcfg, jnp.asarray(a[0]),
                           jnp.asarray(a[1]),
                           jmake_pages(jcfg, N, PS, dtype=jnp.float32),
                           *(jnp.asarray(x) for x in a[2:]))
    with torch.no_grad():
        tl, _, _ = tds.forward(tparams, cfg,
                               *(torch.from_numpy(x) for x in a[:2]),
                               tds.make_pages(cfg, N, PS),
                               *(torch.from_numpy(x) for x in a[2:]))
    assert float(np.max(np.abs(np.asarray(jl) - tl.numpy()))) <= LOGIT_TOL


@pytest.mark.parametrize("cf", [4.0, 0.3], ids=["ample", "overflow"])
def test_forward_dispatch_backend_matches_jax(cf):
    """The dispatch branch (``moe.expert_dispatch`` behind DeepSeek's gate
    and beside its shared experts) against the reference's, on the oracle
    path: logits within ``LOGIT_TOL`` and the summed drops equal, on a
    prefill whose 64-token rows pass ``_SMALL_BATCH_T`` (no capacity raise)
    and then the decode step. At an ample capacity nothing drops and the
    logits are the dense backend's; at 0.3 the prefill drops."""
    jcfg, jparams, cfg, tparams = _both(moe_backend="dispatch",
                                        moe_capacity_factor=cf)
    rng = np.random.default_rng(4)
    S = 40
    toks = rng.integers(1, cfg.vocab_size, size=(2, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    table = np.zeros((2, 16), np.int32)
    table[0, :6] = np.arange(1, 7)
    table[1, :6] = np.arange(7, 13)
    steps = [(toks, pos, [S, S], [S, S]),
             (np.array([[3], [4]], np.int32), np.array([[S], [S]], np.int32),
              [S + 1, S + 1], [1, 1])]
    jpages = jmake_pages(jcfg, N, PS, dtype=jnp.float32)
    tpages = tds.make_pages(cfg, N, PS)
    drops = []
    for tk, ps_, total, new in steps:
        a = [np.asarray(x, np.int32) for x in (tk, ps_, table, total, new)]
        jl, jpages, jaux = jds.forward(
            jparams, jcfg, jnp.asarray(a[0]), jnp.asarray(a[1]), jpages,
            *(jnp.asarray(x) for x in a[2:]))
        with torch.no_grad():
            tl, tpages, aux = tds.forward(
                tparams, cfg, *(torch.from_numpy(x) for x in a[:2]), tpages,
                *(torch.from_numpy(x) for x in a[2:]))
        assert float(np.max(np.abs(np.asarray(jl) - tl.numpy()))) \
            <= LOGIT_TOL
        got = int(aux["moe_dropped_assignments"])
        assert got == int(jaux["moe_dropped_assignments"])
        drops.append(got)
    assert (drops[0] > 0) == (cf < 1.0), drops
    assert drops[1] == 0          # T = 2 <= _SMALL_BATCH_T: C raised


# -- parameters and the family ------------------------------------------------


def test_params_from_jax_keeps_router_bias_f32():
    kw = cfg_kw(dtype="bfloat16", topk_method="noaux_tc", n_group=2,
                topk_group=1, model_type="deepseek_v3")
    tree = jds.init_params(JModelConfig(**kw), jax.random.PRNGKey(1))
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    np_tree["moe_layers"]["router_bias"] = np.full((2, 4), 1e-3 + 2 ** -20,
                                                   np.float32)
    got = tds.params_from_jax(np_tree, ModelConfig(**kw), device="cpu")
    bias = got["moe_layers"]["router_bias"]
    assert bias.dtype == torch.float32
    assert float(bias[0, 0]) == np.float32(1e-3 + 2 ** -20)
    assert got["moe_layers"]["w_gate"].dtype == torch.bfloat16
    assert got["dense_layers"]["wkv_a"].dtype == torch.bfloat16


@pytest.mark.parametrize("variant", [{}, {"topk_method": "noaux_tc",
                                          "n_group": 2, "topk_group": 1,
                                          "q_lora_rank": 48}])
def test_init_params_builds_the_reference_tree(variant):
    kw = cfg_kw(**variant)
    ref = jds.init_params(JModelConfig(**kw), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(5)
    got = tds.init_params(ModelConfig(**kw), gen, device="cpu")
    again = tds.init_params(ModelConfig(**kw),
                            torch.Generator().manual_seed(5), device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == sum(len(v) if isinstance(v, dict) else 1
                                for v in got.values())
    for path, leaf in flat_ref:
        keys = [p.key for p in path]
        mine = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        assert tuple(mine.shape) == leaf.shape, keys
        if keys[-1] == "router_bias":
            assert mine.dtype == torch.float32
    assert torch.equal(got["moe_layers"]["w_gate"],
                       again["moe_layers"]["w_gate"])
    assert not torch.equal(got["moe_layers"]["w_gate"][0],
                           got["moe_layers"]["w_gate"][1])


def test_get_family_and_unported_families():
    assert get_family(ModelConfig(**cfg_kw())) is tds
    assert get_family(ModelConfig(**cfg_kw(moe_backend="dispatch"))) is tds
    assert get_family(ModelConfig.tiny()).__name__.endswith(".llama")
    assert get_family(ModelConfig.tiny(num_experts=4, model_type="mixtral")
                      ).__name__.endswith(".moe")
    assert get_family(ModelConfig.tiny(model_type="gemma2")).__name__ \
        .endswith(".gemma")
    with pytest.raises(NotImplementedError, match="only gemma2"):
        get_family(ModelConfig.tiny(model_type="gemma3"))


# -- the engine ---------------------------------------------------------------


SIZES = dict(num_pages=64, page_size=8, max_num_seqs=4, max_prefill_chunk=16,
             max_context=128, min_prefill_bucket=4, mixed_batch=True,
             decode_progress_every=2)
MAX_TOKENS = {"r0": 10, "r1": 7, "r2": 6, "r3": 6}


def _prompts():
    rng = np.random.default_rng(12)
    p = {f"r{i}": list(map(int, rng.integers(1, 256, size=n)))
         for i, n in enumerate([40, 11, 7, 0])}
    # r3 shares r0's first 24 tokens: three full pages of 8
    p["r3"] = p["r0"][:24] + list(map(int, rng.integers(1, 256, size=5)))
    return p


async def _workload(engine, Req, Samp, Stop):
    prompts = _prompts()
    out = {}
    started = asyncio.Event()

    async def run(rid, wait=False):
        if wait:
            await started.wait()
        req = Req(token_ids=list(prompts[rid]), request_id=rid,
                  stop_conditions=Stop(max_tokens=MAX_TOKENS[rid]),
                  sampling_options=Samp(temperature=0.0))
        toks, last = [], None
        async for frame in engine.generate(req):
            toks += frame.token_ids
            last = frame
            if rid == "r0" and len(toks) >= 2:
                started.set()
        started.set()
        out[rid] = (toks, last.finish_reason.value, last.cached_tokens)

    try:
        await asyncio.gather(run("r0"), run("r1"), run("r2", wait=True))
        await run("r3")
    finally:
        await engine.stop()
    return out


async def _both_engines(backend):
    """(reference results, port results, JaxEngine, TorchEngine) of
    ``_workload`` per step on one expert backend; ``dispatch`` at a
    capacity factor of 0.5 and 64-token chunks, so the steps of more than
    ``_SMALL_BATCH_T`` padded tokens drop, the port on its oracle attention
    (pad slots route and take capacity, so their hidden states must be the
    reference's: the family's own attention, ``attn_impl`` None, computes
    them as the XLA path does, where the kernels' plain versions zero them;
    ROADMAP Queue C)."""
    extra, sizes = {}, SIZES
    if backend == "dispatch":
        extra = dict(moe_backend="dispatch", moe_capacity_factor=0.5)
        sizes = dict(SIZES, max_prefill_chunk=64)
    jcfg, jparams, cfg, tparams = _both(**extra)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        attn_impl="scan", decode_multistep=1, pipeline_decode=False,
        **sizes))
    teng = TorchEngine(cfg, tparams, TorchEngineConfig(
        decode_multistep=1, pipeline_decode=False, **sizes),
                       device="cpu")
    if backend == "dispatch":
        teng._attn = dict.fromkeys(teng._attn)
    ref = await _workload(jeng, JRequest, JSampling, JStop)
    got = await _workload(teng, TRequest, TSampling, TStop)
    for rid in MAX_TOKENS:
        assert got[rid][:2] == ref[rid][:2], rid
        assert len(got[rid][0]) == MAX_TOKENS[rid]
    assert got["r3"][2] == ref["r3"][2] > 0          # the prefix-cache hit
    assert teng.mixed_steps > 0
    assert set(teng.kernel_launches) == {"mla_decode", "mla_prefill"}
    return ref, got, jeng, teng


@pytest.mark.async_timeout(240)
async def test_engine_greedy_streams_match_jax_engine():
    _ref, _got, _jeng, teng = await _both_engines("dense")
    assert all(n > 0 for n in teng.kernel_launches.values()), \
        teng.kernel_launches
    assert teng.stats().worker_stats.moe_dropped_tokens == 0


@pytest.mark.async_timeout(240)
async def test_engine_dispatch_streams_and_drops_match_jax_engine():
    """The dispatch backend per step: the same tokens, and the same
    dropped assignments in ``stats()``."""
    _ref, _got, jeng, teng = await _both_engines("dispatch")
    dropped = teng.stats().worker_stats.moe_dropped_tokens
    assert dropped == jeng.stats().worker_stats.moe_dropped_tokens > 0


def test_engine_random_init_serves_deepseek_on_cpu():
    cfg = ModelConfig(**cfg_kw())
    eng = TorchEngine.random_init(cfg, TorchEngineConfig(**SIZES), seed=3,
                                  device="cpu")
    assert eng.pages.shape == (3, 64, 2, 1, 8, 128)

    async def one():
        req = TRequest(token_ids=list(range(1, 20)), request_id="x",
                       stop_conditions=TStop(max_tokens=3),
                       sampling_options=TSampling(temperature=0.0))
        frames = [f async for f in eng.generate(req)]
        await eng.stop()
        return frames

    frames = asyncio.run(one())
    assert sum(len(f.token_ids) for f in frames) == 3
    assert frames[-1].finish_reason.value == "length"


def test_deepseek_v2_lite_config():
    """The published V2-Lite geometry, parsed by the port's ``from_hf``,
    and its yarn rope equal to the reference's on the same fields."""
    import dataclasses
    cfg = ModelConfig.deepseek_v2_lite()
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.vocab_size) == (27, 2048, 16, 102400)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_head_dim,
            cfg.qk_nope_head_dim, cfg.v_head_dim) == (0, 512, 64, 128, 128)
    assert (cfg.first_k_dense_replace, cfg.intermediate_size,
            cfg.num_experts, cfg.moe_intermediate_size,
            cfg.n_shared_experts, cfg.num_experts_per_tok,
            cfg.topk_method, cfg.norm_topk_prob) == (
                1, 10944, 64, 1408, 2, 6, "greedy", False)
    assert (cfg.rope_scaling_factor, cfg.rope_mscale,
            cfg.rope_mscale_all_dim, cfg.rope_orig_max_position) == (
                40.0, 0.707, 0.707, 4096)
    assert (cfg.num_kv_heads, cfg.head_dim, cfg.tie_word_embeddings) == (
        1, 512, False)
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jinv, jscale = jds.yarn_freqs(jcfg)
    inv, scale = tds.yarn_freqs(cfg)
    assert np.array_equal(inv, jinv) and scale == jscale
    assert tds._mla_scale(cfg) == jds._mla_scale(jcfg)


def test_engine_refuses_geometry_the_kernels_do_not_take(monkeypatch):
    """On the GPU the engine refuses, at construction, a config the latent
    kernels cannot run (here 4 heads: they take groups of 16) instead of
    serving it through the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = ModelConfig(**cfg_kw(dtype="bfloat16"))
    with pytest.raises(ValueError, match="num_heads=4"):
        TorchEngine(cfg, {}, TorchEngineConfig(**SIZES), device="cuda")
