"""The port's MoE family (``dynamo_tpu_torch/models/moe.py``: mixtral,
qwen3-MoE) and its capacity-dispatch backend against ``dynamo_tpu``'s, on
the CPU, in float32 from the same numpy weights (the reference's
``init_params``, handed over as numpy); ``tests/test_moe.py`` without the
expert mesh.

- The router (softmax, top-k, renorm): the same expert ids, weights within
  1e-6; the dense backend's ``moe_mlp`` within ``MLP_TOL``.
- The dispatch backend: equal to the dense one where capacity holds every
  assignment; under overflow the dropped assignments EQUAL to the
  reference's and to a numpy replay of the capacity rule, at step sizes
  either side of ``_SMALL_BATCH_T`` (the 4x capacity raise), the output
  within ``MLP_TOL`` (the combine sums each token's k contributions in a
  fixed order, the reference scatter-adds them over tokens: float32
  rounding apart).
- ``forward`` on a prefill, a mixed and a decode step: logits within
  ``LOGIT_TOL``, cache pages within ``PAGE_TOL``, per-step drops equal.
- ``TorchEngine(device="cpu")`` against ``JaxEngine(attn_impl="scan")``,
  mixtral per step and qwen3-MoE with the reference's decode defaults
  (pipelined, fused blocks of up to 8): greedy streams token for token,
  logprobs within 2e-6 relative, the dispatch counters equal, on both
  backends, and ``moe_dropped_tokens`` equal in ``stats()``. Pad slots
  take capacity, so the dispatch engines serve the port through its oracle
  attention (the reference's XLA path: the kernels' plain versions zero
  pad query slots, ROADMAP Queue C);
  ``test_dispatch_drops_on_pad_slots_follow_attention`` shows the
  difference that makes.
- A fused block's drop count (an output of its graph on the card) equal to
  the sum over the same steps run one forward at a time.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import moe as jmoe
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.llama import make_pages as jmake_pages
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import (ATTENTION, TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)

# small CPU shapes: keep torch off the cores other test workers time on
torch.set_num_threads(2)

MLP_TOL = 1e-6
LOGIT_TOL = 1e-4
PAGE_TOL = 1e-5
LOGPROB_RTOL = 2e-6
PS, N = 4, 32
FAMILIES = ("mixtral", "qwen3_moe")


def cfg_kw(model_type="qwen3_moe", **kw):
    """``tests/test_moe.py``'s ``moe_cfg`` at 8 experts, top-2."""
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             max_position_embeddings=512, dtype="float32", num_experts=8,
             num_experts_per_tok=2, moe_intermediate_size=32,
             model_type=model_type, qk_norm=model_type == "qwen3_moe")
    d.update(kw)
    return d


@functools.lru_cache(maxsize=None)
def _tree(model_type):
    """The reference's params (from PRNGKey 0) and their numpy tree."""
    params = jmoe.init_params(JModelConfig(**cfg_kw(model_type)),
                              jax.random.PRNGKey(0))
    return params, jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), params)


def _both(model_type="qwen3_moe", **kw):
    """(reference cfg, reference params, port cfg, port params)."""
    d = cfg_kw(model_type, **kw)
    params, np_tree = _tree(model_type)
    cfg = ModelConfig(**d)
    return (JModelConfig(**d), params, cfg,
            tmoe.params_from_jax(np_tree, cfg, device="cpu"))


def _layer0(params):
    return {k: v[0] for k, v in params["layers"].items()}


def _x(T, seed=1, H=64):
    return np.random.default_rng(seed).standard_normal(
        (1, T, H)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# -- the family, the router and the two backends ------------------------------


def test_get_family_routes_the_moe_family():
    for mt in FAMILIES:
        assert get_family(ModelConfig(**cfg_kw(mt))) is tmoe
        assert get_family(ModelConfig(**cfg_kw(
            mt, moe_backend="dispatch"))) is tmoe


@pytest.mark.parametrize("norm", [True, False])
def test_router_topk_matches_jax(norm):
    jcfg, jp, cfg, tp = _both(norm_topk_prob=norm)
    x = _x(24)
    jw, ji = jmoe._router_topk(jcfg, _layer0(jp), jnp.asarray(x))
    tw, ti = tmoe._router_topk(cfg, _layer0(tp), t(x))
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert float(np.max(np.abs(np.asarray(jw) - tw.numpy()))) <= 1e-6
    sums = tw.sum(-1)
    assert bool(torch.allclose(sums, torch.ones_like(sums))) == norm


@pytest.mark.parametrize("model_type", FAMILIES)
def test_moe_mlp_matches_jax(model_type):
    jcfg, jp, cfg, tp = _both(model_type)
    x = _x(24, seed=2)
    want = np.asarray(jmoe.moe_mlp(jcfg, _layer0(jp), jnp.asarray(x)))
    got = tmoe.moe_mlp(cfg, _layer0(tp), t(x)).numpy()
    assert np.max(np.abs(want - got)) <= MLP_TOL


def test_dense_backend_chunks_tokens(monkeypatch):
    """The dense backend's token chunks (``_DENSE_CHUNK_BYTES``) change
    nothing: a budget of one token per chunk gives the same output."""
    _j, _jp, cfg, tp = _both()
    x = t(_x(24, seed=3))
    whole = tmoe.moe_mlp(cfg, _layer0(tp), x)
    monkeypatch.setattr(tmoe, "_DENSE_CHUNK_BYTES", 1)
    assert torch.allclose(tmoe.moe_mlp(cfg, _layer0(tp), x), whole,
                          rtol=0, atol=MLP_TOL)


def test_dispatch_equals_dense_at_ample_capacity():
    jcfg, jp, cfg, tp = _both(moe_backend="dispatch",
                              moe_capacity_factor=4.0)
    x = t(_x(96, seed=4))
    out, dropped = tmoe.moe_mlp_dispatch(cfg, _layer0(tp), x)
    assert int(dropped) == 0 and dropped.dtype == torch.int32
    dense = tmoe.moe_mlp(cfg, _layer0(tp), x)
    assert float((out - dense).abs().max()) <= MLP_TOL


@pytest.mark.parametrize("T", [16, 64, 65, 96, 200])
def test_dispatch_drops_equal_jax(T):
    """At a capacity factor of 0.3: the reference's drop count exactly, and
    a numpy replay's (per-expert routed counts past ``C``); the 4x raise
    keeps T <= 64 from dropping at all. Output within ``MLP_TOL``."""
    jcfg, jp, cfg, tp = _both(moe_backend="dispatch",
                              moe_capacity_factor=0.3)
    x = _x(T, seed=T)
    jout, jdrop = jmoe.moe_mlp_dispatch(jcfg, _layer0(jp), jnp.asarray(x))
    out, dropped = tmoe.moe_mlp_dispatch(cfg, _layer0(tp), t(x))
    assert int(dropped) == int(jdrop)
    assert float(np.max(np.abs(np.asarray(jout) - out.numpy()))) <= MLP_TOL
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    C = tmoe.capacity(T, k, E, 0.3)
    _w, top_i = tmoe._router_topk(cfg, _layer0(tp), t(x).reshape(T, -1))
    counts = np.bincount(top_i.numpy().reshape(-1), minlength=E)
    assert int(dropped) == int(np.maximum(counts - C, 0).sum())
    assert (int(dropped) > 0) == (T > tmoe._SMALL_BATCH_T), int(dropped)


def test_small_batch_capacity_raise():
    """T <= 64: capacity raised to 4x the expected load, so a tight factor
    drops nothing and dispatch equals dense."""
    _j, _jp, cfg, tp = _both(moe_backend="dispatch", moe_capacity_factor=0.3)
    assert tmoe.capacity(16, 2, 8, 0.3) == 16
    assert tmoe.capacity(96, 2, 8, 0.3) == 8
    assert tmoe.capacity(1, 8, 128, 2.0) == 1
    x = t(_x(16, seed=5))
    out, dropped = tmoe.moe_mlp_dispatch(cfg, _layer0(tp), x)
    assert int(dropped) == 0
    dense = tmoe.moe_mlp(cfg, _layer0(tp), x)
    assert float((out - dense).abs().max()) <= MLP_TOL


# -- the forward -----------------------------------------------------------------


def _steps(V):
    """A prefill of two 40-token rows (80 tokens: past the capacity raise,
    no pad slot), a mixed step (row 0 a 16-token chunk, row 1 one token)
    and a decode step, on pages of 4 positions."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, V, size=(2, 56)).astype(np.int32)
    table = np.zeros((2, 16), np.int32)
    table[0, :15] = np.arange(1, 16)
    table[1, :15] = np.arange(16, 31)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    out = [(prompt[:, :40], pos, table, [40, 40], [40, 40])]
    toks = np.zeros((2, 16), np.int32)
    toks[0] = prompt[0, 40:56]
    toks[1, 0] = prompt[1, 40]
    pos = np.zeros((2, 16), np.int32)
    pos[0] = np.arange(40, 56)
    pos[1, 0] = 40
    out.append((toks, pos, table, [56, 41], [16, 1]))
    out.append((np.array([[3], [4]], np.int32),
                np.array([[56], [41]], np.int32), table, [57, 42], [1, 1]))
    return out


@pytest.mark.parametrize("model_type,backend,kernels", [
    ("mixtral", "dense", False), ("qwen3_moe", "dense", False),
    ("mixtral", "dispatch", False), ("qwen3_moe", "dispatch", False),
    ("qwen3_moe", "dense", True)])
def test_forward_matches_jax(model_type, backend, kernels):
    """The port's forward against ``jmoe.forward`` (XLA attention) at a
    capacity factor of 0.5; ``kernels``: through the engine's kernel
    wrappers (their plain versions on CPU tensors), on the dense backend,
    where pad slots take no capacity."""
    jcfg, jp, cfg, tp = _both(model_type, moe_backend=backend,
                              moe_capacity_factor=0.5)
    jpages = jmake_pages(jcfg, N, PS, dtype=jnp.float32)
    tpages = tmoe.make_pages(cfg, N, PS)
    drops = []
    for i, (toks, pos, table, total, new) in enumerate(_steps(cfg.vocab_size)):
        a = [np.asarray(v, np.int32) for v in (toks, pos, table, total, new)]
        jl, jpages, jaux = jmoe.forward(
            jp, jcfg, jnp.asarray(a[0]), jnp.asarray(a[1]), jpages,
            *(jnp.asarray(v) for v in a[2:]))
        impl = None
        if kernels:
            impl = ATTENTION["paged_decode" if i == 2 else
                             "ragged_mixed" if i == 1 else "paged_prefill"]
        with torch.no_grad():
            tl, tpages, aux = tmoe.forward(
                tp, cfg, t(a[0]), t(a[1]), tpages, *(t(v) for v in a[2:]),
                attn_impl=impl)
        assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
        assert float(np.max(np.abs(np.asarray(jl) - tl.numpy()))) \
            <= LOGIT_TOL, i
        perr = float(np.max(np.abs(np.asarray(jpages)[:, 1:]
                                   - tpages.numpy()[:, 1:])))
        assert perr <= PAGE_TOL, (i, perr)
        got = aux["moe_dropped_assignments"]
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(jaux["moe_dropped_assignments"]), i
        drops.append(int(got))
    # the 80-token prefill overflows; decode (T = 2) cannot
    assert (drops[0] > 0) == (backend == "dispatch") and drops[2] == 0


def test_init_params_builds_the_reference_tree():
    kw = cfg_kw(attention_bias=True)
    ref = jmoe.init_params(JModelConfig(**kw), jax.random.PRNGKey(0))
    got = tmoe.init_params(ModelConfig(**kw), torch.Generator().manual_seed(5),
                           device="cpu")
    again = tmoe.init_params(ModelConfig(**kw),
                             torch.Generator().manual_seed(5), device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == sum(len(v) if isinstance(v, dict) else 1
                                for v in got.values())
    for path, leaf in flat_ref:
        keys = [p.key for p in path]
        mine = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        assert tuple(mine.shape) == leaf.shape, keys
    assert torch.equal(got["layers"]["w_gate"], again["layers"]["w_gate"])
    assert not torch.equal(got["layers"]["w_gate"][0],
                           got["layers"]["w_gate"][1])


def test_qwen3_30b_a3b_config():
    """The published Qwen3-30B-A3B geometry through ``from_hf``: the same
    fields as the reference's parse of the same ``config.json`` values, and
    30.5 B parameters."""
    cfg = ModelConfig.qwen3_30b_a3b()
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (48, 2048, 32, 4, 128, 151936)
    assert (cfg.num_experts, cfg.num_experts_per_tok,
            cfg.moe_intermediate_size, cfg.norm_topk_prob, cfg.qk_norm,
            cfg.tie_word_embeddings) == (128, 8, 768, True, True, False)
    assert (cfg.rope_theta, cfg.rms_norm_eps,
            cfg.max_position_embeddings) == (1e6, 1e-6, 40960)
    assert get_family(cfg) is tmoe
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    shapes = jax.eval_shape(
        lambda: jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert 30.5e9 < n < 30.6e9, n


# -- the engine -----------------------------------------------------------------


SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=64,
             max_context=128, min_prefill_bucket=4)
MAX_TOKENS = (9, 6, 13)


def _requests(classes):
    Req, Samp, Stop = classes
    rng = np.random.default_rng(11)
    lens = (40, 9, 23)
    return [Req(token_ids=list(map(int, rng.integers(1, 256, size=n))),
                request_id=f"r{i}",
                stop_conditions=Stop(max_tokens=m),
                sampling_options=Samp(temperature=0.0))
            for i, (n, m) in enumerate(zip(lens, MAX_TOKENS))]


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
            "chained_steps": eng.chained_steps}


# mixtral serves per step, qwen3-MoE with the reference's decode defaults
# (pipelined, fused blocks of up to 8 steps)
MODES = {"mixtral": dict(decode_multistep=1, pipeline_decode=False),
         "qwen3_moe": {}}


@functools.lru_cache(maxsize=None)
def _reference(model_type, backend):
    """The three requests served on ``JaxEngine(attn_impl="scan")`` in
    ``MODES[model_type]``: (results, counters, dropped assignments)."""
    jcfg, jp, _cfg, _tp = _both(model_type, moe_backend=backend,
                                moe_capacity_factor=0.5)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="scan", **SIZES,
                                               **MODES[model_type]))
    ref = asyncio.run(_serve(jeng, _requests((JRequest, JSampling, JStop))))
    return ref, counters(jeng), jeng.stats().worker_stats.moe_dropped_tokens


def serve_both(model_type, backend, oracle):
    """The reference's serve (``_reference``) and the same requests on
    ``TorchEngine`` in the same mode (``oracle``: through the port's oracle
    attention, the reference's XLA path, instead of the kernels' plain
    versions); returns (reference results, counters and drops, port
    results, port engine)."""
    _j, _jp, cfg, tp = _both(model_type, moe_backend=backend,
                             moe_capacity_factor=0.5)
    teng = TorchEngine(cfg, tp, TorchEngineConfig(**SIZES,
                                                  **MODES[model_type]),
                       device="cpu")
    if oracle:
        teng._attn = dict.fromkeys(teng._attn)
    ref, ref_counters, ref_drops = _reference(model_type, backend)
    got = asyncio.run(_serve(teng, _requests((TRequest, TSampling, TStop))))
    return ref, ref_counters, ref_drops, got, teng


@pytest.mark.parametrize("model_type,backend", [
    ("mixtral", "dense"), ("qwen3_moe", "dense"), ("mixtral", "dispatch"),
    ("qwen3_moe", "dispatch")])
def test_engine_streams_match_jax_engine(model_type, backend):
    ref, ref_counters, ref_drops, got, teng = serve_both(
        model_type, backend, oracle=backend == "dispatch")
    for (rt, rl, rf), (gt, gl, gf), m in zip(ref, got, MAX_TOKENS):
        assert gt == rt and gf == rf, (ref, got)
        assert len(gt) == m
        np.testing.assert_allclose(gl, rl, rtol=LOGPROB_RTOL, atol=0)
    assert counters(teng) == ref_counters
    assert teng.mixed_steps > 0
    assert (teng.multistep_blocks > 0) == (model_type == "qwen3_moe")
    dropped = teng.stats().worker_stats.moe_dropped_tokens
    assert dropped == ref_drops
    assert (dropped > 0) == (backend == "dispatch"), dropped
    if backend == "dense":
        assert all(n > 0 for n in teng.kernel_launches.values()), \
            teng.kernel_launches
    assert not teng._pending_moe_drops


def test_dispatch_drops_on_pad_slots_follow_attention():
    """Pad query slots route and take dispatch capacity in both packages.
    Through the kernels' plain versions (the engine's attention on the CPU,
    as on the card) a pad slot's attention is zero, where the reference's
    XLA path attends it to position 0: the tokens agree, but the drop count
    is not the reference's (ROADMAP Queue C)."""
    ref, _c, theirs, got, teng = serve_both("qwen3_moe", "dispatch",
                                            oracle=False)
    assert [g[0] for g in got] == [r[0] for r in ref]
    assert all(n > 0 for n in teng.kernel_launches.values())
    mine = teng.stats().worker_stats.moe_dropped_tokens
    assert mine > 0 and theirs > 0 and mine != theirs, (mine, theirs)


def test_fused_block_drops_equal_the_per_step_sum():
    """One fused block of 4 greedy steps at B = 8 on 16 experts (five rows
    on one token: decode-size steps overflow the raised capacity of
    ``ceil(4 * 8 * 2 / 16) = 4``) against the same
    steps run one forward at a time from a copy of the cache, feeding each
    step the tokens the block sampled: the block's ``drops`` output is the
    sum of the steps' ``moe_dropped_assignments``."""
    cfg = ModelConfig(**cfg_kw(num_experts=16, moe_backend="dispatch",
                               moe_capacity_factor=0.5))
    tp = tmoe.init_params(cfg, torch.Generator().manual_seed(2), scale=0.2,
                          device="cpu")
    eng = TorchEngine(cfg, tp, TorchEngineConfig(**SIZES), device="cpu")
    B, w, ctx = 8, 4, 10
    i32 = dict(dtype=torch.int32)
    table = torch.zeros((B, eng.table_width), **i32)
    per = -(-(ctx + w) // PS)
    table[:, :per] = 1 + torch.arange(B * per, **i32).reshape(B, per)
    tok = torch.tensor([[5]] * 5 + [[17], [99], [200]], **i32)
    x = {"table": table, "tok": tok, "pos": torch.full((B, 1), ctx - 1, **i32),
         "total": torch.full((B,), ctx, **i32),
         "alive": torch.ones(B, dtype=torch.bool),
         "budget": torch.full((B,), 100, **i32),
         "min_gate": torch.zeros(B, **i32),
         "stop_ids": torch.full((B, 1), -1, **i32),
         "temp": torch.zeros(B), "top_k": torch.zeros(B, **i32),
         "top_p": torch.ones(B), "step0": torch.tensor(0)}
    saved = eng.pages.clone()
    out = eng._block(x, w, False)
    sampled = out["packed"][:, :, 0]
    pages = saved.clone()
    total = 0
    feed = tok
    for j in range(w):
        with torch.no_grad():
            _l, _p, aux = tmoe.forward(
                tp, cfg, feed, torch.full((B, 1), ctx - 1 + j, **i32), pages,
                table, torch.full((B,), ctx + j, **i32),
                torch.ones(B, **i32), attn_impl=eng._attn["paged_decode"])
        total += int(aux["moe_dropped_assignments"])
        feed = sampled[:, j:j + 1].contiguous()
    assert total > 0
    assert int(out["drops"]) == total
    assert torch.equal(pages, eng.pages)


@pytest.mark.parametrize("backend", [None, "dense", "dispatch"])
def test_worker_passes_the_moe_backend(tmp_path, backend):
    """``--moe-backend`` replaces a MoE checkpoint's expert backend in the
    worker's engine, as the reference's worker does (no flag: the config's
    ``dense``)."""
    import json
    from dynamo_tpu_torch.worker.main import build_engine, build_parser
    hf = dict(model_type="qwen3_moe", vocab_size=256, hidden_size=64,
              intermediate_size=128, moe_intermediate_size=32,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, num_experts=8,
              num_experts_per_tok=2, max_position_embeddings=512)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    argv = ["--model-path", str(tmp_path), "--random-weights", "--device",
            "cpu", "--dtype", "float32", "--num-pages", "16",
            "--max-context", "64"]
    if backend:
        argv += ["--moe-backend", backend]
    eng = build_engine(build_parser().parse_args(argv))
    assert get_family(eng.model_cfg) is tmoe
    assert eng.model_cfg.moe_backend == (backend or "dense")
    assert eng._moe_dispatch_active == (backend == "dispatch")
