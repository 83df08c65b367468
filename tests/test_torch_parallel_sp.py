"""Sequence parallelism of the port against the JAX package's sp meshes, on
the CPU.

- In process (no process group): the sharding helpers split nothing over
  ``sp`` (``ModelSharding``'s specs and the cache's ``shard_layout`` equal
  the reference's on sp=2, sp=2 x tp=2 and sp=2 x dp=2 meshes; the local
  config, the engine's transport splits and its KV block are what tp and
  dp alone give), and ``TorchEngine`` on those meshes takes the
  reference's ring threshold and batch floors; it refuses the families
  whose ring step the reference cannot run (MoE, Gemma-2, DeepSeek: each
  fails in ``JaxEngine`` at its first ring step, the stream ending in an
  error), naming the family.
- Rank worlds of 2 and 4 (``tests/torch_parallel_ranks.py``, started as
  processes; this process starts no process group), while this process
  runs the reference on the conftest's 8 virtual devices:
  ``RankMesh.rotate`` round rings of 2 and 4; ``ring_self_attention``
  against the reference's at sp = 2 and 4, with 4/4 and 8/2 heads, a
  padded row, whole and as partials, and with its heads over ``tp`` at
  sp=2 x tp=2 (float32, within ``ATTN_TOL``); ``ring_prefill`` against
  the reference's on ``MeshSpec(sp=4)`` and ``MeshSpec(sp=2, tp=2)``:
  the logits and every rank's cache (page 0 excluded) within
  ``RING_TOL`` (the reference's own tolerance), with a 5-token pad on
  one row, and a resident prefix written by a chunked step first;
  ``TorchEngine`` on sp=2, sp=2 x tp=2 and sp=2 x dp=2 worlds against
  ``JaxEngine`` on the same meshes: a long prompt takes one ring step,
  a short one stays chunked, a prefix hit's long tail rides the ring,
  a seeded draw on a long prompt too, the streams token-equal, every
  rank runs the decode and chunked-prefill kernels' wrappers, and the
  replicas' caches are byte-equal; on the sp=2 world the KV data plane:
  its merged frames inject byte-equal into a one-rank engine and back,
  and every scatter reaches both replicas whole.
- A ``--sequence-parallel-size 2`` worker serves a chat over HTTP in one
  ring step, and its repeat from the prefix cache.
"""

import asyncio
import dataclasses
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dynamo_tpu.parallel.ring_attention import \
    ring_self_attention as jring_self_attention
from dynamo_tpu.parallel.ring_prefill import ring_prefill as jring_prefill
from dynamo_tpu.parallel.sharding import ModelSharding as JModelSharding
from dynamo_tpu.parallel.sharding import shard_layout as jshard_layout
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import TorchEngine, \
    TorchEngineConfig
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.parallel.mesh import MeshSpec, RankMesh, coords_rank
from dynamo_tpu_torch.parallel.sharding import (ModelSharding, Sharding,
                                                cache_spec, local_config,
                                                shard_layout)
from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel import (HELPER, REPO, _jmesh, _kw,
                                       _specs_equal, _tree, _world_spec)

torch.set_num_threads(2)

# float32: the ring's online softmax against the reference's, one merge
# order apart
ATTN_TOL = 1e-5
# the reference's own tolerance for ring_prefill
# (tests/test_ring_serving.py)
RING_TOL = 2e-4
SP2, SP4 = dict(sp=2), dict(sp=4)
SP2TP2, SP2DP2 = dict(tp=2, sp=2), dict(dp=2, sp=2)
# the engines' sizes: the reference's TestRingWithPrefix (chunks of 8, a
# ring past 16 remaining tokens), fused decode at its default
SP_ENGINE = dict(num_pages=96, page_size=4, max_num_seqs=2,
                 max_prefill_chunk=8, max_context=256, min_prefill_bucket=8,
                 ring_threshold=16)
# the KV plane's engine: prompt a (26 tokens) rides the ring, b (a and
# 5 more) is a prefix hit under the threshold
KV_ENGINE = dict(num_pages=64, page_size=4, max_num_seqs=2,
                 max_prefill_chunk=8, max_context=128, min_prefill_bucket=8,
                 ring_threshold=16)
PS = 4


def _cid(mesh):
    return "".join(f"{k}{v}" for k, v in mesh.items())


def _size(mesh):
    return int(np.prod(list(mesh.values())))


# -- ring attention ---------------------------------------------------------------

# (mesh, heads (Hq, Hkv), partials, head_axis)
ATTN = [(m, h, part, None) for m in (SP2, SP4)
        for h in ((4, 4), (8, 2)) for part in (False, True)]
ATTN += [(SP2TP2, (8, 2), part, "tp") for part in (False, True)]


def _attn_id(c):
    mesh, (hq, hkv), part, head = c
    return (f"{_cid(mesh)}-{hq}x{hkv}-{'partials' if part else 'out'}"
            + (f"-heads-over-{head}" if head else ""))


def _attn_inputs(hq, hkv, seed=3):
    """q/k/v [2, 16, H, 16] from a numpy seed; row 1 has 5 pad positions
    (``valid`` False)."""
    rng = np.random.default_rng(seed)
    B, S, D = 2, 16, 16
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    valid = np.ones((B, S), bool)
    valid[1, S - 5:] = False
    return dict(q=rng.normal(size=(B, S, hq, D)).astype(np.float32),
                k=rng.normal(size=(B, S, hkv, D)).astype(np.float32),
                v=rng.normal(size=(B, S, hkv, D)).astype(np.float32),
                pos=pos, valid=valid)


def _ref_attention(mesh, heads, partials, head_axis):
    x = _attn_inputs(*heads)
    out = jring_self_attention(
        _jmesh(JMeshSpec(**mesh)), *(jnp.asarray(x[k]) for k in "qkv"),
        jnp.asarray(x["pos"]), kv_valid=jnp.asarray(x["valid"]),
        head_axis=head_axis, return_partials=partials)
    if partials:
        return [np.asarray(o) for o in out]
    return np.asarray(out)


# -- ring prefill -----------------------------------------------------------------

# (case, mesh, resident prefix)
PREFILL = [("sp4", SP4, False), ("sp2tp2", SP2TP2, False),
           ("sp2tp2-prefix", SP2TP2, True)]
PB, PS_LEN, NPAGES = 2, 32, 32


def _prefill_steps(prefix: bool):
    """B=2 rows of 32 positions on 8 pages each; row 1 has 5 fewer real
    tokens. With ``prefix``, a chunked step writes both rows' first 16
    positions, then the ring prefills the rest over that resident
    prefix."""
    rng = np.random.default_rng(7)
    table_w = PS_LEN // PS
    table = np.arange(1, 1 + PB * table_w, dtype=np.int32).reshape(
        PB, table_w)
    toks = rng.integers(0, 256, size=(PB, PS_LEN)).astype(np.int32)
    pos = np.tile(np.arange(PS_LEN, dtype=np.int32)[None], (PB, 1))
    if not prefix:
        new = np.array([PS_LEN, PS_LEN - 5], np.int32)
        return [dict(tokens=toks, positions=pos, table=table, total=new,
                     new=new, ring=True)]
    h = PS_LEN // 2
    first = np.array([h, h], np.int32)
    rest = np.array([h, h - 5], np.int32)
    return [dict(tokens=toks[:, :h], positions=pos[:, :h], table=table,
                 total=first, new=first, ring=False),
            dict(tokens=toks[:, h:], positions=pos[:, h:], table=table,
                 total=h + rest, new=rest, ring=True)]


def _ref_prefill(mesh, prefix):
    """The reference's steps under jit: its ``llama.forward`` for a
    chunked step, its ``ring_prefill`` for a ring step, on its mesh with
    the weights placed by ``ModelSharding``."""
    jcfg, params, _cfg, _t = _tree("llama")
    jmesh = _jmesh(JMeshSpec(**mesh))
    params = JModelSharding(jcfg, jmesh).shard_params(params)
    pages = jllama.make_pages(jcfg, NPAGES, PS, dtype=jnp.float32)
    logits = []
    for st in _prefill_steps(prefix):
        a = [jnp.asarray(st[k]) for k in ("tokens", "positions")]
        b = [jnp.asarray(st[k]) for k in ("table", "total", "new")]
        if st["ring"]:
            fn = jax.jit(lambda p, pg, *x: jring_prefill(
                p, jcfg, x[0], x[1], pg, x[2], x[3], x[4], mesh=jmesh))
        else:
            fn = jax.jit(lambda p, pg, *x: jllama.forward(
                p, jcfg, x[0], x[1], pg, x[2], x[3], x[4]))
        lg, pages = fn(params, pages, *a, *b)
        logits.append(np.asarray(lg))
    return logits, np.asarray(pages)


# -- engines ----------------------------------------------------------------------

ENGINES = [SP2, SP2TP2, SP2DP2]


def _jax_sp_engine(mesh, sizes=SP_ENGINE):
    jcfg = JModelConfig(**_kw("llama"))
    params = jax.tree_util.tree_map(jnp.asarray, _tree("llama")[3])
    js = JModelSharding(jcfg, _jmesh(JMeshSpec(**mesh)))
    return JaxEngine(jcfg, params, JaxEngineConfig(
        mesh=js.mesh, shard_params_fn=js.shard_params,
        shard_pages_fn=js.shard_pages, attn_impl="scan", **sizes))


def _engine_case(name, mesh, workload, sizes, **extra):
    return dict(kind="engine", name=name, cfg=_kw("llama"),
                tree=_tree("llama")[3], mesh=mesh, engine=sizes,
                workload=workload, **extra)


def _run(tmp):
    worlds = {2: [], 4: []}
    for mesh, axis in ((SP2, "sp"), (SP4, "sp"), (SP2TP2, "sp"),
                       (SP2TP2, "tp")):
        worlds[_size(mesh)].append(dict(kind="rotate",
                                        name=f"rotate-{_cid(mesh)}-{axis}",
                                        mesh=mesh, axis=axis))
    for c in ATTN:
        mesh, heads, part, head = c
        worlds[_size(mesh)].append(dict(
            kind="ring_attention", name=_attn_id(c), mesh=mesh,
            inputs=_attn_inputs(*heads), partials=part, head_axis=head))
    for name, mesh, prefix in PREFILL:
        worlds[_size(mesh)].append(dict(
            kind="ring_prefill", name=name, cfg=_kw("llama"),
            tree=_tree("llama")[3], mesh=mesh, num_pages=NPAGES,
            page_size=PS, steps=_prefill_steps(prefix)))
    for mesh in ENGINES:
        worlds[_size(mesh)].append(_engine_case(
            f"ring-{_cid(mesh)}", mesh, "ring", SP_ENGINE, dump_pages=True))
    worlds[2].append(_engine_case("spkv-sp2", SP2, "spkv", KV_ENGINE,
                                  dump_pages=True))
    runs = []
    for world, cases in worlds.items():
        path, out = _world_spec(tmp, world, cases)
        proc = subprocess.Popen([sys.executable, HELPER, path],
                                env=dict(os.environ, OMP_NUM_THREADS="1"),
                                cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        runs.append((world, proc, out))
    refs = {}

    def kernels():
        for c in ATTN:
            refs[_attn_id(c)] = _ref_attention(*c)
        for name, mesh, prefix in PREFILL:
            refs[name] = _ref_prefill(mesh, prefix)

    def engine(mesh):
        eng = _jax_sp_engine(mesh)

        async def go():
            try:
                return await ranks.ring_workload(eng, JRequest, JSampling,
                                                 JStop)
            finally:
                await eng.stop()
        refs[f"ring-{_cid(mesh)}"] = asyncio.run(go())

    try:
        # the references side by side (XLA compiles outside the GIL)
        with ThreadPoolExecutor(1 + len(ENGINES)) as pool:
            jobs = [pool.submit(kernels)]
            jobs += [pool.submit(engine, m) for m in ENGINES]
            for j in jobs:
                j.result()
    finally:
        got = {}
        for world, proc, out in runs:
            try:
                log, _ = proc.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
            got[world] = {"rc": proc.returncode, "log": log}
            for r in range(world):
                try:
                    with open(f"{out}.{r}", "rb") as f:
                        got[world][r] = pickle.load(f)
                except FileNotFoundError:
                    got[world][r] = {"error": f"rank {r} wrote nothing"}
    return refs, got


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """The worlds and the references, started with the module's first test
    and run beside the in-process tests."""
    pool = ThreadPoolExecutor(1)
    job = pool.submit(_run, tmp_path_factory.mktemp("spworlds"))
    yield job
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def worlds(_started):
    return _started.result()


def _rank(worlds, world, rank, name):
    got = worlds[1][world]
    res = got[rank]
    assert name in res, (res.get("error"), got["log"][-3000:])
    return res[name]


# -- in process -----------------------------------------------------------------


def _port_engine(mesh):
    cfg = ModelConfig(**_kw("llama"))
    rmesh = RankMesh(MeshSpec(**mesh), 0)
    ts = ModelSharding(cfg, rmesh)
    return TorchEngine(
        cfg, get_family(cfg).params_from_jax(_tree("llama")[3], cfg),
        TorchEngineConfig(mesh=rmesh, shard_params_fn=ts.shard_params,
                          shard_pages_fn=ts.shard_pages, **SP_ENGINE),
        device="cpu")


@pytest.mark.parametrize("mesh", [SP2, SP2TP2, SP2DP2], ids=_cid)
def test_sharding_and_engine_sizes_split_nothing_over_sp(mesh):
    jcfg, _params, cfg, _t = _tree("llama")
    jmesh = _jmesh(JMeshSpec(**mesh))
    rmesh = RankMesh(MeshSpec(**mesh), 0)
    js = JModelSharding(jcfg, jmesh)
    _specs_equal(js.param_specs(), ModelSharding(cfg, rmesh).param_specs())
    jpages = js.shard_pages(jllama.make_pages(jcfg, 16, PS))
    assert shard_layout(Sharding(rmesh, cache_spec(cfg, rmesh))) == \
        jshard_layout(jpages.sharding)
    tp = mesh.get("tp", 1)
    assert local_config(cfg, rmesh) == dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads
        // tp, intermediate_size=cfg.intermediate_size // tp)
    eng = _port_engine(mesh)
    jeng = _jax_sp_engine(mesh)
    try:
        assert eng._sp == jeng._sp == 2
        assert eng.scheduler.cfg.ring_threshold == \
            jeng.scheduler.cfg.ring_threshold == 16
        for k in ("min_decode_bucket", "min_prefill_seqs_bucket"):
            assert getattr(eng.cfg, k) == getattr(jeng.cfg, k), k
        # the cache splits its kv heads over tp alone; a block is the
        # whole model's
        assert eng._kv_splits == ([("tp", 3)] if tp > 1 else [])
        assert eng.kv_block_shape() == (cfg.num_layers, 2, cfg.num_kv_heads,
                                        PS, cfg.head_dim)
        assert eng.pages.shape[3] == cfg.num_kv_heads // tp
    finally:
        eng._step_executor.shutdown()


def _ref_ring_error(name):
    """A ``JaxEngine`` on an sp=2 mesh (no sharding hooks, as the
    reference's own ring tests build it) serving one long prompt: the
    stream's error, or None when it streamed tokens."""
    jcfg, params, _cfg, _t = _tree(name)
    eng = JaxEngine(jcfg, params, JaxEngineConfig(
        mesh=_jmesh(JMeshSpec(sp=2)), attn_impl="scan", **SP_ENGINE))
    prompt = ranks._prompts(67, [40])[0]

    async def go():
        try:
            return await ranks._stream(eng, ranks._req(
                JRequest, JSampling, JStop, "f", prompt, 2,
                temperature=0.0))
        finally:
            await eng.stop()
    out = asyncio.run(go())
    assert eng.ring_steps == 1
    return out.get("error")


@pytest.mark.parametrize("name", ["moe", "gemma", "deepseek"])
def test_families_the_reference_cannot_ring_are_refused(name):
    err = _ref_ring_error(name)
    # the reference takes the ring step and fails in it: MoE's expert
    # stacks break llama's dense MLP, Gemma-2's tree has no mlp_norm,
    # DeepSeek's no stacked layers
    assert err, f"{name}: the reference's ring step served"
    cfg = ModelConfig(**_kw(name))
    with pytest.raises(ValueError, match=(
            f"has no path for {cfg.model_type!r}")):
        TorchEngine(cfg, {}, TorchEngineConfig(
            mesh=RankMesh(MeshSpec(sp=2), 0), **SP_ENGINE), device="cpu")
    # and pipeline parallelism does not combine with sp
    with pytest.raises(ValueError, match="does not combine with sp"):
        TorchEngine(ModelConfig(**_kw("llama")), {}, TorchEngineConfig(
            mesh=RankMesh(MeshSpec(pp=2, sp=2), 0), **SP_ENGINE),
            device="cpu")


# -- the worlds -------------------------------------------------------------------


@pytest.mark.parametrize("mesh,axis", [(SP2, "sp"), (SP4, "sp"),
                                       (SP2TP2, "sp"), (SP2TP2, "tp")],
                         ids=["sp2", "sp4", "sp2tp2-sp", "sp2tp2-tp"])
def test_rotate_hands_each_rank_its_predecessors_tensor(worlds, mesh, axis):
    world = _size(mesh)
    spec = MeshSpec(**mesh)
    n = mesh[axis]
    for r in range(world):
        got = _rank(worlds, world, r, f"rotate-{_cid(mesh)}-{axis}")
        c = got["coords"]
        prev = dict(c, **{axis: (c[axis] - 1) % n})
        assert got["got"].tolist() == [float(coords_rank(spec, prev))] * 3


@pytest.mark.parametrize("case", ATTN, ids=[_attn_id(c) for c in ATTN])
def test_ring_self_attention_matches_the_reference(worlds, case):
    want = worlds[0][_attn_id(case)]
    world = _size(case[0])
    for r in range(world):
        got = _rank(worlds, world, r, _attn_id(case))["out"]
        if case[2]:
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_allclose(g, w, rtol=ATTN_TOL,
                                           atol=ATTN_TOL)
        else:
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=ATTN_TOL,
                                       atol=ATTN_TOL)


@pytest.mark.parametrize("name,mesh,prefix", PREFILL,
                         ids=[c[0] for c in PREFILL])
def test_ring_prefill_matches_the_reference(worlds, name, mesh, prefix):
    want_logits, want_cache = worlds[0][name]
    world = _size(mesh)
    cfg = ModelConfig(**_kw("llama"))
    tp = mesh.get("tp", 1)
    hkv = cfg.num_kv_heads // tp
    for r in range(world):
        got = _rank(worlds, world, r, name)
        assert len(got["logits"]) == len(want_logits)
        for g, w in zip(got["logits"], want_logits):
            # every rank holds every row's logits
            np.testing.assert_allclose(g, w, rtol=RING_TOL, atol=RING_TOL)
        c = got["coords"]
        want = want_cache[:, :, :, c["tp"] * hkv:(c["tp"] + 1) * hkv]
        assert got["cache"].shape == want.shape
        np.testing.assert_allclose(got["cache"][:, 1:], want[:, 1:],
                                   rtol=RING_TOL, atol=RING_TOL)
        assert np.any(got["cache"][:, 1:])
    # the sp replicas' caches are byte-equal
    for r in range(world):
        mine = _rank(worlds, world, r, name)
        for o in range(world):
            other = _rank(worlds, world, o, name)
            if other["coords"]["tp"] == mine["coords"]["tp"]:
                assert mine["cache"].tobytes() == other["cache"].tobytes()


def _streams(res):
    return {k: v for k, v in res.items()
            if isinstance(v, dict) and ("tokens" in v or "error" in v)}


@pytest.mark.parametrize("mesh", ENGINES, ids=_cid)
def test_engine_ring_steps_match_jax_engine(worlds, mesh):
    case = f"ring-{_cid(mesh)}"
    world = _size(mesh)
    got = _rank(worlds, world, 0, case)
    want = worlds[0][case]
    gs, ws = _streams(got), _streams(want)
    assert set(gs) == set(ws) == {"r1", "short", "r2", "r3"}
    for rid in ws:
        assert "error" not in gs[rid], gs[rid]
        assert gs[rid]["tokens"] == ws[rid]["tokens"], rid
        assert gs[rid]["finish"] == ws[rid]["finish"], rid
        np.testing.assert_allclose(gs[rid]["logprobs"], ws[rid]["logprobs"],
                                   rtol=1e-4, atol=1e-5)
        # one ring step per long prompt, none for the short one
        assert gs[rid]["ring_steps"] == ws[rid]["ring_steps"], rid
    assert [gs[r]["ring_steps"] for r in ("r1", "short", "r2", "r3")] == \
        [1, 1, 2, 3]
    # the prefix hit: the head's six pages came from the cache
    assert gs["r2"]["cached"] == ws["r2"]["cached"] == 24
    assert got["counters"]["ring_steps"] == 3
    assert "ring" in got["taps"] and got["tap_threads"] == 1
    assert got["counters"]["blocks"] > 0
    # every rank ran the decode and the chunked-prefill kernels' wrappers
    # (the short prompt's chunks and every decode step, replicated)
    for r in range(world):
        launches = _rank(worlds, world, r, case)["launches"]
        assert launches == got["launches"]
        assert launches["paged_decode"] > 0 and \
            launches["paged_prefill"] > 0, launches
    # the replicas (over sp, and over dp) hold the same cache
    tp = mesh.get("tp", 1)
    for r in range(world):
        mine = _rank(worlds, world, r, case)["cache"]
        for o in range(world):
            if (o // mesh["sp"]) % tp == (r // mesh["sp"]) % tp:
                other = _rank(worlds, world, o, case)["cache"]
                assert mine.tobytes() == other.tobytes(), (r, o)


def _frames_data(frames) -> np.ndarray:
    parts = []
    for meta, raw in frames:
        L, *rest = meta["block_shape"]
        parts.append(np.frombuffer(raw, np.float32).reshape(
            L, len(meta["blocks"]), *rest))
    return np.concatenate(parts, axis=1)


def test_kv_frames_of_an_sp_world_inject_byte_equal(worlds):
    cfg = ModelConfig(**_kw("llama"))
    got = _rank(worlds, 2, 0, "spkv-sp2")
    # a rode the ring on the world, chunks on the one-rank engine
    assert got["counters"]["ring_steps"] == 1
    assert got["a"]["tokens"] == got["one_a"]["tokens"]
    assert len(got["frames"]) == len(got["one_frames"]) >= 2
    for (m1, _r1), (m2, _r2) in zip(got["frames"], got["one_frames"]):
        assert m1 == m2
        assert m1["block_shape"] == [cfg.num_layers, 2, cfg.num_kv_heads,
                                     PS, cfg.head_dim]
    pages = np.asarray(got["pages"])
    mine, one = _frames_data(got["frames"]), _frames_data(got["one_frames"])
    assert mine.tobytes() == pages.tobytes()
    np.testing.assert_allclose(mine, one, rtol=RING_TOL, atol=RING_TOL)
    # injected both ways, byte-equal
    assert np.asarray(got["one_pages"]).tobytes() == pages.tobytes()
    assert np.asarray(got["back"]).tobytes() == one.tobytes()
    assert got["b"]["cached"] >= 24
    # every scatter reached the other replica whole, and both caches hold
    # the same bytes after the workload
    res = _rank(worlds, 2, 1, "spkv-sp2")
    assert res["scatters"]
    for vals in res["scatters"].values():
        assert vals.shape[0] == cfg.num_layers
        assert vals.shape[3] == cfg.num_kv_heads
    assert got["cache"].tobytes() == res["cache"].tobytes()


# -- the worker -------------------------------------------------------------------


def test_sp2_worker_serves_a_long_chat_in_one_ring_step(tmp_path):
    """A ``--sequence-parallel-size 2`` worker (its follower rank started
    by itself, gloo on the CPU) serves a chat past the chunk budget in
    one ring step; the same chat again hits the prefix cache, its few
    remaining tokens chunked, and answers the same."""
    import time

    import chip_smoke as cs
    from dynamo_tpu_torch.utils.testing import make_test_model_dir
    from tests.procutils import free_port
    from tests.test_torch_parallel_worker import (ENGINE_FLAGS, _env, _get,
                                                  _post)
    model_dir = make_test_model_dir(str(tmp_path / "sp-model"))
    coord_port, http_port = free_port(), free_port()
    coord = f"127.0.0.1:{coord_port}"
    env = dict(_env(), DYN_LOG="info")
    procs = []
    try:
        procs.append(cs.Child("coordinator",
                              "dynamo_tpu_torch.runtime.coordinator",
                              ["--host", "127.0.0.1", "--port",
                               str(coord_port)], str(tmp_path), env))
        procs[-1].wait_for("coordinator listening", timeout=60)
        worker = cs.Child(
            "worker", "dynamo_tpu_torch.worker.main",
            ["--coordinator", coord, "--model-path", model_dir,
             "--model-name", "sp", "--random-weights", "--device", "cpu",
             "--sequence-parallel-size", "2"] + ENGINE_FLAGS,
            str(tmp_path), env)
        procs.append(worker)
        procs.append(cs.Child("frontend", "dynamo_tpu_torch.frontend.main",
                              ["--coordinator", coord, "--http-host",
                               "127.0.0.1", "--http-port", str(http_port)],
                              str(tmp_path), env))
        worker.wait_for("torch worker serving model", timeout=120)
        assert "world 2, backend gloo, fused blocks eager, mesh dp 1 x pp " \
               "1 x tp 1 x sp 2" in worker.text()
        procs[-1].wait_for("frontend listening", timeout=60)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.monotonic() + 60
        while not _get(f"{base}/v1/models")["data"]:
            assert time.monotonic() < deadline, "model never registered"
            time.sleep(0.2)
        # ~70 tokens with the chat template: past the chunk budget of 16
        # and inside the context of 128
        chat = {"model": "sp", "max_tokens": 6, "temperature": 0,
                "messages": [{"role": "user", "content":
                              "the quick brown fox jumps over the lazy dog"}]}
        r1 = _post(f"{base}/v1/chat/completions", chat)
        r2 = _post(f"{base}/v1/chat/completions", chat)
        assert r1["usage"]["prompt_tokens"] > 16
        assert r1["usage"]["completion_tokens"] == 6
        assert r2["choices"][0]["message"]["content"] == \
            r1["choices"][0]["message"]["content"]
        assert r2["usage"]["prompt_tokens_details"]["cached_tokens"] > 0
        # the long prompt rode the ring once; its repeat hit the prefix
        # cache and its few remaining tokens stayed chunked
        rings = [ln for ln in worker.text().splitlines()
                 if "ring prefill:" in ln and "over sp=2" in ln]
        assert len(rings) == 1, rings
        assert all(p.proc.poll() is None for p in procs)
    except BaseException:
        for proc in procs:
            print(f"--- {proc.name}\n{proc.tail()}")
        raise
    finally:
        for proc in reversed(procs):
            proc.stop()
