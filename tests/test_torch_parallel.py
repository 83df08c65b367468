"""Tensor and expert parallelism of the port against the JAX package's
GSPMD mesh, on the CPU.

- Specs and shards (no process): ``ModelSharding``'s checks and messages
  are the reference's; its spec trees equal the reference's entry for
  entry; for each family (Llama, Gemma-2, MoE, DeepSeek, int8) every
  rank's slice of every parameter equals, byte for byte, the reference's
  ``addressable_shards`` on the mesh device at the same coordinates; the
  cache's slices and ``shard_layout`` agree.
- Rank worlds (``tests/torch_parallel_ranks.py``, started as processes:
  this process starts no process group): a world of 2 ranks runs the
  sharded forward of every family at tp=2 (and the MoE at ep=2) and then
  ``TorchEngine`` at tp=2 and ep=2; a world of 4 runs the MoE and DeepSeek
  forwards at tp=2 x ep=2. Meanwhile this process runs the reference on the
  conftest's 8 virtual CPU devices: the forwards under ``jit`` on the
  sharded weights and cache, and ``JaxEngine`` on the same mesh with the
  same workloads. Logits agree within ``LOGIT_RTOL`` (float32); streams
  (greedy and sampled, through fused blocks, chained steps, speculative
  verify steps), embeddings, scores and MoE drop counts agree; every
  fanned-out dispatch runs on the leader's one step thread (embeddings and
  scoring asked for while streams decode); a page gather after each
  workload (fanned out, assembled from the tp group) equals the
  reference's gather of the same pages within ``GATHER_RTOL``; a step that
  raises on the follower alone trips the outcome cross-check. The MoE
  engine case's prompts fill their prefill rows (see
  ``torch_parallel_ranks.moe_workload``: padded slots route differently in
  the two packages, ROADMAP Queue C).
"""

import asyncio
import dataclasses
from concurrent.futures import ThreadPoolExecutor
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import get_family as jget_family
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops.quant import quantize_params as jquantize
from dynamo_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dynamo_tpu.parallel.mesh import make_mesh as jmake_mesh
from dynamo_tpu.parallel.sharding import ModelSharding as JModelSharding
from dynamo_tpu.parallel.sharding import shard_layout as jshard_layout
from dynamo_tpu.parallel.sharding import \
    transport_sharding as jtransport_sharding
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.parallel.mesh import MeshSpec, RankMesh, coords_rank
from dynamo_tpu_torch.parallel.sharding import (ModelSharding, Sharding,
                                                shard_layout,
                                                transport_sharding)
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "torch_parallel_ranks.py")

# float32 logits: the port's row-parallel partial sums against GSPMD's
LOGIT_RTOL = 1e-5
# embeddings and prompt logprobs through the engines
EMBED_RTOL = 1e-5
SCORE_ATOL = 2e-5
# float32 KV pages gathered after a workload (the layers past the first
# hold K/V computed from row-parallel sums)
GATHER_RTOL = 1e-5
# the pages gathered after each engine workload
GATHER_PAGES = [1, 2, 3]
PS, NPAGES = 4, 16

# -- the families, at tiny size -----------------------------------------------


def _kw(name):
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                rope_theta=10000.0, max_position_embeddings=512,
                dtype="float32")
    if name == "gemma":
        base.update(model_type="gemma2", num_layers=4, sliding_window=8,
                    attn_logit_softcap=40.0, final_logit_softcap=25.0,
                    query_pre_attn_scalar=24.0)
    elif name.startswith("moe"):
        base.update(model_type="qwen3_moe", qk_norm=True, num_experts=8,
                    num_experts_per_tok=2, moe_intermediate_size=32,
                    moe_backend="dispatch" if name.endswith("dispatch")
                    else "dense")
    elif name.startswith("deepseek"):
        base.update(num_layers=3, num_kv_heads=1, head_dim=128,
                    model_type="deepseek_v2", q_lora_rank=0,
                    kv_lora_rank=128, qk_rope_head_dim=16,
                    qk_nope_head_dim=32, v_head_dim=32, num_experts=4,
                    num_experts_per_tok=2, moe_intermediate_size=32,
                    n_shared_experts=2, first_k_dense_replace=1,
                    moe_backend="dispatch" if name.endswith("dispatch")
                    else "dense")
    return base


FAMILIES = ("llama", "gemma", "moe", "deepseek", "int8")


def _numpy_tree(jcfg, seed: int = 0):
    """The family's parameter tree (its structure from the reference's
    ``init_params``, traced, not run) filled from a numpy seed: weights
    normal at 0.02, norms about 1 (Gemma-2's about 0: its norms scale by
    ``1 + w``), each perturbed so that it matters."""
    shapes = jax.eval_shape(
        lambda: jget_family(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    gemma = jcfg.model_type == "gemma2"

    def fill(path, sd):
        name = path[-1].key
        if "norm" in name:
            base = 0.0 if gemma else 1.0
            return (base + rng.normal(scale=0.2, size=sd.shape)).astype(
                sd.dtype)
        return (rng.normal(scale=0.02, size=sd.shape)).astype(sd.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _tree(name):
    """(reference cfg, reference params, port cfg, numpy tree)."""
    d = _kw(name)
    jcfg = JModelConfig(**d)
    np_tree = _numpy_tree(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_tree)
    if name == "int8":
        params = jquantize(params)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, ModelConfig(**d), np_tree


def _port_params(name):
    _jcfg, _p, cfg, np_tree = _tree(name)
    return get_family(cfg).params_from_jax(np_tree, cfg, device="cpu")


# -- specs and shards -------------------------------------------------------------


def _jmesh(spec: JMeshSpec):
    return jmake_mesh(spec, devices=jax.devices()[:spec.size])


def _specs_equal(jspecs, specs):
    if isinstance(jspecs, dict):
        assert set(jspecs) == set(specs) - {"post_attn_norm",
                                            "pre_ffw_norm", "post_ffw_norm"}
        for k in jspecs:
            _specs_equal(jspecs[k], specs[k])
    else:
        assert tuple(jspecs) == specs, (jspecs, specs)


@pytest.mark.parametrize("name", FAMILIES)
def test_param_specs_equal_reference(name):
    jcfg, _p, cfg, _t = _tree(name)
    for shape in (dict(tp=2), dict(tp=2, ep=2), dict(ep=2)):
        if "ep" in shape and not cfg.num_experts:
            continue
        jspec = JModelSharding(jcfg, _jmesh(JMeshSpec(**shape)))
        spec = ModelSharding(cfg, RankMesh(MeshSpec(**shape), 0))
        _specs_equal(jspec.param_specs(), spec.param_specs())
        assert tuple(jspec.pages_spec()) == spec.pages_spec()
        assert tuple(jspec.pages_layer_spec()) == spec.pages_layer_spec()


def _ref_shards(name, jshard):
    """The reference's placed tree. Its shard_params has no entry for
    Gemma-2's sandwich norms (a KeyError): they are placed replicated."""
    _jcfg, params, _cfg, _t = _tree(name)
    if name != "gemma":
        return jshard.shard_params(params)
    with pytest.raises(KeyError):
        jshard.shard_params(params)
    specs = jshard.param_specs()
    for k in ("post_attn_norm", "pre_ffw_norm", "post_ffw_norm"):
        specs["layers"][k] = PartitionSpec()

    def place(path, leaf):
        node = specs
        for k in path:
            node = node[k.key]
        return jax.device_put(leaf, NamedSharding(jshard.mesh, node))
    return jax.tree_util.tree_map_with_path(place, params)


@pytest.mark.parametrize("name", FAMILIES)
def test_rank_shards_equal_reference_addressable_shards(name):
    jcfg, _p, cfg, _t = _tree(name)
    shape = dict(tp=2, ep=2) if cfg.num_experts else dict(tp=2)
    jspec = JMeshSpec(**shape)
    jmesh = _jmesh(jspec)
    placed = _ref_shards(name, JModelSharding(jcfg, jmesh))
    full = _port_params(name)
    spec = MeshSpec(**shape)
    devs = np.asarray(jmesh.devices)
    mine = {r: ModelSharding(cfg, RankMesh(spec, r)).shard_params(full)
            for r in range(spec.size)}

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    n = 0
    for path, leaf in leaves(placed):
        for sh in leaf.addressable_shards:
            idx = np.argwhere(devs == sh.device)[0]
            rank = coords_rank(spec, dict(zip(
                ("dp", "pp", "tp", "sp", "ep"), map(int, idx))))
            got = mine[rank]
            for k in path:
                got = got[k]
            want = np.asarray(sh.data)
            got = got.numpy()
            assert got.shape == want.shape, (path, rank)
            assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
            assert got.tobytes() == want.tobytes(), (path, rank)
            n += 1
    assert n >= 4 * spec.size


def test_sharding_checks_and_messages_equal_reference():
    cases = [dict(num_kv_heads=3, num_heads=6), dict(intermediate_size=129),
             dict(num_experts=8, moe_intermediate_size=33),
             dict(kv_lora_rank=16, num_heads=3, qk_rope_head_dim=8,
                  qk_nope_head_dim=8, v_head_dim=8, head_dim=16)]
    for over in cases:
        d = dict(_kw("llama"), **over)
        with pytest.raises(ValueError) as want:
            JModelSharding(JModelConfig(**d), _jmesh(JMeshSpec(tp=2)))
        with pytest.raises(ValueError) as got:
            ModelSharding(ModelConfig(**d), RankMesh(MeshSpec(tp=2), 1))
        assert str(got.value) == str(want.value)
    d = dict(_kw("moe"), num_experts=6)
    with pytest.raises(ValueError) as want:
        JModelSharding(JModelConfig(**d), _jmesh(JMeshSpec(ep=4)))
    with pytest.raises(ValueError) as got:
        ModelSharding(ModelConfig(**d), RankMesh(MeshSpec(ep=4), 0))
    assert str(got.value) == str(want.value)
    # a mesh over the wrong number of devices (here: a world of one)
    with pytest.raises(ValueError) as want:
        jmake_mesh(JMeshSpec(tp=3), devices=jax.devices()[:1])
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError) as got:
        make_mesh(MeshSpec(tp=3))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["llama", "deepseek"])
def test_pages_and_layout_equal_reference(name):
    jcfg, _p, cfg, _t = _tree(name)
    jmesh = _jmesh(JMeshSpec(tp=2))
    jshard = JModelSharding(jcfg, jmesh)
    pages = np.random.default_rng(1).normal(size=jllama.make_pages(
        jcfg, NPAGES, PS).shape).astype(np.float32)
    jpages = jshard.shard_pages(jnp.asarray(pages))
    jlist = jshard.shard_pages([jnp.asarray(p) for p in pages])
    devs = list(np.asarray(jmesh.devices).reshape(-1))
    for r in range(2):
        shard = ModelSharding(cfg, RankMesh(MeshSpec(tp=2), r))
        got = shard.shard_pages(torch.from_numpy(pages)).numpy()
        want = [s for s in jpages.addressable_shards
                if s.device == devs[r]][0]
        assert got.tobytes() == np.asarray(want.data).tobytes()
        got_l = shard.shard_pages([torch.from_numpy(p) for p in pages])
        for gl, jl in zip(got_l, jlist):
            want = [s for s in jl.addressable_shards
                    if s.device == devs[r]][0]
            assert gl.numpy().tobytes() == np.asarray(want.data).tobytes()
        assert shard_layout(shard.pages_sharding()) == jshard_layout(
            jpages.sharding)
        assert shard_layout(transport_sharding(
            shard.pages_sharding(per_layer=True), per_layer=True)) == \
            jshard_layout(jtransport_sharding(jlist))
    assert shard_layout(None) == (1, -1)
    two = Sharding(RankMesh(MeshSpec(tp=2, ep=2), 0), ("tp", "ep"))
    assert shard_layout(two) == (0, -1)


# -- the rank worlds ---------------------------------------------------------------


def _steps(cfg):
    """A prefill (rows of 8 and 5 tokens) and a decode step after it."""
    rng = np.random.default_rng(4)
    B, P = 2, NPAGES // 2
    table = np.zeros((B, P), np.int32)
    table[0, :3] = [1, 2, 3]
    table[1, :3] = [4, 5, 6]
    lens = [8, 5]
    toks = np.zeros((B, 8), np.int32)
    pos = np.zeros((B, 8), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, size=n)
        pos[i, :n] = np.arange(n)
    pre = dict(tokens=toks, positions=pos, table=table,
               total=np.array(lens, np.int32), new=np.array(lens, np.int32))
    dec = dict(tokens=rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(
        np.int32), positions=np.array([[8], [5]], np.int32), table=table,
        total=np.array([9, 6], np.int32), new=np.ones(B, np.int32))
    return [pre, dec]


def _ref_forward(name, shape):
    """The reference's forward under jit on its mesh: weights and cache
    placed by ``ModelSharding`` (Gemma-2: see ``_ref_shards``)."""
    jcfg, params, _cfg, _t = _tree(name)
    fam = jget_family(jcfg)
    jmesh = _jmesh(JMeshSpec(**shape))
    jshard = JModelSharding(jcfg, jmesh)
    p = _ref_shards(name, jshard)
    pages = jshard.shard_pages(jllama.make_pages(jcfg, NPAGES, PS))
    kw = {}
    if jcfg.num_experts and shape.get("ep", 1) > 1:
        kw["ep_mesh"] = jmesh
    fwd = jax.jit(lambda p, pg, t, po, tb, tot, new: fam.forward(
        p, jcfg, t, po, pg, tb, tot, new, **kw))
    logits, drops = [], []
    for st in _steps(jcfg):
        out = fwd(p, pages, *(jnp.asarray(st[k]) for k in (
            "tokens", "positions", "table", "total", "new")))
        pages = out[1]
        logits.append(np.asarray(out[0]))
        if len(out) > 2:
            drops.append(int(out[2]["moe_dropped_assignments"]))
    return logits, drops


FWD2 = [("llama", dict(tp=2)), ("gemma", dict(tp=2)), ("int8", dict(tp=2)),
        ("moe", dict(tp=2)), ("moe_dispatch", dict(ep=2)),
        ("deepseek", dict(tp=2))]
FWD4 = [("moe", dict(tp=2, ep=2)), ("moe_dispatch", dict(tp=2, ep=2)),
        ("deepseek_dispatch", dict(tp=2, ep=2))]

# one decode batch shape (min_decode_bucket): fewer reference compiles
ENGINE = dict(num_pages=64, page_size=4, max_num_seqs=4,
              max_prefill_chunk=16, max_context=64, min_prefill_bucket=4,
              min_decode_bucket=4)
# (name, family, mesh, engine sizes, workload); the serve case's chunks
# all pad to 16 tokens: one chunk shape, fewer reference compiles
ENGINES = [
    ("serve", "llama", dict(tp=2), dict(ENGINE, min_prefill_bucket=16),
     "serve"),
    ("spec", "llama", dict(tp=2), dict(ENGINE, spec_tokens=2,
                                       decode_multistep=1), "spec"),
    ("moe", "moe_dispatch", dict(ep=2),
     dict(ENGINE, max_num_seqs=8, max_prefill_seqs=8, max_prefill_chunk=128,
          min_prefill_bucket=16), "moe"),
]
MOE_CF = 0.5   # the moe engine case's capacity factor: it drops


def _engine_cfg_kw(name):
    d = _kw(name)
    if name == "moe_dispatch":
        d["moe_capacity_factor"] = MOE_CF
    return d


def _cid(name, shape):
    return "-".join([name] + [f"{k}{v}" for k, v in shape.items()])


def _forward_case(name, shape):
    _jcfg, _p, cfg, tree = _tree(name)
    return dict(kind="forward", name="fwd-" + _cid(name, shape),
                cfg=dataclasses.asdict(cfg), tree=tree, mesh=shape,
                num_pages=NPAGES, page_size=PS, steps=_steps(cfg))


def _world_spec(tmp, world, cases):
    out = str(tmp / f"world{world}")
    spec = dict(world=world, address=f"file://{tmp}/store{world}",
                out=out, cases=cases)
    path = tmp / f"spec{world}.pkl"
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    return str(path), out


def _jax_engine(name, shape, sizes):
    jcfg = JModelConfig(**_engine_cfg_kw(name))
    params = jax.tree_util.tree_map(jnp.asarray, _tree(name)[3])
    jshard = JModelSharding(jcfg, _jmesh(JMeshSpec(**shape)))
    return JaxEngine(jcfg, params, JaxEngineConfig(
        mesh=jshard.mesh, shard_params_fn=jshard.shard_params,
        shard_pages_fn=jshard.shard_pages, attn_impl="scan", **sizes))


def _run_worlds(tmp):
    """Start both worlds, run the references meanwhile, collect."""
    cases2 = [_forward_case(n, s) for n, s in FWD2]
    for name, fam, shape, sizes, work in ENGINES:
        cases2.append(dict(kind="engine", name=name,
                           cfg=_engine_cfg_kw(fam), tree=_tree(fam)[3],
                           mesh=shape, engine=sizes, workload=work,
                           gather=GATHER_PAGES))
    # last: a follower's failure breaks the world
    cases2.append(dict(kind="engine", name="fail", cfg=_kw("llama"),
                       tree=_tree("llama")[3], mesh=dict(tp=2),
                       engine=dict(ENGINE), workload="fail", fail_step=3))
    cases4 = [_forward_case(n, s) for n, s in FWD4]
    runs = []
    for world, cases in ((2, cases2), (4, cases4)):
        path, out = _world_spec(tmp, world, cases)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        proc = subprocess.Popen([sys.executable, HELPER, path], env=env,
                                cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        runs.append((world, proc, out))
    refs = {"fwd": {}, "engine": {}}

    def forwards(which):
        for name, shape in which:
            refs["fwd"][(name, tuple(shape.items()))] = _ref_forward(
                name, shape)

    def engine(name, fam, shape, sizes, work):
        eng = _jax_engine(fam, shape, sizes)

        async def go():
            try:
                out = await ranks.WORKLOADS[work](eng, JRequest, JSampling,
                                                  JStop)
                out["gather"] = np.asarray(await eng.run_exclusive(
                    eng.gather_pages_host, GATHER_PAGES))
                return out
            finally:
                await eng.stop()
        refs["engine"][name] = asyncio.run(go())

    try:
        # the references side by side (XLA compiles outside the GIL)
        with ThreadPoolExecutor(3 + len(ENGINES)) as pool:
            jobs = [pool.submit(forwards, f)
                    for f in (FWD2[:3], FWD2[3:], FWD4)]
            jobs += [pool.submit(engine, *e) for e in ENGINES]
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
def _worlds_started(tmp_path_factory):
    """The worlds and the references, started with the module's first test
    and run beside the tests that need neither."""
    pool = ThreadPoolExecutor(1)
    job = pool.submit(_run_worlds, tmp_path_factory.mktemp("worlds"))
    yield job
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def worlds(_worlds_started):
    return _worlds_started.result()


def _rank0(worlds, world, name):
    got = worlds[1][world]
    res = got[0]
    assert "error" not in res or name in res, (res.get("error"),
                                               got["log"][-3000:])
    assert name in res, (res.get("error"), got["log"][-3000:])
    return res[name]


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), err


@pytest.mark.parametrize("name,shape", FWD2 + FWD4,
                         ids=[_cid(n, s) for n, s in FWD2 + FWD4])
def test_sharded_forward_logits_match_reference_mesh(worlds, name, shape):
    world = 4 if (name, shape) in FWD4 else 2
    case = "fwd-" + _cid(name, shape)
    got = _rank0(worlds, world, case)
    want_logits, want_drops = worlds[0]["fwd"][(name, tuple(shape.items()))]
    assert len(got["logits"]) == len(want_logits) == 2
    for g, w in zip(got["logits"], want_logits):
        _close(g, w, LOGIT_RTOL)
    assert got["drops"] == want_drops
    # every rank computed the same logits (each holds the full row)
    for r in range(1, world):
        for g, w in zip(worlds[1][world][r][case]["logits"], got["logits"]):
            assert np.array_equal(g, w)


def _streams(res):
    return {k: v for k, v in res.items()
            if isinstance(v, dict) and ("tokens" in v or "error" in v)}


@pytest.mark.parametrize("name", [e[0] for e in ENGINES])
def test_engine_streams_match_jax_engine_on_the_mesh(worlds, name):
    got = _rank0(worlds, 2, name)
    want = worlds[0]["engine"][name]
    gs, ws = _streams(got), _streams(want)
    assert set(gs) == set(ws)
    for rid in ws:
        assert "error" not in gs[rid], gs[rid]
        assert gs[rid]["tokens"] == ws[rid]["tokens"], rid
        assert gs[rid]["finish"] == ws[rid]["finish"], rid
        np.testing.assert_allclose(gs[rid]["logprobs"], ws[rid]["logprobs"],
                                   rtol=1e-4, atol=1e-5)
    c = got["counters"]
    if name == "serve":
        assert c["blocks"] > 0
    if name == "spec":
        assert c["chained"] > 0 and c["blocks"] == 0
        _close(got["embed"], want["embed"], EMBED_RTOL)
        assert len(got["score"]) == len(want["score"]) == 2
        for (gl, gi, gt), (wl, wi, wt) in zip(got["score"], want["score"]):
            np.testing.assert_allclose(gl, wl, atol=SCORE_ATOL)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gt, wt, atol=SCORE_ATOL)
    if name == "moe":
        assert got["drops"] == want["drops"] > 0
    _close(got["gather"], want["gather"], GATHER_RTOL)
    # every fanned-out dispatch (embeddings and scoring asked for beside
    # the streams included) ran on the one step thread
    assert got["tap_threads"] == 1
    # the follower ran the same attention calls as the leader
    assert worlds[1][2][1][name]["launches"] == got["launches"]


def test_follower_only_failure_trips_the_outcome_cross_check(worlds):
    follower = worlds[1][2][1]
    assert "fail" in follower, follower.get("error")
    err = follower["fail"].get("follower_error", "")
    assert "multihost divergence: leader completed step" in err, follower
