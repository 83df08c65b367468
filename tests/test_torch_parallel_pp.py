"""Pipeline parallelism of the port against the JAX package's pp meshes, on
the CPU.

- Specs and slices (no process): ``pp_sharding_fns``' specs equal the
  reference's ``_param_specs`` entry for entry for the Llama, MoE and
  Gemma-2 trees at pp=2 and pp=2 x tp=2, every rank's slice of every leaf
  and of the cache equals the reference's ``addressable_shards`` on the
  mesh device at the same coordinates byte for byte, and the cache's
  ``shard_layout`` agrees; the checks and messages of the sharding, of
  ``pipeline_forward``, of ``TorchEngine`` under pp (int8, speculation,
  prompt scoring, DeepSeek) and of the worker's flags are the reference's;
  a rank's KVBM block is the whole model's, as the reference's.
- Rank worlds of 2, 4 and 8 (``tests/torch_parallel_ranks.py``, started
  as processes; this process starts no process group) run the port's
  ``pipeline_forward``, while this process runs the reference's on the
  conftest's 8 virtual devices (jitted): the logits and every rank's
  cache slab agree within ``PP_RTOL`` (float32, the reference's own
  tolerance) for the Llama tree at pp=2 (M = 1 and 2), pp=2 x tp=2, pp=2
  x dp=2 and pp=2 x tp=2 x dp=2, MoE at pp=2 on both backends and at pp=2
  x tp=2 (dispatch), Gemma-2 at pp=2 with three layers a stage (stage 1
  starts on an odd layer: its windows follow the global index), and a
  decode step whose stages run the decode kernel's wrapper against the
  reference's stages running its Pallas decode kernel (interpret mode).
- ``TorchEngine`` on pp=2 and pp=2 x dp=2 worlds streams token-equal with
  ``JaxEngine`` on ``pipeline_forward`` (greedy and a seeded draw), its
  fused blocks, chained steps and mixed steps counted; the dp replicas'
  caches are byte-equal. On pp=2 and pp=2 x tp=2 worlds the KV data
  plane: the world's merged frames equal a one-rank engine's of the same
  tree, inject byte-equal both ways, and a KVBM host + disk round trip
  on a pp=2 world returns the pages byte-equal.
- A ``--pipeline-parallel-size 2 --tensor-parallel-size 2`` worker serves
  two greedy chats identically and embeddings over HTTP.
"""

import asyncio
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops.pallas.decode import \
    paged_decode_attention_stacked as jdecode_kernel
from dynamo_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dynamo_tpu.parallel.pipeline import _param_specs as j_param_specs
from dynamo_tpu.parallel.pipeline import pipeline_forward as jpipeline
from dynamo_tpu.parallel.pipeline import pp_sharding_fns as jpp_sharding_fns
from dynamo_tpu.parallel.pipeline import stage_adapter_for as jadapter_for
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
from dynamo_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                pp_sharding_fns,
                                                stage_adapter_for)
from dynamo_tpu_torch.parallel.sharding import (Sharding, StageSharding,
                                                cache_spec, local_config,
                                                shard_layout)
from tests import torch_parallel_ranks as ranks
from tests.procutils import free_port
from tests.test_torch_parallel import (ENGINE, HELPER, REPO, _jmesh, _kw,
                                       _numpy_tree, _world_spec)

torch.set_num_threads(2)

# the reference's own pipeline tolerance (tests/test_pipeline_parallel.py)
PP_RTOL = 2e-4
PS = 4
B, S, P_ = 4, 8, 4
NPAGES = 1 + B * P_
PP2, PP2TP2 = dict(pp=2), dict(pp=2, tp=2)
DP2PP2, DP2PP2TP2 = dict(dp=2, pp=2), dict(dp=2, pp=2, tp=2)

# -- the trees ------------------------------------------------------------------


def _fwd_kw(fam):
    """Tiny configs with layers the stages divide: four (Gemma-2: six,
    three a stage, so stage 1 starts on an odd layer past a window of 4
    on the 8-token rows); the decode-kernel case at head_dim 128 and
    pages of 8, what the reference's Pallas kernel takes."""
    if fam == "gemma":
        return dict(_kw("gemma"), num_layers=6, sliding_window=4)
    if fam == "llama_dh128":
        return dict(_kw("llama"), num_layers=4, head_dim=128)
    kw = dict(_kw(fam), num_layers=4)
    if fam == "moe_dispatch":
        kw["moe_capacity_factor"] = 4.0
    return kw


@functools.lru_cache(maxsize=None)
def _fam_tree(fam, seed=0):
    """(reference cfg, reference params, port cfg, numpy tree)."""
    d = _fwd_kw(fam)
    jcfg = JModelConfig(**d)
    tree = _numpy_tree(jcfg, seed)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            ModelConfig(**d), tree)


def _steps(fam, n):
    """A prefill of rows of 8, 6, 8 and 3 tokens (the reference's pipeline
    test batch) and, for ``n`` = 2, a decode step after it (through the
    decode kernel on the kernel case)."""
    ps = 8 if fam == "llama_dh128" else PS
    rng = np.random.default_rng(11)
    V = _fwd_kw(fam)["vocab_size"]
    table = np.arange(1, 1 + B * P_, dtype=np.int32).reshape(B, P_)
    lens = np.array([S, S - 2, S, 3], np.int32)
    toks = rng.integers(1, V, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    steps = [dict(tokens=toks, positions=pos, table=table, total=lens,
                  new=lens)]
    if n == 2:
        steps.append(dict(
            tokens=rng.integers(1, V, size=(B, 1)).astype(np.int32),
            positions=lens[:, None].copy(), table=table, total=lens + 1,
            new=np.ones(B, np.int32),
            attn="decode" if fam == "llama_dh128" else None))
    return steps, ps


# (case, family, mesh, microbatches, steps): world = the mesh's size
FWD = [("llama-pp2-m1", "llama", PP2, 1, 2),
       ("llama-pp2-m2", "llama", PP2, 2, 2),
       ("moe-pp2", "moe", PP2, None, 1),
       ("moe_dispatch-pp2", "moe_dispatch", PP2, None, 1),
       ("gemma-pp2", "gemma", PP2, None, 2),
       ("decode-kernel-pp2", "llama_dh128", PP2, 2, 2),
       ("llama-pp2tp2", "llama", PP2TP2, None, 1),
       ("moe_dispatch-pp2tp2", "moe_dispatch", PP2TP2, None, 1),
       ("llama-dp2pp2", "llama", DP2PP2, None, 1),
       ("llama-dp2pp2tp2", "llama", DP2PP2TP2, None, 1)]


def _size(mesh):
    return int(np.prod(list(mesh.values())))


def _pipeline_case(name, fam, mesh, micro, n):
    _j, _p, cfg, tree = _fam_tree(fam)
    steps, ps = _steps(fam, n)
    return dict(kind="pipeline", name=name, cfg=dataclasses.asdict(cfg),
                tree=tree, mesh=mesh, micro=micro, num_pages=NPAGES,
                page_size=ps, steps=steps)


def _ref_pipeline(fam, mesh, micro, n):
    """The reference's ``pipeline_forward`` under jit on its mesh, weights
    and cache placed by its ``pp_sharding_fns``: (logits per step, the
    whole cache after the steps)."""
    jcfg, params, _cfg, _t = _fam_tree(fam)
    steps, ps = _steps(fam, n)
    jmesh = _jmesh(JMeshSpec(**mesh))
    shard_params, shard_pages = jpp_sharding_fns(jmesh, jcfg)
    p = shard_params(params)
    pages = shard_pages(jllama.make_pages(jcfg, NPAGES, ps,
                                          dtype=jnp.float32))
    logits = []
    for st in steps:
        fwd = jax.jit(functools.partial(
            jpipeline, cfg=jcfg, mesh=jmesh, n_microbatches=micro,
            attn_impl=jdecode_kernel if st.get("attn") else None))
        lg, pages = fwd(p, tokens=jnp.asarray(st["tokens"]),
                        positions=jnp.asarray(st["positions"]), pages=pages,
                        page_table=jnp.asarray(st["table"]),
                        total_lens=jnp.asarray(st["total"]),
                        new_lens=jnp.asarray(st["new"]))
        logits.append(np.asarray(lg))
    return logits, np.asarray(pages)


# -- the engines ----------------------------------------------------------------

# one chunk shape, one decode batch shape; a penalty window of 4 slots, so
# the logit-biased request's decode runs per step, chained
PP_ENGINE = dict(ENGINE, min_prefill_bucket=16, penalty_window=4)
ENGINES = [("pp", PP2), ("pp", DP2PP2)]
KVBM_DISK = "kvbm-disk"
# the KVBM case's pool: the pressure request evicts the first prompt's
# blocks (``tests/test_torch_parallel_kv.py``'s sizes)
KVBM_ENGINE = dict(num_pages=16, page_size=4, max_num_seqs=2,
                   max_prefill_chunk=16, max_context=64,
                   min_prefill_bucket=16, min_decode_bucket=2)


def _engine_kw():
    return dict(_kw("llama"), num_layers=4)


@functools.lru_cache(maxsize=None)
def _engine_tree():
    return _numpy_tree(JModelConfig(**_engine_kw()), 0)


def _engine_case(name, mesh, workload, sizes=PP_ENGINE, **extra):
    return dict(kind="engine", name=name, cfg=_engine_kw(),
                tree=_engine_tree(), mesh=mesh, engine=sizes,
                workload=workload, **extra)


def _jax_pp_engine(mesh):
    """``JaxEngine`` with ``pipeline_forward`` as its forward (the
    reference's worker wiring, ``dynamo_tpu/worker/main.py``)."""
    jcfg = JModelConfig(**_engine_kw())
    params = jax.tree_util.tree_map(jnp.asarray, _engine_tree())
    jmesh = _jmesh(JMeshSpec(**mesh))
    shard_params, shard_pages = jpp_sharding_fns(jmesh, jcfg)
    return JaxEngine(
        jcfg, params, JaxEngineConfig(
            mesh=jmesh if mesh.get("dp", 1) > 1 else None,
            shard_params_fn=shard_params, shard_pages_fn=shard_pages,
            attn_impl="scan", **PP_ENGINE),
        forward_fn=functools.partial(jpipeline, mesh=jmesh))


def _cid(mesh):
    return "".join(f"{k}{v}" for k, v in mesh.items())


def _run(tmp):
    worlds = {2: [], 4: [], 8: []}
    for name, fam, mesh, micro, n in FWD:
        worlds[_size(mesh)].append(_pipeline_case(name, fam, mesh, micro, n))
    for name, mesh in ENGINES:
        worlds[_size(mesh)].append(_engine_case(
            f"{name}-{_cid(mesh)}", mesh, name, dump_pages=True))
    worlds[2].append(_engine_case("ppkv-pp2", PP2, "ppkv"))
    worlds[4].append(_engine_case("ppkv-pp2tp2", PP2TP2, "ppkv"))
    worlds[2].append(_engine_case("kvbm-pp2", PP2, "kvbm", KVBM_ENGINE,
                                  disk_path=str(tmp / KVBM_DISK)))
    runs = []
    for world, cases in worlds.items():
        path, out = _world_spec(tmp, world, cases)
        proc = subprocess.Popen([sys.executable, HELPER, path],
                                env=dict(os.environ, OMP_NUM_THREADS="1"),
                                cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        runs.append((world, proc, out))
    refs = {}

    def forwards(cases):
        for name, fam, mesh, micro, n in cases:
            refs[name] = _ref_pipeline(fam, mesh, micro, n)

    def engine(name, mesh):
        eng = _jax_pp_engine(mesh)

        async def go():
            try:
                return await ranks.WORKLOADS[name](eng, JRequest, JSampling,
                                                   JStop)
            finally:
                await eng.stop()
        refs[f"{name}-{_cid(mesh)}"] = asyncio.run(go())

    try:
        # the references side by side (XLA compiles outside the GIL)
        with ThreadPoolExecutor(3 + len(ENGINES)) as pool:
            jobs = [pool.submit(forwards, FWD[i::3]) for i in range(3)]
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
def _started(tmp_path_factory):
    """The worlds and the references, started with the module's first test
    and run beside the in-process tests."""
    pool = ThreadPoolExecutor(1)
    job = pool.submit(_run, tmp_path_factory.mktemp("ppworlds"))
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


# -- specs and slices -------------------------------------------------------------

SPEC_FAMILIES = ("llama", "moe", "gemma")


@pytest.mark.parametrize("mesh", [PP2, PP2TP2], ids=_cid)
@pytest.mark.parametrize("fam", SPEC_FAMILIES)
def test_stage_specs_and_slices_equal_reference(fam, mesh):
    jcfg, params, cfg, tree = _fam_tree(fam)
    jmesh = _jmesh(JMeshSpec(**mesh))
    tp = mesh.get("tp", 1)
    tails = jadapter_for(jcfg).TP_TAILS
    want = j_param_specs(params, "pp", tp, tails)
    spec = MeshSpec(**mesh)
    port_tails = stage_adapter_for(cfg).TP_TAILS
    assert {k: tuple(v) for k, v in tails.items()} == port_tails
    got = StageSharding(cfg, RankMesh(spec, 0), port_tails).param_specs(
        get_family(cfg).params_from_jax(tree, cfg, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        if k == "layers":
            assert set(got[k]) == set(want[k])
            for name in want[k]:
                assert tuple(want[k][name]) == got[k][name], name
        else:
            assert tuple(want[k]) == got[k], k
    # every rank's slice of every leaf and of the cache is the reference's
    # shard on the device at the same coordinates
    shard_params, shard_pages = jpp_sharding_fns(jmesh, jcfg)
    placed = shard_params(params)
    pages = np.random.default_rng(2).normal(size=jllama.make_pages(
        jcfg, NPAGES, PS).shape).astype(np.float32)
    jpages = shard_pages(jnp.asarray(pages))
    full = get_family(cfg).params_from_jax(tree, cfg, device="cpu")
    devs = np.asarray(jmesh.devices)
    mine = {}
    for r in range(spec.size):
        sp, spg = pp_sharding_fns(RankMesh(spec, r), cfg)
        mine[r] = (sp(full), spg(torch.from_numpy(pages)))

    def rank_of(device):
        idx = np.argwhere(devs == device)[0]
        return coords_rank(spec, dict(zip(
            ("dp", "pp", "tp", "sp", "ep"), map(int, idx))))

    n = 0
    leaves = [((k,), v) for k, v in placed.items() if k != "layers"] + \
        [(("layers", k), v) for k, v in placed["layers"].items()]
    for path, leaf in leaves:
        for sh in leaf.addressable_shards:
            got = mine[rank_of(sh.device)][0]
            for k in path:
                got = got[k]
            assert got.numpy().tobytes() == np.asarray(sh.data).tobytes(), \
                (path, sh.device)
            n += 1
    for sh in jpages.addressable_shards:
        got = mine[rank_of(sh.device)][1]
        assert got.numpy().tobytes() == np.asarray(sh.data).tobytes()
    assert n >= 8 * spec.size
    # the cache's layout, and the stage's local config
    mesh0 = RankMesh(spec, 0)
    assert shard_layout(Sharding(mesh0, cache_spec(cfg, mesh0))) == \
        jshard_layout(jpages.sharding)
    lc = local_config(cfg, mesh0)
    assert lc.num_layers == cfg.num_layers // 2
    assert lc.num_kv_heads == cfg.num_kv_heads // tp


def test_sharding_and_forward_checks_equal_reference():
    jcfg, params, cfg, tree = _fam_tree("llama")
    # pp x tp with no config, and an indivisible kv head count
    for spec, over in ((PP2TP2, None), (PP2TP2, dict(num_kv_heads=3,
                                                     num_heads=6))):
        jc = None if over is None else JModelConfig(**dict(
            _fwd_kw("llama"), **over))
        c = None if over is None else ModelConfig(**dict(
            _fwd_kw("llama"), **over))
        with pytest.raises(ValueError) as want:
            jpp_sharding_fns(_jmesh(JMeshSpec(**spec)), jc)
        with pytest.raises(ValueError) as got:
            pp_sharding_fns(RankMesh(MeshSpec(**spec), 0), c)
        assert str(got.value) == str(want.value)
    # the forward's checks: layers, microbatches, a family with no stage
    st, _ps = _steps("llama", 1)
    st = st[0]
    jargs = [jnp.asarray(st[k]) for k in ("tokens", "positions")]
    targs = [torch.from_numpy(st[k]) for k in ("tokens", "positions")]
    jrest = [jnp.asarray(st[k]) for k in ("table", "total", "new")]
    trest = [torch.from_numpy(st[k]) for k in ("table", "total", "new")]
    jmesh = _jmesh(JMeshSpec(pp=2))
    mesh = RankMesh(MeshSpec(pp=2), 0)
    ds = dict(_kw("deepseek"), num_layers=4)
    for kw, micro in ((dict(_fwd_kw("llama"), num_layers=3), None),
                      (_fwd_kw("llama"), 3), (ds, None)):
        with pytest.raises(ValueError) as want:
            jpipeline(None, JModelConfig(**kw), *jargs, None, *jrest,
                      mesh=jmesh, n_microbatches=micro)
        with pytest.raises(ValueError) as got:
            pipeline_forward(None, ModelConfig(**kw), *targs, None, *trest,
                             mesh=mesh, n_microbatches=micro)
        assert str(got.value) == str(want.value)


def _port_pp_engine(cfg_kw, **over):
    cfg = ModelConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(0)
    params = get_family(cfg).init_params(cfg, gen)
    mesh = RankMesh(MeshSpec(pp=2), 0)
    sp, spg = pp_sharding_fns(mesh, cfg)
    return TorchEngine(cfg, params, TorchEngineConfig(
        mesh=mesh, shard_params_fn=sp, shard_pages_fn=spg,
        **dict(ENGINE, **over)), device="cpu")


def _jax_pp(cfg_kw, **over):
    jcfg = JModelConfig(**cfg_kw)
    params = jax.tree_util.tree_map(
        jnp.asarray, _numpy_tree(jcfg, 0))
    jmesh = _jmesh(JMeshSpec(pp=2))
    sp, spg = jpp_sharding_fns(jmesh, jcfg)
    return JaxEngine(jcfg, params, JaxEngineConfig(
        shard_params_fn=sp, shard_pages_fn=spg, attn_impl="scan",
        **dict(ENGINE, **over)),
        forward_fn=functools.partial(jpipeline, mesh=jmesh))


@pytest.mark.parametrize("over", [dict(quantize="int8"),
                                  dict(spec_tokens=2)],
                         ids=["int8", "spec"])
def test_engine_refuses_what_the_reference_refuses_under_pp(over):
    kw = _fwd_kw("llama")
    with pytest.raises(ValueError) as want:
        _jax_pp(kw, **over)
    with pytest.raises(ValueError) as got:
        _port_pp_engine(kw, **over)
    assert str(got.value) == str(want.value)


def test_engine_refuses_scoring_and_deepseek_under_pp():
    kw = _fwd_kw("llama")
    jeng, eng = _jax_pp(kw), _port_pp_engine(kw)
    with pytest.raises(NotImplementedError) as want:
        jeng._score_batch([[1, 2, 3]])
    with pytest.raises(NotImplementedError) as got:
        eng._score_batch([[1, 2, 3]])
    assert str(got.value) == str(want.value)
    ds = dict(_kw("deepseek"), num_layers=4)
    with pytest.raises(ValueError) as want:
        jpipeline(None, JModelConfig(**ds), None, None, None, None, None,
                  None, mesh=_jmesh(JMeshSpec(pp=2)))
    cfg = ModelConfig(**ds)
    with pytest.raises(ValueError) as got:
        TorchEngine(cfg, {}, TorchEngineConfig(
            mesh=RankMesh(MeshSpec(pp=2), 0), **ENGINE), device="cpu")
    assert str(got.value) == str(want.value)


def test_worker_refusals_under_pp_equal_reference(tmp_path, caplog):
    from dynamo_tpu.worker import main as jmain
    from dynamo_tpu_torch.utils.testing import make_test_model_dir
    from dynamo_tpu_torch.worker import main as tmain
    three = make_test_model_dir(str(tmp_path / "three"),
                                num_hidden_layers=3)
    mla = make_test_model_dir(
        str(tmp_path / "mla"), model_type="deepseek_v2", kv_lora_rank=32,
        q_lora_rank=0, qk_rope_head_dim=16, qk_nope_head_dim=16,
        v_head_dim=16, n_routed_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, n_shared_experts=1,
        first_k_dense_replace=1)
    cases = [(three, ["--sequence-parallel-size", "2"]),
             (three, ["--num-nodes", "2", "--jax-coordinator",
                      "127.0.0.1:1"]),
             (three, []), (mla, [])]
    for model, flags in cases:
        flags = ["--pipeline-parallel-size", "2", *flags]
        with pytest.raises(SystemExit) as want:
            jmain.build_engine(jmain.build_parser().parse_args(
                ["--model-path", model, *flags]))
        with pytest.raises(SystemExit) as got:
            tmain.build_engine(tmain.build_parser().parse_args(
                ["--model-path", model, "--device", "cpu", *flags]))
        w, g = str(want.value.code), str(got.value.code)
        if "--num-nodes" in flags:
            # the same refusal; the reason in parentheses is each
            # package's own
            assert g.split(" (")[0] == w.split(" (")[0], (g, w)
        else:
            assert g == w, (g, w)
    # the MoE dispatch warning, in the reference's words
    moe = make_test_model_dir(
        str(tmp_path / "moe"), model_type="qwen3_moe", num_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=32,
        num_hidden_layers=2)
    args = tmain.build_parser().parse_args(
        ["--model-path", moe, "--pipeline-parallel-size", "2"])
    cfg = dataclasses.replace(ModelConfig.from_pretrained(moe),
                              moe_backend="dispatch")
    tmain.refuse_pp(args, cfg)
    assert "MoE dispatch drop accounting is not surfaced under " \
           "--pipeline-parallel-size" in caplog.text


@pytest.mark.parametrize("mesh", [dict(tp=2), PP2, PP2TP2], ids=_cid)
def test_kvbm_block_bytes_are_the_whole_models_as_the_references(mesh):
    """A rank's KVBM block size (its prefetch depth in blocks, its onboard
    byte counts) is one block of the whole model, as the reference's on
    the same mesh, though the rank's cache holds its layers and heads
    only (the rank's own part of the block counted half the bytes at
    tp=2)."""
    from dynamo_tpu.kvbm.prefetch import _block_bytes as jblock_bytes
    from dynamo_tpu.parallel.sharding import ModelSharding as JModelSharding
    from dynamo_tpu_torch.kvbm.prefetch import _block_bytes
    from dynamo_tpu_torch.parallel.sharding import ModelSharding
    jcfg, params, cfg, tree = _fam_tree("llama")
    jmesh = _jmesh(JMeshSpec(**mesh))
    rmesh = RankMesh(MeshSpec(**mesh), 0)
    staged = mesh.get("pp", 1) > 1
    if staged:
        jsp, jspg = jpp_sharding_fns(jmesh, jcfg)
        sp, spg = pp_sharding_fns(rmesh, cfg)
        fwd = functools.partial(jpipeline, mesh=jmesh)
    else:
        js = JModelSharding(jcfg, jmesh)
        jsp, jspg, fwd = js.shard_params, js.shard_pages, None
        ts = ModelSharding(cfg, rmesh)
        sp, spg = ts.shard_params, ts.shard_pages
    jeng = JaxEngine(jcfg, params, JaxEngineConfig(
        mesh=None if staged else jmesh, shard_params_fn=jsp,
        shard_pages_fn=jspg, attn_impl="scan", **ENGINE), forward_fn=fwd)
    eng = TorchEngine(cfg, get_family(cfg).params_from_jax(tree, cfg),
                      TorchEngineConfig(mesh=rmesh, shard_params_fn=sp,
                                        shard_pages_fn=spg, **ENGINE),
                      device="cpu")
    whole = (cfg.num_layers, 2, cfg.num_kv_heads, PS, cfg.head_dim)
    assert eng.kv_block_shape() == whole
    assert _block_bytes(eng) == jblock_bytes(jeng) == \
        int(np.prod(whole)) * 4
    assert tuple(eng.pages.shape) != (whole[0], NPAGES) + whole[1:]


# -- the worlds -------------------------------------------------------------------


@pytest.mark.parametrize("name,fam,mesh,micro,n", FWD,
                         ids=[c[0] for c in FWD])
def test_pipeline_forward_matches_the_reference_pipeline(
        worlds, name, fam, mesh, micro, n):
    want_logits, want_cache = worlds[0][name]
    world = _size(mesh)
    cfg = ModelConfig(**_fwd_kw(fam))
    lps = cfg.num_layers // mesh["pp"]
    tp = mesh.get("tp", 1)
    hkv = cfg.num_kv_heads // tp
    for r in range(world):
        got = _rank(worlds, world, r, name)
        assert len(got["logits"]) == len(want_logits) == n
        for g, w in zip(got["logits"], want_logits):
            # every rank holds every row's logits
            np.testing.assert_allclose(g, w, rtol=PP_RTOL, atol=PP_RTOL)
        c = got["coords"]
        # this rank's stage's layers and its kv heads of the cache, every
        # page but the garbage page
        want = want_cache[c["pp"] * lps:(c["pp"] + 1) * lps, :, :,
                          c["tp"] * hkv:(c["tp"] + 1) * hkv]
        assert got["cache"].shape == want.shape
        np.testing.assert_allclose(got["cache"][:, 1:], want[:, 1:],
                                   rtol=PP_RTOL, atol=PP_RTOL)
        assert np.any(got["cache"][:, 1:])


def _streams(res):
    return {k: v for k, v in res.items()
            if isinstance(v, dict) and ("tokens" in v or "error" in v)}


@pytest.mark.parametrize("name,mesh", ENGINES,
                         ids=[f"{n}-{_cid(m)}" for n, m in ENGINES])
def test_engine_streams_match_jax_engine_on_the_pipeline(worlds, name,
                                                         mesh):
    case = f"{name}-{_cid(mesh)}"
    world = _size(mesh)
    got = _rank(worlds, world, 0, case)
    want = worlds[0][case]
    gs, ws = _streams(got), _streams(want)
    assert set(gs) == set(ws) == {"p0", "p1", "p2", "q0"}
    for rid in ws:
        assert "error" not in gs[rid], gs[rid]
        assert gs[rid]["tokens"] == ws[rid]["tokens"], rid
        assert gs[rid]["finish"] == ws[rid]["finish"], rid
        np.testing.assert_allclose(gs[rid]["logprobs"], ws[rid]["logprobs"],
                                   rtol=1e-4, atol=1e-5)
    c = got["counters"]
    # every path of the engine ran through the pipeline: fused blocks,
    # chained steps (the logit-biased request) and mixed steps (p2)
    assert c["blocks"] > 0 and c["chained"] > 0, c
    assert "mixed" in got["taps"] and "chained" in got["taps"]
    assert got["tap_threads"] == 1
    if mesh.get("dp", 1) > 1:
        assert c["dp_splits"] > 0
    for r in range(1, world):
        assert _rank(worlds, world, r, case)["launches"] == got["launches"]
    # the dp replicas hold the same cache, stage by stage
    half = world // mesh.get("dp", 1)
    for r in range(half, world):
        mine = _rank(worlds, world, r - half, case)["cache"]
        other = _rank(worlds, world, r, case)["cache"]
        assert mine[:, 1:].tobytes() == other[:, 1:].tobytes(), r


def _frames_data(frames) -> np.ndarray:
    """Layer-major merged frames as one transport array ``[L, n, 2, Hkv,
    ps, Dh]`` (float32), the frames' blocks in order."""
    parts = []
    for meta, raw in frames:
        L, *rest = meta["block_shape"]
        parts.append(np.frombuffer(raw, np.float32).reshape(
            L, len(meta["blocks"]), *rest))
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("mesh", [PP2, PP2TP2], ids=_cid)
def test_kv_frames_of_a_staged_world_equal_a_one_rank_engine(worlds, mesh):
    world = _size(mesh)
    tp = mesh.get("tp", 1)
    cfg = ModelConfig(**_engine_kw())
    got = _rank(worlds, world, 0, f"ppkv-{_cid(mesh)}")
    assert got["a"]["tokens"] == got["one_a"]["tokens"]
    # merged frames of the whole tree, as the one-rank engine's
    assert len(got["frames"]) == len(got["one_frames"]) >= 2
    for (m1, _r1), (m2, _r2) in zip(got["frames"], got["one_frames"]):
        assert m1 == m2
        assert m1["block_shape"] == [cfg.num_layers, 2, cfg.num_kv_heads,
                                     PS, cfg.head_dim]
    pages = np.asarray(got["pages"])
    mine, one = _frames_data(got["frames"]), _frames_data(got["one_frames"])
    assert mine.tobytes() == pages.tobytes()
    if tp == 1:
        # pp splits no sum: the staged forward's KV is the one-rank one's
        assert mine.tobytes() == one.tobytes()
    else:
        np.testing.assert_allclose(mine, one, rtol=PP_RTOL, atol=1e-6)
    # injected both ways, byte-equal: the world's frames into the emptied
    # one-rank engine, the one-rank engine's into the emptied world
    assert np.asarray(got["one_pages"]).tobytes() == pages.tobytes()
    assert np.asarray(got["back"]).tobytes() == one.tobytes()
    assert got["b"]["cached"] >= 24
    # every other rank received its layers (and heads) of each scatter
    for r in range(1, world):
        res = _rank(worlds, world, r, f"ppkv-{_cid(mesh)}")
        assert res["scatters"]
        for vals in res["scatters"].values():
            assert vals.shape[0] == cfg.num_layers // mesh["pp"]
            assert vals.shape[3] == cfg.num_kv_heads // tp


def test_kvbm_round_trip_on_a_staged_world(worlds):
    got = _rank(worlds, 2, 0, "kvbm-pp2")
    assert got["evicted"] > 0 and got["onboarded"] > 0, got
    assert got["on_disk"] > 0
    assert np.asarray(got["before"]).tobytes() == \
        np.asarray(got["after"]).tobytes()
    assert got["p1"]["tokens"] == got["p2"]["tokens"]


# -- the worker -------------------------------------------------------------------


def test_pp2_tp2_worker_serves_chat_and_embeddings(tmp_path):
    import chip_smoke as cs
    from tests.test_torch_parallel_worker import (ENGINE_FLAGS, _env, _get,
                                                  _post)
    from dynamo_tpu_torch.utils.testing import make_test_model_dir
    model_dir = make_test_model_dir(str(tmp_path / "pp-model"),
                                    num_hidden_layers=4)
    coord_port, http_port = free_port(), free_port()
    coord = f"127.0.0.1:{coord_port}"
    env = _env()
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
             "--model-name", "pp", "--random-weights", "--device", "cpu",
             "--pipeline-parallel-size", "2", "--tensor-parallel-size", "2"]
            + ENGINE_FLAGS, str(tmp_path), env)
        procs.append(worker)
        procs.append(cs.Child("frontend", "dynamo_tpu_torch.frontend.main",
                              ["--coordinator", coord, "--http-host",
                               "127.0.0.1", "--http-port", str(http_port)],
                              str(tmp_path), env))
        worker.wait_for("torch worker serving model", timeout=120)
        assert "world 4, backend gloo, fused blocks eager, mesh dp 1 x pp " \
               "2 x tp 2" in worker.text()
        procs[-1].wait_for("frontend listening", timeout=60)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.monotonic() + 60
        while not _get(f"{base}/v1/models")["data"]:
            assert time.monotonic() < deadline, "model never registered"
            time.sleep(0.2)
        chat = {"model": "pp", "max_tokens": 6, "temperature": 0,
                "messages": [{"role": "user", "content": "staged hello"}]}
        r1 = _post(f"{base}/v1/chat/completions", chat)
        assert r1["choices"][0]["finish_reason"] == "length"
        assert r1["usage"]["completion_tokens"] == 6
        r2 = _post(f"{base}/v1/chat/completions", chat)
        assert r2["choices"][0]["message"]["content"] == \
            r1["choices"][0]["message"]["content"]
        emb = _post(f"{base}/v1/embeddings",
                    {"model": "pp", "input": ["hello", "fox"]})
        vecs = [d["embedding"] for d in emb["data"]]
        assert [len(v) for v in vecs] == [64, 64]
        assert all(np.isfinite(v).all() for v in vecs)
        assert all(p.proc.poll() is None for p in procs)
    except BaseException:
        for proc in procs:
            print(f"--- {proc.name}\n{proc.tail()}")
        raise
    finally:
        for proc in reversed(procs):
            proc.stop()
