"""Data parallelism of the port against the JAX package's dp meshes, on
the CPU.

Two rank worlds (``tests/torch_parallel_ranks.py``, started as processes):
dp=2 (two ranks) and dp=2 x tp=2 (four), beside ``JaxEngine`` on
``MeshSpec(dp=2)`` and ``MeshSpec(dp=2, tp=2)`` on the conftest's virtual
devices running the same workloads:

- streams, greedy and sampled (unseeded draws address their rows of the
  whole batch's draw; seeded ones their seed and position), through
  prefill, mixed and chained steps and fused blocks, and (dp=2) through
  speculative verify steps with embeddings and scoring beside them, are
  token-equal to the reference's; a shared-prefix request on the other
  replica's rows reads pages the first replica's rows wrote;
- after each workload every dp replica's cache is byte-equal to the
  other's, page for page: the page pool stays replicated because every
  replica writes every row's K/V;
- the forwards of DeepSeek (dense experts) and of the MoE dispatch
  backend at a capacity that drops (the whole batch's capacity and
  slots, each replica its rows) match the reference's mesh forward, drop
  counts included.

In this process, with no process group: a batch dp does not divide (B=1)
runs replicated, issuing no collective; the bucket floors and the
``max_num_seqs`` refusal equal the reference's.
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
from dynamo_tpu.models import get_family as jget_family
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dynamo_tpu.parallel.sharding import ModelSharding as JModelSharding
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import TorchEngine, \
    TorchEngineConfig
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.parallel.mesh import MeshSpec, RankMesh
from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel import (ENGINE, HELPER, LOGIT_RTOL, REPO,
                                       _forward_case, _jax_engine, _jmesh,
                                       _kw, _port_params, _ref_forward,
                                       _tree, _world_spec)

DP2, DP2TP2 = dict(dp=2), dict(dp=2, tp=2)
DP_ENGINE = dict(ENGINE, min_prefill_bucket=16)
SPEC_ENGINE = dict(ENGINE, spec_tokens=2, decode_multistep=1)
# (world, name, mesh, engine sizes, workload)
ENGINES = [(2, "dp", DP2, DP_ENGINE, "dp"),
           (2, "spec", DP2, SPEC_ENGINE, "spec"),
           (4, "dp", DP2TP2, DP_ENGINE, "dp")]
# the dispatch backend at a capacity that drops: one prefill of 96
# tokens (past the small-batch floor of 64) over 8 experts
MOE_CF = 0.5
MOE_PAGES, MOE_PS = 32, 4


def _moe_kw():
    return dict(_kw("moe_dispatch"), moe_capacity_factor=MOE_CF)


def _moe_steps():
    """A prefill of rows of 48 and 40 tokens, then a decode step."""
    rng = np.random.default_rng(6)
    B, P = 2, 16
    table = np.zeros((B, P), np.int32)
    table[0, :13] = np.arange(1, 14)
    table[1, :11] = np.arange(14, 25)
    lens = [48, 40]
    toks = np.zeros((B, 48), np.int32)
    pos = np.zeros((B, 48), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, 256, size=n)
        pos[i, :n] = np.arange(n)
    pre = dict(tokens=toks, positions=pos, table=table,
               total=np.array(lens, np.int32), new=np.array(lens, np.int32))
    dec = dict(tokens=rng.integers(1, 256, size=(B, 1)).astype(np.int32),
               positions=np.array([[48], [40]], np.int32), table=table,
               total=np.array([49, 41], np.int32), new=np.ones(B, np.int32))
    return [pre, dec]


def _moe_case():
    cfg = ModelConfig(**_moe_kw())
    return dict(kind="forward", name="fwd-moe-dispatch-dp2",
                cfg=dataclasses.asdict(cfg), tree=_tree("moe_dispatch")[3],
                mesh=DP2, num_pages=MOE_PAGES, page_size=MOE_PS,
                steps=_moe_steps())


def _moe_ref():
    jcfg = JModelConfig(**_moe_kw())
    params = jax.tree_util.tree_map(jnp.asarray, _tree("moe_dispatch")[3])
    jshard = JModelSharding(jcfg, _jmesh(JMeshSpec(dp=2)))
    p = jshard.shard_params(params)
    pages = jshard.shard_pages(jllama.make_pages(jcfg, MOE_PAGES, MOE_PS))
    fam = jget_family(jcfg)
    fwd = jax.jit(lambda p, pg, t, po, tb, tot, new: fam.forward(
        p, jcfg, t, po, pg, tb, tot, new))
    logits, drops = [], []
    for st in _moe_steps():
        out = fwd(p, pages, *(jnp.asarray(st[k]) for k in (
            "tokens", "positions", "table", "total", "new")))
        pages = out[1]
        logits.append(np.asarray(out[0]))
        drops.append(int(out[2]["moe_dropped_assignments"]))
    return logits, drops


def _run(tmp):
    worlds = {2: [_forward_case("deepseek", DP2), _moe_case()], 4: []}
    for world, name, mesh, sizes, work in ENGINES:
        worlds[world].append(dict(
            kind="engine", name=name, cfg=_kw("llama"),
            tree=_tree("llama")[3], mesh=mesh, engine=sizes, workload=work,
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

    def engine(world, name, mesh, sizes, work):
        eng = _jax_engine("llama", mesh, sizes)

        async def go():
            try:
                return await ranks.WORKLOADS[work](eng, JRequest, JSampling,
                                                   JStop)
            finally:
                await eng.stop()
        refs[(world, name)] = asyncio.run(go())

    def forwards():
        refs["deepseek"] = _ref_forward("deepseek", DP2)
        refs["moe"] = _moe_ref()

    try:
        with ThreadPoolExecutor(1 + len(ENGINES)) as pool:
            jobs = [pool.submit(engine, *e) for e in ENGINES]
            jobs.append(pool.submit(forwards))
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
    job = pool.submit(_run, tmp_path_factory.mktemp("dpworlds"))
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


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _streams(res):
    return {k: v for k, v in res.items()
            if isinstance(v, dict) and ("tokens" in v or "error" in v)}


@pytest.mark.parametrize("world,name", [(w, n) for w, n, *_ in ENGINES],
                         ids=[f"{n}-world{w}" for w, n, *_ in ENGINES])
def test_dp_streams_match_jax_engine_on_the_dp_mesh(worlds, world, name):
    got = _rank(worlds, world, 0, name)
    want = worlds[0][(world, name)]
    gs, ws = _streams(got), _streams(want)
    assert set(gs) == set(ws)
    for rid in ws:
        assert "error" not in gs[rid], gs[rid]
        assert gs[rid]["tokens"] == ws[rid]["tokens"], rid
        assert gs[rid]["finish"] == ws[rid]["finish"], rid
        assert gs[rid]["cached"] == ws[rid]["cached"], rid
        np.testing.assert_allclose(gs[rid]["logprobs"], ws[rid]["logprobs"],
                                   rtol=1e-4, atol=1e-5)
    c = got["counters"]
    if name == "dp":
        assert c["blocks"] > 0 and c["chained"] >= 0
        # d5 shares d0's first 20 tokens: 5 blocks from the other
        # replica's rows
        assert gs["d5"]["cached"] == 20
    else:
        assert c["chained"] > 0 and c["blocks"] == 0
        np.testing.assert_allclose(got["embed"], want["embed"], rtol=1e-5)
        for (gl, gi, gt), (wl, wi, wt) in zip(got["score"], want["score"]):
            np.testing.assert_allclose(gl, wl, atol=2e-5)
            np.testing.assert_array_equal(gi, wi)
    assert got["tap_threads"] == 1
    # the steps and blocks dp divides ran split on every rank (a step run
    # replicated would give the same streams)
    assert c["dp_splits"] > 0
    for r in range(1, world):
        res = _rank(worlds, world, r, name)
        assert res["launches"] == got["launches"]
        assert res["dp_splits"] == c["dp_splits"]


@pytest.mark.parametrize("world,name", [(w, n) for w, n, *_ in ENGINES],
                         ids=[f"{n}-world{w}" for w, n, *_ in ENGINES])
def test_every_dp_replica_holds_the_same_cache(worlds, world, name):
    tp = world // 2
    written = 0
    for r in range(tp):
        mine = _rank(worlds, world, r, name)["cache"]
        other = _rank(worlds, world, r + tp, name)["cache"]
        assert mine.shape == other.shape
        for page in range(1, mine.shape[1]):
            assert mine[:, page].tobytes() == other[:, page].tobytes(), \
                (r, page)
            written += bool(np.any(mine[:, page]))
    assert written >= 8 * tp


def test_deepseek_forward_at_dp2_matches_the_reference_mesh(worlds):
    case = "fwd-" + "-".join(["deepseek"] + [f"{k}{v}" for k, v in
                                             DP2.items()])
    got = _rank(worlds, 2, 0, case)
    want_logits, want_drops = worlds[0]["deepseek"]
    for g, w in zip(got["logits"], want_logits):
        _close(g, w, LOGIT_RTOL)
    assert got["drops"] == want_drops
    assert np.array_equal(_rank(worlds, 2, 1, case)["logits"][0],
                          got["logits"][0])


def test_moe_dispatch_at_dp2_drops_as_the_whole_batch(worlds):
    got = _rank(worlds, 2, 0, "fwd-moe-dispatch-dp2")
    want_logits, want_drops = worlds[0]["moe"]
    for g, w in zip(got["logits"], want_logits):
        _close(g, w, LOGIT_RTOL)
    assert got["drops"] == want_drops and want_drops[0] > 0


# -- in this process ------------------------------------------------------------


def _dp_engine(**sizes):
    cfg = ModelConfig(**_kw("llama"))
    return TorchEngine(cfg, _port_params("llama"), TorchEngineConfig(
        mesh=RankMesh(MeshSpec(dp=2), 0), **sizes), device="cpu")


def test_bucket_floors_and_refusal_equal_the_reference():
    jcfg = JModelConfig(**_kw("llama"))
    params = jax.tree_util.tree_map(jnp.asarray, _tree("llama")[3])
    with pytest.raises(ValueError) as want:
        JaxEngine(jcfg, params, JaxEngineConfig(
            mesh=_jmesh(JMeshSpec(dp=2)), max_num_seqs=3, attn_impl="scan"))
    with pytest.raises(ValueError) as got:
        _dp_engine(max_num_seqs=3)
    assert str(got.value) == str(want.value)
    jeng = _jax_engine("llama", DP2, ENGINE)
    eng = _dp_engine(**ENGINE)
    for knob in ("min_decode_bucket", "min_prefill_seqs_bucket"):
        assert getattr(eng.cfg, knob) == getattr(jeng.cfg, knob) == \
            (4 if knob == "min_decode_bucket" else 2), knob


def test_a_batch_dp_does_not_divide_runs_replicated():
    """B=1 on a dp=2 rank whose mesh has no process group: any collective
    would raise; the packed output equals a one-rank engine's."""
    cfg = ModelConfig(**_kw("llama"))
    one = TorchEngine(cfg, _port_params("llama"),
                      TorchEngineConfig(**ENGINE), device="cpu")
    two = _dp_engine(**ENGINE)
    rng = np.random.default_rng(8)
    a = one._empty_arrays(1, 16)
    a["toks"][0, :11] = rng.integers(1, 256, size=11)
    a["pos"][0, :11] = np.arange(11)
    a["total"][0] = a["new"][0] = 11
    a["temp"][0] = 0.8
    a["table"] = np.zeros((1, one.table_width), np.int32)
    a["table"][0, :3] = [1, 2, 3]
    a["step"] = np.array(3, np.int64)
    with torch.no_grad():
        want = one._step(dict(a), "paged_prefill")
        got = two._step(dict(a), "paged_prefill")
    assert torch.equal(got, want)
    assert torch.equal(two.pages, one.pages)
    assert two.dp_splits == 0
