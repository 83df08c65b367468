"""The KV data plane over a tensor-parallel cache, against the JAX
package's mesh, on the CPU.

A world of two ranks (``tests/torch_parallel_ranks.py``, started as
processes) serves the tiny Llama at tp=2 twice, while this process runs
the same workloads on ``JaxEngine`` on the conftest's tp=2 mesh:

- ``kv``: prompt ``a`` served, its blocks exported as merged frames
  (``export_frames``: the leader's fanned-out gather assembles the whole
  kv heads from both ranks) and its pages gathered; the world then injects
  the reference's frames of a prompt it never computed and serves a
  request on them. The two packages' frames of the same hashes agree
  (metas and layout equal, bytes within ``FRAME_RTOL``; the cache's shard
  layout is the reference's, and the world advertises none), the stream
  on the injected reference frames equals the reference's own, and the
  world's frames injected into a tp=1 ``JaxEngine`` give the stream the
  reference gives on its own blocks. Each follower receives only its own
  head slice of every scatter.
- ``kvbm``: a host + disk tier round trip through ``TieredEngine``: the
  pages onboarded back are byte-equal to those gathered before the
  eviction, and the streams equal ``TieredEngine`` over ``JaxEngine`` on
  the mesh.

- ``kvbm_sampled``: evictions between the steps of an unseeded sampled
  stream decoding through chained steps and fused blocks: leader and
  follower run every step under one step id and agree on its output
  (the eviction's gather takes an id of its own ahead of the step).

Every fanned-out dispatch and page IO op of the leader, the evictions'
gathers the scheduler planned included, runs on its one step thread, and
a scatter that fails on the follower alone trips the outcome cross-check
(the world's last case: it breaks the world).
"""

import asyncio
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu import tokens as jtokens
from dynamo_tpu.engine import transfer as jtransfer
from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.kvbm.manager import TieredEngine as JTieredEngine
from dynamo_tpu.kvbm.manager import TieredKvConfig as JTieredKvConfig
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel import (HELPER, REPO, _jax_engine, _kw,
                                       _tree, _world_spec)

# float32 K/V of the layers past the first come from row-parallel sums
FRAME_RTOL = 1e-5
KV_ENGINE = dict(num_pages=64, page_size=4, max_num_seqs=4,
                 max_prefill_chunk=16, max_context=64, min_prefill_bucket=16,
                 min_decode_bucket=4)
KVBM_ENGINE = dict(num_pages=16, page_size=4, max_num_seqs=2,
                   max_prefill_chunk=16, max_context=64,
                   min_prefill_bucket=16, min_decode_bucket=2)
TP2 = dict(tp=2)
JNS = {"transfer": jtransfer, "tokens": jtokens,
       "TieredEngine": JTieredEngine, "TieredKvConfig": JTieredKvConfig}


def _run(tmp):
    """Start the world, run the references beside it, collect."""
    ref_path = str(tmp / "ref_frames.pkl")
    tree = _tree("llama")[3]
    cases = [dict(kind="engine", name="kv", cfg=_kw("llama"), tree=tree,
                  mesh=TP2, engine=KV_ENGINE, workload="kv",
                  ref_frames=ref_path),
             dict(kind="engine", name="kvbm", cfg=_kw("llama"), tree=tree,
                  mesh=TP2, engine=KVBM_ENGINE, workload="kvbm",
                  disk_path=str(tmp / "port-disk")),
             dict(kind="engine", name="kvbm_sampled", cfg=_kw("llama"),
                  tree=tree, mesh=TP2, engine=KVBM_ENGINE,
                  workload="kvbm_sampled", record_steps=True,
                  disk_path=str(tmp / "port-disk-sampled")),
             # last: a follower's failure breaks the world
             dict(kind="engine", name="kvfail", cfg=_kw("llama"), tree=tree,
                  mesh=TP2, engine=KV_ENGINE, workload="kvfail",
                  fail_step=0, fail_kinds=("scatter",))]
    path, out = _world_spec(tmp, 2, cases)
    proc = subprocess.Popen([sys.executable, HELPER, path],
                            env=dict(os.environ, OMP_NUM_THREADS="1"),
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    refs = {}

    def kv():
        eng = _jax_engine("llama", TP2, KV_ENGINE)

        async def go():
            try:
                return await ranks.kv_workload(eng, JRequest, JSampling,
                                               JStop, JNS)
            finally:
                await eng.stop()
        refs["kv"] = asyncio.run(go())
        with open(ref_path + ".tmp", "wb") as f:
            pickle.dump(refs["kv"]["frames2"], f)
        os.replace(ref_path + ".tmp", ref_path)

    def kvbm():
        eng = _jax_engine("llama", TP2, KVBM_ENGINE)
        refs["kvbm"] = asyncio.run(ranks.kvbm_workload(
            eng, JRequest, JSampling, JStop, JNS, str(tmp / "ref-disk")))

    try:
        with ThreadPoolExecutor(2) as pool:
            for job in [pool.submit(kv), pool.submit(kvbm)]:
                job.result()
    finally:
        try:
            log, _ = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        got = {"rc": proc.returncode, "log": log}
        for r in range(2):
            try:
                with open(f"{out}.{r}", "rb") as f:
                    got[r] = pickle.load(f)
            except FileNotFoundError:
                got[r] = {"error": f"rank {r} wrote nothing"}
    return refs, got


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("kvworld"))


def _leader(world, name):
    got = world[1]
    res = got[0]
    assert name in res, (res.get("error"), got["log"][-3000:])
    return res[name]


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _same_stream(got, want):
    assert "error" not in got, got
    assert got["tokens"] == want["tokens"]
    assert got["finish"] == want["finish"]
    assert got["cached"] == want["cached"]


def _frame_values(meta, raw):
    bs = meta["block_shape"]
    n = len(meta["blocks"])
    return np.frombuffer(raw, np.float32).reshape([bs[0], n] + bs[1:])


def test_merged_frames_equal_the_reference(world):
    got, want = _leader(world, "kv"), world[0]["kv"]
    _same_stream(got["a"], want["a"])
    assert len(got["frames"]) == len(want["frames"]) == 2
    for (gm, graw), (wm, wraw) in zip(got["frames"], want["frames"]):
        assert gm == wm
        assert gm["layout"] == "layer" and gm["dtype"] == "float32"
        _close(_frame_values(gm, graw), _frame_values(wm, wraw), FRAME_RTOL)
    # the gathered pages are the whole kv heads: the frames' bytes
    whole = np.concatenate([_frame_values(m, r) for m, r in got["frames"]],
                           axis=1)
    assert whole.shape[3] == _kw("llama")["num_kv_heads"]
    np.testing.assert_array_equal(got["pages"], whole)
    _close(got["pages"], want["pages"], FRAME_RTOL)
    # the reference's layout of the tp=2 cache; a world advertises no
    # shard layout (merged frames), as the reference's multi-host does
    assert got["layout"] == want["layout"] == (2, 3)
    assert got["payload"] == {}


def test_reference_frames_injected_into_the_world_stream_as_the_reference(
        world):
    got, want = _leader(world, "kv"), world[0]["kv"]
    assert got["injected"] == len(want["frames2"][0][0]["blocks"]) == 4
    _same_stream(got["b"], want["b"])
    assert got["b"]["cached"] == 16


def test_world_frames_injected_into_a_one_device_jax_engine(world):
    got, want = _leader(world, "kv"), world[0]["kv"]
    jcfg = JModelConfig(**_kw("llama"))
    params = jax.tree_util.tree_map(jnp.asarray, _tree("llama")[3])
    eng = JaxEngine(jcfg, params, JaxEngineConfig(attn_impl="scan",
                                                  **KV_ENGINE))
    a, c = ranks._prompts(17, [24, 16])[0], want["c"]
    tail = ranks._prompts(19, [5])[0]

    async def go():
        try:
            n = 0
            for meta, raw in got["frames"]:
                n += await eng.run_exclusive(jtransfer.inject_frame, eng,
                                             dict(meta, _raw=raw))
            s = await ranks._stream(eng, ranks._req(
                JRequest, JSampling, JStop, "c", a + tail, 6,
                temperature=0.0))
            return n, s
        finally:
            await eng.stop()
    n, stream = asyncio.run(go())
    assert n == 6
    _same_stream(stream, c)
    assert stream["cached"] == 24


def test_each_follower_receives_only_its_own_head_slice(world):
    for name in ("kv", "kvbm"):
        lead = _leader(world, name)["scatters"]
        follower = world[1][1][name]
        assert "follower_error" not in follower, follower
        got = follower["scatters"]
        assert lead and set(got) == set(lead), name
        hkv = _kw("llama")["num_kv_heads"]
        for step, parts in lead.items():
            assert len(parts) == 2
            assert parts[0].shape == parts[1].shape == got[step].shape
            assert got[step].shape[3] == hkv // 2
            np.testing.assert_array_equal(got[step], parts[1])


def test_every_page_io_op_runs_on_the_leader_step_thread(world):
    for name in ("kv", "kvbm"):
        res = _leader(world, name)
        assert res["tap_threads"] == 1, name
        assert world[1][1][name]["launches"] == res["launches"]


def test_a_scatter_failed_on_the_follower_alone_trips_the_cross_check(
        world):
    follower = world[1][1]
    assert "kvfail" in follower, follower.get("error")
    err = follower["kvfail"].get("follower_error", "")
    assert "multihost divergence: leader completed step" in err, follower
    assert follower["kvfail"]["scatters"], "no scatter reached the follower"


def test_kvbm_round_trip_on_the_world_is_byte_exact(world):
    got, want = _leader(world, "kvbm"), world[0]["kvbm"]
    for rid in ("p1", "x", "p2"):
        _same_stream(got[rid], want[rid])
    assert got["evicted"] == want["evicted"] == 6
    assert got["onboarded"] == want["onboarded"] >= 6
    assert got["offloaded"] >= 6 and got["on_disk"] > 0
    assert got["p2"]["cached"] == 24
    assert got["before"].tobytes() == got["after"].tobytes()
    _close(got["before"], want["before"], FRAME_RTOL)


def test_evictions_between_sampled_steps_keep_the_ranks_in_lockstep(
        world):
    got = _leader(world, "kvbm_sampled")
    follower = world[1][1]["kvbm_sampled"]
    assert "follower_error" not in follower, follower
    for rid in ("q", "s", "x"):
        assert "error" not in got[rid], got[rid]
    assert len(got["s"]["tokens"]) == 16 and len(got["x"]["tokens"]) == 2
    # q's blocks were evicted at x's admission: their gathers fanned out
    # after s's fused blocks and before the mixed step of x's prefill
    # and s's sampled row
    assert got["evicted"] > 0
    taps = got["taps"]
    decode = [i for i, k in enumerate(taps) if k in ("block", "mixed")]
    assert any(decode[0] < i < decode[-1]
               for i, k in enumerate(taps) if k == "gather"), " ".join(taps)
    kinds = {k for k, _s, _p in got["steps"]}
    assert {"block", "mixed"} <= kinds, kinds
    lead, foll = got["steps"], follower["steps"]
    assert [(k, s) for k, s, _p in foll] == [(k, s) for k, s, _p in lead]
    for (kind, step, want), (_k, _s, have) in zip(lead, foll):
        np.testing.assert_array_equal(have, want, err_msg=f"{kind} {step}")
