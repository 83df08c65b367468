"""The port's worker and profiler at world size 2, on the CPU.

- ``--tensor-parallel-size 2``: one worker process starts its own follower
  rank (the same command with ``--local-rank 1``), joins a gloo world with
  it and serves chat (twice, the same text), ``/v1/embeddings`` and echo
  scoring through the frontend.
- ``--num-nodes 2``: two workers, one per node rank, rendezvous at
  ``--jax-coordinator`` and through the bring-up barrier, and serve the
  same.
- The KV data plane and dp at world size > 1, on one stack: a tp=2
  ``--disagg prefill`` world beside a tp=1 ``--disagg decode`` worker
  answers as an aggregated tp=1 worker (greedy), its prompts prefilled
  remotely and pulled; a ``--data-parallel-size 2`` worker answers the
  same; a tp=2 worker with ``--host-cache-bytes`` serves ``kv_export`` to
  a peer (merged frames of the whole kv heads, the aggregated worker's
  blocks); SIGTERM on that world's leader drains it and releases its
  follower.
- ``--sequence-parallel-size 2``, alone and with ``--data-parallel-size
  2``, makes a world of dp x sp ranks and ``build_engine`` builds the
  engine the reference's ``build_engine`` builds on the same flags: its
  mesh, ring threshold, bucket floors and sizes (sp worlds serve in
  ``tests/test_torch_parallel_sp.py``; pipeline parallelism in
  ``tests/test_torch_parallel_pp.py``).
- The profiler's tp=2 sweep config runs over a rank group and writes the
  reference's schema.

Every process here is a subprocess: this process starts no process group.
"""

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from dynamo_tpu_torch.planner.perf_interpolation import MultiPerfInterpolator
from dynamo_tpu_torch.worker.main import build_parser, refuse_unported
from tests.procutils import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_FLAGS = ["--page-size", "4", "--num-pages", "64", "--max-num-seqs",
                "2", "--max-prefill-chunk", "16", "--max-context", "128",
                "--no-kv-events", "--dtype", "float32"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env["OMP_NUM_THREADS"] = "1"
    return env


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read().decode())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from dynamo_tpu_torch.utils.testing import make_test_model_dir
    path = str(tmp_path_factory.mktemp("model") / "tp-model")
    make_test_model_dir(path)
    return path


def _serve_and_check(tmp_path, model_dir, worker_argvs, follower_line):
    import chip_smoke as cs
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
        workers = []
        for i, argv in enumerate(worker_argvs):
            workers.append(cs.Child(
                f"worker{i}", "dynamo_tpu_torch.worker.main",
                ["--coordinator", coord, "--model-path", model_dir,
                 "--model-name", "tp", "--random-weights", "--device",
                 "cpu"] + ENGINE_FLAGS + argv, str(tmp_path), env))
        procs += workers
        procs.append(cs.Child("frontend", "dynamo_tpu_torch.frontend.main",
                              ["--coordinator", coord, "--http-host",
                               "127.0.0.1", "--http-port", str(http_port)],
                              str(tmp_path), env))
        workers[0].wait_for("torch worker serving model", timeout=120)
        assert "world 2, backend gloo, fused blocks eager" in \
            workers[0].text()
        follower = workers[-1]
        follower.wait_for(follower_line, timeout=60)
        procs[-1].wait_for("frontend listening", timeout=60)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.monotonic() + 60
        while not _get(f"{base}/v1/models")["data"]:
            assert time.monotonic() < deadline, "model never registered"
            time.sleep(0.2)
        chat = {"model": "tp", "max_tokens": 6, "temperature": 0,
                "messages": [{"role": "user", "content": "tensor hi"}]}
        r1 = _post(f"{base}/v1/chat/completions", chat)
        assert r1["choices"][0]["finish_reason"] == "length"
        assert r1["usage"]["completion_tokens"] == 6
        r2 = _post(f"{base}/v1/chat/completions", chat)
        assert r2["choices"][0]["message"]["content"] == \
            r1["choices"][0]["message"]["content"]
        emb = _post(f"{base}/v1/embeddings",
                    {"model": "tp", "input": ["hello", "fox"]})
        assert [len(d["embedding"]) for d in emb["data"]] == [64, 64]
        echo = _post(f"{base}/v1/completions",
                     {"model": "tp", "prompt": "hello world", "echo": True,
                      "max_tokens": 0, "logprobs": 0})
        assert echo["choices"][0]["text"] == "hello world"
        assert echo["choices"][0]["logprobs"]["token_logprobs"][0] is None
        assert all(p.proc.poll() is None for p in procs)
        return r1["choices"][0]["message"]["content"]
    except BaseException:
        for proc in procs:
            print(f"--- {proc.name}\n{proc.tail()}")
        raise
    finally:
        for proc in reversed(procs):
            proc.stop()


# the KV stack's chats, and the token-id prompt of its peer pull (six
# full pages and two tokens)
KV_CHATS = ["tensor hi", "world of ranks", "pages move"]
KV_PROMPT = [int(x) for x in np.random.default_rng(3).integers(5, 200, 26)]
PAGE = 4


async def _pull_kv_export(coord, component, hashes):
    """A peer's pull from ``component``'s ``kv_export``: wire-v5 frames,
    as (meta, bytes) pairs."""
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    drt = await DistributedRuntime.create(coordinator=coord)
    try:
        client = await drt.namespace("dynamo").component(component) \
            .endpoint("kv_export").client()
        (inst, *_rest) = await client.wait_for_instances(1, timeout=30)
        stream = await client.direct({"block_hashes": hashes, "wire": 5},
                                     inst.instance_id)
        frames = []
        async for f in stream:
            if "_raw" in f:
                meta = {k: v for k, v in f.items() if k != "_raw"}
                frames.append((meta, bytes(f["_raw"])))
        return frames
    finally:
        await drt.close()


def _kv_stack(tmp_path, model_dir):
    """One coordinator and frontend; workers: ``agg`` (tp=1, aggregated),
    the ``pd`` pair (a tp=2 ``--disagg prefill`` world and a tp=1
    ``--disagg decode`` worker), ``dp`` (``--data-parallel-size 2``) and
    ``kv`` (tp=2, ``--host-cache-bytes``). Returns each model's chat
    answers, the decode worker's pulled bytes, both peer pulls, and the
    drained world's output."""
    import chip_smoke as cs
    from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
    coord_port, http_port, dec_port = free_port(), free_port(), free_port()
    coord = f"127.0.0.1:{coord_port}"
    env = _env()
    procs = {}

    def worker(name, model, extra, system_port=None):
        wenv = env if system_port is None else dict(
            env, DYN_SYSTEM_ENABLED="1", DYN_SYSTEM_PORT=str(system_port))
        procs[name] = cs.Child(
            name, "dynamo_tpu_torch.worker.main",
            ["--coordinator", coord, "--model-path", model_dir,
             "--model-name", model, "--random-weights", "--device", "cpu"]
            + ENGINE_FLAGS + extra, str(tmp_path), wenv)

    out = {}
    try:
        procs["coordinator"] = cs.Child(
            "coordinator", "dynamo_tpu_torch.runtime.coordinator",
            ["--host", "127.0.0.1", "--port", str(coord_port)],
            str(tmp_path), env)
        procs["coordinator"].wait_for("coordinator listening", timeout=60)
        worker("agg", "agg", ["--component", "agg"])
        worker("prefill", "pd", ["--tensor-parallel-size", "2", "--disagg",
                                 "prefill", "--component", "prefill"])
        worker("decode", "pd", ["--disagg", "decode"], dec_port)
        worker("dp", "dp", ["--data-parallel-size", "2", "--component",
                            "dp"])
        worker("kv", "kv", ["--tensor-parallel-size", "2",
                            "--host-cache-bytes", str(1 << 20),
                            "--component", "kvt"])
        procs["frontend"] = cs.Child(
            "frontend", "dynamo_tpu_torch.frontend.main",
            ["--coordinator", coord, "--http-host", "127.0.0.1",
             "--http-port", str(http_port)], str(tmp_path), env)
        for name in ("agg", "prefill", "decode", "dp", "kv"):
            procs[name].wait_for("torch worker serving model", timeout=120)
        procs["frontend"].wait_for("frontend listening", timeout=60)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.monotonic() + 60
        while {m["id"] for m in _get(f"{base}/v1/models")["data"]} \
                < {"agg", "pd", "dp", "kv"}:
            assert time.monotonic() < deadline, "models never registered"
            time.sleep(0.2)
        for model in ("agg", "pd", "dp"):
            out[model] = [_post(f"{base}/v1/chat/completions", {
                "model": model, "max_tokens": 6, "temperature": 0,
                "messages": [{"role": "user", "content": c}]})
                ["choices"][0]["message"]["content"] for c in KV_CHATS]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{dec_port}/metrics", timeout=30) as r:
            out["decode_metrics"] = r.read().decode()
        hashes = compute_block_hash_for_seq(KV_PROMPT, PAGE)
        for model, component in (("kv", "kvt"), ("agg", "agg")):
            _post(f"{base}/v1/completions", {
                "model": model, "prompt": KV_PROMPT, "max_tokens": 2,
                "temperature": 0})
            out[f"pull_{model}"] = asyncio.run(
                _pull_kv_export(coord, component, hashes))
        out["processes_alive"] = all(p.proc.poll() is None
                                     for p in procs.values())
        kv = procs["kv"]
        os.kill(kv.proc.pid, signal.SIGTERM)
        out["kv_exit"] = kv.proc.wait(timeout=90)
        out["kv_log"] = kv.text()
        return out
    except BaseException:
        for proc in procs.values():
            print(f"--- {proc.name}\n{proc.tail()}")
        raise
    finally:
        for proc in reversed(list(procs.values())):
            proc.stop()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory, model_dir):
    """The serving stacks, side by side: one tp=2 worker that starts its
    own follower, two ``--num-nodes 2`` workers, and the KV stack
    (``_kv_stack``). Each entry is the stack's result, or the exception it
    raised."""
    addr = f"127.0.0.1:{free_port()}"
    common = ["--tensor-parallel-size", "2", "--num-nodes", "2",
              "--jax-coordinator", addr]
    runs = {"tp": [["--tensor-parallel-size", "2"]],
            "nodes": [common + ["--node-rank", "0"],
                      common + ["--node-rank", "1"]]}

    def run(name):
        try:
            if name == "kv":
                return _kv_stack(tmp_path_factory.mktemp(name), model_dir)
            return _serve_and_check(tmp_path_factory.mktemp(name), model_dir,
                                    runs[name], "torch follower rank 1/2 "
                                    "in lockstep on cpu")
        except Exception as e:  # noqa: BLE001 — raised by its test
            return e
    with ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(run, name) for name in [*runs, "kv"]}
        return {name: job.result() for name, job in jobs.items()}


def _kv(stacks):
    if isinstance(stacks["kv"], Exception):
        raise stacks["kv"]
    assert stacks["kv"]["processes_alive"]
    return stacks["kv"]


def test_tensor_parallel_worker_starts_its_follower(stacks):
    if isinstance(stacks["tp"], Exception):
        raise stacks["tp"]
    assert stacks["tp"]


def test_two_node_workers_serve_one_endpoint(stacks):
    if isinstance(stacks["nodes"], Exception):
        raise stacks["nodes"]
    assert stacks["nodes"]


def test_tp2_prefill_world_and_tp1_decode_answer_as_aggregated(stacks):
    kv = _kv(stacks)
    assert kv["pd"] == kv["agg"]
    # every prompt prefilled remotely: its KV pulled from the world
    pulled = [ln for ln in kv["decode_metrics"].splitlines()
              if ln.startswith("dynamo_worker_disagg_kv_bytes_total")
              and 'direction="pulled"' in ln]
    assert sum(float(ln.rsplit(" ", 1)[1]) for ln in pulled) > 0, pulled


def test_data_parallel_worker_answers(stacks):
    kv = _kv(stacks)
    assert kv["dp"] == kv["agg"]


def test_tp2_world_with_host_tier_serves_kv_export_to_a_peer(stacks):
    kv = _kv(stacks)
    got, want = kv["pull_kv"], kv["pull_agg"]
    assert got and len(got) == len(want)
    blocks = 0
    for (gm, graw), (wm, wraw) in zip(got, want):
        assert {k: gm[k] for k in ("blocks", "dtype", "block_shape",
                                   "layout")} == \
            {k: wm[k] for k in ("blocks", "dtype", "block_shape", "layout")}
        # merged frames: every kv head of the world's two ranks
        assert gm["block_shape"][2] == 2
        g = np.frombuffer(graw, np.float32)
        w = np.frombuffer(wraw, np.float32)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
        blocks += len(gm["blocks"])
    assert blocks == len(KV_PROMPT) // PAGE


def test_sigterm_drains_a_world_leader_and_releases_its_follower(stacks):
    kv = _kv(stacks)
    log = kv["kv_log"]
    assert kv["kv_exit"] == 0, log[-3000:]
    assert "graceful drain started (SIGTERM)" in log
    assert "drain complete" in log
    assert "torch worker rank 0 stopped: kernel launches" in log
    assert "torch follower rank 1 released: kernel launches" in log


@pytest.mark.parametrize("flags,dp", [
    (["--sequence-parallel-size", "2", "--data-parallel-size", "2"], 2),
    (["--sequence-parallel-size", "2"], 1),
], ids=["sp2-dp2", "sp2"])
def test_sequence_parallel_flags_build_the_references_engine(
        flags, dp, model_dir, monkeypatch):
    """``--sequence-parallel-size`` is served: the world is dp x sp ranks,
    and ``build_engine`` builds this rank's engine over ``MeshSpec(dp,
    sp)`` with the reference's ring threshold, bucket floors and sizes
    (the reference's ``build_engine`` on the same flags, on the
    conftest's virtual devices; the port's rank engine is built over a
    mesh without process groups, which construction does not use)."""
    import types

    import torch

    from dynamo_tpu.worker import main as jmain
    from dynamo_tpu_torch.engine.torch_engine import TorchEngine
    from dynamo_tpu_torch.parallel import multihost as mh
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, RankMesh
    from dynamo_tpu_torch.parallel.sharding import ModelSharding
    from dynamo_tpu_torch.worker import main as tmain
    argv = ["--model-path", model_dir, "--random-weights", *ENGINE_FLAGS,
            *flags]
    args = build_parser().parse_args(argv + ["--device", "cpu"])
    refuse_unported(args)
    n = 2 * dp
    assert tmain.world_size(args) == tmain.local_ranks(args) == n
    built = {}

    def rank_engine(cfg, ecfg, world, mesh_spec=None, params=None, **kw):
        built["spec"], built["world"] = mesh_spec, world.world
        shard = ModelSharding(cfg, RankMesh(mesh_spec, 0))
        return TorchEngine(cfg, params, dataclasses.replace(
            ecfg, mesh=shard.mesh, shard_params_fn=shard.shard_params,
            shard_pages_fn=shard.shard_pages), device="cpu")
    monkeypatch.setattr(mh, "build_rank_engine", rank_engine)
    eng = tmain.build_engine(args, types.SimpleNamespace(
        world=n, device=torch.device("cpu")))
    jeng = jmain.build_engine(jmain.build_parser().parse_args(argv))
    try:
        assert built == {"spec": MeshSpec(dp=dp, sp=2), "world": n}
        assert dict(jeng.cfg.mesh.shape) == built["spec"].shape()
        assert (eng._sp, eng._dp) == (jeng._sp, jeng._dp) == (2, dp)
        assert eng.scheduler.cfg.ring_threshold == \
            jeng.scheduler.cfg.ring_threshold == 16
        for k in ("num_pages", "page_size", "max_num_seqs",
                  "max_prefill_chunk", "max_context", "min_decode_bucket",
                  "min_prefill_seqs_bucket", "ring_threshold"):
            assert getattr(eng.cfg, k) == getattr(jeng.cfg, k), k
    finally:
        eng._step_executor.shutdown()


def test_tensor_parallel_world_must_span_the_nodes():
    args = build_parser().parse_args(
        ["--model-path", "m", "--tensor-parallel-size", "4",
         "--num-nodes", "2", "--local-devices", "1",
         "--jax-coordinator", "127.0.0.1:1"])
    with pytest.raises(SystemExit, match="must equal --num-nodes 2 x "
                                         "--local-devices 1"):
        refuse_unported(args)
    args = build_parser().parse_args(
        ["--model-path", "m", "--tensor-parallel-size", "2",
         "--num-nodes", "2"])
    with pytest.raises(SystemExit, match="--jax-coordinator required"):
        refuse_unported(args)


def test_profile_sweep_runs_tp2_over_a_rank_group(tmp_path):
    out = tmp_path / "sweep.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.planner.profile",
         "--sweep", "2,1", "--device", "cpu", "--dtype", "float32",
         "--isl", "8,16", "--concurrency", "1,2", "--osl", "4",
         "--num-pages", "64", "--page-size", "4", "--max-prefill-chunk",
         "16", "--output", str(out)],
        capture_output=True, text=True, timeout=180, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "profile: tp=2 sp=1 done (2+2 rows)" in proc.stdout
    profile = json.loads(out.read_text())
    assert profile["meta"] == {"engine": "torch", "model": None, "osl": 4}
    (cfg,) = profile["configs"]
    assert (cfg["tp"], cfg["sp"], cfg["chips"]) == (2, 1, 2)
    assert [r["isl"] for r in cfg["prefill"]] == [8, 16]
    assert [r["concurrency"] for r in cfg["decode"]] == [1, 2]
    for row in cfg["prefill"]:
        assert set(row) == {"isl", "ttft_s", "tokens_per_s"}
        assert row["ttft_s"] > 0
    for row in cfg["decode"]:
        assert set(row) == {"concurrency", "itl_s", "tokens_per_s"}
        assert row["tokens_per_s"] > 0
    multi = MultiPerfInterpolator.from_file(str(out))
    assert multi.options[0]["chips"] == 2
