"""Rank processes of the parallel tests: torch and the port only, no JAX.

``python tests/torch_parallel_ranks.py SPEC`` is local rank 0 of a world:
it starts the other ranks (``parallel/multihost.start_local_ranks``: the
same command with ``--local-rank R``), every rank joins the world at the
spec's ``file://`` store (``gloo``, on the CPU) and runs the spec's cases
in order, and each rank pickles its results to ``<out>.<rank>``. The
pytest process writes the spec (the reference's weights as numpy trees)
and holds rank 0's results against the JAX package; it starts no process
group itself.

Cases:

- ``forward``: the family's forward on this rank's shards (``ModelSharding``
  over the case's mesh) through the case's steps, on one cache; the logits
  and drop counts of every step.
- ``engine``: ``TorchEngine`` on this rank's shards (``build_rank_engine``);
  rank 0 fans its steps out (``StepFanout``) and runs the case's workload,
  the others ``follow_steps``. ``fail_step`` makes the followers raise once
  after running the first dispatch at or past that step: the leader's next
  message must trip the outcome cross-check.

The workloads are plain functions of (engine, request classes), so the
tests run them on ``JaxEngine`` too.
"""

from __future__ import annotations

import asyncio
import datetime
import os
import pickle
import sys
import threading
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# -- workloads ------------------------------------------------------------------


def _prompts(seed: int, sizes):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 250, size=n))) for n in sizes]


async def _stream(engine, req):
    toks, lps, last = [], [], None
    async for frame in engine.generate(req):
        if frame.error:
            return {"error": frame.error}
        toks += list(frame.token_ids)
        lps += list(frame.log_probs or [])
        last = frame
    return {"tokens": toks, "logprobs": [float(x) for x in lps],
            "finish": last.finish_reason.value}


def _req(Req, Samp, Stop, rid, prompt, max_tokens, **samp):
    return Req(token_ids=list(prompt), request_id=rid,
               stop_conditions=Stop(max_tokens=max_tokens, ignore_eos=True),
               sampling_options=Samp(**samp))


async def serve_workload(engine, Req, Samp, Stop) -> dict:
    """Greedy and sampled streams through fused blocks and prefill steps,
    then a prefix-sharing greedy request beside a seeded, penalized one."""
    p = _prompts(3, [40, 10, 7, 18, 12])
    out = {}
    reqs = [("g0", p[0], 12, dict(temperature=0.0)),
            ("g1", p[1], 9, dict(temperature=0.0)),
            ("s0", p[2], 10, dict(temperature=0.9)),
            ("s1", p[3], 8, dict(temperature=0.7, top_k=20, seed=7))]
    res = await asyncio.gather(*[
        _stream(engine, _req(Req, Samp, Stop, rid, pr, n, **kw))
        for rid, pr, n, kw in reqs])
    out.update(zip([r[0] for r in reqs], res))
    later = [("g2", p[0][:24] + p[4][:5], 7, dict(temperature=0.0)),
             ("s2", p[4], 8, dict(temperature=0.8, seed=3,
                                  frequency_penalty=0.5))]
    res = await asyncio.gather(*[
        _stream(engine, _req(Req, Samp, Stop, rid, pr, n, **kw))
        for rid, pr, n, kw in later])
    out.update(zip([r[0] for r in later], res))
    return out


async def spec_workload(engine, Req, Samp, Stop) -> dict:
    """Repetitive prompts (n-gram drafts for the verify steps) beside a
    plain one, greedy and sampled, with embeddings and prompt scoring
    asked for while they decode (on a rank of a world those run between
    dispatches, on the thread that issues the steps)."""
    base = _prompts(5, [6, 5, 30])
    reqs = [("v0", base[0] * 5, 14, dict(temperature=0.0)),
            ("v1", base[1] * 6, 12, dict(temperature=0.8, seed=11)),
            ("v2", base[2], 10, dict(temperature=0.0))]

    async def aside():
        await asyncio.sleep(0)
        emb = np.asarray(await engine.embed([base[1], base[2]]))
        scored = await engine.score([base[2], base[0]])
        return emb, [tuple(np.asarray(x) for x in row) for row in scored]

    *res, (emb, scored) = await asyncio.gather(*[
        _stream(engine, _req(Req, Samp, Stop, rid, pr, n, **kw))
        for rid, pr, n, kw in reqs], aside())
    out = dict(zip([r[0] for r in reqs], res))
    out["embed"], out["score"] = emb, scored
    return out


async def moe_workload(engine, Req, Samp, Stop) -> dict:
    """Eight prompts in one prefill batch (128 tokens: past the small-batch
    capacity pad, so a low capacity factor drops), then their decode. Every
    prompt fills its prefill row: a pad slot takes dispatch capacity, and
    the port's pad attention is zero where the reference's attends position
    0 (ROADMAP Queue C), so with drops a padded batch routes differently in
    the two packages at any mesh."""
    p = _prompts(9, [16] * 8)
    res = await asyncio.gather(*[
        _stream(engine, _req(Req, Samp, Stop, f"m{i}", pr, 6,
                             temperature=0.0))
        for i, pr in enumerate(p)])
    out = {f"m{i}": r for i, r in enumerate(res)}
    out["drops"] = int(engine.moe_dropped_total())
    return out


async def fail_workload(engine, Req, Samp, Stop) -> dict:
    """One greedy stream, long enough to outlive a follower's failure."""
    p = _prompts(13, [9])
    return {"f0": await _stream(engine, _req(Req, Samp, Stop, "f0", p[0],
                                             24, temperature=0.0))}


WORKLOADS = {"serve": serve_workload, "spec": spec_workload,
             "moe": moe_workload, "fail": fail_workload}


# -- cases -------------------------------------------------------------------------


def _params(cfg, tree):
    from dynamo_tpu_torch.models import get_family
    return get_family(cfg).params_from_jax(tree, cfg, device="cpu")


def run_forward(case: dict, world) -> dict:
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from dynamo_tpu_torch.parallel.sharding import (ModelSharding,
                                                    local_config)
    cfg = ModelConfig(**case["cfg"])
    fam = get_family(cfg)
    mesh = make_mesh(MeshSpec(**case["mesh"]))
    shard = ModelSharding(cfg, mesh)
    params = shard.shard_params(_params(cfg, case["tree"]))
    pages = shard.shard_pages(fam.make_pages(cfg, case["num_pages"],
                                             case["page_size"]))
    lcfg = local_config(cfg, mesh)
    logits, drops = [], []
    with torch.no_grad():
        for st in case["steps"]:
            t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
            out = fam.forward(params, lcfg, t["tokens"], t["positions"],
                              pages, t["table"], t["total"], t["new"],
                              mesh=mesh)
            logits.append(out[0].numpy())
            if len(out) > 2:
                drops.append(int(out[2]["moe_dropped_assignments"]))
    return {"logits": logits, "drops": drops}


def run_engine(case: dict, world) -> dict:
    from dynamo_tpu_torch.engine.torch_engine import TorchEngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.parallel import multihost as mh
    from dynamo_tpu_torch.parallel.mesh import MeshSpec
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    cfg = ModelConfig(**case["cfg"])
    engine = mh.build_rank_engine(
        cfg, TorchEngineConfig(**case["engine"]), world,
        MeshSpec(**case["mesh"]), params=_params(cfg, case["tree"]))
    if not world.leader:
        fail_at = case.get("fail_step")
        if fail_at is not None:
            real = engine.execute_arrays
            state = {"armed": True}

            def flaky(kind, a, step):
                out = real(kind, a, step)
                if state["armed"] and kind in ("step", "chained", "block") \
                        and step >= fail_at:
                    state["armed"] = False
                    raise RuntimeError(f"injected failure at step {step}")
                return out
            engine.execute_arrays = flaky
        try:
            mh.follow_steps(world.fanout, engine)
        except RuntimeError as e:
            return {"follower_error": str(e),
                    "launches": dict(engine.kernel_launches)}
        return {"launches": dict(engine.kernel_launches)}
    fanout = mh.StepFanout(world.fanout)
    fanout.install(engine)
    # the threads the leader's taps ran on (one: the step thread)
    threads = set()
    tap = engine.step_tap

    def tap_on(kind, arrays, step):
        threads.add(threading.get_ident())
        tap(kind, arrays, step)
    engine.step_tap = tap_on
    work = WORKLOADS[case["workload"]]

    async def drive():
        try:
            out = await work(engine, PreprocessedRequest, SamplingOptions,
                             StopConditions)
            # the KV data plane over a sharded cache is refused
            try:
                engine.gather_pages_host([1])
                out["gather"] = "served"
            except NotImplementedError as e:
                out["gather"] = str(e)
            return out
        finally:
            await engine.stop()
            if case.get("fail_step") is None:
                await engine.run_on_step_thread(fanout.close)

    out = asyncio.run(drive())
    out["counters"] = {"blocks": engine.multistep_blocks,
                       "chained": engine.chained_steps,
                       "decode_dispatches": engine.decode_dispatches,
                       "block_mode": engine.block_mode}
    out["launches"] = dict(engine.kernel_launches)
    out["tap_threads"] = len(threads)
    return out


def main(argv) -> int:
    from dynamo_tpu_torch.parallel import multihost as mh
    torch.set_num_threads(1)
    spec_path = argv[0]
    local_rank = int(argv[argv.index("--local-rank") + 1]) \
        if "--local-rank" in argv else 0
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    procs = []
    if local_rank == 0:
        procs = mh.start_local_ranks(
            [sys.executable, os.path.abspath(__file__), spec_path],
            spec["world"])
    results = {}
    world = None
    try:
        world = mh.initialize_distributed(spec["address"], 1, 0,
                                          spec["world"],
                                          local_rank=local_rank,
                                          device="cpu",
                                          timeout=datetime.timedelta(
                                              seconds=120))
        for case in spec["cases"]:
            run = run_forward if case["kind"] == "forward" else run_engine
            results[case["name"]] = run(case, world)
    except Exception:  # noqa: BLE001 — reported through the results file
        results["error"] = traceback.format_exc()
    finally:
        rank = world.rank if world is not None else local_rank
        with open(f"{spec['out']}.{rank}", "wb") as f:
            pickle.dump(results, f)
        if procs:
            mh.stop_local_ranks(procs, timeout=120.0)
        if "error" not in results:
            mh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
