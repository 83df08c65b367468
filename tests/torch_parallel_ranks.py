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
  message must trip the outcome cross-check. ``dump_pages``: every rank
  returns its cache after the workload; ``record_steps``: every step and
  block it ran, with its step id and packed output. Rank 0 records the
  threads its taps ran on, their kinds in order and each scatter's
  per-rank value slices; the others record the slices they received.

A forward case over a mesh with ``dp`` runs each rank's rows of every
step (``DpRows``) and gathers the logits over ``dp``.

- ``pipeline``: ``parallel/pipeline.pipeline_forward`` on this rank's
  stage (``pp_sharding_fns`` over the case's mesh) through the case's
  steps at the case's microbatch count, each step through the attention
  its ``attn`` names (None: the plain paged attention; ``"decode"``: the
  decode kernel's wrapper); the logits (gathered over ``dp``), this
  rank's coordinates and its cache slab after the steps.
- ``rotate``: ``RankMesh.rotate`` over the case's axis of a tensor
  holding this rank's number; what came back and this rank's
  coordinates.
- ``ring_attention``: ``parallel/ring_attention.ring_self_attention`` on
  the case's full arrays over the case's mesh (``head_axis`` as given):
  the whole result (or its partials).
- ``ring_prefill``: the case's steps on this rank's shards
  (``ModelSharding`` over the case's mesh), each through
  ``parallel/ring_prefill.ring_prefill`` when it is marked ``ring``, else
  through the family's forward (a resident prefix); the logits of every
  step, this rank's coordinates and its cache after the steps.

The workloads are plain functions of (engine, request classes, and for
the KV data plane a namespace of the package's modules), so the tests run
them on ``JaxEngine`` too.
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
    toks, lps, last, cached = [], [], None, None
    async for frame in engine.generate(req):
        if frame.error:
            return {"error": frame.error}
        toks += list(frame.token_ids)
        lps += list(frame.log_probs or [])
        if frame.cached_tokens is not None:
            cached = frame.cached_tokens
        last = frame
    return {"tokens": toks, "logprobs": [float(x) for x in lps],
            "finish": last.finish_reason.value, "cached": cached}


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


async def pp_workload(engine, Req, Samp, Stop) -> dict:
    """Pipeline serving: two prompts (one past a prefill chunk) greedy and
    a seeded draw decode through fused blocks, a third arrives while they
    decode (mixed steps); then a greedy request whose logit bias fills
    the penalty window, so its decode runs per step, chained."""
    p = _prompts(47, [40, 10, 7, 12])
    first = [("p0", p[0], 12, dict(temperature=0.0)),
             ("p1", p[1], 10, dict(temperature=0.8, seed=7))]
    started = asyncio.Event()

    async def after(rid, prompt, n, kw):
        await started.wait()
        return await _stream(engine, _req(Req, Samp, Stop, rid, prompt, n,
                                          **kw))

    async def first_of(rid, prompt, n, kw):
        toks, lps, last = [], [], None
        async for frame in engine.generate(_req(Req, Samp, Stop, rid, prompt,
                                                n, **kw)):
            if frame.error:
                return {"error": frame.error}
            toks += list(frame.token_ids)
            lps += list(frame.log_probs or [])
            last = frame
            if len(toks) >= 2:
                started.set()
        return {"tokens": toks, "logprobs": [float(x) for x in lps],
                "finish": last.finish_reason.value}

    res = await asyncio.gather(
        *[first_of(*r) for r in first],
        after("p2", p[2], 8, dict(temperature=0.0)))
    out = dict(zip(["p0", "p1", "p2"], res))
    out["q0"] = await _stream(engine, _req(
        Req, Samp, Stop, "q0", p[3], 10, temperature=0.0,
        logit_bias={5: 0.5, 9: -0.5, 11: 0.25}))
    return out


async def ppkv_workload(engine, Req, Samp, Stop, ns) -> dict:
    """The KV data plane of a world (layer-staged, or sequence-parallel,
    where ``a`` rides the ring) and a one-rank engine of the same tree
    (``ns["one"]()``): both serve prompt ``a`` and export its
    blocks as merged frames; the world's frames are injected into the
    emptied one-rank engine and the one-rank engine's into the emptied
    world (each rank its slice of every scatter); both gather the blocks
    again; then ``b``, which extends ``a``, is served on the world."""
    xfer, tok = ns["transfer"], ns["tokens"]
    ps = engine.allocator.page_size
    pa = _prompts(43, [26])[0]
    tail = _prompts(44, [5])[0]
    hashes = tok.compute_block_hash_for_seq(pa, ps)
    greedy = dict(temperature=0.0)

    def pages_of(eng):
        by_hash = eng.allocator._by_hash
        return np.asarray(eng.gather_pages_host([by_hash[h]
                                                 for h in hashes]))

    async def export(eng):
        return _frames_out(await eng.run_exclusive(
            xfer.export_frames, eng, hashes, "layer", 4))

    async def inject(eng, frames):
        await eng.run_exclusive(eng.allocator.clear)
        for meta, raw in frames:
            await eng.run_exclusive(xfer.inject_frame, eng,
                                    dict(meta, _raw=raw))
        return await eng.run_exclusive(pages_of, eng)

    out = {"a": await _stream(engine, _req(Req, Samp, Stop, "a", pa, 4,
                                           **greedy))}
    out["frames"] = await export(engine)
    out["pages"] = await engine.run_exclusive(pages_of, engine)
    one = ns["one"]()
    try:
        out["one_a"] = await _stream(one, _req(Req, Samp, Stop, "a", pa, 4,
                                               **greedy))
        out["one_frames"] = await export(one)
        out["one_pages"] = await inject(one, out["frames"])
    finally:
        await one.stop()
    out["back"] = await inject(engine, out["one_frames"])
    out["b"] = await _stream(engine, _req(Req, Samp, Stop, "b", pa + tail,
                                          4, **greedy))
    return out


async def ring_workload(engine, Req, Samp, Stop) -> dict:
    """Sequence parallelism's ring step, one request at a time: a long
    novel prompt (one ring step), a short one (chunked: under the
    threshold), a prompt sharing the first's 24-token head whose long
    tail rides the ring over the cached prefix, and a seeded draw on a
    long novel prompt. Records the engine's ring steps after each."""
    head, tail_a, tail_b, long_s = _prompts(53, [24, 40, 40, 36])
    short = _prompts(59, [9])[0]
    reqs = [("r1", head + tail_a, dict(temperature=0.0)),
            ("short", short, dict(temperature=0.0)),
            ("r2", head + tail_b, dict(temperature=0.0)),
            ("r3", long_s, dict(temperature=0.8, seed=5))]
    out = {}
    for rid, prompt, kw in reqs:
        out[rid] = await _stream(engine, _req(Req, Samp, Stop, rid, prompt,
                                              6, **kw))
        out[rid]["ring_steps"] = engine.ring_steps
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


async def dp_workload(engine, Req, Samp, Stop) -> dict:
    """Data parallelism's rows: four requests in one batch (greedy, an
    unseeded and a seeded draw: each replica samples its own rows), then a
    batch whose second row, the other replica's, shares the first batch's
    first prompt (its prefix pages were written by that batch's replica 0
    rows; every replica holds them)."""
    p = _prompts(31, [26, 9, 12, 7, 5])
    first = [("d0", p[0], 9, dict(temperature=0.0)),
             ("d1", p[1], 11, dict(temperature=0.0)),
             ("d2", p[2], 8, dict(temperature=0.9)),
             ("d3", p[3], 10, dict(temperature=0.8, top_k=30, seed=5))]
    out = {}
    res = await asyncio.gather(*[
        _stream(engine, _req(Req, Samp, Stop, rid, pr, n, **kw))
        for rid, pr, n, kw in first])
    out.update(zip([r[0] for r in first], res))
    # admitted in order: d5 takes the batch's second row
    later = [("d4", p[4], 6, dict(temperature=0.7, seed=2)),
             ("d5", p[0][:20] + p[4][:3], 7, dict(temperature=0.0))]
    res = await asyncio.gather(*[
        _stream(engine, _req(Req, Samp, Stop, rid, pr, n, **kw))
        for rid, pr, n, kw in later])
    out.update(zip([r[0] for r in later], res))
    return out


def _frames_out(frames) -> list:
    """Wire frames as (meta, bytes) pairs (what a puller receives)."""
    return [(dict(f.obj), np.ascontiguousarray(f.raw).tobytes())
            for f in frames]


async def kv_workload(engine, Req, Samp, Stop, ns, ref_frames=None) -> dict:
    """The KV data plane of one engine: serve prompt ``a``, export its
    prompt blocks as merged layer-major frames of 4 blocks and gather
    their pages. The reference (``ref_frames`` None) also serves ``a2``
    and exports its blocks, then serves ``b`` and ``c``, which extend
    ``a2`` and ``a``; the port's world instead injects the reference's
    frames of ``a2`` (``ref_frames()``, waited for; one as wire bytes, one
    as a tensor) and serves ``b`` on them."""
    xfer, tok = ns["transfer"], ns["tokens"]
    ps = engine.allocator.page_size
    pa, pa2 = _prompts(17, [24, 16])
    tail = _prompts(19, [5])[0]

    async def export(prompt):
        hashes = tok.compute_block_hash_for_seq(prompt, ps)
        frames = await engine.run_exclusive(xfer.export_frames, engine,
                                            hashes, "layer", 4)
        by_hash = engine.allocator._by_hash
        pages = await engine.run_exclusive(
            engine.gather_pages_host, [by_hash[h] for h in hashes])
        return _frames_out(frames), np.asarray(pages)

    greedy = dict(temperature=0.0)
    out = {"a": await _stream(engine, _req(Req, Samp, Stop, "a", pa, 6,
                                           **greedy))}
    out["frames"], out["pages"] = await export(pa)
    # the cache's shard layout, and what a pull from it would advertise
    out["layout"] = tuple(xfer.cache_shard_layout(engine))
    out["payload"] = xfer.kv_shard_payload(engine)
    if ref_frames is None:
        out["a2"] = await _stream(engine, _req(Req, Samp, Stop, "a2", pa2,
                                               6, **greedy))
        out["frames2"], _pages = await export(pa2)
        out["c"] = await _stream(engine, _req(Req, Samp, Stop, "c",
                                              pa + tail, 6, **greedy))
    else:
        # the first frame as wire bytes (host values), the next as a
        # tensor (what a device-direct pull hands over): on a world both
        # take the fanned-out host-values scatter
        n = 0
        for i, (meta, raw) in enumerate(await ref_frames()):
            meta = dict(meta, _raw=raw)
            if i == 0:
                n += await engine.run_exclusive(xfer.inject_frame, engine,
                                                meta)
            else:
                metas, vals = xfer.frame_arrays(meta)
                n += await xfer.inject_device_windowed(
                    engine, metas, torch.from_numpy(vals.copy()))
        out["injected"] = n
    out["b"] = await _stream(engine, _req(Req, Samp, Stop, "b", pa2 + tail,
                                          6, **greedy))
    return out


async def kvfail_workload(engine, Req, Samp, Stop, ns) -> dict:
    """A prompt served, its blocks exported, the cache emptied and the
    frames injected back (page scatters), then one more stream: a
    follower that failed a scatter learns the leader completed it."""
    ps = engine.allocator.page_size
    p = _prompts(37, [16])[0]
    out = {"a": await _stream(engine, _req(Req, Samp, Stop, "a", p, 4,
                                           temperature=0.0))}
    hashes = ns["tokens"].compute_block_hash_for_seq(p, ps)
    frames = await engine.run_exclusive(ns["transfer"].export_frames,
                                        engine, hashes, "layer", 4)
    await engine.run_exclusive(engine.allocator.clear)
    for meta, raw in _frames_out(frames):
        await engine.run_exclusive(ns["transfer"].inject_frame, engine,
                                   dict(meta, _raw=raw))
    out["b"] = await _stream(engine, _req(Req, Samp, Stop, "b", p, 8,
                                          temperature=0.0))
    return out


# the KVBM case's host tier: three blocks of the tiny model (float32), so
# the rest demotes to disk
KVBM_HOST_BLOCKS = 3


async def kvbm_workload(engine, Req, Samp, Stop, ns, disk_path) -> dict:
    """A host + disk tier round trip: prompt ``p`` (six full blocks and a
    token), a pressure request that evicts its blocks (spilled to the
    host tier and on to disk), then ``p`` again, onboarded from both
    tiers. Returns the streams, the tier counters and ``p``'s pages
    gathered before the eviction and after the onboard."""
    from functools import partial
    cfg = engine.model_cfg
    ps = engine.allocator.page_size
    block = cfg.num_layers * 2 * cfg.num_kv_heads * ps * cfg.head_dim * 4
    tiered = ns["TieredEngine"](engine, ns["TieredKvConfig"](
        host_budget_bytes=KVBM_HOST_BLOCKS * block,
        disk_budget_bytes=1 << 20, disk_path=disk_path,
        prefetch_depth_bytes=0))
    p = _prompts(23, [6 * ps + 1])[0]
    pressure = _prompts(29, [40])[0]
    hashes = ns["tokens"].compute_block_hash_for_seq(p, ps)

    def pages_of():
        by_hash = engine.allocator._by_hash
        return np.asarray(engine.gather_pages_host(
            [by_hash[h] for h in hashes]))

    greedy = dict(temperature=0.0)
    out = {"p1": await _stream(tiered, _req(Req, Samp, Stop, "p1", p, 4,
                                            **greedy))}
    out["before"] = await engine.run_exclusive(pages_of)
    out["x"] = await _stream(tiered, _req(Req, Samp, Stop, "x", pressure,
                                          16, **greedy))
    by_hash = engine.allocator._by_hash
    out["evicted"] = sum(h not in by_hash for h in hashes)
    await asyncio.to_thread(partial(tiered.flush_spills, 30.0))
    out["p2"] = await _stream(tiered, _req(Req, Samp, Stop, "p2", p, 4,
                                           **greedy))
    out["after"] = await engine.run_exclusive(pages_of)
    out["offloaded"], out["onboarded"] = tiered.offloaded, tiered.onboarded
    out["on_disk"] = len(tiered.disk) if tiered.disk is not None else 0
    await tiered.stop()
    return out


async def kvbm_sampled_workload(engine, Req, Samp, Stop, ns,
                                disk_path) -> dict:
    """Evictions between the steps of an unseeded sampled stream: prompt
    ``q`` served and cached, then ``s`` (temperature 1, no seed) decodes
    through fused blocks and chained steps while ``x`` is admitted beside
    it; their pages outgrow the free ones, so ``q``'s blocks are evicted
    into the host tier at ``x``'s admission and as ``s`` grows. Returns
    the streams and the evictions."""
    ps = engine.allocator.page_size
    tiered = ns["TieredEngine"](engine, ns["TieredKvConfig"](
        host_budget_bytes=1 << 20, disk_budget_bytes=1 << 20,
        disk_path=disk_path, prefetch_depth_bytes=0))
    q, sp, xp = _prompts(41, [6 * ps + 1, 5 * ps, 4 * ps])
    hashes = ns["tokens"].compute_block_hash_for_seq(q, ps)
    out = {"q": await _stream(tiered, _req(Req, Samp, Stop, "q", q, 2,
                                           temperature=0.0))}
    started = asyncio.Event()

    async def sampled():
        toks, last = [], None
        async for frame in tiered.generate(_req(Req, Samp, Stop, "s", sp,
                                                16, temperature=1.0)):
            if frame.error:
                return {"error": frame.error}
            toks += list(frame.token_ids)
            started.set()
            last = frame
        return {"tokens": toks, "finish": last.finish_reason.value}

    async def beside():
        await started.wait()
        return await _stream(tiered, _req(Req, Samp, Stop, "x", xp, 2,
                                          temperature=0.0))

    out["s"], out["x"] = await asyncio.gather(sampled(), beside())
    by_hash = engine.allocator._by_hash
    out["evicted"] = sum(h not in by_hash for h in hashes)
    await tiered.stop()
    return out


WORKLOADS = {"serve": serve_workload, "spec": spec_workload,
             "moe": moe_workload, "fail": fail_workload, "dp": dp_workload,
             "pp": pp_workload, "ppkv": ppkv_workload,
             "ring": ring_workload, "spkv": ppkv_workload,
             "kv": kv_workload, "kvbm": kvbm_workload,
             "kvbm_sampled": kvbm_sampled_workload,
             "kvfail": kvfail_workload}


def port_ns() -> dict:
    """The port's modules the KV workloads call."""
    from dynamo_tpu_torch import tokens
    from dynamo_tpu_torch.engine import transfer
    from dynamo_tpu_torch.kvbm.manager import TieredEngine, TieredKvConfig
    return {"transfer": transfer, "tokens": tokens,
            "TieredEngine": TieredEngine, "TieredKvConfig": TieredKvConfig}


# -- cases -------------------------------------------------------------------------


def _params(cfg, tree):
    from dynamo_tpu_torch.models import get_family
    return get_family(cfg).params_from_jax(tree, cfg, device="cpu")


def run_forward(case: dict, world) -> dict:
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.parallel.mesh import DpRows, MeshSpec, make_mesh
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
            kw = {}
            B = t["tokens"].shape[0]
            if DpRows.split(mesh, B):
                dp = DpRows(mesh, B // mesh.shape["dp"], t["table"],
                            t["positions"], t["new"])
                t = {k: dp.local(v) for k, v in t.items()}
                kw["dp"] = dp
            out = fam.forward(params, lcfg, t["tokens"], t["positions"],
                              pages, t["table"], t["total"], t["new"],
                              mesh=mesh, **kw)
            lg = out[0]
            if "dp" in kw:
                lg = kw["dp"].gather(lg)
            logits.append(lg.numpy())
            if len(out) > 2:
                drops.append(int(out[2]["moe_dropped_assignments"]))
    return {"logits": logits, "drops": drops}


def run_pipeline(case: dict, world) -> dict:
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops.kernels.decode import \
        paged_decode_attention_stacked
    from dynamo_tpu_torch.parallel.mesh import DpRows, MeshSpec, make_mesh
    from dynamo_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                    pp_sharding_fns)
    cfg = ModelConfig(**case["cfg"])
    mesh = make_mesh(MeshSpec(**case["mesh"]))
    shard_params, shard_pages = pp_sharding_fns(mesh, cfg)
    params = shard_params(_params(cfg, case["tree"]))
    pages = shard_pages(get_family(cfg).make_pages(
        cfg, case["num_pages"], case["page_size"]))
    attn = {None: None, "decode": paged_decode_attention_stacked}
    logits = []
    with torch.no_grad():
        for st in case["steps"]:
            t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()
                 if k != "attn"}
            B = t["tokens"].shape[0]
            dp = None
            if DpRows.split(mesh, B):
                dp = DpRows(mesh, B // mesh.shape["dp"], t["table"])
                t = {k: dp.local(v) for k, v in t.items()}
            lg, _ = pipeline_forward(
                params, cfg, t["tokens"], t["positions"], pages, t["table"],
                t["total"], t["new"], mesh=mesh,
                n_microbatches=case.get("micro"),
                attn_impl=attn[st.get("attn")], dp=dp)
            logits.append((lg if dp is None else dp.gather(lg)).numpy())
    return {"logits": logits, "coords": dict(mesh.coords),
            "cache": pages.numpy().copy()}


_MESHES: dict = {}


def _mesh(spec: dict):
    """One mesh per shape a world's cases use, made on first use (every
    rank runs the cases in one order, so the groups are made in one
    order)."""
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    key = tuple(sorted(spec.items()))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(MeshSpec(**spec))
    return _MESHES[key]


def run_rotate(case: dict, world) -> dict:
    mesh = _mesh(case["mesh"])
    x = torch.full((3,), float(world.rank))
    return {"got": mesh.rotate(x, case["axis"]).numpy(),
            "coords": dict(mesh.coords)}


def run_ring_attention(case: dict, world) -> dict:
    from dynamo_tpu_torch.parallel.ring_attention import ring_self_attention
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in case["inputs"].items()}
    out = ring_self_attention(
        _mesh(case["mesh"]), t["q"], t["k"], t["v"], t["pos"],
        kv_valid=t["valid"], head_axis=case.get("head_axis"),
        return_partials=case["partials"])
    if case["partials"]:
        return {"out": [x.numpy() for x in out]}
    return {"out": out.numpy()}


def run_ring_prefill(case: dict, world) -> dict:
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.parallel.ring_prefill import ring_prefill
    from dynamo_tpu_torch.parallel.sharding import (ModelSharding,
                                                    local_config)
    cfg = ModelConfig(**case["cfg"])
    fam = get_family(cfg)
    mesh = _mesh(case["mesh"])
    shard = ModelSharding(cfg, mesh)
    params = shard.shard_params(_params(cfg, case["tree"]))
    pages = shard.shard_pages(fam.make_pages(cfg, case["num_pages"],
                                             case["page_size"]))
    lcfg = local_config(cfg, mesh)
    logits = []
    with torch.no_grad():
        for st in case["steps"]:
            t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()
                 if k != "ring"}
            args = (t["tokens"], t["positions"], pages, t["table"],
                    t["total"], t["new"])
            if st["ring"]:
                lg, _ = ring_prefill(params, cfg, *args, mesh=mesh)
            else:
                lg = fam.forward(params, lcfg, *args, mesh=mesh)[0]
            logits.append(lg.numpy())
    return {"logits": logits, "coords": dict(mesh.coords),
            "cache": pages.numpy().copy()}


def _record_steps(engine) -> list:
    """Record every step and fused block this rank runs, as (kind, step
    id, packed output): a world's ranks must run each under one id and
    agree on its output."""
    rec = []
    step, block = engine._invoke_step, engine._invoke_block

    def run_step(kind, a, *args, **kw):
        out = step(kind, a, *args, **kw)
        rec.append((kind, int(np.asarray(a["step"]).reshape(())),
                    out.numpy().copy()))
        return out

    def run_block(xa, *args, **kw):
        out = block(xa, *args, **kw)
        rec.append(("block", int(np.asarray(xa["step0"]).reshape(())),
                    out["packed"].numpy().copy()))
        return out
    engine._invoke_step, engine._invoke_block = run_step, run_block
    return rec


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
    def cache():
        return engine.pages.numpy().copy() if case.get("dump_pages") \
            else None
    steps = _record_steps(engine) if case.get("record_steps") else None

    if not world.leader:
        fail_at = case.get("fail_step")
        real = engine.execute_arrays
        state = {"armed": fail_at is not None, "scatters": {}}

        def follow(kind, a, step):
            if kind == "scatter":
                # the values this rank received: its own slice alone
                state["scatters"][step] = np.array(a["vals"])
            out = real(kind, a, step)
            if state["armed"] and kind in case.get(
                    "fail_kinds", ("step", "chained", "block")) \
                    and step >= fail_at:
                state["armed"] = False
                raise RuntimeError(f"injected failure at step {step}")
            return out
        engine.execute_arrays = follow
        res = {"launches": dict(engine.kernel_launches),
               "scatters": state["scatters"]}
        try:
            mh.follow_steps(world.fanout, engine)
        except RuntimeError as e:
            res["follower_error"] = str(e)
            return res
        res["launches"] = dict(engine.kernel_launches)
        res["dp_splits"] = engine.dp_splits
        res["cache"] = cache()
        res["steps"] = steps
        return res
    fanout = mh.StepFanout(world.fanout)
    fanout.install(engine)
    # the threads the leader's taps ran on (one: the step thread), and the
    # per-rank slices of each scatter's values
    threads = set()
    scatters = {}
    kinds = []
    tap = engine.step_tap

    def tap_on(kind, arrays, step, **kw):
        threads.add(threading.get_ident())
        kinds.append(kind)
        if kw.get("shards") is not None:
            scatters[step] = [np.array(s) for s in kw["shards"]]
        tap(kind, arrays, step, **kw)
    engine.step_tap = tap_on
    work = WORKLOADS[case["workload"]]
    extra = {}
    if case["workload"] in ("kv", "kvbm", "kvbm_sampled", "kvfail", "ppkv",
                            "spkv"):
        extra["ns"] = port_ns()
    if case["workload"] in ("ppkv", "spkv"):
        from dynamo_tpu_torch.engine.torch_engine import TorchEngine
        extra["ns"]["one"] = lambda: TorchEngine(
            cfg, _params(cfg, case["tree"]),
            TorchEngineConfig(**case["engine"]), device="cpu")
    if case.get("disk_path"):
        extra["disk_path"] = case["disk_path"]
    if case.get("ref_frames"):
        async def ref_frames(path=case["ref_frames"]):
            # the reference's frames, written by the pytest process
            for _ in range(1200):
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        return pickle.load(f)
                await asyncio.sleep(0.1)
            raise TimeoutError(f"no reference frames at {path}")
        extra["ref_frames"] = ref_frames

    async def drive():
        try:
            out = await work(engine, PreprocessedRequest, SamplingOptions,
                             StopConditions, **extra)
            if case.get("gather"):
                # the KV data plane over the sharded cache: whole pages
                out["gather"] = await engine.run_exclusive(
                    engine.gather_pages_host, case["gather"])
            return out
        finally:
            await engine.stop()
            if case.get("fail_step") is None:
                await engine.run_on_step_thread(fanout.close)

    out = asyncio.run(drive())
    out["counters"] = {"blocks": engine.multistep_blocks,
                       "chained": engine.chained_steps,
                       "decode_dispatches": engine.decode_dispatches,
                       "dp_splits": engine.dp_splits,
                       "ring_steps": engine.ring_steps,
                       "block_mode": engine.block_mode}
    out["launches"] = dict(engine.kernel_launches)
    out["tap_threads"] = len(threads)
    out["taps"] = kinds
    out["scatters"] = scatters
    out["cache"] = cache()
    out["steps"] = steps
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
            run = {"forward": run_forward, "pipeline": run_pipeline,
                   "engine": run_engine, "rotate": run_rotate,
                   "ring_attention": run_ring_attention,
                   "ring_prefill": run_ring_prefill}[case["kind"]]
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
