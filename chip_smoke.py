"""Quickest proof that the PyTorch + CUDA port serves on the GPU.

    python3 chip_smoke.py            # the whole check, on one CUDA GPU
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --profile  # and a device-time breakdown by kernel
    python3 chip_smoke.py --sweep    # kernel checks, then split lengths
                                     # timed and split by kernel

Phases (each prints what it finds; any failure makes the exit code non-zero
and suppresses the final result line):

1. the card (``nvidia-smi``), then a build of every CUDA kernel from
   ``dynamo_tpu_torch/ops/kernels/csrc`` with ``nvcc`` for ``sm_90a``;
2. each kernel against its plain PyTorch version on the card, at the
   Llama-3.2-3B attention shapes (Hq=24, Hkv=8, Dh=128, page 16, bf16), with
   its device time per call (``time_ms``: a run of calls between one pair
   of CUDA events, enqueued behind a device-side sleep, the layer cycling
   over enough layers that a pass reads past the L2; ``ms_per_call`` is
   the one-call-per-event-pair method of the first slices), the plain
   version's, one PyTorch call's (``scaled_dot_product_attention`` on the
   gathered KV, a yardstick the port never calls) and the least time the
   card needs for the same work (bytes at 3.35 TB/s or operations at 989
   TFLOP/s bf16, whichever is larger; counted from this run's inputs);
   for every B2 and B3 case past 1 ulp of the plain version, the rows
   past 1 ulp, each against ``plain.online_attention_rows``, which rounds
   as the kernel does (p against the running max of 64-position chunks,
   where the plain version uses the row's final max; a split row over its
   splits' ranges), and such a row more than 1 ulp from that fails; and the
   shapes of speculation and Gemma-2-27B: B1 and B3 at 32 query heads over
   16 (G = 2) with a 4096-position window, softcap 50 and contexts up to
   8192, B2 as a verify step (B = 32, S = K+1 = 5 at G = 3); B1-B3 at
   query groups 5 (40 heads over 8, Qwen2.5-14B's), 7 (28 over 4,
   Qwen2.5-7B's) and Qwen3-30B-A3B's 8 (32 over 4); and B1-B3 at the
   widened geometries (``GEOMETRY_CASES``): Gemma-2-9B's head_dim 256
   (16 over 8, window 4096, softcap 50, contexts up to 8192), Llama-3.2-1B's
   head_dim 64 (32 over 8), and groups of 12 (96 over 8, Mistral-Large-2's)
   and 16 (64 over 4, Qwen3-235B-A22B's);
3. the full-width Llama-3.2-3B forward (random weights from a seed) on a
   prefill, a mixed and a decode step, once through the kernels and once
   through their plain versions: every layer's attention must agree within
   2 bf16 ulps per row, and the logits within 1.5 times the distance
   between the plain versions and the JAX-style oracle ``ops.attention``,
   which differ only in where they round;
4. ``TorchEngine`` serving greedy requests at full width with the
   reference's defaults (pipelined decode, fused blocks of up to 8 steps,
   each block one CUDA graph replay): prompts of 128-1024 seeded token
   ids, two sharing a prefix, some arriving while others decode; every
   request must finish with its tokens, no NaN, fused blocks must run and
   chain on the device, and the decode, prefill and ragged kernels must
   all have launched, graph replays counted (the wrappers' counts equal to
   the engine's attention calls). It prints tok/s, TTFT p50, dispatch ms
   by step kind, dispatches per token and the graphs captured. Then one
   block (B=16, ctx 1024, 8 steps; greedy, then sampled with seeds) runs
   eagerly and as its graph's replay from the same cache: packed output,
   carry and KV equal bit for bit, and both timed (CUDA events);
4d. the same serve per step (``pipeline_decode=False``), then pipelined
   without fusion (``decode_multistep=1``, which must chain steps on the
   device), each with phase 4's report and its per-request token
   agreement with phase 4's streams (a differing stream's first differing
   step and its top-2 logit margin);
4c. ``TorchEngine`` serving every sampling option at full width: two
   seeded requests, two unseeded with top-p, frequency + presence and
   repetition penalties, a +100 logit bias, a guided JSON schema over a
   synthetic byte vocabulary. A second serve on a fresh engine must give
   the same tokens, the biased request only its id, the guided text a
   document of the schema (or a legal prefix of one), every request
   finite logprobs, and every kernel of the model must launch; each
   seeded request is served alone too, and the tokens it changes are
   reported with the first changed step's margin. On Llama-3.2-3B's vocab
   the sampler on the card is held against the CPU (threefry words
   bit-equal, Gumbel noise within 1 ulp, tokens equal) and
   ``TorchEngine._sample_tail`` is timed alone at B=32;
4e. int8 W8A8 (``ops/quant.py``) on the Llama weights: the layer weights'
    bytes against bf16's, phase 3's steps through the kernels and their
    plain versions on the int8 tree under phase 3's gate (the distance to
    the bf16 logits printed, not gated), phase 4's serve on an int8 engine
    (tok/s beside phase 4's) and its block's replay time;
4f. speculative decoding, K = 4: a verify step's forward (``[2, 5]``,
    logits window 5) through B2 against the plain versions under phase
    3's gate; a serve with n-gram drafts on prompts that repeat a span;
    phase 4d's workload with the proposer fed the per-step serve's greedy
    streams: drafts must be accepted; acceptance rate, tokens per verify
    step, tok/s beside the per-step and fused serves, and where each stream
    leaves the per-step one, with the top-2 margin there.

Then, with the Llama model freed, Gemma-2-27B (``ModelConfig.gemma2_27b``
at full width, cut to ``GEMMA27_LAYERS`` of its 46 layers: 27B's
attention geometry stays in phase 2's rows; random bf16 weights made on
the card): its forward on seven steps (``gemma_plan``: a 5633-token row past the
sliding layers' 4096-position window beside a 1502-token one; prefill,
mixed and decode) under phase 3's checks, and phase 4's serve fused (cold,
warm, graph vs eager) and per step; then:

5. Llama-3.2-3B served through the port's entry points, at full width in
   bf16 and ``ENTRY_LAYERS`` (14) of its 28 layers, as every worker
   process of phases 5-8 serves it (random weights from a seed): this
   script writes a model directory (``config.json`` at the published
   widths, a SentencePiece
   ``tokenizer.model`` of 128256 pieces, a chat template), starts the
   port's coordinator, one torch worker (phase 4's engine sizes, system
   server on) and the port's frontend as three processes (every serving
   package must import: rung (a)), and is their HTTP client: a warming
   pass, then the identity pass (4 greedy chat completions one at a time,
   2 streamed; a completion with echo + logprobs, which the worker scores
   through the prefill kernel; 2 embeddings) served twice, every answer
   equal, every chat finished by length (or EOS); then timed windows of
   phase 4's own traffic (its ten prompts as token ids in streamed
   completions, 32 tokens each, six at once and four released at a
   stream's fourth token): its cold seed, then its warm seed and two more
   of the same lengths, each printing tok/s, the client's TTFT and the
   part of it spent outside the worker's engine (the client's mean TTFT
   less the worker's queue + prefill stage spans over the window), beside
   phase 4's warm in-process numbers on the same requests. The worker's
   ``/metrics`` must show the decode, prefill and ragged kernels launched
   (its ``dynamo_worker_kernel_launches_total`` read just before the
   identity passes and just after the timed ones). Each process's log
   tail is printed on failure; all are stopped in a ``finally``;
5b. the loader: two full-width Llama-3.2-3B layers and the tied embedding
   (1.19 GB of bf16) written as safetensors by this script's own header
   writer, read onto the card by ``models/hf_loader.py``: bit for bit,
   with its time.

7. the planner's path (``phase_planner``): (a) the port's profiler
   (``dynamo_tpu_torch/planner/profile.py`` ``amain``, ``--engine torch
   --random-weights`` on phase 5's model directory, the CLI's default
   sweep: isl 128 / 512 / 1024 / 2048, concurrency 1-32, osl 32) in this
   process: 4 prefill and 6 decode rows, finite and positive (``itl_s``
   may be 0: a fused block's tokens arrive in one burst), printed beside
   phase 4's replayed block token, loaded by ``MultiPerfInterpolator``,
   B1 and B2 launched; (b) the mocker with ``calibrate_mock_args``'s
   constants fitted to (a), profiled the same way, each row beside the
   card's as a ratio (reported); (c) the port's coordinator and frontend
   and ``python -m dynamo_tpu_torch.planner.main --connector local`` as
   processes, the planner spawning the port's ``--disagg prefill`` /
   ``--disagg decode`` workers on the card (min 1 / 1, at most 2 / 1;
   the planner's default EWMA predictor): a load step of 16 clients
   sending 2048-token prompts saturates the pair, which the planner's
   arithmetic over (a)'s profile (its TTFT correction at its clamp of 4)
   sizes at 2 prefill workers once the pair delivers more than a fourth
   of the profiled prefill rate over the headroom; the pool must reach 2
   only after the new worker's ``/healthz/ready`` answers 200, every
   request finish with
   its tokens, the pool return to 1 by a drain, no crash be counted and
   the workers' ``/metrics`` show B1 and B2 launched.
8. a world of two ranks (``phase_tp``): Llama-3.2-3B at full width and
   depth (seed 0's bf16 weights, phase 3's), one process each
   (``--tp-rank``). The backend is printed first, with the card count:
   NCCL over two cards where there are two; on one card NCCL with two
   ranks there is tried first and what it says printed, and where it
   refuses both ranks run on the one card over gloo (collectives on CUDA
   tensors through the host; fused blocks eager), a check of
   correctness, not a speed of parallelism. (a) In the rank processes:
   phase 3's steps (prefill, mixed, decode: B2, B3, B1) through the
   kernels on each rank's shards at tp=2: rank 0's logits within phase
   3's gate of the tp=1 forward's (1.5 times plain vs oracle, of the same
   run), the greatest per-layer attention distance printed, both ranks
   launching B1-B3; then the KV data plane over the tp=2 cache
   (``tp_kv_rank``): a tp=2 ``TorchEngine`` under a host tier prefills
   6(a)'s four prompts, its merged frames land byte-equal in a tp=1
   engine, the CUDA IPC plane carries the world's gather to a child
   process and the child's copy back into the emptied world, the world
   emptied and re-injected from the frames gathers byte-equal, and a KVBM
   offload, eviction and onboard brings the same bytes back, with the
   world's gather and inject GB/s beside 6(a)'s;
   then dp=2 (``dp_forward_rank``): phase 3's steps, each rank its row of
   the whole model, within phase 3's gate, both replicas' caches
   byte-equal at every written page, both ranks launching B1-B3; then a
   ``MeshSpec(dp=2)`` engine (``dp_serve_rank``) serves four of phase 4's
   requests (two greedy, then an unseeded and a seeded draw arriving
   while those decode; fused blocks): every request its tokens, split
   dispatches and blocks counted, both replicas' caches byte-equal at
   every held page, both ranks launching B1-B3; then pp=2
   (``pp_forward_rank``): phase 3's steps through
   ``parallel/pipeline.pipeline_forward``, each rank its stage's 14
   layers and cache slab, at one and two microbatches, within phase 3's
   gate, each slab against its layers of the tp=1 kernel cache (byte
   equality reported), both ranks launching B1-B3; then a
   ``MeshSpec(pp=2)`` engine (``pp_serve_rank``) serves four of phase 4's
   warm requests (greedy and sampled, two arriving while the others
   decode; fused blocks and mixed steps): every request its tokens, the
   greedy ones beside phase 4's, the first prompt's blocks gathered from
   the stages and injected as merged frames into a tp=1 engine
   byte-equal, both ranks launching B1-B3; then sp=2
   (``sp_forward_rank``): a 4096-token prompt through
   ``parallel/ring_prefill.ring_prefill`` (each rank half the positions,
   the K/V round the ring, every position written by both replicas),
   then a prompt sharing its first 64 pages with a 1024-token novel tail
   (the ring merged with the cached prefix), then two decode steps of
   both through B1 over the ring-written cache: rank 0's logits within
   phase 3's gate rule of a tp=1 kernel forward's (B2 chunks of 512, B1),
   the tolerance 1.5 times that forward's distance to the oracle's on the
   same step, each layer's cache distance to the tp=1 kernel cache
   reported, both replicas' ring caches byte-equal, both ranks launching
   B1; then a ``MeshSpec(sp=2)`` engine (``sp_serve_rank``) serves a
   short prompt, a 2048-token one (one ring step) and a short one
   arriving while they decode (a mixed step): every request its tokens,
   exactly one ring step, both replicas' caches byte-equal at every held
   page, both ranks launching B1-B3. (b) The frontend and one
   worker with ``--tensor-parallel-size 2 --random-weights
   --dist-backend`` on phase 5's model directory (``tp_serve``): phase
   5's identity pass (every answer checked; each chat's tokens against
   phase 5's tp=1 worker's, reported: bf16 near ties part), one of phase
   5's warm timed windows (TTFT and tok/s beside phase 5's), and each
   rank's B1-B3 launches, printed by the rank when SIGTERM drains the
   leader: both must have launched all three. Then the KV plane through
   workers (``tp_disagg_serve``): a tp=2 ``--disagg
   prefill --host-cache-bytes`` world beside a tp=1 ``--disagg decode``
   worker on phase 5's model directory: phase 5's identity pass (every
   answer checked, the echo and embeddings phase 5's; each chat's tokens
   against phase 5's tp=1 worker's, reported: bf16 near ties part), every
   prompt a remote prefill on the world whose export lease was acked,
   pulled bytes per plane and the world's tier counters printed; SIGTERM
   drains the world's leader, which releases its follower, and both
   ranks print their launches: B2 on each, B1 in the decode worker.

After phase 7, each alone on the card: Gemma-2-9B (``ModelConfig.gemma2_9b``,
head_dim 256, 42 layers, 18.5 GB) and Llama-3.2-1B (``llama32_1b``, head_dim
64, 16 layers) at full width and depth through phase 3's forward check
(Gemma's with ``gemma_plan``'s row past the window) and phase 4's serve
(Gemma's also per step); then the checkpoint loaders: a seeded full-width
Llama-3.2-1B written as a GGUF file (F16, F32 norms, Q8_0 ``attn_v`` and
``ffn_down``, Q/K rows in llama.cpp's order) and served through the
worker's ``.gguf`` route, every tensor on the card bit for bit as written,
with phase 4's requests; and two full-width DeepSeek-V2-Lite layers (dense,
then MoE) as safetensors, read by ``models/deepseek.py`` ``load_params``,
bit for bit, their forward equal to the in-memory tree's.

Then DeepSeek-V2-Lite (MLA + MoE):

2b. each latent (MLA) kernel against its plain version at V2-Lite's
    shapes (nh=16, dkv=512, dr=64, page 16, bf16), NaN in the garbage page:
    decode at B = 1, 8, 32 (contexts up to 4096, one of 1 token), prefill
    B=4 S=512 with prefix hits and a 300-token row, and a mixed batch (two
    chunks + six decode rows at S=512), and S=131 (a ragged last 4-slot
    tile) with decode rows whose contexts end on a split boundary and one
    position either side of it; within 2 bf16 ulps per (query,
    head) row, finite, pad slots exactly zero; each with its time, the
    plain version's, one ``scaled_dot_product_attention`` call's on the
    gathered latent (and the backend that served it) and its bound
    (runs with the kernel phase 2, before any model is built);
3b. the full-width DeepSeek-V2-Lite forward at ``DEEPSEEK_LAYERS`` of its
    27 layers (its dense layer and 4 MoE layers; random weights from a
    seed, bf16) on a prefill, a mixed and a decode step,
    through the kernels, their plain versions and the JAX-style oracle
    (``_mla_attend`` / ``_mla_attend_blockwise``): every layer within 2
    ulps per row; the logits gate of phase 3 is reported, and decides
    nothing, since random MoE gates can flip a near-tie route between two
    forwards that differ in rounding: it prints, per MoE layer, the
    tokens whose routes differ between the forwards, and per layer each
    latent attention's distance to the oracle's on the same inputs;
4b. ``TorchEngine`` serving DeepSeek-V2-Lite with phase 4's workload and
    checks (both latent kernels launch, fused blocks replayed as graphs),
    the graph-vs-eager block, phase 4d, then phase 4c's sampled workload,
    then phase 4d's first four requests speculating (K = 4) with drafts fed
    from the per-step streams: verify steps through B5 must accept; then
    phase 4's serves on the capacity dispatch expert backend
    (``phase_dispatch``): its dropped assignments, each stream's agreement
    with the dense backend's, its block's graph against the eager block.

Last, Qwen3-30B-A3B (``ModelConfig.qwen3_30b_a3b`` at ``QWEN3_LAYERS``
of its 48 layers, 128 experts of 768, top-8, 32 query heads over 4,
qk-norm; random bf16 weights made on the card a layer at a time, after
phase 6 has freed its
engines: phase 6(a) must leave ``memory_allocated`` within 1 GiB of its
value before): phase 3's forward check (its logits gate too, with the
flipped top-8 routes reported), phase 4's serve on
the dense expert backend and then on the dispatch one, and the replayed
block's ms per token against the 18.2 ms weight floor.

It imports nothing of JAX and nothing of the JAX package. Every phase
prints its seconds. The last line is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels, each with its launches from its own
model's greedy serve (``launches``), sampled serve (``launches_sampled``),
speculating serve (``launches_spec``) and, for the Llama tree's three,
phase 5's worker (``launches_serve_entry``), phase 6's workers
(``launches_disagg``), phase 7's profiler engine and planner-spawned
workers (``launches_planner``), the int8 serves (``launches_int8``), Gemma-2's
fused serves (``launches_gemma``), Qwen3-30B-A3B's serves on both
expert backends (``launches_moe``), Gemma-2-9B's and Llama-3.2-1B's fused
serves (``launches_gemma9b``, ``launches_llama1b``) and the GGUF model's
serve (``launches_gguf``), and phase 8's per rank, its rank processes'
(``launches_tp_forward``: the tp=2 forward, the KV plane's engine, the
dp=2 forward, the dp=2 engine's serve, the pp=2 forward, the pp=2
engine's serve, the sp=2 forward and the sp=2 engine's serve; the sp
checks' alone in ``launches_sp``) and its workers'
(``launches_tp_serve``: the tp=2 worker's ranks; ``launches_tp_disagg``:
the prefill world's ranks and the decode worker); for
the latent kernels, DeepSeek's serves on the dispatch backend
(``launches_dispatch``).
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import os
import struct
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
HQ, HKV, DH, PS = 24, 8, 128, 16
NH, DKV, DR = 16, 512, 64      # DeepSeek-V2-Lite's latent attention
# kernel vs plain: per (query, head) row, in bf16 ulps of the row's largest
# value (``row_ulp_error``); both round their output once to bf16, so one
# ulp is the expected distance and a second covers the f32 sums' order
KERNEL_TOL_ULPS = 2.0
# logits through the kernels vs through their plain versions, at most this
# many times the distance between two plain attentions that differ only in
# where they round (the plain versions and the JAX-style oracle): 28 random
# bf16 layers amplify rounding, and this run measures how far
LOGITS_VS_ORACLE = 1.5
REPS = 25
L2_BYTES = 50 * 2 ** 20        # H100 L2
MAX_FLUSH_LAYERS = 64
SLEEP_CYCLES_PER_S = 2.0e9     # torch.cuda._sleep spins clock cycles
SERVE_TIMEOUT_S = 300          # a serve takes seconds; a stuck one fails
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms_per_call(fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of one ``fn(1)`` call each (the
    method of the first two slices: for a kernel of tens of microseconds it
    measures the wrapper's Python time, and layer 1 stays in L2)."""
    for _ in range(3):
        fn(1)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(1)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_ms(fn, layers: int, reps: int = REPS, runs: int = 3) -> float:
    """Device time of one call of ``fn(layer)``: ``reps`` calls, ``layer``
    cycling over ``layers`` (``flush_layers``: one pass reads past the 50
    MB L2, as serving reads each layer's KV cold), between one pair of CUDA
    events, divided by ``reps``; the median of ``runs`` such runs. Each run
    is enqueued behind a device-side sleep longer than the host takes to
    enqueue it, so the card runs the calls back to back and the events time
    the device, not the wrapper's Python."""
    for i in range(min(reps, layers + 2)):
        fn(i % layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i % layers)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(2.0 * host_s, 2.0) * SLEEP_CYCLES_PER_S))
        a.record()
        for i in range(reps):
            fn(i % layers)
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def flush_layers(read_bytes: int) -> int:
    """Layers to cycle so that one pass reads at least twice the L2."""
    need = -(-2 * L2_BYTES // max(read_bytes, 1))
    return int(min(MAX_FLUSH_LAYERS, max(1, need)))


# -- phase 2: kernels against their plain versions -------------------------


def kv_rows_read(q_lens, ctxs, window):
    """Live K/V positions the rows' queries can see, summed over rows."""
    rows = 0
    for ql, ctx in zip(q_lens, ctxs):
        rows += ctx - (max(ctx - ql - window + 1, 0) if window else 0)
    return rows


def make_case(rng, B, q_lens, ctxs, S, window=None, softcap=None, hq=HQ,
              hkv=HKV, max_ctx=4096, sm_scale=None, dh=DH):
    """A paged cache holding each row's context on distinct random pages in
    every layer (as many layers as ``flush_layers`` asks for timing, at
    least 2; layer 1 is checked), the page table (``max_ctx // ps`` wide,
    unused entries 0) and bf16 queries at the row's last ``q_len``
    positions; ``hq`` query heads over ``hkv`` kv heads of head_dim ``dh``
    (Llama-3.2-3B's by default), the query scale ``dh ** -0.5`` unless
    given."""
    sm_scale = dh ** -0.5 if sm_scale is None else sm_scale
    L = max(2, flush_layers(kv_rows_read(q_lens, ctxs, window)
                            * hkv * dh * 2 * 2))
    P = max_ctx // PS
    need = sum(-(-c // PS) for c in ctxs)
    N = need + 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    pages = torch.randn((L, N, 2, hkv, PS, dh), generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
    # the garbage page holds NaN: a kernel that multiplies a masked weight
    # by it instead of selecting would leak NaN into the output
    pages[:, 0] = float("nan")
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    table = np.zeros((B, P), np.int32)
    positions = np.zeros((B, S), np.int32)
    off = 0
    for i in range(B):
        n = -(-ctxs[i] // PS)
        table[i, :n] = perm[off:off + n]
        off += n
        positions[i, :q_lens[i]] = np.arange(ctxs[i] - q_lens[i], ctxs[i])
    q = torch.randn((B, S, hq, dh), generator=g, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    return dict(q=q, pages=pages, layers=L, dh=dh,
                table=torch.from_numpy(table).to(dev),
                positions=torch.from_numpy(positions).to(dev),
                total=torch.tensor(ctxs, dtype=torch.int32, device=dev),
                q_lens=list(q_lens), ctxs=list(ctxs), window=window,
                softcap=softcap, sm_scale=sm_scale, hq=hq, hkv=hkv)


def work_of(case, S):
    """(bytes, operations) the function needs on these inputs: each live
    K/V row read once, the real query slots read once, the whole output
    written once, the table entries and lengths read; 4*Dh operations per
    (query head, visible kv position). A group of more than 8 query heads
    takes B1 one block per sub-group, each streaming the kv head's pages:
    the bound still counts one read."""
    B = len(case["ctxs"])
    win = case["window"] or 0
    kv_rows = kv_rows_read(case["q_lens"], case["ctxs"], win)
    pairs = 0
    for ql, ctx in zip(case["q_lens"], case["ctxs"]):
        for p in range(ctx - ql, ctx):
            first = max(p - win + 1, 0) if win else 0
            pairs += p + 1 - first
    hq, hkv, dh = case["hq"], case["hkv"], case["dh"]
    kv_bytes = kv_rows * hkv * dh * 2 * 2
    q_bytes = sum(case["q_lens"]) * hq * dh * 2   # real query slots only
    out_bytes = B * S * hq * dh * 2               # pad slots are written zero
    meta = B * (-(-max(case["ctxs"]) // PS)) * 4 + B * 8
    return kv_bytes + q_bytes + out_bytes + meta, 4 * dh * hq * pairs


def sdpa_inputs(case, S, decode: bool, layer: int):
    """Gathered K/V [B, Hkv, T, Dh] of ``layer`` and a boolean mask for one
    ``scaled_dot_product_attention`` call computing the same function."""
    B = len(case["ctxs"])
    T = -(-max(case["ctxs"]) // PS) * PS
    tbl = case["table"][:, :T // PS].long()
    kv = case["pages"][layer][tbl]                  # [B, n, 2, Hkv, ps, Dh]
    hkv, dh = case["hkv"], case["dh"]
    k = kv[:, :, 0].permute(0, 2, 1, 3, 4).reshape(B, hkv, T, dh)
    v = kv[:, :, 1].permute(0, 2, 1, 3, 4).reshape(B, hkv, T, dh)
    k = torch.nan_to_num(k)
    v = torch.nan_to_num(v)
    q = case["q"][:, :1] if decode else case["q"]
    qpos = case["total"].long()[:, None] - 1 if decode else \
        case["positions"][:, :1].long() + torch.arange(S, device="cuda")
    t = torch.arange(T, device="cuda")
    mask = (t[None, None, :] <= qpos[:, :, None]) & \
        (t[None, None, :] < case["total"].long()[:, None, None])
    if case["window"]:
        mask &= t[None, None, :] > qpos[:, :, None] - case["window"]
    mask |= ~mask.any(dim=-1, keepdim=True)   # pad slots: keep finite
    return q.transpose(1, 2).contiguous(), k, v, mask[:, None]


def judge(name, label, run, plain, library, layers, q_lens, work, results):
    """Hold one kernel case against its plain version on layer 1: per
    (query slot, head) row within KERNEL_TOL_ULPS on the real slots,
    finite, pad slots exactly zero; then time the kernel's wrapper, the
    plain version and the library call (``library`` is None where no
    PyTorch call computes the function), each a function of the layer,
    over ``layers`` layers (``time_ms``), and the kernel also by the
    per-call method of the first slices; record the row with its bound."""
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    out = run(1)
    torch.cuda.synchronize()
    ref = plain(1)
    torch.cuda.synchronize()
    real = torch.zeros(out.shape[:2], dtype=torch.bool, device="cuda")
    for i, ql in enumerate(q_lens):
        real[i, :ql] = True
    diff = (out.float() - ref.float()).abs()
    err = float(diff[real].max())
    ulps = float(row_ulp_error(out, ref)[real].max())
    finite = bool(torch.isfinite(out).all())
    pad_zero = bool((out[~real].float() == 0).all())
    ok = finite and pad_zero and ulps <= KERNEL_TOL_ULPS
    ms = time_ms(run, layers)
    plain_ms = time_ms(plain, layers, reps=5)
    lib_ms = time_ms(library, layers) if library is not None else None
    ms_per_call = time_ms_per_call(run)
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOPS_PER_S * 1e3
    row = dict(label=label, max_abs_err=err, max_err_ulps=ulps, ms=ms,
               plain_ms=plain_ms, ms_per_call=ms_per_call, layers=layers,
               library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"[kernel] {name} {label}: max|d|={err:.3e} row err={ulps:.3f} "
        f"ulps (tol {KERNEL_TOL_ULPS}) "
        f"finite={finite} pad_zero={pad_zero} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib} "
        f"ms_per_call={ms_per_call:.4f} layers={layers} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
        f"-> {'ok' if ok else 'FAIL'}")
    results.setdefault(name, []).append(row)
    if not ok:
        raise AssertionError(f"{name} {label}: kernel disagrees with its "
                             f"plain version ({ulps} ulps, finite {finite}, "
                             f"pad rows zero {pad_zero})")


def check_kernel(name, fn, plain, case, S, decode, results, label):
    import torch.nn.functional as F
    q = case["q"][:, :1].contiguous() if decode else case["q"]
    head = (q, case["pages"])
    tail = (case["table"], case["positions"][:, :1].contiguous() if decode
            else case["positions"], case["total"], case["sm_scale"])
    kw = dict(window=case["window"], softcap=case["softcap"])
    L = case["layers"]
    sdpa = [sdpa_inputs(case, S, decode, layer) for layer in range(L)]
    judge(name, label, lambda layer: fn(*head, layer, *tail, **kw),
          lambda layer: plain(*head, layer, *tail, **kw),
          lambda layer: F.scaled_dot_product_attention(
              *sdpa[layer][:3], attn_mask=sdpa[layer][3],
              scale=case["sm_scale"], enable_gqa=True),
          L, case["q_lens"], work_of(case, 1 if decode else S), results)


def kernel_cases(rng):
    """Phase 2's cases, made in order from ``rng``: (kernel, label, case, S,
    decode). A generator, so a test can rebuild one case from the same
    draws of the same generator."""
    # B1: decode at B in {1, 8, 32}, ragged contexts up to 4096
    for B in (1, 8, 32):
        ctxs = [4096] + list(rng.integers(1, 4097, size=B - 1))
        if B > 2:
            ctxs[1] = 1
        yield ("paged_decode", f"B={B} ctx<={max(ctxs)}",
               make_case(rng, B, [1] * B, ctxs, 1), 1, True)
    yield ("paged_decode", "B=8 window=1024 softcap=30",
           make_case(rng, 8, [1] * 8, list(rng.integers(1500, 4097, 8)), 1,
                     window=1024, softcap=30.0), 1, True)
    # B2: S=512 chunks, rows with prefix hits and one partial chunk
    S = 512
    yield ("paged_prefill", PREFILL_PREFIX_LABEL,
           make_case(rng, 4, [512, 512, 512, 300], [512, 1024, 3000, 1836],
                     S), S, False)
    yield ("paged_prefill", "B=2 S=512 window=256 softcap=50",
           make_case(rng, 2, [512, 512], [2048, 512], S, window=256,
                     softcap=50.0), S, False)
    # B3: two 512-token chunks (one over a prefix) + six decode rows
    ctxs = [1024, 512] + list(rng.integers(64, 4097, size=6))
    yield ("ragged_mixed", "B=8 S=512 2 chunks + 6 decode rows",
           make_case(rng, 8, [512, 512, 1, 1, 1, 1, 1, 1], ctxs, S), S,
           False)
    # this slice's shapes (after the cases above, whose draws they leave
    # as they were): Gemma-2-27B's attention (32 query heads over 16 kv
    # heads, the sliding layers' window 4096, softcap 50, query scale
    # 144^-0.5, contexts up to its 8192) in B1 and B3, and B2 as the
    # speculative verify step runs it at Llama-3.2-3B's shapes (S = K+1)
    gemma = dict(window=GEMMA_WINDOW, softcap=50.0, hq=32, hkv=16,
                 max_ctx=8192, sm_scale=144.0 ** -0.5)
    ctxs = [8192, 1] + list(rng.integers(2, 8193, size=30))
    yield ("paged_decode", GEMMA_DECODE_LABEL,
           make_case(rng, 32, [1] * 32, ctxs, 1, **gemma), 1, True)
    K = SPEC_K
    ctxs = list(rng.integers(K + 2, 4097, size=32))
    yield ("paged_prefill", SPEC_VERIFY_LABEL,
           make_case(rng, 32, [K + 1] * 32, ctxs, K + 1), K + 1, False)
    ctxs = [6000, 512] + list(rng.integers(64, 8193, size=6))
    yield ("ragged_mixed", GEMMA_MIXED_LABEL,
           make_case(rng, 8, [512, 512, 1, 1, 1, 1, 1, 1], ctxs, S,
                     **gemma), S, False)
    # the query groups of the MoE slice (after the cases above): 5
    # (Qwen2.5-14B, 40 heads over 8), 7 (Qwen2.5-7B, 28 over 4) and
    # Qwen3-30B-A3B's 8 (32 over 4), each through B1, B2 and B3 at the
    # Llama cases' batch and context shapes
    for tag, hq, hkv in GROUP_CASES:
        heads = dict(hq=hq, hkv=hkv)
        ctxs = [4096, 1] + list(rng.integers(2, 4097, size=30))
        yield ("paged_decode", f"{tag} B=32 ctx<=4096",
               make_case(rng, 32, [1] * 32, ctxs, 1, **heads), 1, True)
        yield ("paged_prefill", f"{tag} B=4 S=512 prefix hits",
               make_case(rng, 4, [512, 512, 512, 300],
                         [512, 1024, 3000, 1836], S, **heads), S, False)
        ctxs = [1024, 512] + list(rng.integers(64, 4097, size=6))
        yield ("ragged_mixed", f"{tag} B=8 S=512 2 chunks + 6 decode",
               make_case(rng, 8, [512, 512, 1, 1, 1, 1, 1, 1], ctxs, S,
                         **heads), S, False)
    # the head dims and groups of the geometry slice (after the cases
    # above): Gemma-2-9B's attention (16 heads over 8 of head_dim 256, the
    # sliding layers' window 4096, softcap 50, query scale 256^-0.5,
    # contexts up to 8192), Llama-3.2-1B's (32 over 8 of head_dim 64), and
    # groups of 12 (Mistral-Large-2's 96 over 8) and 16 (Qwen3-235B-A22B's
    # 64 over 4), which B1 runs as sub-groups of 6 and 8 heads
    for tag, heads in GEOMETRY_CASES:
        top = heads.get("max_ctx", 4096)
        ctxs = [top, 1] + list(rng.integers(2, top + 1, size=30))
        yield ("paged_decode", f"{tag} B=32 ctx<={top}",
               make_case(rng, 32, [1] * 32, ctxs, 1, **heads), 1, True)
        yield ("paged_prefill", f"{tag} B=4 S=512 prefix hits",
               make_case(rng, 4, [512, 512, 512, 300],
                         [512, 1024, top - 1096, 1836], S, **heads), S,
               False)
        ctxs = [top - 2192, 512] + list(rng.integers(64, top + 1, size=6))
        yield ("ragged_mixed", f"{tag} B=8 S=512 2 chunks + 6 decode",
               make_case(rng, 8, [512, 512, 1, 1, 1, 1, 1, 1], ctxs, S,
                         **heads), S, False)


PREFILL_PREFIX_LABEL = "B=4 S=512 prefix hits"
# Gemma-2-27B's sliding window, and the draft count of the spec phases
GEMMA_WINDOW = 4096
SPEC_K = 4
GEMMA_DECODE_LABEL = "B=32 G=2 window=4096 softcap=50 ctx<=8192"
SPEC_VERIFY_LABEL = "B=32 S=5 spec verify (K=4, G=3)"
GEMMA_MIXED_LABEL = "B=8 G=2 window=4096 softcap=50"
# (label, query heads, kv heads) of the MoE slice's group cases
GROUP_CASES = (("G=5 (40/8)", 40, 8), ("G=7 (28/4)", 28, 4),
               ("G=8 Hkv=4 (32/4, Qwen3-30B-A3B)", 32, 4))
# (label, make_case's head arguments) of the geometry slice's cases
GEOMETRY_CASES = (
    ("Dh=256 G=2 (16/8, Gemma-2-9B) window=4096 softcap=50",
     dict(hq=16, hkv=8, dh=256, window=4096, softcap=50.0, max_ctx=8192)),
    ("Dh=64 G=4 (32/8, Llama-3.2-1B)", dict(hq=32, hkv=8, dh=64)),
    ("G=12 (96/8, Mistral-Large-2)", dict(hq=96, hkv=8)),
    ("G=16 (64/4, Qwen3-235B-A22B)", dict(hq=64, hkv=4)))


def phase_kernels(results):
    from dynamo_tpu_torch.ops.kernels.decode import (
        paged_decode_attention_stacked, paged_decode_plain)
    from dynamo_tpu_torch.ops.kernels.prefill import (
        paged_prefill_attention_stacked, paged_prefill_plain)
    from dynamo_tpu_torch.ops.kernels.ragged import (
        ragged_mixed_attention_stacked, ragged_mixed_plain)
    impls = {"paged_decode": (paged_decode_attention_stacked,
                              paged_decode_plain),
             "paged_prefill": (paged_prefill_attention_stacked,
                               paged_prefill_plain),
             "ragged_mixed": (ragged_mixed_attention_stacked,
                              ragged_mixed_plain)}
    for name, label, case, S, decode in kernel_cases(
            np.random.default_rng(0)):
        check_kernel(name, *impls[name], case, S, decode, results, label)
        if name != "paged_decode" and results[name][-1]["max_err_ulps"] > 1:
            _worst, flagged = prefill_rows_report(case, S, name=name,
                                                  label=label)
            bad = [f for f in flagged if f[5] > 1.0]
            if bad:
                raise AssertionError(
                    f"{name} {label}: {len(bad)} rows past 1 ulp from the "
                    f"plain version are past 1 ulp from the chunked "
                    f"rounding too, first {bad[0]}")
        del case


def chunked_rows(case, layer, b, h, spans=None):
    """``online_attention_rows`` (the prefill kernel's own chunked
    rounding, with the case's window and softcap, over the kv ranges
    ``spans`` of a split row) for every real (query slot, head) row of
    sequence ``b`` and kv head ``h``: bf16 [q_len, G, Dh]."""
    from dynamo_tpu_torch.ops.kernels.plain import online_attention_rows
    hq, hkv, dh = case["hq"], case["hkv"], case["dh"]
    G = hq // hkv
    ctx, ql = case["ctxs"][b], case["q_lens"][b]
    n = -(-ctx // PS)
    kv = case["pages"][layer][case["table"][b, :n].long()]  # [n,2,Hkv,ps,Dh]
    k = kv[:, 0, h].reshape(n * PS, dh)
    v = kv[:, 1, h].reshape(n * PS, dh)
    qs = (case["q"][b, :ql, h * G:(h + 1) * G].float() * case["sm_scale"]
          ).to(torch.bfloat16).reshape(ql * G, dh)
    qpos = (ctx - ql + torch.arange(ql, device="cuda")).repeat_interleave(G)
    return online_attention_rows(
        qs, k, v, qpos, ctx, window=case["window"] or 0,
        softcap=case["softcap"] or 0.0, spans=spans).reshape(ql, G, dh)


def split_spans(case, S, b):
    """The kv ranges of the ragged kernel's split blocks for a short row
    (``ragged.ragged_splits`` on this card), or None for a row of query
    tiles."""
    from dynamo_tpu_torch.ops.kernels.decode import sm_count
    from dynamo_tpu_torch.ops.kernels.ragged import (SPLIT_Q_CAP,
                                                     ragged_splits)
    if not 1 <= case["q_lens"][b] <= SPLIT_Q_CAP:
        return None
    P = case["table"].shape[1]
    _n_work, splits, per = ragged_splits(
        len(case["ctxs"]), S, case["hkv"], case["hq"] // case["hkv"], P, PS,
        sm_count(0))
    end = min(case["ctxs"][b], P * PS)
    return [(r * per * PS, min(end, (r + 1) * per * PS))
            for r in range(splits) if r * per * PS < end]


def prefill_rows_report(case, S, layer=1, name="paged_prefill", label=None):
    """A B2 (``paged_prefill``) or B3 (``ragged_mixed``) case, row by row:
    the (query slot, head) rows where the kernel is more than 1 ulp from
    its plain version, and the kernel and the plain version each against
    ``chunked_rows``, which rounds p against the running max of
    64-position chunks as the kernel (and the TPU kernel, per its own
    chunk) does, where the plain version rounds against the row's final
    max; a split row of B3 takes its splits' ranges. Phase 2 runs it on
    every B2/B3 case past 1 ulp and fails if a row past 1 ulp from the
    plain version is more than 1 ulp from the chunked rounding: such a row
    is the kernel's fault, not the rounding's."""
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    from dynamo_tpu_torch.ops.kernels.prefill import (
        paged_prefill_attention_stacked, paged_prefill_plain)
    from dynamo_tpu_torch.ops.kernels.ragged import (
        ragged_mixed_attention_stacked)
    fn = paged_prefill_attention_stacked if name == "paged_prefill" else \
        ragged_mixed_attention_stacked
    args = (case["q"], case["pages"], layer, case["table"],
            case["positions"], case["total"], case["sm_scale"])
    kw = dict(window=case["window"], softcap=case["softcap"])
    out = fn(*args, **kw)
    ref = paged_prefill_plain(*args, **kw)
    hkv = case["hkv"]
    G = case["hq"] // hkv
    worst = {"kernel_vs_plain": 0.0, "kernel_vs_chunked": 0.0,
             "plain_vs_chunked": 0.0}
    flagged = []
    for b, ql in enumerate(case["q_lens"]):
        spans = split_spans(case, S, b) if name == "ragged_mixed" else None
        for h in range(hkv):
            cols = slice(h * G, (h + 1) * G)
            mir = chunked_rows(case, layer, b, h, spans)
            kp = row_ulp_error(out[b, :ql, cols], ref[b, :ql, cols])
            km = row_ulp_error(out[b, :ql, cols], mir)
            pm = row_ulp_error(ref[b, :ql, cols], mir)
            for key, e in (("kernel_vs_plain", kp), ("kernel_vs_chunked", km),
                           ("plain_vs_chunked", pm)):
                worst[key] = max(worst[key], float(e.max()))
            for slot, g in (kp > 1.0).nonzero().tolist():
                flagged.append((b, slot, h * G + g,
                                case["ctxs"][b] - ql + slot,
                                float(kp[slot, g]), float(km[slot, g]),
                                float(pm[slot, g])))
    tag = f"{name} {label or PREFILL_PREFIX_LABEL}"
    log(f"[kernel] {tag} rows: {len(flagged)} of "
        f"{sum(case['q_lens']) * case['hq']} past 1 ulp from the plain "
        f"version; max ulps kernel vs plain {worst['kernel_vs_plain']:.3f}, "
        f"kernel vs chunked rounding {worst['kernel_vs_chunked']:.3f}, "
        f"plain vs chunked rounding {worst['plain_vs_chunked']:.3f}")
    for b, slot, head, pos, kp, km, pm in flagged[:16]:
        log(f"[kernel] {name} row b={b} slot={slot} head={head} "
            f"pos={pos} ctx={case['ctxs'][b]}: kernel vs plain {kp:.3f}, "
            f"kernel vs chunked {km:.3f}, plain vs chunked {pm:.3f} ulps")
    return worst, flagged


# -- phase 2b: the latent (MLA) kernels against their plain versions -------


def make_mla_case(rng, q_lens, ctxs, S):
    """A latent cache [L, N, 2, 1, ps, dkv] holding each row's context on
    distinct random pages (slot 1: the rope key, zero past its dr columns,
    as the model writes it; the garbage page NaN), the page table
    (``max_context // ps`` wide) and queries at the row's last ``q_len``
    positions: float32 ``q_lat`` (as the model computes it) and bf16
    ``q_pe``; as many layers as ``flush_layers`` asks for timing, at least
    2 (layer 1 is checked)."""
    B = len(ctxs)
    L = max(2, flush_layers(sum(ctxs) * (DKV + DR) * 2))
    P = 4096 // PS
    N = sum(-(-c // PS) for c in ctxs) + 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    pages = torch.randn((L, N, 2, 1, PS, DKV), generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
    pages[:, :, 1, :, :, DR:] = 0
    pages[:, 0] = float("nan")
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    table = np.zeros((B, P), np.int32)
    positions = np.zeros((B, S), np.int32)
    off = 0
    for i in range(B):
        n = -(-ctxs[i] // PS)
        table[i, :n] = perm[off:off + n]
        off += n
        positions[i, :q_lens[i]] = np.arange(ctxs[i] - q_lens[i], ctxs[i])
    q_lat = torch.randn((B, S, NH, DKV), generator=g, device=dev)
    q_pe = torch.randn((B, S, NH, DR), generator=g, device=dev).to(
        torch.bfloat16)
    return dict(q_lat=q_lat, q_pe=q_pe, pages=pages, layers=L,
                table=torch.from_numpy(table).to(dev),
                positions=torch.from_numpy(positions).to(dev),
                total=torch.tensor(ctxs, dtype=torch.int32, device=dev),
                q_lens=list(q_lens), ctxs=list(ctxs),
                sm_scale=(128 + DR) ** -0.5)


def mla_work_of(case, S):
    """(bytes, operations) the latent attention needs on these inputs:
    each live position's latent and rope key read once ((dkv + dr) * 2
    bytes, not slot 1's padding), the real query slots' bf16 rows read
    once, the whole float32 output written once, the table entries and
    lengths read; 2 (dkv + dr) + 2 dkv operations per (query head,
    visible position)."""
    B = len(case["ctxs"])
    pairs = sum(sum(p + 1 for p in range(ctx - ql, ctx))
                for ql, ctx in zip(case["q_lens"], case["ctxs"]))
    kv_bytes = sum(case["ctxs"]) * (DKV + DR) * 2
    q_bytes = sum(case["q_lens"]) * NH * (DKV + DR) * 2
    out_bytes = B * S * NH * DKV * 4
    meta = B * (-(-max(case["ctxs"]) // PS)) * 4 + B * 8
    return (kv_bytes + q_bytes + out_bytes + meta,
            pairs * NH * (2 * (DKV + DR) + 2 * DKV))


def mla_sdpa(case, S, decode):
    """One ``scaled_dot_product_attention`` call computing the same
    function on the gathered latent: q [B, nh, S, dkv+dr], k [B, 1, T,
    dkv+dr], v [B, 1, T, dkv] (``enable_gqa``), a boolean mask. Returns the
    call as a function of the layer and the backend PyTorch picks for it."""
    import torch.nn.functional as F
    B = len(case["ctxs"])
    T = -(-max(case["ctxs"]) // PS) * PS
    tbl = case["table"][:, :T // PS].long()
    ks, vs = [], []
    for layer in range(case["layers"]):
        # [B, n, 2, 1, ps, dkv]
        kv = torch.nan_to_num(case["pages"][layer][tbl])
        ckv = kv[:, :, 0, 0].reshape(B, T, DKV)
        kpe = kv[:, :, 1, 0, :, :DR].reshape(B, T, DR)
        ks.append(torch.cat([ckv, kpe], dim=-1)[:, None])
        vs.append(ckv[:, None].contiguous())
        del kv, ckv, kpe
    q = torch.cat([case["q_lat"].to(torch.bfloat16), case["q_pe"]], dim=-1)
    q = (q[:, :1] if decode else q).transpose(1, 2).contiguous()
    qpos = case["total"].long()[:, None] - 1 if decode else \
        case["positions"][:, :1].long() + torch.arange(S, device="cuda")
    t = torch.arange(T, device="cuda")
    mask = (t[None, None, :] <= qpos[:, :, None]) & \
        (t[None, None, :] < case["total"].long()[:, None, None])
    mask |= ~mask.any(dim=-1, keepdim=True)   # pad slots: keep finite
    mask = mask[:, None]
    try:
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(
            q, ks[0], vs[0], attn_mask=mask, scale=case["sm_scale"],
            enable_gqa=True)).name
    except Exception as e:                  # noqa: BLE001 — report only
        backend = f"unknown ({type(e).__name__})"
    return (lambda layer: F.scaled_dot_product_attention(
        q, ks[layer], vs[layer], attn_mask=mask, scale=case["sm_scale"],
        enable_gqa=True)), backend


def check_mla(name, case, S, decode, results, label):
    from dynamo_tpu_torch.ops.kernels.mla_decode import (
        mla_decode_plain, mla_paged_decode_stacked)
    from dynamo_tpu_torch.ops.kernels.mla_prefill import (
        mla_paged_prefill_stacked, mla_prefill_plain)
    c = case
    if decode:
        head = (c["q_lat"][:, :1].contiguous(),
                c["q_pe"][:, :1].contiguous(), c["pages"])
        tail = (c["table"], c["total"], c["sm_scale"])
        fn, plain = mla_paged_decode_stacked, mla_decode_plain
    else:
        head = (c["q_lat"], c["q_pe"], c["pages"])
        tail = (c["table"], c["positions"], c["total"], c["sm_scale"])
        fn, plain = mla_paged_prefill_stacked, mla_prefill_plain
    library, backend = mla_sdpa(case, S, decode)
    log(f"[kernel] {name} {label}: library call "
        f"scaled_dot_product_attention served by {backend}")
    judge(name, label, lambda layer: fn(*head, layer, *tail),
          lambda layer: plain(*head, layer, *tail), library, c["layers"],
          case["q_lens"], mla_work_of(case, 1 if decode else S), results)


def phase_mla_kernels(results):
    rng = np.random.default_rng(10)
    # B4: decode at B in {1, 8, 32}, contexts up to 4096, one of 1 token
    for B in (1, 8, 32):
        ctxs = [4096] + list(rng.integers(1, 4097, size=B - 1))
        if B > 2:
            ctxs[1] = 1
        case = make_mla_case(rng, [1] * B, ctxs, 1)
        check_mla("mla_decode", case, 1, True, results,
                  f"B={B} ctx<={max(ctxs)}")
    # B5: S=512 chunks with prefix hits and one 300-token row; then the
    # mixed shape: two chunks (one over a prefix) + six decode rows
    S = 512
    case = make_mla_case(rng, [512, 512, 512, 300], [512, 1024, 3000, 1836],
                         S)
    check_mla("mla_prefill", case, S, False, results,
              "B=4 S=512 prefix hits")
    ctxs = [1024, 512] + list(rng.integers(64, 4097, size=6))
    case = make_mla_case(rng, [512, 512, 1, 1, 1, 1, 1, 1], ctxs, S)
    check_mla("mla_prefill", case, S, False, results,
              "B=8 S=512 2 chunks + 6 decode rows")
    del case
    q_lens, ctxs = mla_ragged_shape()
    case = make_mla_case(rng, q_lens, ctxs, 131)
    check_mla("mla_prefill", case, 131, False, results,
              "B=7 S=131 ragged tiles + decode rows on a split edge")


def mla_ragged_shape():
    """Phase 2b's third B5 case: S = 131 (a ragged last 4-slot tile),
    chunks of 77 and 130 over prefixes, a row of 5, a decode row at ctx 1
    and three whose contexts end one before, on and one after a split
    boundary of ``mla_prefill_splits`` on this card."""
    from dynamo_tpu_torch.ops.kernels.mla_prefill import mla_prefill_splits
    q_lens = [77, 1, 130, 5, 1, 1, 1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _n, _splits, per = mla_prefill_splits(len(q_lens), 131, NH, 4096 // PS,
                                          PS, sms)
    edge = per * PS
    return q_lens, [77, 1, 1000, 5, edge - 1, edge, edge + 1]


# -- phase 3: full-width forward, kernels vs plain attention ---------------


def llama_cfg():
    from dynamo_tpu_torch.models.config import ModelConfig
    return ModelConfig.llama32_3b()


def llama_impls():
    """(kernel, plain, oracle) attention per step kind for the Llama
    forward."""
    from dynamo_tpu_torch.ops.attention import paged_attention
    from dynamo_tpu_torch.ops.kernels.decode import (
        paged_decode_attention_stacked, paged_decode_plain)
    from dynamo_tpu_torch.ops.kernels.prefill import (
        paged_prefill_attention_stacked, paged_prefill_plain)
    from dynamo_tpu_torch.ops.kernels.ragged import (
        ragged_mixed_attention_stacked, ragged_mixed_plain)
    return ({"decode": paged_decode_attention_stacked,
             "prefill": paged_prefill_attention_stacked,
             "mixed": ragged_mixed_attention_stacked},
            {"decode": paged_decode_plain, "prefill": paged_prefill_plain,
             "mixed": ragged_mixed_plain},
            paged_attention)


def mla_impls():
    """(kernel, plain, oracle) latent attention per step kind for the
    DeepSeek forward: the engine's choice (decode kernel at S == 1, the
    prefill kernel for prefill and mixed steps), their plain versions, and
    None (the forward's own ``_mla_attend`` / ``_mla_attend_blockwise``)."""
    from dynamo_tpu_torch.engine.torch_engine import MLA_ATTENTION
    from dynamo_tpu_torch.ops.kernels.mla_decode import mla_decode_plain
    from dynamo_tpu_torch.ops.kernels.mla_prefill import mla_prefill_plain

    def decode_plain(q_lat, q_pe, pages, layer, table, positions, total,
                     scale):
        return mla_decode_plain(q_lat, q_pe, pages, layer, table, total,
                                scale)
    return ({"decode": MLA_ATTENTION["mla_decode"],
             "prefill": MLA_ATTENTION["mla_prefill"],
             "mixed": MLA_ATTENTION["mla_prefill"]},
            {"decode": decode_plain, "prefill": mla_prefill_plain,
             "mixed": mla_prefill_plain},
            None)


def llama_plan(cfg, rng):
    """Phase 3's steps on two rows of 1024-token prompts, each on 64 pages
    of a 200-page cache: a prefill of both rows' first 512 tokens, a mixed
    step (row 0's next chunk over its cached prefix, row 1 one token) and
    a decode step. Returns (steps, page table, pages per cache); a step is
    (label, kind, tokens, positions, total, new, logits window), ``kind``
    the attention it runs (decode, prefill or mixed)."""
    P = 4096 // PS
    table = np.zeros((2, P), np.int32)
    table[0, :64] = np.arange(1, 65)
    table[1, :64] = np.arange(65, 129)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 1024)).astype(np.int32)
    S = 512
    steps = [("prefill", "prefill", prompt[:, :S],
              np.tile(np.arange(S), (2, 1)), [S, S], [S, S], 1)]
    toks = np.zeros((2, S), np.int32)
    pos = np.zeros((2, S), np.int32)
    toks[0] = prompt[0, S:2 * S]
    pos[0] = np.arange(S, 2 * S)
    toks[1, 0] = prompt[1, S]
    pos[1, 0] = S
    steps.append(("mixed", "mixed", toks, pos, [2 * S, S + 1], [S, 1], 1))
    steps.append(("decode", "decode", [[7], [9]], [[2 * S], [S + 1]],
                  [2 * S + 1, S + 2], [1, 1], 1))
    return steps, table, 200


def spec_plan(cfg, rng):
    """A speculative verify step at Llama-3.2-3B's widths: phase 3's
    prefill of two 512-token prompts, then one ``[2, K+1]`` step feeding
    each row's last token and K drafts through the chunked-prefill
    attention with a logits window of K+1, as ``TorchEngine._spec_step``
    runs it."""
    steps, table, pages = llama_plan(cfg, rng)
    S, K = 512, SPEC_K
    drafts = rng.integers(0, cfg.vocab_size, size=(2, K + 1)).astype(
        np.int32)
    # the token sampled after the prompt at position S, then the drafts
    pos = np.tile(np.arange(S, S + K + 1), (2, 1))
    return [steps[0], ("verify", "prefill", drafts, pos,
                       [S + K + 1, S + K + 1], [K + 1, K + 1], K + 1)], \
        table, pages


# Gemma-2-27B's forward check: row 0's prompt runs past the sliding
# layers' window of 4096, row 1's stays short
GEMMA_LENS = (5633, 1502)


def gemma_plan(cfg, rng):
    """Gemma-2-27B's steps on two rows: five prefill chunks of 1024 tokens
    take row 0 to 5120 positions (the last chunk's queries see only the
    window's 4096 positions on the sliding layers) and row 1, beside it,
    to 1500 in chunks of 350 and a last of 100 (chunks with pad slots);
    then a mixed step (row 0's next 512 tokens, row 1 one) and a decode
    step. The page table is 8192 positions wide."""
    P = 8192 // PS
    n0, n1 = (-(-(n + 2) // PS) for n in GEMMA_LENS)
    table = np.zeros((2, P), np.int32)
    table[0, :n0] = np.arange(1, n0 + 1)
    table[1, :n1] = np.arange(n0 + 1, n0 + n1 + 1)
    prompt = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
              for n in GEMMA_LENS]
    steps = []
    done = [0, 0]
    for S, chunks in ([(1024, (1024, 350))] * 4 + [(1024, (1024, 100)),
                                                    (512, (512, 1)),
                                                    (1, (1, 1))]):
        toks = np.zeros((2, S), np.int32)
        pos = np.zeros((2, S), np.int32)
        for r, n in enumerate(chunks):
            toks[r, :n] = prompt[r][done[r]:done[r] + n]
            pos[r, :n] = np.arange(done[r], done[r] + n)
            done[r] += n
        kind = ("decode" if S == 1 else "mixed" if chunks[1] == 1
                else "prefill")
        steps.append((f"{kind} S={S} ctx {done[0]}/{done[1]}", kind, toks,
                      pos, list(done), list(chunks), 1))
    return steps, table, n0 + n1 + 1


def phase_forward(params, cfg, impls, strict_logits=True, plan=llama_plan,
                  compare=None):
    """The steps of ``plan`` through three forwards, each on its own
    cache: through the kernels, through the kernels' plain versions, and
    through the JAX-style oracle (``ops.attention`` for the Llama tree and
    Gemma-2, the DeepSeek forward's own latent attention: float32 scores
    from the unrounded query, float32 weights).

    Inside the kernel forward every layer's attention is also computed by
    the plain version on the SAME inputs (the model's real activations and
    cache): every row must agree within KERNEL_TOL_ULPS. End to end, 28
    layers of random bf16 weights amplify any rounding-level difference, so
    the logits through the kernels may be no further from the plain
    forward's than LOGITS_VS_ORACLE times the distance this run measures
    between the plain and the oracle forwards, which differ only in where
    they round. The greedy token is not compared: with random weights the
    top two logits of a row are often closer than that distance. With
    ``strict_logits`` off (DeepSeek) the logits gate is reported and the
    per-layer check alone decides: random MoE gates can flip a near-tie
    route between two forwards that differ in rounding, and one flipped
    route moves the logits by far more than rounding. ``compare`` =
    (label, params): a fourth forward through the kernels on those weights
    (the bf16 tree beside an int8 one), whose distance to the kernel
    forward's logits is printed and gates nothing."""
    from dynamo_tpu_torch.models import deepseek, get_family, moe
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    family = get_family(cfg)
    kernel, plain, oracle = impls
    mla = oracle is None
    rng = np.random.default_rng(1)
    dev = "cuda"
    layer_errs = []
    vs_oracle = []          # MLA: per layer, (kernel, plain) vs the oracle
    real_slots = None       # [B, S] bool of the step being run

    def checked(name):
        def attn(*args, **kw):
            out = kernel[name](*args, **kw)
            ref = plain[name](*args, **kw)
            layer_errs.append(float(row_ulp_error(out, ref).max()))
            if mla:
                orc = mla_oracle_latent(cfg, *args)
                vs_oracle.append(
                    (float(row_ulp_error(out, orc)[real_slots].max()),
                     float(row_ulp_error(ref, orc)[real_slots].max())))
            return out
        return attn

    # MoE (DeepSeek's gate, the mixtral / qwen3-MoE router): record each
    # MoE layer's routed experts per forward
    routes = {"on": None}
    router = (deepseek, "_gate") if mla else (moe, "_router_topk")
    gate = getattr(*router)

    def recording_gate(cfg_, lp, x):
        w, idx = gate(cfg_, lp, x)
        if routes["on"] is not None:
            routes[routes["on"]].append(idx.sort(dim=-1).values)
        return w, idx

    impls = {"kernel": checked, "plain": lambda n: plain[n],
             "oracle": lambda n: oracle}
    weights = {k: params for k in impls}
    if compare is not None:
        impls["compare"] = lambda n: kernel[n]
        weights["compare"] = compare[1]
    steps, table, num_pages = plan(cfg, rng)
    caches = {k: family.make_pages(cfg, num_pages, PS, device=dev)
              for k in impls}
    for name, kind, toks, pos, total, new, window in steps:
        a = [torch.from_numpy(np.asarray(x, np.int32)).to(dev)
             for x in (toks, pos, table, total, new)]
        S_step = a[0].shape[1]
        real_slots = (torch.arange(S_step, device=dev)[None, :]
                      < a[4][:, None])
        logits = {}
        layer_errs.clear()
        vs_oracle.clear()
        if cfg.num_experts:
            setattr(*router, recording_gate)
        try:
            for k, impl in impls.items():
                routes["on"] = k
                routes[k] = []
                logits[k] = family.forward(weights[k], cfg, a[0], a[1],
                                           caches[k], a[2], a[3], a[4],
                                           attn_impl=impl(kind),
                                           logits_window=window)[0]
        finally:
            setattr(*router, gate)
            routes["on"] = None
        torch.cuda.synchronize()
        lk, lp, lo = logits["kernel"], logits["plain"], logits["oracle"]
        finite = bool(torch.isfinite(lk).all())
        diff = float((lk - lp).abs().max())
        scale = float(lp.abs().max())
        odiff = float((lp - lo).abs().max())
        tol = LOGITS_VS_ORACLE * odiff
        lmax = max(layer_errs)
        log(f"[forward] {name}: per-layer kernel vs plain row err="
            f"{lmax:.3f} ulps over {len(layer_errs)} layers (tol "
            f"{KERNEL_TOL_ULPS}); logits kernels vs plain max|d|={diff:.4e} "
            f"(tol {tol:.4e} = {LOGITS_VS_ORACLE} x plain vs oracle "
            f"{odiff:.4e}); max|logits|={scale:.4e} finite={finite}")
        if not finite or lmax > KERNEL_TOL_ULPS \
                or (strict_logits and diff > tol):
            raise AssertionError(f"forward {name}: kernels vs plain "
                                 f"attention disagree")
        log(f"[forward] {name}: logits ratio kernels-vs-plain / "
            f"plain-vs-oracle = {diff / max(odiff, 1e-30):.3f}")
        if compare is not None:
            lc = logits["compare"]
            same = float((lk.argmax(-1) == lc.argmax(-1)).float().mean())
            log(f"[forward] {name}: logits vs the {compare[0]} forward "
                f"max|d|={float((lk - lc).abs().max()):.4e} (max|logits| "
                f"{float(lc.abs().max()):.4e}), argmax agreement "
                f"{same:.3f} (reported, not gated)")
        if routes["kernel"]:
            flips = route_flips(routes, real_slots)
            log(f"[forward] {name}: MoE routes differing per layer over "
                f"{int(real_slots.sum())} tokens, kernels vs plain "
                f"{flips['kernel']} (total {sum(flips['kernel'])}), plain "
                f"vs oracle {flips['oracle']} (total "
                f"{sum(flips['oracle'])})")
        if vs_oracle:
            kv = [round(x[0], 3) for x in vs_oracle]
            pv = [round(x[1], 3) for x in vs_oracle]
            log(f"[forward] {name}: per layer, latent attention vs the "
                f"oracle (f32 scores from the unrounded query, f32 "
                f"weights) in ulps: kernel {kv}; plain {pv}; kernel/plain "
                f"max {max(kv) / max(max(pv), 1e-30):.3f}")
        if diff > tol:
            log(f"[forward] {name}: logits gate exceeded ({diff:.4e} > "
                f"{tol:.4e}); reported only: the per-layer check decides "
                f"(random MoE gates can flip a near-tie route)")
    del caches


def route_flips(routes, real_slots):
    """Per MoE layer, the real tokens whose routed expert set differs:
    kernels vs plain and plain vs oracle."""
    out = {}
    for k, other in (("kernel", "plain"), ("oracle", "plain")):
        out[k] = [int(((a != b).any(dim=-1).reshape(-1)
                       & real_slots.reshape(-1)).sum())
                  for a, b in zip(routes[k], routes[other])]
    return out


def mla_oracle_latent(cfg, q_lat, q_pe, pages, layer, table, positions,
                      total, sm_scale):
    """The DeepSeek oracle's latent attention (``deepseek._mla_attend``
    before its output projection) on the attention call's own inputs:
    float32 scores from the unrounded query, float32 softmax weights."""
    from dynamo_tpu_torch.models.deepseek import _gather_ctx
    from dynamo_tpu_torch.ops.kernels.plain import NEG_INF
    ckv, kpe = _gather_ctx(cfg, pages[layer][table.long()])
    ckv32 = ckv.float()
    s = (torch.einsum("bsnk,btk->bnst", q_lat.float(), ckv32)
         + torch.einsum("bsnd,btd->bnst", q_pe.float(), kpe.float())
         ) * sm_scale
    t = torch.arange(ckv.shape[1], device=ckv.device)[None, None, None, :]
    mask = ((t <= positions.long()[:, None, :, None])
            & (t < total.long()[:, None, None, None]))
    probs = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bnst,btk->bsnk", probs, ckv32)


# -- phase 4: the engine serving requests ----------------------------------


# engine counters a serve reports as its own (the difference over it)
SERVE_COUNTERS = ("decode_dispatches", "multistep_blocks", "chained_steps",
                  "mixed_steps")


# phase 4's workload (also phase 5's timed windows, sent over HTTP):
# prompt lengths, the requests that start at once, and the count of tokens
# a stream has when the rest are released (so they arrive mid-decode)
SERVE_LENS = (1024, 128, 700, 512, 256, 900, 384, 1000, 640, 160)
SERVE_FIRST_N, SERVE_RELEASE_AT = 6, 4


def serve_prompts(V: int, seed: int, n_req: int = len(SERVE_LENS)):
    """Phase 4's prompts: seeded token ids of ``SERVE_LENS``; request 3
    shares request 0's first 512 tokens (a prefix-cache hit)."""
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, V, size=n)))
               for n in SERVE_LENS[:n_req]]
    if n_req > 3:
        prompts[3] = prompts[0][:512] + prompts[3][:256]
    return prompts


async def serve(engine, n_req=10, max_tokens=32, seed=2, prompts=None):
    """One serve of greedy requests (prompts made from ``seed``, or
    ``prompts``) on a running engine, with a step recorder of its own.
    Returns (stats per request, wall seconds, the serve's step records,
    engine counters and graph captures / replays over it)."""
    from dynamo_tpu_torch.engine.steptrace import StepRecorder
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    engine.steptrace = StepRecorder()      # this serve's steps only
    before = {k: getattr(engine, k) for k in SERVE_COUNTERS}
    g = engine.graphs
    g0 = (len(g), g.replays) if g is not None else (0, 0)
    if prompts is None:
        prompts = serve_prompts(engine.model_cfg.vocab_size, seed, n_req)
    n_req = len(prompts)
    started = asyncio.Event()
    stats = {}

    async def one(i):
        if i >= SERVE_FIRST_N:
            await started.wait()       # arrives while the others decode
        req = PreprocessedRequest(
            token_ids=prompts[i], request_id=f"s{seed}r{i}",
            stop_conditions=StopConditions(max_tokens=max_tokens),
            sampling_options=SamplingOptions(temperature=0.0))
        t0 = time.perf_counter()
        ttft, toks, lps, fin = None, [], [], None
        async for out in engine.generate(req):
            if out.token_ids and ttft is None:
                ttft = time.perf_counter() - t0
            toks += out.token_ids
            lps += list(out.log_probs or [])
            fin = out.finish_reason
            if len(toks) >= SERVE_RELEASE_AT:
                started.set()
        stats[i] = dict(ttft=ttft, tokens=toks, logprobs=lps, finish=fin,
                        prompt=prompts[i])
    t0 = time.perf_counter()
    await asyncio.gather(*(one(i) for i in range(n_req)))
    wall = time.perf_counter() - t0
    g1 = (len(g), g.replays) if g is not None else (0, 0)
    info = {k: getattr(engine, k) - before[k] for k in SERVE_COUNTERS}
    info.update(records=engine.steptrace.snapshot(limit=4096)["records"],
                captured=g1[0] - g0[0], replays=g1[1] - g0[1])
    return stats, wall, info


def run_serve(engine, seeds=(2,), **kw):
    """``serve`` once per seed, one after the other on ``engine``, then
    stop it; with a deadline: an engine step that raises leaves its
    requests waiting forever, and the phase must fail instead. Returns
    each serve's result."""
    async def serves():
        try:
            return [await serve(engine, seed=s, **kw) for s in seeds]
        finally:
            await engine.stop()
    return asyncio.run(asyncio.wait_for(serves(),
                                        SERVE_TIMEOUT_S * len(seeds)))


# the engine sizes of phases 4, 4b and 4d
SERVE_SIZES = dict(num_pages=4096, page_size=PS, max_num_seqs=32,
                   max_prefill_chunk=512, max_prefill_seqs=8,
                   max_context=4096)
# phase 4's two serves: the first captures the block graphs its shapes
# need, the second (other prompts, the same lengths) finds them captured,
# as a serving engine does after its first requests; phase 4d serves the
# second's prompts
COLD_SEED, WARM_SEED = 2, 3


def serve_engine(params, cfg, seeds, sizes=None, serve_kw=None,
                 **engine_kw):
    """A fresh ``TorchEngine`` (the reference's defaults but for
    ``engine_kw``; phase 4's sizes unless ``sizes``) serving ``serve()``'s
    workload once per seed (``serve_kw`` passed on); returns (engine, the
    serves' results, the family's kernel launches over all of them)."""
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    engine = TorchEngine(cfg, params,
                         TorchEngineConfig(**(sizes or SERVE_SIZES),
                                           **engine_kw),
                         device="cuda")
    reset_launch_counts()
    served = run_serve(engine, seeds, **(serve_kw or {}))
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in engine.kernel_launches}
    return engine, served, counts


def serve_report(stats, wall, info, tag):
    """Print one serve's tok/s, TTFT p50 / max, dispatch ms by step kind,
    dispatches per token, and the graphs it captured and replayed; returns
    the count of fused blocks chained on the device."""
    recs = info["records"]
    by_kind = {}
    for rec in recs:
        by_kind.setdefault(rec["kind"], []).append(rec["dispatch_ms"])
    chained_blocks = sum(1 for r in recs
                         if r["kind"] == "multistep" and r["chained"])
    for kind, ms in sorted(by_kind.items()):
        log(f"[{tag}] steps kind={kind} n={len(ms)} dispatch_ms "
            f"median={float(np.median(ms)):.2f} max={max(ms):.2f} "
            f"sum={sum(ms):.1f}")
    n_tok = sum(len(s["tokens"]) for s in stats.values())
    ttfts = sorted(s["ttft"] for s in stats.values())
    cap_s = sum(r["compile_ms"] for r in recs) / 1e3
    log(f"[{tag}] {len(stats)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; TTFT p50={ttfts[len(ttfts) // 2]:.3f} s "
        f"max={ttfts[-1]:.3f} s; {len(recs)} dispatches "
        f"({len(recs) / n_tok:.3f} per token); decode_dispatches="
        f"{info['decode_dispatches']} multistep_blocks="
        f"{info['multistep_blocks']} (chained {chained_blocks}) "
        f"chained_steps={info['chained_steps']} mixed_steps="
        f"{info['mixed_steps']}; graphs captured {info['captured']} in "
        f"{cap_s:.2f} s, replayed {info['replays']}")
    return chained_blocks


def check_stats(stats, cfg):
    for i, s in sorted(stats.items()):
        if len(s["tokens"]) != 32 or s["finish"] is None \
                or s["finish"].value != "length":
            raise AssertionError(f"request {i}: {len(s['tokens'])} tokens, "
                                 f"finish {s['finish']}")
        if not all(math.isfinite(x) for x in s["logprobs"]):
            raise AssertionError(f"request {i}: non-finite logprobs")
        if any(not (0 <= t < cfg.vocab_size) for t in s["tokens"]):
            raise AssertionError(f"request {i}: token out of vocab")


def phase_engine(params, cfg, sizes=None):
    """Serve ``serve()``'s workload twice on one engine with the
    reference's defaults (pipelined, fused blocks of up to 8 steps, each
    one CUDA graph replay): cold (the serve captures the graphs its shapes
    need) and warm (other prompts of the same lengths: the graphs are
    there). Every request must finish with its 32 tokens and finite
    logprobs, fused blocks must have run and chained on the device, and
    each of the family's kernels must have launched, replays counted (the
    wrappers' ``LAUNCHES`` equal to the engine's attention calls). Then
    the graph of one block against the same block run eagerly
    (``graph_vs_eager``). Returns the kernels' launch counts over both
    serves and the warm serve's streams."""
    engine, served, counts = serve_engine(params, cfg,
                                          (COLD_SEED, WARM_SEED), sizes)
    chained = 0
    for (stats, wall, info), tag in zip(served, ("cold", "warm")):
        chained += serve_report(stats, wall, info, f"engine {tag}")
        check_stats(stats, cfg)
    log(f"[engine] launches={counts}")
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched while serving")
    if counts != engine.kernel_launches:
        raise AssertionError(f"kernel launches {counts} are not the "
                             f"attention calls {engine.kernel_launches}")
    if engine.multistep_blocks <= 0 or chained <= 0:
        raise AssertionError("the serves ran no fused block chained on the "
                             "device")
    stats, wall, _info = served[1]
    ttfts = sorted(s["ttft"] for s in stats.values())
    PHASE4_WARM[cfg.model_type] = {
        "tok_s": sum(len(s["tokens"]) for s in stats.values()) / wall,
        "ttft_p50": ttfts[len(ttfts) // 2], "ttft_max": ttfts[-1],
        "ttft_mean": float(np.mean(ttfts))}
    PHASE4_STREAMS[cfg.model_type] = stats
    graph_vs_eager(engine)
    return counts, stats


# -- graph vs eager: one fused block -----------------------------------------

GRAPH_B, GRAPH_CTX, GRAPH_W = 16, 1024, 8


def block_inputs(engine, draw):
    """A fused block's inputs at B=16 rows of 1024 positions, each row on
    pages of its own, every row alive: greedy, or (``draw``) sampled at
    T=0.8, top-p 0.9, half the rows seeded. Returns (inputs, the pages
    the block writes)."""
    B, n = GRAPH_B, GRAPH_CTX // PS + 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    table = torch.zeros((B, engine.table_width), dtype=torch.int32,
                        device=dev)
    table[:, :n] = 1 + torch.arange(B * n, device=dev,
                                    dtype=torch.int32).reshape(B, n)
    i32 = dict(dtype=torch.int32, device=dev)
    x = {"table": table,
         "tok": torch.randint(0, engine.model_cfg.vocab_size, (B, 1),
                              generator=g, device=dev, dtype=torch.int32),
         "pos": torch.full((B, 1), GRAPH_CTX - 1, **i32),
         "total": torch.full((B,), GRAPH_CTX, **i32),
         "alive": torch.ones(B, dtype=torch.bool, device=dev),
         "budget": torch.full((B,), 1 << 20, **i32),
         "min_gate": torch.zeros(B, **i32),
         "stop_ids": torch.full((B, 1), -1, **i32),
         "temp": torch.full((B,), 0.8 if draw else 0.0, device=dev),
         "top_k": torch.zeros(B, **i32),
         "top_p": torch.full((B,), 0.9 if draw else 1.0, device=dev),
         "step0": torch.tensor(5, dtype=torch.int64, device=dev)}
    if draw:
        x["seeds"] = torch.where(torch.arange(B, device=dev) % 2 == 0,
                                 torch.arange(B, device=dev) + 1, 0
                                 ).to(torch.int32)
        x["min_p"] = torch.zeros(B, device=dev)
    # the block writes positions GRAPH_CTX - 1 .. + GRAPH_W - 1 of each row
    first, last = (GRAPH_CTX - 1) // PS, (GRAPH_CTX + GRAPH_W - 2) // PS
    return x, table[:, first:last + 1].reshape(-1).long()


def graph_vs_eager(engine):
    """One fused block of 8 steps at B=16, ctx 1024 (greedy, then sampled
    with seeds), run eagerly and as its CUDA graph's replay from the same
    cache: packed output, carry and the KV the block wrote must be equal
    bit for bit. Then each is timed (CUDA events around one call, median
    of 5): the eager body launches every kernel from Python, the replay
    launches one graph; the per-token device ms is the block's over 8."""
    for draw in (False, True):
        x, ids = block_inputs(engine, draw)
        saved = engine.pages[:, ids].clone()
        out_e = {k: v.clone() for k, v in
                 engine._block(x, GRAPH_W, draw).items()}
        kv_e = engine.pages[:, ids].clone()
        engine.pages[:, ids] = saved
        fresh = len(engine.graphs or ())
        out_g = engine._run_block(x, GRAPH_W, draw, report=False)
        kv_g = engine.pages[:, ids].clone()
        bad = [k for k in out_e if not torch.equal(out_e[k], out_g[k])]
        if not torch.equal(kv_e, kv_g):
            bad.append("kv")
        label = "sampled" if draw else "greedy"
        if bad:
            raise AssertionError(f"graph replay differs from the eager "
                                 f"block ({label}) in {bad}")
        eager = time_ms_per_call(lambda _l: engine._block(x, GRAPH_W, draw),
                                 reps=5)
        graph = time_ms_per_call(
            lambda _l: engine._run_block(x, GRAPH_W, draw, report=False),
            reps=5)
        engine.pages[:, ids] = saved
        if not engine.cfg.quantize:     # the int8 block has its own line
            BLOCK_MS[(engine.model_cfg.model_type,
                      engine.model_cfg.moe_backend, label)] = graph / GRAPH_W
        log(f"[graphs] block B={GRAPH_B} ctx={GRAPH_CTX} w={GRAPH_W} "
            f"{label}: replay equals eager bit for bit (packed, carry, KV; "
            f"{len(engine.graphs or ()) - fresh} capture); eager {eager:.3f} ms, "
            f"graph {graph:.3f} ms per block = {eager / GRAPH_W:.3f} / "
            f"{graph / GRAPH_W:.3f} ms per token ({eager / graph:.1f}x)")


# -- phase 4d: the same serve, per step ----------------------------------------


def report_agreement(tag, engine, stats, ref, what):
    """Each request's token agreement with the same request in ``ref``;
    where a stream differs, its first differing step and the top-2 logit
    margin there (one forward of the prefix alone, on ``engine``'s
    weights). Returns the count of requests token for token as ``ref``."""
    same = 0
    for i, s in sorted(stats.items()):
        a, b = s["tokens"], ref[i]["tokens"]
        diff = [j for j, (p, q) in enumerate(zip(a, b)) if p != q]
        if not diff:
            same += 1
            continue
        m = first_step_margin(engine, s["prompt"], a, diff[0],
                              dict(temperature=0.0))
        log(f"[{tag}] r{i}: {len(diff)} of {len(a)} tokens differ from "
            f"{what}; first at step {diff[0]}, top-2 margin there {m:.4e}")
    log(f"[{tag}] {same} of {len(stats)} requests token for token as "
        f"{what}")
    return same


PER_STEP_MODES = (("per-step", dict(pipeline_decode=False)),
                  ("pipelined", dict(decode_multistep=1)))


def phase_per_step(params, cfg, fused, modes=PER_STEP_MODES, sizes=None):
    """Phase 4d: ``serve()``'s workload per step, unpipelined
    (``pipeline_decode=False``: one step, one fetch) and then pipelined
    without fusion (``decode_multistep=1``: step N+1 chained on the device
    while N is fetched), each on a fresh engine with the prompts of phase
    4's warm serve, each with phase 4's report, its launches, and its
    per-request token agreement with that serve's fused streams ``fused``
    (``report_agreement``). The pipelined serve must chain. Returns
    {mode: (streams, tok/s)}."""
    out = {}
    for tag, kw in modes:
        engine, served, counts = serve_engine(params, cfg, (WARM_SEED,),
                                              sizes, **kw)
        stats, wall, info = served[0]
        serve_report(stats, wall, info, tag)
        check_stats(stats, cfg)
        log(f"[{tag}] launches={counts}")
        report_agreement(tag, engine, stats, fused, "the fused serve")
        if tag == "pipelined" and info["chained_steps"] <= 0:
            raise AssertionError("the pipelined serve chained no step")
        out[tag] = (stats, sum(len(s["tokens"]) for s in stats.values())
                    / wall)
        del engine
        gc.collect()
    return out


# -- phase 4c: every sampling option, served --------------------------------

GUIDED_SPEC = {"mode": "json_schema", "schema": {
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
    "required": ["ok", "n"]}}
BIAS_ID = 4242
# (request id, sampling options): the workload of phase 4c
SAMPLED = [
    ("seed-a", dict(temperature=0.8, seed=11)),
    ("seed-b", dict(temperature=0.8, seed=12)),
    ("free-a", dict(temperature=1.0, top_p=0.9)),
    ("free-b", dict(temperature=1.0, top_p=0.9)),
    ("freq", dict(temperature=0.8, frequency_penalty=0.7,
                  presence_penalty=0.5)),
    ("rep", dict(temperature=0.8, repetition_penalty=1.3)),
    ("bias", dict(temperature=1.0, logit_bias={BIAS_ID: 100.0})),
    ("guided", dict(temperature=0.7, guided=GUIDED_SPEC)),
]
SAMPLED_PROMPTS = [96, 160, 64, 224, 128, 192, 80, 48]
SAMPLED_MAX = 32
GUIDED_MAX = 48
SAMPLER_B = 32
SAMPLER_V = 128256


def synthetic_vocab(V, seed=0):
    """Token bytes of a synthetic byte vocabulary of ``V`` ids, made from
    ``seed``: ids 0-255 are the single bytes, the rest random 2-4-byte
    strings over a JSON-ish alphabet or, one in ten, None (special); the
    last id is the EOS. Returns (token_bytes, eos)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'{}[]":, \n0123456789.-+eEtruefalsnbcdxyz_',
                             np.uint8)
    n = V - 256
    lens = rng.integers(2, 5, size=n)
    special = rng.random(n) < 0.1
    chars = rng.choice(alphabet, size=(n, 4))
    toks = [bytes([b]) for b in range(256)]
    toks += [None if special[i] else chars[i, :lens[i]].tobytes()
             for i in range(n)]
    toks[V - 1] = None
    return toks, V - 1


async def serve_sampled(engine, names, eos):
    """Serve phase 4c's requests named in ``names``, all submitted at once;
    returns {name: dict(tokens, logprobs, finish)}."""
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    rng = np.random.default_rng(4)
    V = engine.model_cfg.vocab_size
    prompts = {rid: list(map(int, rng.integers(0, V, size=n)))
               for (rid, _o), n in zip(SAMPLED, SAMPLED_PROMPTS)}
    opts = dict(SAMPLED)
    out = {}

    async def one(rid):
        guided = rid == "guided"
        req = PreprocessedRequest(
            token_ids=prompts[rid], request_id=rid,
            stop_conditions=StopConditions(
                max_tokens=GUIDED_MAX if guided else SAMPLED_MAX),
            sampling_options=SamplingOptions(**opts[rid]),
            eos_token_ids=[eos] if guided else [])
        toks, lps, fin = [], [], None
        async for frame in engine.generate(req):
            toks += frame.token_ids
            lps += list(frame.log_probs or [])
            fin = frame.finish_reason
        out[rid] = dict(tokens=toks, logprobs=lps, finish=fin)

    await asyncio.gather(*(one(rid) for rid in names))
    await engine.stop()
    return out, prompts


def check_guided(tokens, finish, vocab, eos):
    """(c): the grammar accepts every emitted token; the text parses as a
    conforming document when the request stopped on EOS, and is a legal
    prefix when it hit max_tokens. Returns the text."""
    from dynamo_tpu_torch.engine.guided import (compile_guided,
                                                initial_state, step)
    g = compile_guided(GUIDED_SPEC)
    st = initial_state(g)
    text = b""
    for t in tokens:
        if t == eos:
            continue
        bs = vocab[t]
        if bs is None:
            raise AssertionError(f"guided: special token {t} emitted")
        for b in bs:
            st = step(g, st, b)
            if st is None:
                raise AssertionError(f"guided: {text + bs!r} leaves the "
                                     "grammar")
        text += bs
    if finish == "eos":
        doc = json.loads(text)
        if not (isinstance(doc.get("ok"), bool)
                and isinstance(doc.get("n"), int)):
            raise AssertionError(f"guided: {doc!r} does not conform")
    elif finish != "length":
        raise AssertionError(f"guided: finish {finish}")
    return text.decode("utf-8", "replace")


def first_step_margin(engine, prompt, tokens, k, so):
    """The request's draw at generated step ``k`` (the first where two
    serves differ), recomputed from a forward of its prompt and first ``k``
    tokens alone: the gap between the best and second best
    Gumbel-perturbed score (logit / T + noise) among the top candidates of
    a seeded request, the gap between the two best logits of a greedy
    one."""
    from dynamo_tpu_torch.ops import prng
    from dynamo_tpu_torch.ops.sampling import (TOPK_MAX, _masked_candidates,
                                               sampling_noise)
    cfg = engine.model_cfg
    ids = prompt + tokens[:k]
    n = len(ids)
    pages = engine.family.make_pages(cfg, -(-n // PS) + 2, PS,
                                     device="cuda")
    table = torch.zeros((1, 4096 // PS), dtype=torch.int32, device="cuda")
    table[0, :-(-n // PS)] = torch.arange(1, -(-n // PS) + 1)
    t = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")
    kernel = "mla_prefill" if engine.mla else "paged_prefill"
    logits = engine.family.forward(
        engine.params, cfg, t([ids]), t([list(range(n))]), pages, table,
        t([n]), t([n]), attn_impl=engine.attention[kernel])[0]
    if not so["temperature"]:
        top2 = torch.topk(logits.float()[0], 2).values
        return float(top2[0] - top2[1])
    temp = torch.tensor([so["temperature"]], device="cuda")
    scaled, _idx = _masked_candidates(logits.float(), temp,
                                      t([0]), torch.ones(1, device="cuda"))
    base = prng.PRNGKey(engine.cfg.seed, device="cuda")
    noise = sampling_noise(base, 1, min(TOPK_MAX, cfg.vocab_size),
                           seeds=t([(so["seed"] % 0x7FFFFFFF) + 1]),
                           seed_rng=base, seed_pos=t([n]))
    top2 = torch.topk((scaled + noise)[0], 2).values
    return float(top2[0] - top2[1])


def sampler_parity():
    """(f), gated: the sampler on the card against the same sampler on the
    CPU, on identical logits at B=32, V=128256 with seeded and unseeded
    rows, top-k, top-p and min-p: the threefry words bit-equal, the Gumbel
    noise within 1 ulp, the tokens equal."""
    from dynamo_tpu_torch.ops import prng
    from dynamo_tpu_torch.ops.sampling import sample_tokens, sampling_noise
    rng = np.random.default_rng(5)
    B, V = SAMPLER_B, SAMPLER_V
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    host = dict(temp=rng.uniform(0.5, 1.3, B).astype(np.float32),
                top_k=rng.choice([0, 0, 20, 50], B).astype(np.int32),
                top_p=rng.choice([1.0, 0.9, 0.7], B).astype(np.float32),
                min_p=rng.choice([0.0, 0.05], B).astype(np.float32),
                seeds=np.where(rng.random(B) < 0.5,
                               rng.integers(1, 2 ** 31 - 1, B), 0
                               ).astype(np.int32),
                pos=rng.integers(1, 4096, B).astype(np.int32))
    got = {}
    for dev in ("cpu", "cuda"):
        a = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        base = prng.PRNGKey(0, device=dev)
        key = prng.fold_in(base, 123)
        words = prng.random_bits(key, (B, 64))
        noise = sampling_noise(key, B, 64, seeds=a["seeds"], seed_rng=base,
                               seed_pos=a["pos"])
        toks, lps = sample_tokens(torch.from_numpy(logits).to(dev), noise,
                                  a["temp"], a["top_k"], a["top_p"],
                                  min_p=a["min_p"])
        got[dev] = [x.cpu() for x in (words, noise, toks, lps)]
    (wc, nc, tc, lc), (wg, ng, tg, lg) = got["cpu"], got["cuda"]
    ulps = (nc.view(torch.int32).long() - ng.view(torch.int32).long()).abs()
    rel = float(((lg - lc).abs() / lc.abs().clamp_min(1e-30)).max())
    ok = torch.equal(wc, wg) and int(ulps.max()) <= 1 and torch.equal(tc, tg)
    log(f"[sampling] card vs CPU at B={B} V={V}: threefry words equal "
        f"{torch.equal(wc, wg)}, Gumbel noise max {int(ulps.max())} ulps, "
        f"tokens equal {torch.equal(tc, tg)}, logprobs max rel diff "
        f"{rel:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sampler on the card disagrees with the CPU")


def sampling_time(engine):
    """``TorchEngine._sample_tail`` alone at B=32, V=128256: no extras
    (the batch-wide draw), seeds + penalties over a window of 32, and
    seeds + penalties + guided masks; each case's time per call and the
    Gumbel draw's (``sampling_noise`` alone, same case), by
    ``time_ms_per_call``: CUDA events around each call, so for these runs
    of small launches the host's issue time as much as the device's."""
    from dynamo_tpu_torch.ops.sampling import TOPK_MAX, sampling_noise
    B, V, W = SAMPLER_B, SAMPLER_V, engine.cfg.penalty_window
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn((B, V), generator=g, device=dev) * 3
    base = dict(step=torch.tensor(9, device=dev),
                temp=torch.full((B,), 0.8, device=dev),
                top_k=torch.zeros(B, dtype=torch.int32, device=dev),
                top_p=torch.full((B,), 0.9, device=dev),
                total=torch.randint(1, 4096, (B,), generator=g, device=dev,
                                    dtype=torch.int32))
    pen = dict(base,
               seeds=torch.where(torch.arange(B, device=dev) % 2 == 0,
                                 torch.arange(B, device=dev) + 1, 0
                                 ).to(torch.int32),
               pen_ids=torch.randint(0, V, (B, W), generator=g, device=dev,
                                     dtype=torch.int32),
               pen_cnt=torch.randint(0, 3, (B, W), generator=g,
                                     device=dev).float(),
               pen_ctx=torch.ones((B, W), device=dev),
               pen_bias=torch.zeros((B, W), device=dev),
               pen_fp=torch.full((B,), 0.5, device=dev),
               pen_pp=torch.full((B,), 0.3, device=dev),
               pen_rp=torch.full((B,), 1.2, device=dev),
               pen_min_p=torch.zeros(B, device=dev))
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, -(-V // 32)),
                          generator=g, device=dev, dtype=torch.int32)
    words[1::2] = -1                          # unconstrained rows
    guided = dict(pen, mask_words=words)
    k = min(TOPK_MAX, V)
    rows = []
    for name, t in (("no extras", base), ("seeds+penalties W=32", pen),
                    ("seeds+penalties+guided", guided)):
        seeds = t.get("seeds")
        ms = time_ms_per_call(lambda _l: engine._sample_tail(logits, t))
        draw = time_ms_per_call(lambda _l: sampling_noise(
            engine._rng, B, k, seeds=seeds, seed_rng=engine._rng,
            seed_pos=t["total"]))
        rows.append((name, ms, draw))
        log(f"[sampling] _sample_tail B={B} V={V} {name}: {ms:.4f} ms per "
            f"call, the Gumbel draw {draw:.4f} ms ({100 * draw / ms:.1f}%)")
    return rows


def phase_sampled(params, cfg, time_sampler):
    """Phase 4c: ``TorchEngine`` serving phase 4c's eight requests (two
    seeded, two unseeded top-p, frequency + presence penalties, a
    repetition penalty, a +100 logit bias, a guided JSON schema over a
    synthetic byte vocabulary) at full width on the loaded weights.
    Checks (a) a second serve on a fresh engine streams the same tokens,
    (b) the biased request emits only its biased id, (c) the guided text
    stays in its grammar, (d) every request finishes with finite
    logprobs, (e) each of the family's kernels launched during the serve;
    reports how many tokens each seeded request changes served alone, with
    the first changed step's margin. With ``time_sampler``: (f)'s gated
    card-vs-CPU sampler check and the sampling time. Returns the kernels'
    launches over the first serve."""
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    vocab, eos = synthetic_vocab(cfg.vocab_size)
    names = [rid for rid, _o in SAMPLED]

    def fresh():
        eng = TorchEngine(cfg, params, TorchEngineConfig(
            num_pages=2048, page_size=PS, max_num_seqs=32,
            max_prefill_chunk=512, max_context=4096), device="cuda")
        eng.enable_guided(vocab, [eos])
        return eng

    def run(eng, which):
        return asyncio.run(asyncio.wait_for(serve_sampled(eng, which, eos),
                                            SERVE_TIMEOUT_S))

    engine = fresh()
    reset_launch_counts()
    t0 = time.perf_counter()
    first, prompts = run(engine, names)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: LAUNCHES[k] for k in engine.kernel_launches}
    second, _ = run(fresh(), names)
    n_tok = sum(len(r["tokens"]) for r in first.values())
    log(f"[sampled] {len(first)} requests, {n_tok} tokens in {wall:.3f} s; "
        f"launches={counts}")
    for rid in names:
        r = first[rid]
        fin = r["finish"].value if r["finish"] is not None else None
        log(f"[sampled] {rid}: {len(r['tokens'])} tokens, finish {fin}, "
            f"first {r['tokens'][:8]}")
        want = GUIDED_MAX if rid == "guided" else SAMPLED_MAX
        if fin not in ("length", "eos") or not r["tokens"] \
                or (fin == "length" and len(r["tokens"]) != want):
            raise AssertionError(f"(d) {rid}: {len(r['tokens'])} tokens, "
                                 f"finish {fin}")
        if not all(math.isfinite(x) for x in r["logprobs"]):
            raise AssertionError(f"(d) {rid}: non-finite logprobs")
        if second[rid]["tokens"] != r["tokens"]:
            raise AssertionError(f"(a) {rid}: a fresh engine with the same "
                                 "seed streamed other tokens")
    log("[sampled] (a) a fresh engine streamed the same tokens for all "
        f"{len(names)} requests")
    if set(first["bias"]["tokens"]) != {BIAS_ID}:
        raise AssertionError(f"(b) the +100 bias on {BIAS_ID} did not "
                             f"force it: {first['bias']['tokens']}")
    text = check_guided(first["guided"]["tokens"],
                        first["guided"]["finish"].value, vocab, eos)
    log(f"[sampled] (b) bias: all {len(first['bias']['tokens'])} tokens are "
        f"{BIAS_ID}; (c) guided ({first['guided']['finish'].value}): "
        f"{text!r}")
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"(e) kernel {k} never launched in 4c")
    for rid in ("seed-a", "seed-b"):
        alone, _ = run(fresh(), [rid])
        a, b = alone[rid]["tokens"], first[rid]["tokens"]
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        msg = f"{len(diff)} of {len(b)} tokens differ"
        if diff:
            m = first_step_margin(engine, prompts[rid], a, diff[0],
                                  dict(SAMPLED)[rid])
            msg += (f"; first at step {diff[0]}, margin there {m:.4e} "
                    "(one forward of the prefix alone)")
        log(f"[sampled] {rid} served alone vs batched: {msg}")
    if time_sampler:
        sampler_parity()
        sampling_time(engine)
    return counts


def phase_profile(params, cfg):
    """``--profile`` only: device time by kernel over a short serving run
    (4 requests of 128-1024 prompt tokens, 16 new tokens each) on an
    engine with the reference's defaults, after a first serve of other
    prompts of the same lengths has captured its block graphs, from
    ``torch.profiler``; the device's busy share is the summed kernel time
    over the run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    engine = TorchEngine(cfg, params, TorchEngineConfig(
        num_pages=1024, page_size=PS, max_num_seqs=32, max_prefill_chunk=512,
        max_context=4096), device="cuda")

    async def serves():
        try:
            await serve(engine, n_req=4, max_tokens=16, seed=5)  # warm up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _s, _w, info = await serve(engine, n_req=4, max_tokens=16,
                                           seed=6)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            return prof, wall, info
        finally:
            await engine.stop()

    prof, wall, info = asyncio.run(asyncio.wait_for(serves(),
                                                    2 * SERVE_TIMEOUT_S))
    log(f"[profile] profiled serve: {info['multistep_blocks']} fused "
        f"blocks, {info['captured']} graphs captured, {info['replays']} "
        f"replayed, {len(info['records'])} dispatches")
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    rows.sort(key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    n_kernels = sum(e.count for e in rows)
    steps = sum(max(1, r["width"]) for r in info["records"])
    log(f"[profile] wall={wall:.3f} s device busy={busy:.3f} s "
        f"({100 * busy / wall:.1f}%); {n_kernels} kernels over "
        f"{steps} model steps ({n_kernels / steps:.0f} per step, "
        f"{1e3 * busy / n_kernels:.4f} ms each on average)")
    # the 12 largest, then the kernels in anonymous namespaces that fell
    # below them: the port's own (csrc/*.cu) among them; a template's name
    # carries its "void " return type, a plain function's does not
    own = [e for e in rows[12:] if e.key.removeprefix("void ")
           .startswith("(anonymous namespace)::")]
    for e in rows[:12] + own:
        log(f"[profile] {dev_us(e) / 1e3:9.2f} ms  n={e.count:6d}  "
            f"{e.key[:90]}")


def kernel_breakdown(fn, layers, calls=10):
    """Device time per call of each CUDA kernel ``fn`` launches (a split
    kernel and its merge), from ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i % layers)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i % layers)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    return {e.key.removeprefix("void ")[:60]: dev_us(e) / 1e3 / calls
            for e in rows if dev_us(e) > 0}


def phase_sweep():
    """``--sweep`` only: the split-KV kernels' device time per call
    (``time_ms``) over split lengths, at phase 2's and 2b's main cases,
    with the default length's time split by kernel (split or tile kernel,
    merge); the MLA prefill kernel at each of phase 2b's three cases."""
    from dynamo_tpu_torch.ops.kernels import mla_decode, mla_prefill, ragged
    from dynamo_tpu_torch.ops.kernels.mla_decode import (
        mla_paged_decode_stacked as mla)
    from dynamo_tpu_torch.ops.kernels.ragged import (
        ragged_mixed_attention_stacked as rag)
    rng = np.random.default_rng(10)
    for B in (1, 8, 32):
        ctxs = [4096] + list(rng.integers(1, 4097, size=B - 1))
        if B > 2:
            ctxs[1] = 1
        c = make_mla_case(rng, [1] * B, ctxs, 1)
        args = (c["q_lat"][:, :1].contiguous(), c["q_pe"][:, :1].contiguous(),
                c["pages"])
        run = lambda layer: mla(*args, layer, c["table"], c["total"],
                                c["sm_scale"])
        knobs = ("SPLIT_POSITIONS", "BLOCKS_PER_SM", "SPLIT_MIN_POSITIONS")
        default = [getattr(mla_decode, k) for k in knobs]
        for pos in (128, 256, 512, 1024):
            for bps in (1, 2, 4):
                for least in (64, 128):
                    for k, v in zip(knobs, (pos, bps, least)):
                        setattr(mla_decode, k, v)
                    splits = mla_decode.mla_decode_splits(B, NH, 4096 // PS,
                                                          PS, 132)
                    log(f"[sweep] mla_decode B={B} split_positions={pos} "
                        f"blocks_per_sm={bps} min_positions={least} "
                        f"splits={splits} "
                        f"ms={time_ms(run, c['layers']):.4f}")
        for k, v in zip(knobs, default):
            setattr(mla_decode, k, v)
        log(f"[sweep] mla_decode B={B} by kernel (ms per call): "
            f"{kernel_breakdown(run, c['layers'])}")
        del c, args
    # B5 at phase 2b's cases (the same draws of the same generator)
    from dynamo_tpu_torch.ops.kernels.mla_prefill import (
        mla_paged_prefill_stacked as mla_pf)
    cases = [("B=4 S=512 prefix hits", lambda: ([512, 512, 512, 300],
                                                [512, 1024, 3000, 1836]), 512),
             ("B=8 mixed", lambda: ([512, 512, 1, 1, 1, 1, 1, 1], [1024, 512]
                                    + list(rng.integers(64, 4097, size=6))),
              512),
             ("B=7 S=131 ragged", mla_ragged_shape, 131)]
    default = mla_prefill.SPLIT_POSITIONS
    for label, shape, S in cases:
        q_lens, ctxs = shape()
        c = make_mla_case(rng, q_lens, ctxs, S)
        run = lambda layer: mla_pf(c["q_lat"], c["q_pe"], c["pages"], layer,
                                   c["table"], c["positions"], c["total"],
                                   c["sm_scale"])
        log(f"[sweep] mla_prefill {label} "
            f"ms={time_ms(run, c['layers']):.4f}")
        if min(q_lens) == 1:
            for pos in (256, 512, 1024, 2048):
                mla_prefill.SPLIT_POSITIONS = pos
                plan = mla_prefill.mla_prefill_splits(len(ctxs), S, NH,
                                                      4096 // PS, PS, 132)
                log(f"[sweep] mla_prefill {label} split_positions={pos} "
                    f"plan={plan} ms={time_ms(run, c['layers']):.4f}")
            mla_prefill.SPLIT_POSITIONS = default
        log(f"[sweep] mla_prefill {label} by kernel (ms per call): "
            f"{kernel_breakdown(run, c['layers'])}")
        del c
    rng = np.random.default_rng(0)
    qls = [512, 512, 1, 1, 1, 1, 1, 1]
    ctxs = [1024, 512] + list(rng.integers(64, 4097, size=6))
    c = make_case(rng, 8, qls, ctxs, 512)
    run = lambda layer: rag(c["q"], c["pages"], layer, c["table"],
                            c["positions"], c["total"], c["sm_scale"])
    default = ragged.SPLIT_POSITIONS, ragged.SPLIT_MIN_POSITIONS
    for pos in (256, 512, 1024, 2048):
        ragged.SPLIT_POSITIONS = pos
        ragged.SPLIT_MIN_POSITIONS = min(pos, default[1])
        log(f"[sweep] ragged_mixed split_positions={pos} plan="
            f"{ragged.ragged_splits(8, 512, HKV, HQ // HKV, 4096 // PS, PS, 132)}"
            f" ms={time_ms(run, c['layers']):.4f}")
    ragged.SPLIT_POSITIONS, ragged.SPLIT_MIN_POSITIONS = default
    log(f"[sweep] ragged_mixed by kernel (ms per call): "
        f"{kernel_breakdown(run, c['layers'])}")


# -- phase 5: serve through the entry points ---------------------------------

# Rung (a) of the entry-point phase: every serving package imports on the
# card's host (msgpack, aiohttp, pydantic, jinja2, prometheus_client,
# tokenizers; checked on the first chip call of this slice), so the port's
# coordinator, one torch worker and the port's frontend run as three OS
# processes and this script is their HTTP client. A missing package fails.
SERVE_PACKAGES = ("msgpack", "aiohttp", "pydantic", "jinja2",
                  "prometheus_client", "tokenizers")
ENTRY_TOKENS = 32
ENTRY_CHAT_WORDS = (200, 96, 320, 160)      # identity pass chats, in words
ENTRY_TIMEOUT_S = 240                        # a process start or a request
ENTRY_TEMPLATE = ("{% for m in messages %}<|{{ m['role'] }}|>"
                  "{{ m['content'] }}<|end|>{% endfor %}"
                  "{% if add_generation_prompt %}<|assistant|>{% endif %}")
# phase 4's warm in-process serve, printed beside phase 5's client numbers
PHASE4_WARM = {}
# phase 4's warm streams per model (the dispatch serves' agreement) and the
# replayed block's ms per token per (model, expert backend, draw)
PHASE4_STREAMS = {}
BLOCK_MS = {}
# phase 5's timed windows over HTTP, each phase 4's ten requests of one
# seed: its cold seed (the worker meets these shapes first), then its warm
# seed and two more of the same lengths (the spread between windows)
ENTRY_WINDOWS = (("cold", COLD_SEED), ("warm", WARM_SEED),
                 ("warm", WARM_SEED + 1), ("warm", WARM_SEED + 2))


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb_field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _pb_bytes(num: int, payload: bytes) -> bytes:
    return _pb_field(num, 2, _varint(len(payload)) + payload)


def sentencepiece_model(V: int) -> bytes:
    """A SentencePiece unigram ``ModelProto`` of ``V`` pieces (the
    protobuf layout ``preprocessor/sp_tokenizer.py`` reads: repeated
    ``SentencePiece {piece=1, score=2, type=3}`` at field 1,
    ``TrainerSpec {model_type=3}`` at field 2): ``<unk>``, ``<s>``,
    ``</s>`` (id 2, the EOS), the 256 byte-fallback pieces, then filler
    words ``▁w<i>`` up to the model's vocab, so every id detokenizes."""
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", -20.0, 6) for b in range(256)]
    pieces += [(f"▁w{i}", -10.0, 1) for i in range(V - len(pieces))]
    out = []
    for piece, score, ptype in pieces:
        body = (_pb_bytes(1, piece.encode()) +
                _pb_field(2, 5, np.float32(score).tobytes()) +
                _pb_field(3, 0, _varint(ptype)))
        out.append(_pb_bytes(1, body))
    return b"".join(out) + _pb_bytes(2, _pb_field(3, 0, _varint(1)))


def write_entry_model(path: str, cfg) -> None:
    """A model directory the worker and the frontend read: ``config.json``
    at ``cfg``'s widths (Llama-3.2-3B's published ones), the SentencePiece
    ``tokenizer.model`` and a chat template. No weights: the worker runs
    ``--random-weights``."""
    os.makedirs(path, exist_ok=True)
    hf = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
          "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
          "rms_norm_eps": cfg.rms_norm_eps,
          "max_position_embeddings": cfg.max_position_embeddings,
          "tie_word_embeddings": cfg.tie_word_embeddings,
          "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16"}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(sentencepiece_model(cfg.vocab_size))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": ENTRY_TEMPLATE, "eos_token": "</s>"}, f)


class Child:
    """One process of the serving stack, its output in a log file; started
    in a session of its own so ``stop`` ends it with whatever it started."""

    def __init__(self, name: str, module: str, args, logdir: str,
                 env_extra=None):
        self.name = name
        self.log_path = os.path.join(logdir, f"{name}.log")
        env = dict(os.environ, PYTHONUNBUFFERED="1",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.update(env_extra or {})
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module] + list(args), cwd=ROOT, env=env,
            stdout=self._log, stderr=subprocess.STDOUT,
            start_new_session=True)

    def text(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def wait_for(self, needle: str, timeout: float = ENTRY_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if needle in self.text():
                return
            if self.proc.poll() is not None:
                raise RuntimeError(f"{self.name} exited with "
                                   f"{self.proc.returncode}")
            time.sleep(0.1)
        raise TimeoutError(f"{self.name}: no {needle!r} in {timeout} s")

    def tail(self, n: int = 40) -> str:
        return "\n".join(self.text().splitlines()[-n:])

    def stop(self) -> None:
        import signal
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
                self.proc.wait(timeout=20)
            except (ProcessLookupError, subprocess.TimeoutExpired):
                pass
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()
        self._log.close()


def free_port() -> int:
    """A free local port from the repo's ``tests/procutils.py``, loaded by
    its path: a ``tests`` package installed in site-packages shadows the
    repo's ``tests`` directory, which has no ``__init__.py``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "procutils", os.path.join(ROOT, "tests", "procutils.py"))
    procutils = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(procutils)
    return procutils.free_port()


def http_post(url: str, body: dict) -> dict:
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=ENTRY_TIMEOUT_S) as resp:
        return json.loads(resp.read())


def http_stream(url: str, body: dict, on_text=None) -> dict:
    """A streamed chat or legacy completion read as it arrives: its text,
    finish reason, usage (chat only), a chat's logprobs entries, the
    client's TTFT (the first chunk with text) and the count of chunks with
    text; ``on_text`` is called with that count at each of them."""
    import urllib.request
    body = dict(body, stream=True, stream_options={"include_usage": True})
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type":
                                          "application/json"})
    t0 = time.perf_counter()
    ttft, parts, finish, usage, lps = None, [], None, None, []
    with urllib.request.urlopen(req, timeout=ENTRY_TIMEOUT_S) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            usage = chunk.get("usage") or usage
            for choice in chunk.get("choices") or []:
                lps += ((choice.get("logprobs") or {}).get("content")
                        or [])
                text = (choice.get("text")
                        or (choice.get("delta") or {}).get("content"))
                if text:
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    parts.append(text)
                    if on_text is not None:
                        on_text(len(parts))
                finish = choice.get("finish_reason") or finish
    return {"text": "".join(parts), "finish": finish, "usage": usage,
            "ttft": ttft, "chunks": len(parts), "logprobs": lps,
            "seconds": time.perf_counter() - t0}


def scrape_metrics(sys_port: int) -> dict:
    """Every sample of the worker's ``/metrics``: series -> value."""
    return scrape_metrics_url(f"http://127.0.0.1:{sys_port}/metrics")


def scrape_metrics_url(url: str) -> dict:
    """Every sample of a ``/metrics`` page: series -> value."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as resp:
        text = resp.read().decode()
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines()
            if line and not line.startswith("#")}


def scrape_launches(sys_port: int) -> dict:
    """The worker's ``dynamo_worker_kernel_launches_total`` by kernel."""
    head = 'dynamo_worker_kernel_launches_total{kernel="'
    return {k[len(head):-2]: v for k, v in scrape_metrics(sys_port).items()
            if k.startswith(head)}


def worker_ttft_s(before: dict, after: dict, n_req: int) -> float:
    """The worker's own mean time from a request's arrival at the engine
    to its first token over a window of ``n_req`` requests: the ``queue``
    and ``prefill`` stage spans (``dynamo_tpu_stage_duration_seconds``)
    between two scrapes, which must count every request once."""
    def d(stat, stage):
        key = f'dynamo_tpu_stage_duration_seconds_{stat}{{stage="{stage}"}}'
        return after.get(key, 0.0) - before.get(key, 0.0)
    n = d("count", "prefill")
    if n != n_req:
        raise AssertionError(f"the worker recorded {n} prefill stages for "
                             f"{n_req} requests")
    return (d("sum", "queue") + d("sum", "prefill")) / n


def entry_prompts(seed: int):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{x}" for x in rng.integers(0, 100000, size=n))
            for n in ENTRY_CHAT_WORDS]


def entry_chats(model: str, seed: int) -> list:
    """The identity pass's 4 greedy chat completions, each token with its
    logprob."""
    return [{"model": model, "max_tokens": ENTRY_TOKENS, "temperature": 0,
             "logprobs": True,
             "messages": [{"role": "user", "content": text}]}
            for text in entry_prompts(seed)]


def entry_requests(base: str, model: str, seed: int) -> dict:
    """The identity pass: ``entry_chats`` one after another (requests 2
    and 3 streamed), then a completion with echo + logprobs (prompt
    scoring) and an embeddings call. Returns every answer."""
    out = {}
    for i, body in enumerate(entry_chats(model, seed)):
        if i < 2:
            r = http_post(f"{base}/v1/chat/completions", body)
            c = r["choices"][0]
            out[f"chat{i}"] = {"text": c["message"]["content"],
                               "finish": c["finish_reason"],
                               "usage": r["usage"],
                               "logprobs": (c.get("logprobs") or {}).get(
                                   "content") or []}
        else:
            r = http_stream(f"{base}/v1/chat/completions", body)
            out[f"chat{i}"] = {k: r[k] for k in ("text", "finish", "usage",
                                                 "logprobs")}
    r = http_post(f"{base}/v1/completions", {
        "model": model, "prompt": entry_prompts(seed + 100)[2],
        "max_tokens": 1, "temperature": 0, "echo": True, "logprobs": 2})
    out["echo"] = r["choices"][0]["logprobs"]
    r = http_post(f"{base}/v1/embeddings", {
        "model": model, "input": entry_prompts(seed + 200)[:2]})
    out["embed"] = [d["embedding"] for d in r["data"]]
    return out


def check_entry_answers(ans: dict, hidden: int) -> None:
    """Every chat finished by length (or EOS) with a finite logprob per
    token, finite echo logprobs, two embeddings of the model's width."""
    for i in range(len(ENTRY_CHAT_WORDS)):
        a = ans[f"chat{i}"]
        n = a["usage"]["completion_tokens"]
        if a["finish"] == "length" and n != ENTRY_TOKENS or \
                a["finish"] == "stop" and not 0 < n <= ENTRY_TOKENS or \
                a["finish"] not in ("length", "stop"):
            raise AssertionError(f"chat{i}: finish {a['finish']} after {n} "
                                 f"tokens")
        if len(a["logprobs"]) != n or not all(
                math.isfinite(e["logprob"]) for e in a["logprobs"]):
            raise AssertionError(f"chat{i}: {len(a['logprobs'])} logprob "
                                 f"entries for {n} tokens")
    lps = ans["echo"]["token_logprobs"]
    if lps[0] is not None or not all(math.isfinite(x) for x in lps[1:]) \
            or len(lps) < 300:
        raise AssertionError(f"echo logprobs: {len(lps)} values, "
                             f"first {lps[:3]}")
    if len(ans["embed"]) != 2 or any(len(v) != hidden or not all(
            math.isfinite(x) for x in v) for v in ans["embed"]):
        raise AssertionError("embeddings: wrong count, width or values")


def entry_window(base: str, model: str, V: int, seed: int) -> dict:
    """One timed window over HTTP with phase 4's own traffic: its ten
    prompts (``serve_prompts(V, seed)``, sent as token ids in streamed
    ``/v1/completions``), 32 greedy tokens each with EOS ignored (phase
    4's requests carry none), the first six at once and the other four
    released when a stream has its fourth chunk of text (one token each,
    or more where the detokenizer held a byte piece). Returns tok/s, the
    wall and every request's client TTFT."""
    import threading
    prompts = serve_prompts(V, seed)
    res = [None] * len(prompts)
    started = threading.Event()

    def seen(n):
        if n >= SERVE_RELEASE_AT:
            started.set()

    def one(i):
        if i >= SERVE_FIRST_N:
            started.wait(ENTRY_TIMEOUT_S)
        try:
            res[i] = http_stream(f"{base}/v1/completions", {
                "model": model, "prompt": prompts[i],
                "max_tokens": ENTRY_TOKENS, "temperature": 0,
                "nvext": {"ignore_eos": True}}, on_text=seen)
        except Exception as e:                  # reported below
            res[i] = {"error": repr(e)}

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(ENTRY_TIMEOUT_S)
    wall = time.perf_counter() - t0
    bad = [(i, r) for i, r in enumerate(res)
           if r is None or r.get("finish") != "length" or r["ttft"] is None]
    if bad:
        raise AssertionError(f"timed window (seed {seed}): {bad}")
    # every stream finished by length: ENTRY_TOKENS tokens each
    n_tok = ENTRY_TOKENS * len(res)
    ttfts = sorted(r["ttft"] for r in res)
    return {"tok_s": n_tok / wall, "ttft_p50": ttfts[len(ttfts) // 2],
            "ttft_max": ttfts[-1], "ttft_mean": float(np.mean(ttfts)),
            "tokens": n_tok, "wall": wall, "n": len(res)}


def phase_serve_entry() -> dict:
    """Llama-3.2-3B at full width and depth, bf16 random weights, served
    by the port's coordinator, one torch worker (phase 4's engine sizes)
    and the port's frontend, as three processes, over HTTP: a warming
    pass, then the identity pass twice (equal answers: the warm pass
    filled the prefix cache both then hit alike), then the timed windows
    (``ENTRY_WINDOWS``: phase 4's own requests, cold, then warm three
    times), each with the part of the client's TTFT spent outside the
    worker's engine. The worker's ``/metrics`` must show B1, B2 and B3
    launched between just before the identity passes and just after the
    timed ones; returns those launch counts."""
    import importlib.util
    from dynamo_tpu_torch.models.config import ModelConfig
    missing = [m for m in SERVE_PACKAGES
               if importlib.util.find_spec(m) is None]
    if missing:
        raise AssertionError(f"serving packages missing here: {missing}")
    cfg = entry_cfg()
    work = os.path.join(ROOT, "build", "serve_entry")
    model_dir = os.path.join(work, "llama32_3b")
    write_entry_model(model_dir, cfg)
    back = ModelConfig.from_pretrained(model_dir)
    off = [f for f in ("model_type", "vocab_size", "hidden_size",
                       "intermediate_size", "num_layers", "num_heads",
                       "num_kv_heads", "head_dim", "rope_theta",
                       "rms_norm_eps", "max_position_embeddings",
                       "tie_word_embeddings", "attention_bias", "qk_norm",
                       "num_experts", "kv_lora_rank", "dtype")
           if getattr(back, f) != getattr(cfg, f)]
    if off:
        raise AssertionError(f"the written config.json reads back with "
                             f"other {off}")
    ports = [free_port() for _ in range(3)]
    coord = f"127.0.0.1:{ports[0]}"
    sizes = []
    for k in ("num_pages", "page_size", "max_num_seqs", "max_prefill_chunk",
              "max_context"):
        sizes += [f"--{k.replace('_', '-')}", str(SERVE_SIZES[k])]
    children = []
    t0 = time.perf_counter()
    try:
        children.append(Child("coordinator",
                              "dynamo_tpu_torch.runtime.coordinator",
                              ["--host", "127.0.0.1", "--port",
                               str(ports[0])], work))
        children[-1].wait_for("coordinator listening")
        children.append(Child(
            "worker", "dynamo_tpu_torch.worker.main",
            ["--coordinator", coord, "--model-path", model_dir,
             "--random-weights", "--dtype", "bfloat16"] + sizes, work,
            {"DYN_SYSTEM_ENABLED": "1", "DYN_SYSTEM_PORT": str(ports[2])}))
        children.append(Child(
            "frontend", "dynamo_tpu_torch.frontend.main",
            ["--coordinator", coord, "--http-host", "127.0.0.1",
             "--http-port", str(ports[1])], work))
        children[1].wait_for("torch worker serving model")
        children[2].wait_for("frontend listening")
        base = f"http://127.0.0.1:{ports[1]}"
        import urllib.request
        model, deadline = None, time.monotonic() + ENTRY_TIMEOUT_S
        while model is None and time.monotonic() < deadline:
            with urllib.request.urlopen(f"{base}/v1/models") as resp:
                data = json.loads(resp.read())["data"]
            model = data[0]["id"] if data else time.sleep(0.2)
        log(f"[serve-entry] stack up in {time.perf_counter() - t0:.1f} s "
            f"(model {model} at {ENTRY_LAYERS} of its 28 layers, worker "
            f"pid {children[1].proc.pid}, "
            f"{len(scrape_launches(ports[2]))} kernels counted on the "
            f"worker's /metrics)")
        t1 = time.perf_counter()
        entry_requests(base, model, seed=5)
        log(f"[serve-entry] warming pass {time.perf_counter() - t1:.1f} s")
        before = scrape_launches(ports[2])
        t1 = time.perf_counter()
        first = entry_requests(base, model, seed=5)
        seq_s = time.perf_counter() - t1
        second = entry_requests(base, model, seed=5)
        for key in first:
            if first[key] != second[key]:
                raise AssertionError(f"{key} differs between two serves of "
                                     f"the same requests")
        check_entry_answers(first, cfg.hidden_size)
        ENTRY_ANSWERS["first"] = first
        n_seq = sum(first[f"chat{i}"]["usage"]["completion_tokens"]
                    for i in range(len(ENTRY_CHAT_WORDS)))
        log(f"[serve-entry] identity pass: 4 chat completions one at a time "
            f"(2 streamed) + echo/logprobs over "
            f"{len(first['echo']['token_logprobs'])} tokens + 2 embeddings "
            f"in {seq_s:.3f} s ({n_seq} chat tokens), served twice: equal; "
            f"finish {[first[f'chat{i}']['finish'] for i in range(4)]}")
        warm = []
        for tag, seed in ENTRY_WINDOWS:
            m0 = scrape_metrics(ports[2])
            r = entry_window(base, model, cfg.vocab_size, seed)
            r["engine"] = worker_ttft_s(m0, scrape_metrics(ports[2]), r["n"])
            r["hop"] = r["ttft_mean"] - r["engine"]
            log(f"[serve-entry] timed {tag} (phase 4's requests, seed "
                f"{seed}): {r['tokens']} tokens in {r['wall']:.4f} s: "
                f"{r['tok_s']:.2f} tok/s; client TTFT p50="
                f"{r['ttft_p50']:.4f} s max={r['ttft_max']:.4f} s mean="
                f"{r['ttft_mean']:.4f} s; the worker's engine "
                f"{r['engine']:.4f} s; outside it (frontend, RPC, HTTP) "
                f"{r['hop'] * 1e3:.2f} ms per request "
                f"({r['hop'] / r['ttft_mean']:.1%})")
            if tag == "warm":
                warm.append(r)
        ENTRY_ANSWERS["warm"] = warm
        hops = [r["hop"] * 1e3 for r in warm]
        toks = [r["tok_s"] for r in warm]
        log(f"[serve-entry] warm windows: {len(warm)} x {warm[0]['n']} "
            f"requests; outside the engine mean {float(np.mean(hops)):.2f} "
            f"ms per request (windows {min(hops):.2f}-{max(hops):.2f}); "
            f"{min(toks):.2f}-{max(toks):.2f} tok/s; client TTFT p50 "
            f"{min(r['ttft_p50'] for r in warm):.4f}-"
            f"{max(r['ttft_p50'] for r in warm):.4f} s")
        p4 = PHASE4_WARM.get("llama")
        if p4:
            log(f"[serve-entry] beside phase 4 in process (warm, seed "
                f"{WARM_SEED}, the same requests, all 28 layers): "
                f"{p4['tok_s']:.2f} tok/s, "
                f"TTFT p50={p4['ttft_p50']:.4f} s max={p4['ttft_max']:.4f} "
                f"s mean={p4['ttft_mean']:.4f} s")
        after = scrape_launches(ports[2])
        delta = {k: int(after[k] - before.get(k, 0)) for k in after}
        log(f"[serve-entry] worker kernel launches over the identity "
            f"passes and the timed windows: {delta}")
        for k in ("paged_decode", "paged_prefill", "ragged_mixed"):
            if delta.get(k, 0) <= 0:
                raise AssertionError(f"kernel {k} never launched in the "
                                     f"worker")
        return delta
    except Exception:
        for c in children:
            log(f"[serve-entry] last 40 lines of {c.name}:\n{c.tail()}")
        raise
    finally:
        for c in reversed(children):
            c.stop()


# -- the loader on the card ----------------------------------------------------

ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}


def write_safetensors(path: str, tensors: dict) -> int:
    """A ``.safetensors`` file of CPU ``tensors`` (8 bytes of header
    length, the JSON header padded to 8 bytes, the raw little-endian
    data). Returns its size in bytes."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)
    return 8 + len(head) + off


def phase_loader() -> None:
    """Two full-width Llama-3.2-3B layers and the tied embedding (about
    1.2 GB of bf16, random from a seed) written as a safetensors file with
    this script's own header writer, read onto the card by the port's
    loader: every leaf equal to the tensor written, bit for bit (after the
    ``[out, in]`` -> ``[in, out]`` transpose and the layer stacking)."""
    from dynamo_tpu_torch.models.hf_loader import load_hf_params
    from dynamo_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig.llama32_3b(num_layers=2)
    g = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return (torch.randn(shape, generator=g, device="cuda")
                * 0.02).to(torch.bfloat16)

    H, I, q, kv = (cfg.hidden_size, cfg.intermediate_size, cfg.q_size,
                   cfg.kv_size)
    want = {("embed",): rand(cfg.vocab_size, H), ("final_norm",): rand(H)}
    hf = {"model.embed_tokens.weight": ("embed",),
          "model.norm.weight": ("final_norm",)}
    per_layer = {"input_layernorm": ("attn_norm", (H,), False),
                 "self_attn.q_proj": ("wq", (q, H), True),
                 "self_attn.k_proj": ("wk", (kv, H), True),
                 "self_attn.v_proj": ("wv", (kv, H), True),
                 "self_attn.o_proj": ("wo", (H, q), True),
                 "post_attention_layernorm": ("mlp_norm", (H,), False),
                 "mlp.gate_proj": ("w_gate", (I, H), True),
                 "mlp.up_proj": ("w_up", (I, H), True),
                 "mlp.down_proj": ("w_down", (H, I), True)}
    tensors = {}
    for name, path in hf.items():
        tensors[name] = want[path].cpu()
    stacked = {}
    for l in range(cfg.num_layers):
        for hf_name, (leaf, shape, transpose) in per_layer.items():
            t = rand(*shape)
            tensors[f"model.layers.{l}.{hf_name}.weight"] = t.cpu()
            stacked.setdefault(leaf, []).append(t.t() if transpose else t)
    for leaf, ts in stacked.items():
        want[("layers", leaf)] = torch.stack(ts)
    del stacked
    work = os.path.join(ROOT, "build", "loader_check")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "model.safetensors")
    t0 = time.perf_counter()
    size = write_safetensors(path, tensors)
    del tensors
    log(f"[loader] wrote {size / 2 ** 30:.3f} GiB in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = load_hf_params(cfg, work, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = 0
        for tree_path, w in want.items():
            leaf = got
            for k in tree_path:
                leaf = leaf[k]
            if leaf.dtype != torch.bfloat16 or leaf.shape != w.shape or \
                    not torch.equal(leaf.view(torch.int16),
                                    w.view(torch.int16)):
                raise AssertionError(f"loaded {tree_path} differs from the "
                                     f"tensor written")
            n += 1
        log(f"[loader] read {size / 2 ** 30:.3f} GiB onto the card in "
            f"{dt:.2f} s ({size / dt / 1e9:.2f} GB/s), {n} leaves bit for "
            f"bit equal to the tensors written")
    finally:
        os.remove(path)


# -- the GGUF and DeepSeek checkpoint loaders ----------------------------------

GGML_F32, GGML_F16, GGML_Q8_0 = 0, 1, 8
GGUF_ALIGN = 32


def _gguf_str(text: str) -> bytes:
    b = text.encode()
    return struct.pack("<Q", len(b)) + b


def _gguf_nbytes(shape, gtype: int) -> int:
    n = int(np.prod(shape))
    return {GGML_F32: 4 * n, GGML_F16: 2 * n, GGML_Q8_0: n // 32 * 34}[gtype]


def write_gguf(path: str, metadata, tensors) -> int:
    """A GGUF v3 file (the public layout the readers of both packages
    parse): ``metadata`` is ``[(key, value)]`` with a str, an int (u32) or
    a float (f32) value; ``tensors`` is ``[(name, shape, ggml type,
    make)]``, ``make()`` giving the tensor's bytes when it is written, one
    tensor at a time, so the host holds one tensor, not the model. Shapes
    are row-major (numpy's order; GGUF stores them innermost first).
    Returns the file's size in bytes."""
    head = bytearray(b"GGUF" + struct.pack("<IQQ", 3, len(tensors),
                                           len(metadata)))
    for key, value in metadata:
        head += _gguf_str(key)
        if isinstance(value, str):
            head += struct.pack("<I", 8) + _gguf_str(value)
        elif isinstance(value, float):
            head += struct.pack("<If", 6, value)
        else:
            head += struct.pack("<II", 4, value)
    offset = 0
    for name, shape, gtype, _make in tensors:
        head += _gguf_str(name) + struct.pack("<I", len(shape))
        for d in reversed(shape):
            head += struct.pack("<Q", d)
        head += struct.pack("<IQ", gtype, offset)
        n = _gguf_nbytes(shape, gtype)
        offset += n + (-n % GGUF_ALIGN)
    with open(path, "wb") as f:
        f.write(bytes(head) + b"\0" * (-len(head) % GGUF_ALIGN))
        for name, shape, gtype, make in tensors:
            raw = make()
            if len(raw) != _gguf_nbytes(shape, gtype):
                raise ValueError(f"{name}: {len(raw)} bytes for {shape} of "
                                 f"ggml type {gtype}")
            f.write(raw)
            f.write(b"\0" * (-len(raw) % GGUF_ALIGN))
        return f.tell()


def q8_0_parts(x: torch.Tensor):
    """ggml's Q8_0 of ``x`` (row-major, blocks of 32): per block the scale
    ``d = max|x| / 127`` stored as f16 and ``q = round(x / d)`` as int8.
    Returns (d f16 [n], q int8 [n, 32]) on x's device."""
    b = x.float().reshape(-1, 32)
    d = b.abs().amax(dim=1) / 127.0
    q = torch.where(d[:, None] > 0, torch.round(b / d[:, None]),
                    torch.zeros((), device=b.device))
    return d.to(torch.float16), q.clamp(-127, 127).to(torch.int8)


def q8_0_blocks(x: torch.Tensor) -> bytes:
    """``x`` as ggml Q8_0 blocks (34 bytes: the f16 scale, 32 int8)."""
    d, q = q8_0_parts(x)
    raw = torch.cat([d.view(torch.uint8).reshape(-1, 2),
                     q.view(torch.uint8)], dim=1)
    return raw.cpu().numpy().tobytes()


def permute_qk(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """llama.cpp's converter: a Q/K weight's ``[out, in]`` rows, per head,
    from rotate-half into interleaved-rope order (the GGUF reader undoes
    it)."""
    out_dim, in_dim = w.shape
    return (w.reshape(n_head, 2, out_dim // n_head // 2, in_dim)
            .transpose(1, 2).reshape(out_dim, in_dim))


# Llama-3.2-1B's GGUF: ggml type per weight family (the rest F16, norms F32)
GGUF_Q8_0 = ("attn_v", "ffn_down")
GGUF_LAYER = {"attn_norm": "attn_norm", "attn_q": "wq", "attn_k": "wk",
              "attn_v": "wv", "attn_output": "wo", "ffn_norm": "mlp_norm",
              "ffn_gate": "w_gate", "ffn_up": "w_up", "ffn_down": "w_down"}


def phase_gguf():
    """A seeded full-width, full-depth Llama-3.2-1B (16 layers, head_dim
    64, tied embedding) written as a GGUF file the way llama.cpp's
    converter writes one (Q/K rows permuted into interleaved-rope order;
    F16, norms F32, ``attn_v`` and ``ffn_down`` Q8_0), then served through
    the worker's ``.gguf`` route (``worker.main.build_engine``: the config
    from the file's metadata, ``models/gguf.py`` ``load_gguf_params``):
    every leaf on the card equal to what was written, bit for bit (F16 as
    its bf16 rounding, Q8_0 as its blocks dequantize), with the read's
    GB/s; then phase 4's ten greedy requests on that engine (every kernel
    launched, every request finished). Returns the kernels' launches over
    the serve."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from dynamo_tpu_torch.worker.main import build_engine, build_parser
    cfg = ModelConfig.llama32_1b()
    gen = torch.Generator(device="cuda").manual_seed(12)
    tree = llama.init_params(cfg, gen, device="cuda")
    for leaf in ("attn_norm", "mlp_norm"):
        tree["layers"][leaf] = (1.0 + 0.1 * torch.randn(
            tree["layers"][leaf].shape, generator=gen, device="cuda")
        ).to(torch.bfloat16)
    H, L = cfg.hidden_size, cfg.num_layers
    md = [("general.architecture", "llama"),
          ("general.alignment", GGUF_ALIGN),
          ("llama.block_count", L), ("llama.embedding_length", H),
          ("llama.feed_forward_length", cfg.intermediate_size),
          ("llama.attention.head_count", cfg.num_heads),
          ("llama.attention.head_count_kv", cfg.num_kv_heads),
          ("llama.attention.key_length", cfg.head_dim),
          ("llama.rope.freq_base", float(cfg.rope_theta)),
          ("llama.attention.layer_norm_rms_epsilon", cfg.rms_norm_eps),
          ("llama.context_length", cfg.max_position_embeddings),
          ("llama.vocab_size", cfg.vocab_size),
          ("tokenizer.ggml.bos_token_id", 128000),
          ("tokenizer.ggml.eos_token_id", 128001)]
    want = {}

    def matrix(leaf, l, gguf_name):
        """[out, in] as the file holds it; records the loaded leaf due."""
        w = tree["layers"][leaf][l].t()
        heads = {"attn_q": cfg.num_heads, "attn_k": cfg.num_kv_heads}
        if gguf_name in GGUF_Q8_0:
            d, q = q8_0_parts(w)
            due = (d.float()[:, None] * q.float()).reshape(w.shape)
        else:
            due = w.to(torch.float16).float()
        want[("layers", leaf, l)] = due.t().to(torch.bfloat16)
        return permute_qk(w, heads[gguf_name]) if gguf_name in heads else w

    def emit(x, gtype):
        if gtype == GGML_Q8_0:
            return lambda: q8_0_blocks(x())
        dt = torch.float32 if gtype == GGML_F32 else torch.float16
        return lambda: x().to(dt).contiguous().cpu().numpy().tobytes()

    tensors = [("token_embd.weight", (cfg.vocab_size, H), GGML_F16,
                emit(lambda: tree["embed"], GGML_F16)),
               ("output_norm.weight", (H,), GGML_F32,
                emit(lambda: tree["final_norm"], GGML_F32))]
    want[("embed",)] = tree["embed"].to(torch.float16).to(torch.bfloat16)
    want[("final_norm",)] = tree["final_norm"]
    for l in range(L):
        for name, leaf in GGUF_LAYER.items():
            full = f"blk.{l}.{name}.weight"
            shape = tuple(tree["layers"][leaf][l].shape)
            if len(shape) == 1:
                want[("layers", leaf, l)] = tree["layers"][leaf][l]
                tensors.append((full, shape, GGML_F32, emit(
                    lambda leaf=leaf, l=l: tree["layers"][leaf][l],
                    GGML_F32)))
                continue
            gtype = GGML_Q8_0 if name in GGUF_Q8_0 else GGML_F16
            tensors.append((full, shape[::-1], gtype, emit(
                lambda leaf=leaf, l=l, name=name: matrix(leaf, l, name),
                gtype)))
    work = os.path.join(ROOT, "build", "gguf_check")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "Llama-3.2-1B-F16-Q8_0.gguf")
    t0 = time.perf_counter()
    size = write_gguf(path, md, tensors)
    del tree, tensors
    gc.collect()
    log(f"[gguf] wrote {path.rsplit(os.sep, 1)[-1]}: {size / 1e9:.3f} GB "
        f"in {time.perf_counter() - t0:.1f} s")
    args = build_parser().parse_args(
        ["--model-path", path, "--device", "cuda", "--dtype", "bfloat16",
         "--num-pages", str(SERVE_SIZES["num_pages"]),
         "--page-size", str(PS), "--max-num-seqs", "32",
         "--max-prefill-chunk", "512", "--max-context", "4096"])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = build_engine(args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        os.remove(path)
    got = engine.params
    n = 0
    for key, w in want.items():
        leaf = got[key[0]] if len(key) == 1 else got[key[0]][key[1]][key[2]]
        if leaf.dtype != torch.bfloat16 or leaf.shape != w.shape or \
                not torch.equal(leaf.view(torch.int16), w.view(torch.int16)):
            raise AssertionError(f"loaded {key} differs from what the GGUF "
                                 f"file holds")
        n += 1
    mc = engine.model_cfg
    log(f"[gguf] the worker's .gguf route built the engine in {dt:.2f} s "
        f"({size / dt / 1e9:.2f} GB/s from the file onto the card, config "
        f"from its metadata: L={mc.num_layers} Hq={mc.num_heads} "
        f"Hkv={mc.num_kv_heads} Dh={mc.head_dim} tied="
        f"{mc.tie_word_embeddings}); {n} tensors bit for bit as written")
    del want
    reset_launch_counts()
    served = run_serve(engine, (COLD_SEED,))
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in engine.kernel_launches}
    stats, wall, info = served[0]
    serve_report(stats, wall, info, "gguf")
    check_stats(stats, mc)
    log(f"[gguf] launches={counts}")
    for k, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} never launched serving the "
                                 f"GGUF model")
    del engine
    return counts


def phase_deepseek_loader():
    """Two full-width DeepSeek-V2-Lite layers (layer 0 dense, layer 1 MoE
    with its 64 routed and 2 shared experts), the embedding and the head,
    random from a seed on the card, written as HF safetensors by this
    script's writer and read onto the card by ``load_hf_params`` ->
    ``models/deepseek.py`` ``load_params``: every leaf equal to the tree
    made in memory, bit for bit, with the read's GB/s; and the forward of
    a 512-token prompt through the latent kernels on the loaded tree
    equal, logits bit for bit, to the forward on the tree in memory."""
    from dynamo_tpu_torch.engine.torch_engine import MLA_ATTENTION
    from dynamo_tpu_torch.models import deepseek
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.hf_loader import load_hf_params
    cfg = ModelConfig.deepseek_v2_lite(num_layers=2)
    K = cfg.first_k_dense_replace
    gen = torch.Generator(device="cuda").manual_seed(13)
    tree = deepseek.init_params(cfg, gen, device="cuda")
    for stack in ("dense_layers", "moe_layers"):
        for leaf in deepseek._ONES:
            if leaf in tree[stack]:
                tree[stack][leaf] = (1.0 + 0.1 * torch.randn(
                    tree[stack][leaf].shape, generator=gen,
                    device="cuda")).to(torch.bfloat16)
    names = dict(deepseek._ATTN_NAMES, **{"self_attn.q_proj.weight":
                                          ("wq", True)})
    tensors = {"model.embed_tokens.weight": tree["embed"].cpu(),
               "model.norm.weight": tree["final_norm"].cpu(),
               "lm_head.weight": tree["lm_head"].t().contiguous().cpu()}
    for l in range(cfg.num_layers):
        stack = "moe_layers" if l >= K else "dense_layers"
        row = l - K if l >= K else l
        mlp = deepseek._MOE_MLP_NAMES if l >= K else \
            deepseek._DENSE_MLP_NAMES
        for tail, (leaf, tr) in dict(names, **mlp).items():
            if leaf not in tree[stack]:
                continue
            t = tree[stack][leaf][row]
            tensors[f"model.layers.{l}.{tail}"] = (
                t.t() if tr else t).contiguous().cpu()
        if l >= K:
            for wname, leaf in deepseek._EXPERT_NAMES.items():
                for j in range(cfg.num_experts):
                    tensors[f"model.layers.{l}.mlp.experts.{j}.{wname}"] = \
                        tree[stack][leaf][row, j].t().contiguous().cpu()
    work = os.path.join(ROOT, "build", "deepseek_loader_check")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "model.safetensors")
    t0 = time.perf_counter()
    size = write_safetensors(path, tensors)
    log(f"[deepseek-loader] wrote {len(tensors)} tensors, {size / 1e9:.3f} "
        f"GB in {time.perf_counter() - t0:.1f} s")
    del tensors
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = load_hf_params(cfg, work, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        os.remove(path)

    def leaves(t, prefix=()):
        for k, v in sorted(t.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    want, have = dict(leaves(tree)), dict(leaves(got))
    if sorted(want) != sorted(have):
        raise AssertionError(f"loaded tree {sorted(have)} is not the tree "
                             f"written {sorted(want)}")
    for key, w in want.items():
        g = have[key]
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                w.view(torch.int16) if w.dtype == torch.bfloat16 else w):
            raise AssertionError(f"loaded {key} differs from the tensor "
                                 f"written")
    log(f"[deepseek-loader] read {size / 1e9:.3f} GB onto the card in "
        f"{dt:.2f} s ({size / dt / 1e9:.2f} GB/s); {len(want)} leaves bit "
        f"for bit as made in memory")
    S = 512
    rng = np.random.default_rng(14)
    dev = "cuda"
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)).astype(
        np.int32)).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    table = torch.arange(1, S // PS + 1, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([S], dtype=torch.int32, device=dev)
    logits = []
    with torch.no_grad():
        for params in (tree, got):
            pages = deepseek.make_pages(cfg, S // PS + 1, PS, device=dev)
            logits.append(deepseek.forward(
                params, cfg, toks, pos, pages, table, lens, lens,
                attn_impl=MLA_ATTENTION["mla_prefill"])[0])
    torch.cuda.synchronize()
    same = torch.equal(logits[0], logits[1])
    log(f"[deepseek-loader] forward of a {S}-token prompt through B5 on the "
        f"loaded tree vs the tree in memory: logits equal={same}, finite="
        f"{bool(torch.isfinite(logits[1]).all())}")
    if not same or not bool(torch.isfinite(logits[1]).all()):
        raise AssertionError("the loaded tree's forward differs from the "
                             "forward of the tree made in memory")


# -- phase 6: the KV data plane ------------------------------------------------

# 6(a): four prompts of 1024 tokens prefilled on one engine (256 blocks of
# 16, 470 MB of bf16 KV at Llama-3.2-3B's widths) and moved to another
KV_PROMPTS, KV_LEN, KV_TOKENS = 4, 1024, 32
KV_SEED, KV_WARM_SEED = 11, 12
# 6(b): the decode-first timed windows (phase 4's requests of these seeds)
DISAGG_WINDOWS = (("cold", COLD_SEED), ("warm", WARM_SEED))
# 6(c): the streams the drill drains mid-decode (long enough that the
# drain lands while they decode: a fused block emits 8 tokens at a time)
DRILL_SEED, DRILL_N, DRILL_TOKENS = 4, 6, 400
# phase 5's identity answers, which phase 6(b) must reproduce
ENTRY_ANSWERS = {}
# phase 6(a)'s one-rank gather and inject rates, beside phase 8(a)'s
KV_LOCAL_RATES = {}


def _gbs(nbytes: float, seconds: float) -> str:
    return f"{nbytes / seconds / 1e9:.2f} GB/s" if seconds > 0 else "n/a"


class _NoRpc:
    """The KV client of an in-process bulk pull: no instance record and no
    RPC plane, so a pull that fell off the bulk plane fails the check."""

    def get_instance(self, iid):
        return None

    async def direct(self, payload, iid):
        raise ConnectionError("no RPC plane in this check: the bulk pull "
                              "failed")


def kv_prompts(V: int, seed: int):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, V, size=KV_LEN)))
            for _ in range(KV_PROMPTS)]


def _kv_request(prompt, rid, max_tokens=KV_TOKENS, prefill_only=False):
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    req = PreprocessedRequest(
        token_ids=list(prompt), request_id=rid,
        stop_conditions=StopConditions(max_tokens=max_tokens,
                                       ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0))
    req.prefill_only = prefill_only
    return req


async def _one(engine, prompt, rid, **kw):
    frames = [f async for f in engine.generate(_kv_request(prompt, rid,
                                                           **kw))]
    return frames


def _pages_equal(a, b, hashes) -> bool:
    """Whether engine ``b`` holds ``a``'s bytes for ``hashes``."""
    n = len(hashes)
    pa = a.dispatch_gather_pages(
        [a.allocator._by_hash[h] for h in hashes])[:, :n]
    pb = b.dispatch_gather_pages(
        [b.allocator._by_hash[h] for h in hashes])[:, :n]
    return bool(torch.equal(pa.view(torch.int16), pb.view(torch.int16)))


def _sha(t: torch.Tensor) -> str:
    import hashlib
    host = t.contiguous().view(torch.int16).cpu().numpy()
    return hashlib.sha256(host.tobytes()).hexdigest()


IPC_CHILD = r"""
import hashlib, json, sys, time
sys.modules["jax"] = None
import torch
from dynamo_tpu_torch.engine.transfer import DeviceTransferPlane
from dynamo_tpu_torch.runtime.codec import unpack
offers = unpack(open(sys.argv[1], "rb").read())
plane = DeviceTransferPlane()
torch.cuda.init()
out = {"seconds": [], "sha256": []}
for offer in offers:
    t0 = time.perf_counter()
    data = plane.pull(offer)
    out["seconds"].append(time.perf_counter() - t0)
    host = data.contiguous().view(torch.int16).cpu().numpy()
    out["sha256"].append(hashlib.sha256(host.tobytes()).hexdigest())
    out["bytes"] = data.nbytes
    del data
out["jax"] = "jax" in [k for k, v in sys.modules.items() if v is not None]
print(json.dumps(out))
"""


def phase_kv_local() -> None:
    """6(a) and 6(d), in this process on the card: Llama-3.2-3B (random
    bf16 weights from seed 0, phase 4's engine sizes) on three engines that
    share the weights. A prefills four 1024-token prompts; their 256 blocks
    move to B through ``export_frames`` and the staged inject pipeline, to
    C over the bulk plane (a ``KvBlockPuller`` given no direct plane and no
    RPC plane), to C again, its cache emptied and zeroed, as CRC'd RPC
    frames, and to a child process (which imports no JAX) over the CUDA IPC
    plane. Every destination must hold A's bytes. B captured its fused
    block graphs on other prompts before the inject; its serve of the four
    prompts after it must replay them (no new capture) with the tokens of
    A's hot serve. Prints the GB/s of the gather, the frame build, each
    plane and the commit. Then the KVBM tiers (``phase_kvbm``)."""
    from dynamo_tpu_torch.engine import transfer as tr
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.runtime.bulk import BulkServer
    from dynamo_tpu_torch.runtime.codec import pack, release_buffer
    from dynamo_tpu_torch.runtime.rpc import RpcConnection, RpcServer
    from dynamo_tpu_torch.worker.disagg import (KV_EXPORT_ENDPOINT,
                                                KvBlockPuller,
                                                get_kv_bandwidth_book)
    cfg = llama_cfg()
    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    small = dict(SERVE_SIZES, num_pages=512)

    def engine(sizes):
        return TorchEngine(cfg, params, TorchEngineConfig(**sizes),
                           device="cuda")

    a, b, c = engine(SERVE_SIZES), engine(SERVE_SIZES), engine(small)
    prompts = kv_prompts(cfg.vocab_size, KV_SEED)
    warm = kv_prompts(cfg.vocab_size, KV_WARM_SEED)
    work = os.path.join(ROOT, "build", "kv_plane")
    os.makedirs(work, exist_ok=True)

    async def run():
        try:
            await transfer_checks()
        finally:
            for e in (a, b, c):
                await e.stop()

    async def transfer_checks():
        hashes = []
        for i, p in enumerate(prompts):
            out = await _one(a, p, f"p{i}", prefill_only=True)
            hashes += [blk[0] for blk in out[-1].kv_transfer_params["blocks"]]
        nbytes = len(hashes) * a.pages[:, 0].numel() * 2
        pages = [a.allocator._by_hash[h] for h in hashes]
        log(f"[kv-local] {len(hashes)} blocks prefilled on A "
            f"({nbytes / 1e6:.1f} MB of KV)")
        # B captures its fused block graphs on other prompts first
        for i, p in enumerate(warm):
            await _one(b, p, f"w{i}")
        captured, replays = len(b.graphs), b.graphs.replays
        ptr = b.pages.data_ptr()

        def gather_ms():
            ms = []
            for _ in range(5):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                a.dispatch_gather_pages(pages)
                t1.record()
                t1.synchronize()
                ms.append(t0.elapsed_time(t1))
            return float(np.median(ms))
        g_ms = await a.run_exclusive(gather_ms)

        def commit_ms():
            # the commit's device work: the 256 blocks written back in
            # place over themselves (index_copy_), CUDA events around it
            vals = a.dispatch_gather_pages(pages)
            ms = []
            for _ in range(5):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                a.scatter_pages_device(pages, vals)
                t1.record()
                t1.synchronize()
                ms.append(t0.elapsed_time(t1))
            return float(np.median(ms))
        c_ms = await a.run_exclusive(commit_ms)
        t0 = time.perf_counter()
        frames = await a.run_exclusive(tr.export_frames, a, hashes, "layer",
                                       16)
        build_s = time.perf_counter() - t0
        tr.stamp_frame_crcs(frames)
        wire = []
        for f in frames:
            meta = dict(f.obj)
            meta["_raw"] = np.ascontiguousarray(f.raw).view(
                np.uint8).tobytes()
            wire.append(meta)
        if wire[0]["dtype"] != "bfloat16" or wire[0]["block_shape"] != \
                [cfg.num_layers, 2, cfg.num_kv_heads, PS, cfg.head_dim]:
            raise AssertionError(f"frame meta {wire[0]}")
        pipe = tr.InjectPipeline(b)
        t0 = time.perf_counter()
        for meta in wire:
            await pipe.add_frame(meta)
        if await pipe.finish() != len(hashes):
            raise AssertionError("the pipeline injected a partial chain")
        inj_s = time.perf_counter() - t0
        if not _pages_equal(a, b, hashes) or b.pages.data_ptr() != ptr:
            raise AssertionError("B's pages are not A's bytes (or moved)")
        tm = pipe.timings
        # phase 8(a) prints its world's rates beside these one-rank ones
        KV_LOCAL_RATES.update(gather=_gbs(nbytes, g_ms / 1e3),
                              inject=_gbs(nbytes, inj_s))
        log(f"[kv-local] gather {g_ms:.3f} ms ({_gbs(nbytes, g_ms / 1e3)}); "
            f"commit (in-place index_copy_) {c_ms:.3f} ms "
            f"({_gbs(nbytes, c_ms / 1e3)}); "
            f"frame build (gather + copy + pinned fetch) {build_s:.3f} s "
            f"({_gbs(nbytes, build_s)}); inject pipeline {inj_s:.3f} s "
            f"({_gbs(nbytes, inj_s)}): stage {tm['stage_s']:.3f} s, upload "
            f"{tm['upload_s']:.3f} s ({_gbs(nbytes, tm['upload_s'])}), "
            f"commits (exclusive-lane round trips) {tm['scatter_s']:.3f} s "
            f"in {b.page_scatter_dispatches} scatters; pages bit-equal")
        # bulk plane: a puller with no direct plane and no RPC fallback
        srv = BulkServer().start()
        srv.register(KV_EXPORT_ENDPOINT, tr.serve_kv_export_bulk(
            a, asyncio.get_running_loop()))
        try:
            puller = KvBlockPuller(c, kv_client=_NoRpc())
            t0 = time.perf_counter()
            await puller.pull_blocks(hashes, 0, bulk_address=srv.address)
            bulk_s = time.perf_counter() - t0
        finally:
            srv.stop()
        if puller.last_pull_stats.get("injected") != len(hashes) or \
                not _pages_equal(a, c, hashes):
            raise AssertionError(f"bulk pull: {puller.last_pull_stats}")
        log(f"[kv-local] bulk plane (a puller given no direct plane): "
            f"{nbytes / 1e6:.1f} MB of KV in {bulk_s:.3f} s "
            f"({_gbs(nbytes, bulk_s)}, the pull's first socket warm-up "
            f"included); bandwidth book "
            f"{get_kv_bandwidth_book().snapshot().get('bulk')}; pages "
            f"bit-equal")
        # RPC frames, wire v5 (CRC'd), into C emptied: its cached blocks
        # evicted and every page zeroed, in place
        def empty():
            c.allocator.clear()
            c.pages.zero_()
        await c.run_exclusive(empty)
        if c.allocator.peek_prefix(hashes):
            raise AssertionError("C still holds the blocks")
        server = await RpcServer().start()
        server.register(KV_EXPORT_ENDPOINT, tr.serve_kv_export(a))
        conn = await RpcConnection(server.address).connect()
        try:
            t0 = time.perf_counter()
            stream = await conn.request(KV_EXPORT_ENDPOINT, {
                "block_hashes": hashes, "wire": tr.FRAME_WIRE_VERSION})
            pipe = tr.InjectPipeline(c)
            n_crc = 0
            async for frame in stream:
                n_crc += "crc32" in frame
                await pipe.add_frame(frame, release=release_buffer)
            if await pipe.finish() != len(hashes) or n_crc != len(frames):
                raise AssertionError("RPC frames: partial chain or no crc")
            rpc_s = time.perf_counter() - t0
        finally:
            await conn.close()
            await server.stop()
        if not _pages_equal(a, c, hashes):
            raise AssertionError("C's pages are not A's bytes")
        log(f"[kv-local] RPC plane: {len(frames)} CRC'd frames in "
            f"{rpc_s:.3f} s ({_gbs(nbytes, rpc_s)}); pages bit-equal")
        # the CUDA IPC plane, into a child process that imports no JAX
        plane = tr.DeviceTransferPlane()
        offs = [await a.run_exclusive(plane.offer, a, hashes)
                for _ in range(2)]
        want = _sha(a.dispatch_gather_pages(pages)[:, :len(hashes)])
        path = os.path.join(work, "offer.bin")
        with open(path, "wb") as f:
            f.write(pack(offs))
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        res = await asyncio.to_thread(
            subprocess.run, [sys.executable, "-c", IPC_CHILD, path],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
        for off in offs:
            plane.ack(off["uuid"])
        if res.returncode != 0:
            raise AssertionError(f"IPC child failed:\n{res.stderr[-3000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        if got["sha256"] != [want, want] or got["jax"]:
            raise AssertionError(f"IPC child: {got}")
        cold, warm_s = got["seconds"]
        log(f"[kv-local] device-direct (CUDA IPC) plane: a child process "
            f"(no JAX) pulled two offers of {got['bytes'] / 1e6:.1f} MB: the "
            f"first in {cold:.4f} s ({_gbs(got['bytes'], cold)}; the "
            f"process's first handle open and allocation), the second in "
            f"{warm_s:.4f} s ({_gbs(got['bytes'], warm_s)}; open + copy + "
            f"wait); sha256 of both equal to A's pages")
        # B replays the graphs it captured, over the injected prefix
        got_t, want_t = [], []
        for i, p in enumerate(prompts):
            fb = await _one(b, p, f"b{i}")
            fa = await _one(a, p, f"a{i}")
            if (fb[-1].cached_tokens or 0) < KV_LEN - PS:
                raise AssertionError(f"B's serve of prompt {i} cached "
                                     f"{fb[-1].cached_tokens} tokens")
            got_t.append([t for f in fb for t in f.token_ids])
            want_t.append([t for f in fa for t in f.token_ids])
        if len(b.graphs) != captured or b.graphs.replays <= replays:
            raise AssertionError(f"B captured {len(b.graphs) - captured} "
                                 f"graphs after the inject, replayed "
                                 f"{b.graphs.replays - replays}")
        if got_t != want_t:
            raise AssertionError("B's tokens over the injected KV differ "
                                 "from A's hot serve")
        log(f"[kv-local] B after the inject: {len(prompts)} serves replayed "
            f"{b.graphs.replays - replays} captured blocks, no capture; "
            f"tokens equal to A's hot serve ({sum(map(len, got_t))} tokens)")

    asyncio.run(asyncio.wait_for(run(), SERVE_TIMEOUT_S))
    del a, b, c
    gc.collect()
    torch.cuda.empty_cache()
    try:
        phase_kvbm(params, cfg)
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - held_before
    log(f"[kv-local] memory_allocated {held_before / 2 ** 30:.3f} GiB before "
        f"6(a), {(held_before + held) / 2 ** 30:.3f} GiB after 6(a) and "
        f"6(d) with their engines and weights freed ({held / 2 ** 20:+.1f} "
        f"MiB)")
    if held > 2 ** 30:
        for line in cuda_holders():
            log(f"[kv-local] held: {line}")
        raise AssertionError(f"{held / 2 ** 30:.2f} GiB stay allocated after "
                             "phase 6(a)/(d)")


def _describe(obj) -> str:
    """A short name for a referrer: its type, a frame's function, a
    function's qualified name, a dict's owner types."""
    if isinstance(obj, type(sys._getframe())):
        return f"frame {obj.f_code.co_name}:{obj.f_lineno}"
    if callable(obj) and hasattr(obj, "__qualname__"):
        return f"{type(obj).__name__} {obj.__qualname__}"
    if isinstance(obj, dict):
        owners = [type(o).__name__ for o in gc.get_referrers(obj)
                  if not isinstance(o, (list, type(sys._getframe())))][:3]
        return f"dict ({len(obj)} keys) of {owners}"
    return type(obj).__name__


def cuda_holders(limit: int = 6) -> list:
    """What holds the card's memory, for a failed release check: every live
    ``TorchEngine`` and the ``limit`` largest live CUDA tensors gc can see,
    each with its referrers (``_describe``), two levels up."""
    from dynamo_tpu_torch.engine.torch_engine import TorchEngine
    gc.collect()
    objs = gc.get_objects()
    found = [o for o in objs if isinstance(o, TorchEngine)]
    tensors = [o for o in objs
               if isinstance(o, torch.Tensor) and o.is_cuda]
    tensors.sort(key=lambda t: t.untyped_storage().nbytes(), reverse=True)
    del objs
    lines = []
    for o in found + tensors[:limit]:
        what = (f"TorchEngine pages {o.pages.nbytes / 2 ** 30:.2f} GiB"
                if isinstance(o, TorchEngine) else
                f"tensor {tuple(o.shape)} {o.dtype} storage "
                f"{o.untyped_storage().nbytes() / 2 ** 20:.1f} MiB")
        refs = []
        for r in gc.get_referrers(o):
            if r is found or r is tensors:
                continue
            up = [_describe(u) for u in gc.get_referrers(r)
                  if u is not found and u is not tensors][:3]
            refs.append(f"{_describe(r)} <- {up}")
        lines.append(f"{what}; referrers: {refs[:4]}")
    return lines


def phase_kvbm(params, cfg) -> None:
    """6(d): ``TieredEngine`` over a card engine whose page pool (200
    pages) is smaller than the working set, with a host budget of 48
    blocks and a disk budget under ``build/``: four 1024-token prompts,
    then four others evict them (spilled to pinned host memory on the
    spill stream, overflowing to disk); the prompts served again onboard
    from host and disk with the tokens of a hot cache's serve. Prints the
    offload GB/s (the spill thread's device->host copies) and the onboard
    GB/s (host-tier blocks injected in place)."""
    import shutil
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.engine.transfer import inject_blocks
    from dynamo_tpu_torch.kvbm import TieredEngine, TieredKvConfig
    block = cfg.num_layers * 2 * cfg.num_kv_heads * PS * cfg.head_dim * 2
    prompts = kv_prompts(cfg.vocab_size, KV_SEED)
    other = kv_prompts(cfg.vocab_size, KV_WARM_SEED)
    disk = os.path.join(ROOT, "build", "kvbm")
    shutil.rmtree(disk, ignore_errors=True)

    def engine(pages):
        return TorchEngine(cfg, params, TorchEngineConfig(
            **dict(SERVE_SIZES, num_pages=pages)), device="cuda")

    async def run():
        hot = engine(1024)
        try:
            want = []
            for i, p in enumerate(prompts):
                await _one(hot, p, f"w{i}")
                fr = await _one(hot, p, f"h{i}")
                want.append([t for f in fr for t in f.token_ids])
        finally:
            await hot.stop()
        eng = engine(200)
        ptr = eng.pages.data_ptr()
        # synchronous onboarding (prefetch depth 0): every tier-resident
        # block is back before admission, so the serve computes what the
        # hot cache's does (the prefetch pipeline's race with the prefill
        # cursor is held to the hot cache's tokens in the CPU tests)
        t = TieredEngine(eng, TieredKvConfig(
            host_budget_bytes=48 * block, disk_budget_bytes=1024 * block,
            disk_path=disk, prefetch_depth_bytes=0))
        try:
            for i, p in enumerate(prompts):
                await _one(t, p, f"a{i}")
            for i, p in enumerate(other):
                await _one(t, p, f"o{i}")
            t.flush_spills(60.0)
            if len(t.disk) == 0 or len(t.host) == 0:
                raise AssertionError(f"tiers host {len(t.host)} disk "
                                     f"{len(t.disk)} after the spill")
            got, cached = [], 0
            for i, p in enumerate(prompts):
                fr = await _one(t, p, f"b{i}")
                cached += fr[-1].cached_tokens or 0
                got.append([x for f in fr for x in f.token_ids])
            if got != want:
                raise AssertionError("tokens after onboard differ from the "
                                     "hot cache's")
            if t.onboarded <= 0 or eng.pages.data_ptr() != ptr:
                raise AssertionError(f"onboarded {t.onboarded}")
            st = t.kvbm_stats()
            off_b, off_s = (st["kvbm_offload_bytes"],
                            st["kvbm_offload_seconds"])
            log(f"[kvbm] pool 200 pages, host {len(t.host)} blocks, disk "
                f"{len(t.disk)} blocks (disk dropped "
                f"{st.get('kvbm_disk_corrupt_dropped')}); offloaded "
                f"{t.offloaded}, onboarded {t.onboarded}, cached "
                f"{cached} prompt tokens on the second serve; tokens equal "
                f"to the hot cache's; offload (device->pinned host on the "
                f"spill stream) {off_b / 1e6:.1f} MB in {off_s:.3f} s "
                f"({_gbs(off_b, off_s)})")
            # onboard rate: the host tier's blocks injected in place into
            # a fresh engine (the synchronous onboard's own call)
            blocks = [t.host.get(h) for h in list(t.host._blocks)]
            fresh = engine(200)
            try:
                def onboard():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    n = inject_blocks(fresh, blocks)
                    torch.cuda.synchronize()
                    return n, time.perf_counter() - t0
                n, secs = await fresh.run_exclusive(onboard)
            finally:
                await fresh.stop()
            log(f"[kvbm] onboard: {n} host-tier blocks "
                f"({n * block / 1e6:.1f} MB) injected in place in "
                f"{secs:.4f} s ({_gbs(n * block, secs)})")
        finally:
            await t.stop()

    asyncio.run(asyncio.wait_for(run(), SERVE_TIMEOUT_S))
    shutil.rmtree(disk, ignore_errors=True)


def _worker_args(model_dir, coord, extra, engine_sizes=None):
    sizes = []
    for k in ("num_pages", "page_size", "max_num_seqs", "max_prefill_chunk",
              "max_context"):
        sizes += [f"--{k.replace('_', '-')}",
                  str((engine_sizes or SERVE_SIZES)[k])]
    return (["--coordinator", coord, "--model-path", model_dir,
             "--random-weights", "--dtype", "bfloat16"] + sizes + extra)


def _stats_plane(coord: str, component: str) -> dict:
    """Every instance's ``__stats__`` of ``component``: endpoint ->
    counters and ``data``, the worker stats (the ``kv_transfer`` bandwidth
    book among them)."""
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

    async def run():
        drt = await DistributedRuntime.create(coordinator=coord)
        try:
            return await drt.namespace("dynamo").component(
                component).scrape_stats()
        finally:
            await drt.close()
    return asyncio.run(run())


def _set_disagg_conf(coord: str, conf: dict) -> None:
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    from dynamo_tpu_torch.worker.disagg import disagg_conf_key

    async def run():
        drt = await DistributedRuntime.create(coordinator=coord)
        try:
            await drt.coord.put(disagg_conf_key("dynamo"),
                                json.dumps(conf).encode())
        finally:
            await drt.close()
    asyncio.run(run())


def _metric(m: dict, name: str, **labels) -> float:
    lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return m.get(f"{name}{{{lab}}}" if lab else name, 0.0)


class _Stack:
    """Coordinator, frontend and workers as processes (``Child``), with
    their system ports; all stopped in ``stop``."""

    def __init__(self, work):
        self.work = work
        self.kids = {}
        self.sys = {}
        self.coord_port = free_port()
        self.http_port = free_port()
        self.coord = f"127.0.0.1:{self.coord_port}"
        self.base = f"http://127.0.0.1:{self.http_port}"

    def start_coordinator(self):
        self.kids["coordinator"] = Child(
            "coordinator", "dynamo_tpu_torch.runtime.coordinator",
            ["--host", "127.0.0.1", "--port", str(self.coord_port)],
            self.work)
        self.kids["coordinator"].wait_for("coordinator listening")

    def start_worker(self, name, args):
        self.sys[name] = free_port()
        self.kids[name] = Child(
            name, "dynamo_tpu_torch.worker.main", args, self.work,
            {"DYN_SYSTEM_ENABLED": "1",
             "DYN_SYSTEM_PORT": str(self.sys[name])})

    def start_frontend(self):
        self.kids["frontend"] = Child(
            "frontend", "dynamo_tpu_torch.frontend.main",
            ["--coordinator", self.coord, "--http-host", "127.0.0.1",
             "--http-port", str(self.http_port)], self.work)
        self.kids["frontend"].wait_for("frontend listening")

    def model(self) -> str:
        import urllib.request
        deadline = time.monotonic() + ENTRY_TIMEOUT_S
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"{self.base}/v1/models") as resp:
                data = json.loads(resp.read())["data"]
            if data:
                return data[0]["id"]
            time.sleep(0.2)
        raise TimeoutError("no model registered")

    def metrics(self, name) -> dict:
        return scrape_metrics(self.sys[name])

    def tails(self, tag="disagg"):
        for k in self.kids.values():
            log(f"[{tag}] last 40 lines of {k.name}:\n{k.tail()}")

    def stop(self):
        for k in reversed(list(self.kids.values())):
            k.stop()


def _chat_view(chat: dict) -> tuple:
    """A chat answer as the model computed it: text, finish, prompt and
    completion token counts, and each token with its logprob."""
    return (chat["text"], chat["finish"], chat["usage"]["prompt_tokens"],
            chat["usage"]["completion_tokens"],
            [(e["token"], e["logprob"]) for e in chat["logprobs"]])


class _BothLegs:
    """The disaggregated pair's computation on one engine: the prefill
    leg (``prefill_only``, what the prefill worker runs), then
    ``_continue_after_first`` (what the decode worker runs), whose prompt
    finds the leg's blocks in this cache as the decode worker finds the
    pulled ones."""

    def __init__(self, engine):
        self.engine = engine

    async def generate(self, request, ctx=None):
        from dynamo_tpu_torch.protocols.common import PreprocessedRequest
        from dynamo_tpu_torch.worker.disagg import _continue_after_first
        leg = PreprocessedRequest.from_dict(request.to_dict())
        leg.prefill_only = True
        first = None
        async for out in self.engine.generate(leg):
            if out.finish_reason is not None:
                first = out
        async for out in _continue_after_first(self.engine, request, first,
                                               ctx):
            yield out


def handoff_answers(model_dir: str) -> list:
    """What the disaggregated pair must answer, computed in this process:
    the decode worker's own engine (``worker.main.build_engine`` on its
    arguments: the same seeded weights, sizes and card) behind the local
    pipeline, each chat run through ``_BothLegs``. Phase 5's four chats,
    twice in order (the stack's first pass, on a cold cache, then its
    second, on the prefixes the first left); returns each pass's
    ``_chat_view``s."""
    from dynamo_tpu_torch.llm.pipeline import LocalEnginePipeline
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.worker.main import (arm_guided, build_engine,
                                              build_parser)
    args = build_parser().parse_args(_worker_args(
        model_dir, "127.0.0.1:1", ["--disagg", "decode"]))
    engine = build_engine(args)
    card = ModelDeploymentCard.from_local_path(model_dir)
    card.kv_cache_block_size = args.page_size
    card.num_top_logprobs = args.num_top_logprobs
    card.penalty_window = engine.cfg.penalty_window
    arm_guided(engine, card)
    pipe = LocalEnginePipeline(card, _BothLegs(engine))

    async def chat(body):
        req = ChatCompletionRequest(**dict(
            body, stream=True, stream_options={"include_usage": True}))
        out = {"text": "", "finish": None, "usage": None, "logprobs": []}
        async for chunk in pipe.generate_chat(req):
            c = chunk.model_dump()
            out["usage"] = c.get("usage") or out["usage"]
            for ch in c.get("choices") or []:
                out["logprobs"] += (ch.get("logprobs") or {}).get(
                    "content") or []
                out["text"] += (ch.get("delta") or {}).get("content") or ""
                out["finish"] = ch.get("finish_reason") or out["finish"]
        return _chat_view(out)

    async def run():
        try:
            return [[await chat(b) for b in entry_chats(card.name, seed=5)]
                    for _ in range(2)]
        finally:
            await engine.stop()
    try:
        return asyncio.run(asyncio.wait_for(run(), SERVE_TIMEOUT_S))
    finally:
        del engine, pipe
        gc.collect()
        torch.cuda.empty_cache()


def _identity_check(stack, model, tag, ref) -> None:
    """Phase 5's identity pass, one request at a time, twice (the first
    pass meets a cold cache, the second the prefixes the first left, as
    phase 5's checked pass did). Each pass's chats must equal ``ref``'s
    (``handoff_answers``) exactly, token for token and logprob for
    logprob: the same kernels on the same inputs in the same order. The
    second pass's echo (but for the generated token's alternatives,
    which the prefill leg does not hand off), its embeddings and every
    chat's first token and logprob (the prefill leg's, computed as phase
    5 computed it) must equal phase 5's. Prints the step where each chat
    leaves phase 5's tokens: from there on the decode worker continues
    from its own prefill of the prompt's tail and the handed-off token,
    where phase 5's worker wrote that token in a decode step."""
    p5 = ENTRY_ANSWERS.get("first")
    if p5 is None:
        raise AssertionError("phase 5's identity answers are missing")
    n = len(ENTRY_CHAT_WORDS)
    t0 = time.perf_counter()
    for i, want in enumerate(ref):
        ans = entry_requests(stack.base, model, seed=5)
        check_entry_answers(ans, llama_cfg().hidden_size)
        for k in range(n):
            got = _chat_view(ans[f"chat{k}"])
            if got != want[k]:
                step = next((j for j, (x, y) in enumerate(zip(got[4],
                                                             want[k][4]))
                             if x != y), None)
                raise AssertionError(
                    f"{tag} pass {i} chat{k} differs from the pair's "
                    f"computation in process at token {step}: "
                    f"{got[4][step] if step is not None else got[:4]} vs "
                    f"{want[k][4][step] if step is not None else want[k][:4]}")
    secs = time.perf_counter() - t0
    echo = {k: (v[:-1] if k == "top_logprobs" else v)
            for k, v in ans["echo"].items()}
    if echo != {k: (v[:-1] if k == "top_logprobs" else v)
                for k, v in p5["echo"].items()} or ans["embed"] != p5["embed"]:
        raise AssertionError(f"{tag}: the echo or embeddings differ from "
                             f"phase 5's")
    leave = []
    for k in range(n):
        got, five = (_chat_view(a[f"chat{k}"])[4] for a in (ans, p5))
        if got[0] != five[0]:
            raise AssertionError(f"{tag} chat{k}: first token {got[0]} vs "
                                 f"phase 5's {five[0]}")
        j = next((j for j, (x, y) in enumerate(zip(got, five))
                  if x[0] != y[0]), None)
        dl = max(abs(x[1] - y[1]) for x, y in zip(got[:j], five[:j]))
        leave.append((j, float(f"{dl:.6g}")))
    log(f"[disagg] {tag}: two identity passes in {secs:.3f} s, every chat "
        f"equal to the pair's computation in process, token for token and "
        f"logprob for logprob ({sum(len(w[4]) for w in ref[0]) * 2} "
        f"tokens); the echo's {len(ans['echo']['token_logprobs'])} prompt "
        f"logprobs, 2 embeddings and every chat's first token and logprob "
        f"equal to phase 5's; where each chat's tokens leave phase 5's "
        f"(None: never) and the largest logprob difference from phase "
        f"5's before it: {leave}")


def phase_disagg() -> dict:
    """6(b) and 6(c): Llama-3.2-3B (phase 5's model directory and random
    weights) served disaggregated by the port's processes: coordinator,
    frontend, a ``--disagg prefill`` worker and a ``--disagg decode``
    worker (decode-first; ``max_local_prefill_length`` 0, so every prompt
    prefills remotely). Phase 5's identity pass, one request at a time and
    twice, must give what the pair computes, held in this process
    (``handoff_answers``, computed while the workers start), and phase 5's
    echo, embeddings and first tokens (``_identity_check``); timed windows
    of phase 4's ten requests print tok/s, client TTFT p50/mean, the decode
    worker's remote prefills (device-direct pulls acked, which must equal
    the requests) and bytes and GB/s per plane (``/metrics`` and the
    ``kv_transfer`` bandwidth book): every pull must ride the device-direct
    plane. The prefill worker's ``/metrics`` must show B2 or B3 launched,
    the decode worker's B1. Then the drain drill (6(c)): a second decode
    worker joins, ``POST /drain`` lands on the decode worker holding
    streams mid-decode; every stream finishes, the survivor resumes the
    frozen streams from pulled KV (``migration_replays{mode="resume"}``,
    none replayed) and no stream's prefill runs twice (remote prefills over
    both decode workers equal the streams). Then a fresh stack under
    ``--disagg-strategy prefill_first``: the identity check again, against
    the same answers. Returns the Llama kernels' launches in the two
    workers of the decode-first stack."""
    cfg = entry_cfg()
    work = os.path.join(ROOT, "build", "disagg")
    os.makedirs(work, exist_ok=True)
    model_dir = os.path.join(ROOT, "build", "serve_entry", "llama32_3b")
    write_entry_model(model_dir, cfg)
    stack = _Stack(work)
    t0 = time.perf_counter()
    launches = {}
    try:
        stack.start_coordinator()
        stack.start_worker("prefill", _worker_args(
            model_dir, stack.coord, ["--disagg", "prefill", "--component",
                                     "prefill"]))
        stack.start_worker("decode", _worker_args(
            model_dir, stack.coord, ["--disagg", "decode"]))
        t1 = time.perf_counter()
        ref = handoff_answers(model_dir)
        log(f"[disagg] the pair's computation in process (one engine, "
            f"both legs): {time.perf_counter() - t1:.1f} s")
        stack.start_frontend()
        for name in ("prefill", "decode"):
            stack.kids[name].wait_for("torch worker serving model")
        model = stack.model()
        log(f"[disagg] decode-first stack up in "
            f"{time.perf_counter() - t0:.1f} s")
        pre0, dec0 = stack.metrics("prefill"), stack.metrics("decode")
        _identity_check(stack, model, "decode-first", ref)
        for tag, seed in DISAGG_WINDOWS:
            m0 = stack.metrics("decode")
            r = entry_window(stack.base, model, cfg.vocab_size, seed)
            m1 = stack.metrics("decode")
            acks = (_metric(m1, "dynamo_worker_kv_offer_acks_total",
                            outcome="ok")
                    - _metric(m0, "dynamo_worker_kv_offer_acks_total",
                              outcome="ok"))
            planes = {p: _metric(m1, "dynamo_worker_disagg_kv_bytes_total",
                                 direction="pulled", plane=p)
                      - _metric(m0, "dynamo_worker_disagg_kv_bytes_total",
                                direction="pulled", plane=p)
                      for p in ("direct", "bulk", "rpc")}
            book = {}
            for eps in _stats_plane(stack.coord, "tpu").values():
                for st in eps.values():
                    book.update((st.get("data") or {}).get("kv_transfer")
                                or {})
            log(f"[disagg] timed {tag} (phase 4's requests, seed {seed}): "
                f"{r['tokens']} tokens in {r['wall']:.4f} s: "
                f"{r['tok_s']:.2f} tok/s; client TTFT p50="
                f"{r['ttft_p50']:.4f} s mean={r['ttft_mean']:.4f} s max="
                f"{r['ttft_max']:.4f} s; remote prefills (direct pulls "
                f"acked) {int(acks)}; pulled bytes by plane "
                f"{ {k: int(v) for k, v in planes.items()} }; bandwidth "
                f"book {book}")
            if int(acks) != r["n"]:
                raise AssertionError(f"{int(acks)} remote prefills for "
                                     f"{r['n']} requests")
            if planes["bulk"] or planes["rpc"] or planes["direct"] <= 0:
                raise AssertionError(f"pulls left the device-direct plane: "
                                     f"{planes}")
        pre1, dec1 = stack.metrics("prefill"), stack.metrics("decode")
        head = 'dynamo_worker_kernel_launches_total{kernel="'
        for k in ("paged_decode", "paged_prefill", "ragged_mixed"):
            key = f'{head}{k}"}}'
            launches[k] = {"prefill": int(pre1.get(key, 0)
                                          - pre0.get(key, 0)),
                           "decode": int(dec1.get(key, 0)
                                         - dec0.get(key, 0))}
        log(f"[disagg] kernel launches over the identity and timed passes: "
            f"{launches}")
        if launches["paged_prefill"]["prefill"] \
                + launches["ragged_mixed"]["prefill"] <= 0 \
                or launches["paged_decode"]["decode"] <= 0:
            raise AssertionError("B2/B3 in the prefill worker or B1 in the "
                                 "decode worker never launched")
        drain_drill(stack, model, cfg)
    except Exception:
        stack.tails()
        raise
    finally:
        stack.stop()
    # prefill-first: a fresh stack, the prefill worker the entry point
    stack = _Stack(os.path.join(work, "prefill_first"))
    os.makedirs(stack.work, exist_ok=True)
    t0 = time.perf_counter()
    try:
        stack.start_coordinator()
        pf = ["--disagg-strategy", "prefill_first"]
        stack.start_worker("prefill", _worker_args(
            model_dir, stack.coord,
            ["--disagg", "prefill", "--component", "prefill"] + pf))
        stack.start_worker("decode", _worker_args(
            model_dir, stack.coord, ["--disagg", "decode"] + pf))
        stack.start_frontend()
        for name in ("prefill", "decode"):
            stack.kids[name].wait_for("torch worker serving model")
        model = stack.model()
        log(f"[disagg] prefill-first stack up in "
            f"{time.perf_counter() - t0:.1f} s")
        m0 = stack.metrics("decode")
        _identity_check(stack, model, "prefill-first", ref)
        m1 = stack.metrics("decode")
        direct = (_metric(m1, "dynamo_worker_disagg_kv_bytes_total",
                          direction="pulled", plane="direct")
                  - _metric(m0, "dynamo_worker_disagg_kv_bytes_total",
                            direction="pulled", plane="direct"))
        other = sum(_metric(m1, "dynamo_worker_disagg_kv_bytes_total",
                            direction="pulled", plane=p)
                    - _metric(m0, "dynamo_worker_disagg_kv_bytes_total",
                              direction="pulled", plane=p)
                    for p in ("bulk", "rpc"))
        log(f"[disagg] prefill-first pulls: {int(direct)} bytes on the "
            f"device-direct plane, {int(other)} on the host planes")
        if direct <= 0 or other:
            raise AssertionError("prefill-first pulls left the "
                                 "device-direct plane")
    except Exception:
        stack.tails()
        raise
    finally:
        stack.stop()
    return {k: v["prefill"] + v["decode"] for k, v in launches.items()}


def drain_drill(stack, model, cfg) -> None:
    """6(c), on the decode-first stack: see ``phase_disagg``. The local
    prefill threshold is raised to one page first (the coordinator's
    hot-reloaded disagg conf), so a resumed stream's partial last block
    is computed where it resumes, and every prompt still prefills
    remotely."""
    import threading
    _set_disagg_conf(stack.coord, {"max_local_prefill_length": PS})
    t0 = time.perf_counter()
    stack.start_worker("decode2", _worker_args(
        model_dir=os.path.join(ROOT, "build", "serve_entry", "llama32_3b"),
        coord=stack.coord, extra=["--disagg", "decode"]))
    stack.kids["decode2"].wait_for("torch worker serving model")
    time.sleep(2.0)                 # the frontend's router sees it
    log(f"[drill] a second decode worker joined in "
        f"{time.perf_counter() - t0:.1f} s")
    names = ("decode", "decode2")
    base0 = {n: stack.metrics(n) for n in names}
    prompts = serve_prompts(cfg.vocab_size, DRILL_SEED, DRILL_N)
    res = [None] * DRILL_N

    def one(i):
        try:
            res[i] = http_stream(f"{stack.base}/v1/completions", {
                "model": model, "prompt": prompts[i],
                "max_tokens": DRILL_TOKENS, "temperature": 0,
                "nvext": {"ignore_eos": True}})
        except Exception as e:                  # reported below
            res[i] = {"error": repr(e)}

    def decoded(m):
        return sum(v for k, v in m.items()
                   if k.startswith("dynamo_worker_decode_dispatches"))

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(DRILL_N)]
    for t in threads:
        t.start()
    # the drain lands on the first decode worker (its block graphs are
    # captured, so its streams decode at once) once every drill stream is
    # routed, every one it holds has pulled its prefill's KV, and it has
    # decoded since: they are all mid-decode, hundreds of tokens from
    # their end
    victim, survivor = names

    def delta(m, n, name, **lab):
        return _metric(m, name, **lab) - _metric(base0[n], name, **lab)
    deadline = time.monotonic() + ENTRY_TIMEOUT_S
    since = None
    while True:
        mid, other = stack.metrics(victim), stack.metrics(survivor)
        held = delta(mid, victim, "dynamo_worker_requests_total",
                     outcome="admitted")
        routed = held + delta(other, survivor, "dynamo_worker_requests_total",
                              outcome="admitted")
        acks_victim = delta(mid, victim, "dynamo_worker_kv_offer_acks_total",
                            outcome="ok")
        if routed == DRILL_N and held >= 1 and acks_victim == held:
            if since is None:
                since = decoded(mid)
            elif decoded(mid) > since:
                break
        if time.monotonic() > deadline:
            raise TimeoutError(f"{victim} never decoded the drill streams")
        time.sleep(0.02)
    http_post(f"http://127.0.0.1:{stack.sys[victim]}/drain", {})
    for t in threads:
        t.join(ENTRY_TIMEOUT_S)
    bad = [(i, r) for i, r in enumerate(res)
           if r is None or r.get("finish") != "length"
           or (r.get("usage") or {}).get("completion_tokens", DRILL_TOKENS)
           != DRILL_TOKENS]
    end = stack.metrics(survivor)

    def d(name, **lab):
        return _metric(end, name, **lab) - _metric(base0[survivor], name,
                                                    **lab)
    resumes = d("dynamo_worker_migration_replays_total", mode="resume")
    replays = d("dynamo_worker_migration_replays_total", mode="replay")
    acks_survivor = d("dynamo_worker_kv_offer_acks_total", outcome="ok")
    rpc = d("dynamo_worker_disagg_kv_bytes_total", direction="pulled",
            plane="rpc")
    log(f"[drill] {DRILL_N} streams of {DRILL_TOKENS} tokens; {victim} "
        f"held {int(held)} of them, decoding, when POST /drain hit it; "
        f"survivor {survivor}: resumed {int(resumes)}, replayed "
        f"{int(replays)}, pulled {int(rpc)} bytes of frozen KV over RPC; "
        f"remote prefills {int(acks_victim)} + {int(acks_survivor)}")
    if bad:
        raise AssertionError(f"streams lost in the drain: {bad}")
    if resumes < 1 or replays != 0 or rpc <= 0:
        raise AssertionError("the survivor did not resume the frozen "
                             "streams from pulled KV")
    if int(acks_victim + acks_survivor) != DRILL_N:
        raise AssertionError("a prefill ran again for a resumed stream")
    stack.kids[victim].proc.wait(60)
    log(f"[drill] {victim} exited with {stack.kids[victim].proc.returncode} "
        f"after its drain")


# -- phase 7: the planner's path ----------------------------------------------

# the planner's workers run the engine the profile measured (the profile
# CLI's sizes: 4096 pages of 16, 32 rows, 1024-token prefill chunks, 4096
# positions): two prefill workers and a decode worker, each 6.4 GB of
# weights and 7.5 GB of cache, fit on the card together
PLANNER_SIZES = dict(SERVE_SIZES, num_pages=4096, max_prefill_chunk=1024)
PLANNER_ISL = 2048          # the load step's prompt length (the profile's
                            # longest row)
PLANNER_TOKENS = 8          # its completion length
PLANNER_CLIENTS = 16        # the step's clients, each a request at a time
PLANNER_INTERVAL_S = 3.0    # the planner's --interval (its predictor is
                            # its default, an EWMA of rate and isl)
PLANNER_HEADROOM = 1.15     # PlannerConfig.headroom (the reference's)
PLANNER_STEP_MAX_S = 150.0  # the load step ends by then if the pool never
                            # reached 2 (the phase then fails)
PLANNER_DRAIN_S = 120.0     # the step's answers must all be in by then
PLANNER_WARM = 4            # warming requests; the last 3 give the TTFT


def planner_profile(model_dir: str, work: str, card: str):
    """7(a): the port's profiler CLI in this process, ``--engine torch
    --random-weights`` on phase 5's model directory with the CLI's default
    sweep. Returns (the profile, the profile file, the wrappers'
    launches)."""
    from dynamo_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from dynamo_tpu_torch.planner import profile as prof
    from dynamo_tpu_torch.planner.perf_interpolation import (
        MultiPerfInterpolator)
    out = os.path.join(work, "profile.json")
    args = prof.build_parser().parse_args(
        ["--engine", "torch", "--random-weights", "--model-path", model_dir,
         "--output", out])
    built = []
    real = prof._build_torch

    def build(a):                   # keep the engine to read its counters
        built.append(real(a))
        return built[-1]
    prof._build_torch = build
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        profile = asyncio.run(prof.amain(args))
    finally:
        prof._build_torch = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in ("paged_decode", "paged_prefill",
                                         "ragged_mixed")}
    calls = dict(built[0].kernel_launches)
    del built
    gc.collect()
    torch.cuda.empty_cache()
    block = BLOCK_MS.get(("llama", llama_cfg().moe_backend, "greedy"))
    log(f"[planner] ({card}) 7(a) profile of TorchEngine (Llama-3.2-3B, "
        f"random weights, isl {args.isl}, concurrency {args.concurrency}, "
        f"osl {args.osl}) in {wall:.1f} s")
    for r in profile["prefill"]:
        log(f"[planner] ({card}) prefill isl={r['isl']}: ttft_s="
            f"{r['ttft_s']!r} tokens_per_s={r['tokens_per_s']!r}")
    for r in profile["decode"]:
        log(f"[planner] ({card}) decode concurrency={r['concurrency']}: "
            f"itl_s={r['itl_s']!r} tokens_per_s={r['tokens_per_s']!r}; "
            f"a replayed block token (B=16, ctx 1024, phase 4, all 28 "
            f"layers) "
            + (f"{block:.3f} ms" if block else "not measured in this run"))
    log(f"[planner] ({card}) the wrappers' CUDA launches {launches}; the "
        f"engine's attention calls {calls} (B3: {launches['ragged_mixed']} "
        f"launches)")
    if len(profile["prefill"]) != 4 or len(profile["decode"]) != 6:
        raise AssertionError("the profile has not 4 prefill and 6 decode "
                             "rows")
    for r in profile["prefill"]:
        if not all(math.isfinite(r[k]) and r[k] > 0
                   for k in ("ttft_s", "tokens_per_s")):
            raise AssertionError(f"prefill row {r}")
    for r in profile["decode"]:
        if not (math.isfinite(r["itl_s"]) and r["itl_s"] >= 0
                and math.isfinite(r["tokens_per_s"])
                and r["tokens_per_s"] > 0):
            raise AssertionError(f"decode row {r}")
    MultiPerfInterpolator.from_file(out)
    for k in ("paged_decode", "paged_prefill"):
        if launches[k] <= 0 or calls.get(k, 0) <= 0:
            raise AssertionError(f"{k} never launched in the profile")
    return profile, out, launches


def planner_mocker(profile: dict, vocab: int, card: str) -> None:
    """7(b): the mocker with the constants ``calibrate_mock_args`` fits to
    7(a)'s profile, profiled the same way (reported, not gated)."""
    from dynamo_tpu_torch.mocker import MockEngineArgs, MockerEngine
    from dynamo_tpu_torch.planner import profile as prof
    fit = prof.calibrate_mock_args(profile)
    isls = [r["isl"] for r in profile["prefill"]]
    concs = [r["concurrency"] for r in profile["decode"]]
    speedup = 10.0                  # the profile CLI's default
    engine = MockerEngine(MockEngineArgs(
        num_pages=4096, page_size=PS, max_num_seqs=max(concs),
        max_prefill_chunk=1024, max_context=4096, speedup_ratio=speedup,
        vocab_size=vocab, **fit))

    async def run():
        try:
            return await prof.profile_engine(
                engine, isls=isls, concurrencies=concs,
                osl=profile["meta"]["osl"], vocab=vocab, time_scale=speedup)
        finally:
            await engine.stop()
    mock = asyncio.run(run())
    log(f"[planner] ({card}) 7(b) the mocker fitted to the card: {fit}")
    for got, want in zip(mock["prefill"], profile["prefill"]):
        log(f"[planner] ({card}) prefill isl={want['isl']}: mocker ttft_s "
            f"{got['ttft_s']!r} / card {want['ttft_s']!r} = "
            f"{got['ttft_s'] / want['ttft_s']:.3f}")
    for got, want in zip(mock["decode"], profile["decode"]):
        ratio = (f"{got['itl_s'] / want['itl_s']:.3f}" if want["itl_s"]
                 else "n/a")
        log(f"[planner] ({card}) decode concurrency={want['concurrency']}: "
            f"mocker itl_s {got['itl_s']!r} / card {want['itl_s']!r} = "
            f"{ratio}; tokens_per_s {got['tokens_per_s']!r} / "
            f"{want['tokens_per_s']!r} = "
            f"{got['tokens_per_s'] / want['tokens_per_s']:.3f}")


def _planner_workers(log_text: str) -> dict:
    """Worker (role, generation) -> (pid, system port), from the planner's
    ``spawned <role> worker pid=.. port=.. log=<dir>/<role>-g<gen>.log``
    lines."""
    import re
    return {(m.group(1), int(m.group(4))): (int(m.group(2)),
                                            int(m.group(3)))
            for m in re.finditer(
                r"spawned (prefill|decode) worker pid=(\d+) port=(\d+) "
                r"log=\S*-g(\d+)\.log", log_text)}


def _ready(port: int) -> bool:
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz/ready", timeout=2) as r:
            return r.status == 200
    except (urllib.error.URLError, OSError):
        return False


def _load_step(base, model, prompts, until, res, progress):
    """``PLANNER_CLIENTS`` clients, each sending ``prompts`` (token ids,
    non-streamed completions of ``PLANNER_TOKENS`` tokens with EOS
    ignored) one request at a time until ``until()`` says stop; then
    waits for the answers up to ``PLANNER_DRAIN_S``. ``res`` gets each
    request's (finish, completion tokens) or its error; ``progress`` is
    called about every 5 s. Returns (sent, seconds sending, seconds to the
    last answer)."""
    import itertools
    import threading
    order = itertools.count()
    lock = threading.Lock()

    def client():
        while not until():
            with lock:
                i = next(order)
                res.append(None)
            try:
                r = http_post(f"{base}/v1/completions", {
                    "model": model,
                    "prompt": prompts[i % len(prompts)].tolist(),
                    "max_tokens": PLANNER_TOKENS, "temperature": 0,
                    "nvext": {"ignore_eos": True}})
                res[i] = (r["choices"][0]["finish_reason"],
                          r["usage"]["completion_tokens"])
            except Exception as e:              # reported by the caller
                res[i] = ("error", repr(e))
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(PLANNER_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    while not until():
        time.sleep(5.0)
        progress(len(res), time.perf_counter() - t0)
    sent = time.perf_counter() - t0
    deadline = time.perf_counter() + PLANNER_DRAIN_S
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    return len(res), sent, time.perf_counter() - t0


def _frontend_ttft(m0: dict, m1: dict) -> float:
    """The frontend's mean TTFT between two scrapes of its ``/metrics``:
    what the planner's ``PrometheusSource`` reads as ``observed_ttft_s``."""
    def total(m, stat):
        head = f"dynamo_frontend_time_to_first_token_seconds_{stat}"
        return sum(v for k, v in m.items() if k.startswith(head))
    n = total(m1, "count") - total(m0, "count")
    return (total(m1, "sum") - total(m0, "sum")) / n if n else float("nan")


def planner_closed_loop(model_dir, work, profile_path, profile, card):
    """7(c): the port's coordinator and frontend as processes, and
    ``python -m dynamo_tpu_torch.planner.main --connector local`` spawning
    the port's disaggregated workers on the card (``--disagg prefill`` /
    ``--disagg decode``, random weights, ``PLANNER_SIZES``): min 1 / 1, at
    most 2 prefill and 1 decode workers. A load step that saturates the
    pair (``PLANNER_CLIENTS`` clients of ``PLANNER_ISL``-token prompts),
    which the planner's arithmetic over (a)'s profile sizes at 2 prefill
    workers once the pair delivers more than a fourth of the profiled
    prefill rate over the headroom, must take the pool from 1 to 2, the
    gauge reaching 2 only once the new worker's ``/healthz/ready`` answers
    200; when it ends, the pool must return to 1 by a drain. Every request
    of the step must finish with its tokens, no worker crash may be
    counted, and the workers' ``/metrics`` must show B1 and B2 launched.
    Returns the kernels' launches over the workers."""
    import shlex
    import signal

    from dynamo_tpu_torch.planner.perf_interpolation import PerfInterpolator
    cfg = llama_cfg()
    interp = PerfInterpolator(profile)
    tps = interp.prefill_tokens_per_s(PLANNER_ISL)
    stack = _Stack(work)
    logs = os.path.join(work, "workers")
    os.makedirs(logs, exist_ok=True)
    worker = [sys.executable, "-m", "dynamo_tpu_torch.worker.main"]
    t0 = time.perf_counter()
    planner = None
    launches = {}
    try:
        stack.start_coordinator()
        stack.start_frontend()
        pre_cmd = worker + _worker_args(
            model_dir, stack.coord, ["--disagg", "prefill", "--component",
                                     "prefill"], PLANNER_SIZES)
        dec_cmd = worker + _worker_args(
            model_dir, stack.coord, ["--disagg", "decode"], PLANNER_SIZES)
        plan_port = free_port()
        planner = Child(
            "planner", "dynamo_tpu_torch.planner.main",
            ["--connector", "local", "--profile", profile_path,
             "--metrics-url", f"{stack.base}/metrics",
             "--interval", str(PLANNER_INTERVAL_S), "--predictor",
             "ewma", "--min-prefill", "1", "--max-prefill", "2",
             "--min-decode", "1", "--max-decode", "1",
             "--prefill-cmd", shlex.join(pre_cmd),
             "--decode-cmd", shlex.join(dec_cmd),
             "--worker-log-dir", logs], work,
            {"DYN_SYSTEM_ENABLED": "1", "DYN_SYSTEM_PORT": str(plan_port)})
        stack.kids["planner"] = planner
        planner.wait_for("planner running")
        gauge = 'dynamo_planner_replicas{role="prefill"}'

        def pm():
            return scrape_metrics(plan_port)
        deadline = time.monotonic() + ENTRY_TIMEOUT_S
        while not (pm().get(gauge) == 1.0 and pm().get(
                'dynamo_planner_replicas{role="decode"}') == 1.0):
            if time.monotonic() > deadline:
                raise TimeoutError("the planner's floor of 1 / 1 never "
                                   "became ready")
            time.sleep(0.2)
        model = stack.model()
        log(f"[planner] ({card}) coordinator, frontend, planner and its 1 "
            f"prefill + 1 decode workers up in "
            f"{time.perf_counter() - t0:.1f} s")
        # fresh prompts (no prefix hits) for every request the step can
        # send: a few a second for at most PLANNER_STEP_MAX_S
        prompts = np.random.default_rng(13).integers(
            3, cfg.vocab_size, size=(1024, PLANNER_ISL))
        # a warming pass, one request at a time; the frontend's TTFT over
        # its last requests (what the planner reads) is reported
        fe0 = None
        for i, p in enumerate(prompts[:PLANNER_WARM]):
            if i == 1:
                fe0 = scrape_metrics_url(f"{stack.base}/metrics")
            r = http_post(f"{stack.base}/v1/completions", {
                "model": model, "prompt": p.tolist(),
                "max_tokens": PLANNER_TOKENS,
                "temperature": 0, "nvext": {"ignore_eos": True}})
            if r["usage"]["completion_tokens"] != PLANNER_TOKENS:
                raise AssertionError(f"a warming request: {r}")
        prompts = prompts[PLANNER_WARM:]
        ttft = _frontend_ttft(fe0, scrape_metrics_url(f"{stack.base}/metrics"))
        profiled = interp.ttft(PLANNER_ISL)
        corr = max(0.25, min(4.0, ttft / profiled))
        floor = tps / (4.0 * PLANNER_HEADROOM)
        log(f"[planner] ({card}) 7(c) the load step: {PLANNER_CLIENTS} "
            f"clients, each sending {PLANNER_ISL}-token prompts of "
            f"{PLANNER_TOKENS} tokens one at a time. The planner's prefill "
            f"need is r * isl / tokens_per_s(isl) * c * headroom: r the "
            f"completions a second it scrapes, c the frontend's TTFT over "
            f"the profile's, clamped to 0.25-4. The profile gives "
            f"{tps:.1f} tokens/s and {profiled * 1e3:.2f} ms at "
            f"{PLANNER_ISL}; one request at a time the frontend saw "
            f"{ttft * 1e3:.2f} ms (c = {corr:.3f}), and a saturated pair "
            f"queues, so c = 4: the need passes 1, and the pool 2, once the "
            f"pair delivers more than {tps:.1f} / (4 * {PLANNER_HEADROOM}) "
            f"= {floor:.1f} prompt tokens/s ({floor / PLANNER_ISL:.3f} "
            f"requests/s)")
        # the monitor: the planner's gauge, then the readiness of every
        # prefill worker spawned after the first (in that order: a gauge of
        # 2 read before probes that all fail would be a worker banked
        # before it was ready)
        import threading
        state = {"two_at": None, "ready_at": None, "gated": 0, "bad": [],
                 "one_again_at": None, "stop": False, "metrics": {},
                 "last": {}, "was_ready": set()}

        def extra_prefill(kids):
            gens = sorted(g for (r, g) in kids if r == "prefill")
            return {g: kids[("prefill", g)] for g in gens[1:]}

        def monitor():
            tick = 0
            while not state["stop"]:
                tick += 1
                try:
                    m = pm()
                except OSError:
                    time.sleep(0.05)
                    continue
                state["last"] = m
                g = m.get(gauge)
                kids = _planner_workers(planner.text())
                now = time.perf_counter()
                extra = extra_prefill(kids)
                ready = {gen for gen, (_pid, port) in extra.items()
                         if _ready(port)}
                state["was_ready"] |= ready
                if ready and state["ready_at"] is None:
                    state["ready_at"] = now
                if g == 2.0 and state["two_at"] is None:
                    state["two_at"] = now
                    if not ready:
                        state["bad"].append(now)
                elif g == 1.0 and state["two_at"] is None and any(
                        _pid_alive(pid) for gen, (pid, _p) in extra.items()
                        if gen not in ready):
                    state["gated"] += 1
                if g == 1.0 and state["two_at"] is not None and \
                        state["one_again_at"] is None:
                    state["one_again_at"] = now
                for key, (_pid, port) in kids.items():
                    if tick % 20:       # the workers' counters once a second
                        break
                    try:
                        state["metrics"][key] = scrape_launches(port)
                    except OSError:
                        pass            # not up yet, or gone
                time.sleep(0.05)
        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        res = []
        t1 = time.perf_counter()

        def until():
            two = state["two_at"]
            return ((two is not None
                     and time.perf_counter() - two > 2 * PLANNER_INTERVAL_S)
                    or time.perf_counter() - t1 > PLANNER_STEP_MAX_S)
        def progress(n_sent, secs):
            done = sum(r is not None for r in res)
            errs = sum(r is not None and r[0] == "error" for r in res)
            log(f"[planner] ({card}) step +{secs:.0f} s: {n_sent} sent, "
                f"{done} answered ({errs} errors); prefill gauge "
                f"{state['last'].get(gauge)}; a new worker "
                + ("ready" if state["ready_at"] else "not ready"))
        fe1 = scrape_metrics_url(f"{stack.base}/metrics")
        n, sent, wall = _load_step(stack.base, model, prompts, until, res,
                                   progress)
        step_end = time.perf_counter()
        fe2 = scrape_metrics_url(f"{stack.base}/metrics")
        delivered = (sum(1 for r in res if r == ("length", PLANNER_TOKENS))
                     / wall)
        need = (delivered * PLANNER_ISL / tps
                * max(0.25, min(4.0, _frontend_ttft(fe1, fe2) / profiled))
                * PLANNER_HEADROOM)
        bad = [(i, r) for i, r in enumerate(res)
               if r != ("length", PLANNER_TOKENS)]
        up = (state["two_at"] - t1) if state["two_at"] else None
        log(f"[planner] ({card}) load step: {n} requests over {sent:.1f} "
            f"s, all answered in {wall:.1f} s: {delivered:.3f} requests/s, "
            f"{delivered * PLANNER_ISL:.1f} prompt tokens/s; frontend TTFT "
            f"{_frontend_ttft(fe1, fe2):.4f} s; the arithmetic over the "
            f"whole step: need {need:.3f}; prefill pool at 2 "
            + (f"{up:.1f} s into the step" if up is not None else "never")
            + f"; a new prefill worker answered ready "
            + (f"{state['ready_at'] - t1:.1f} s into it"
               if state["ready_at"] else "never")
            + f"; the gauge read 1 in {state['gated']} scrapes while a new "
              f"worker was alive and not ready")
        if bad:
            raise AssertionError(f"{len(bad)} requests of the step did not "
                                 f"finish with {PLANNER_TOKENS} tokens: "
                                 f"{bad[:5]}")
        if state["two_at"] is None:
            raise AssertionError("the prefill pool never reached 2")
        if state["bad"] or state["ready_at"] is None or \
                state["ready_at"] > state["two_at"] or state["gated"] < 1:
            raise AssertionError("the gauge counted a second prefill worker "
                                 "before its /healthz/ready answered 200")
        deadline = time.monotonic() + ENTRY_TIMEOUT_S
        while state["one_again_at"] is None or any(
                _pid_alive(pid) for pid, _port in extra_prefill(
                    _planner_workers(planner.text())).values()):
            if time.monotonic() > deadline:
                raise TimeoutError("the prefill pool never drained back to "
                                   "1")
            time.sleep(0.2)
        down = time.perf_counter() - step_end
        m = pm()
        drained = {}            # each new worker that was ready: drained?
        for gen in sorted(state["was_ready"]):
            with open(os.path.join(logs, f"prefill-g{gen}.log"),
                      errors="replace") as f:
                text = f.read()
            drained[f"prefill-g{gen}"] = ("graceful drain started" in text
                                          and "drain complete" in text)
        crashes = {r: m.get(f'dynamo_planner_worker_crashes_total'
                            f'{{role="{r}"}}') for r in ("prefill", "decode")}
        decisions = {a: m.get(f'dynamo_planner_decisions_total'
                              f'{{action="{a}"}}')
                     for a in ("up", "down", "hold")}
        state["stop"] = True
        mon.join(10)
        for key, (_pid, port) in _planner_workers(planner.text()).items():
            try:                    # the live workers' final counts
                state["metrics"][key] = scrape_launches(port)
            except OSError:
                pass
        for k in ("paged_decode", "paged_prefill", "ragged_mixed"):
            launches[k] = int(sum(v.get(k, 0)
                                  for v in state["metrics"].values()))
        per = {f"{r}-g{g}": {k: int(v.get(k, 0)) for k in launches}
               for (r, g), v in state["metrics"].items()}
        log(f"[planner] ({card}) back to 1 prefill worker {down:.1f} s "
            f"after the step (drained: {drained}); decisions "
            f"{decisions}; crashes {crashes}; kernel launches by worker "
            f"{per}")
        if not drained or not all(drained.values()):
            raise AssertionError("a second prefill worker did not leave by "
                                 "a drain")
        if any(crashes.values()):
            raise AssertionError(f"worker crashes counted: {crashes}")
        if launches["paged_decode"] <= 0 or launches["paged_prefill"] <= 0:
            raise AssertionError("B1 or B2 never launched in the planner's "
                                 "workers")
    except Exception:
        stack.tails()
        for name in sorted(os.listdir(logs)):
            with open(os.path.join(logs, name), errors="replace") as f:
                tail = "\n".join(f.read().splitlines()[-40:])
            log(f"[planner] last 40 lines of {name}:\n{tail}")
        raise
    finally:
        if planner is not None and planner.proc.poll() is None:
            # SIGINT: the planner closes its connector, which drains and
            # waits for every worker it spawned
            planner.proc.send_signal(signal.SIGINT)
            try:
                planner.proc.wait(90)
            except subprocess.TimeoutExpired:
                pass
        stack.stop()
    return launches


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie: the planner has not reaped it yet
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def phase_planner() -> dict:
    """7: the planner's path on the card. (a) the port's profiler on
    TorchEngine, (b) the mocker fitted to it, (c) the SLA planner scaling
    the port's workers in a closed loop. Returns the kernels' launches:
    the profiler's engine plus the planner's workers."""
    card = smi_line().strip()
    cfg = entry_cfg()
    work = os.path.join(ROOT, "build", "planner")
    os.makedirs(work, exist_ok=True)
    model_dir = os.path.join(ROOT, "build", "serve_entry", "llama32_3b")
    write_entry_model(model_dir, cfg)
    profile, path, prof_launches = planner_profile(model_dir, work, card)
    planner_mocker(profile, cfg.vocab_size, card)
    workers = planner_closed_loop(model_dir, work, path, profile, card)
    return {k: prof_launches[k] + workers[k] for k in prof_launches}


# -- int8 W8A8, speculative decoding and Gemma-2 ------------------------------


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def phase_int8(params, cfg, _per_step):
    """Llama-3.2-3B under ``quantize_params`` (int8 W8A8): the weight bytes
    on the card against the bf16 tree's; phase 3's steps through the
    kernels and their plain versions, both int8, under phase 3's gate, with
    the distance to the bf16 kernel forward's logits printed (not gated);
    then phase 4's greedy serve (cold and warm) on an int8 engine, every
    kernel launched and every request finished, its warm tok/s beside
    phase 4's bf16 warm serve in this run, and the fused block's graph
    against its eager run (``graph_vs_eager``: its time per block beside
    phase 4's bf16 block). Returns the kernels' launches over the
    serves."""
    from dynamo_tpu_torch.ops.quant import quantize_params
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    layer_bf16 = tree_bytes(params["layers"])
    layer_int8 = tree_bytes(qparams["layers"])
    log(f"[int8] quantized in {time.perf_counter() - t0:.2f} s: layer "
        f"weights {layer_int8 / 1e9:.3f} GB (bf16 {layer_bf16 / 1e9:.3f} "
        f"GB, ratio {layer_int8 / layer_bf16:.3f}); whole tree "
        f"{tree_bytes(qparams) / 1e9:.3f} GB (bf16 "
        f"{tree_bytes(params) / 1e9:.3f} GB; the tied embedding stays bf16)")
    phase_forward(qparams, cfg, llama_impls(), True,
                  compare=("bf16", params))
    del qparams
    gc.collect()
    engine, served, counts = serve_engine(params, cfg,
                                          (COLD_SEED, WARM_SEED),
                                          quantize="int8")
    for (stats, wall, info), tag in zip(served, ("cold", "warm")):
        serve_report(stats, wall, info, f"int8 {tag}")
        check_stats(stats, cfg)
    log(f"[int8] launches={counts}; engine weights on the card "
        f"{tree_bytes(engine.params) / 1e9:.3f} GB")
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched in the int8 "
                                 "serve")
    stats, wall, _info = served[1]
    tok_s = sum(len(s["tokens"]) for s in stats.values()) / wall
    bf16 = PHASE4_WARM.get(cfg.model_type, {})
    log(f"[int8] warm serve {tok_s:.1f} tok/s against the bf16 warm serve's "
        f"{bf16.get('tok_s', float('nan')):.1f} tok/s in this run")
    graph_vs_eager(engine)
    return counts


def repeated_span_prompts(ref, span=64, seen=16):
    """Prompts that repeat a span, made from the per-step serve's streams
    ``ref``: each prompt, the first ``seen`` tokens the model generated
    after it, then the prompt's last ``span`` tokens again. Where the
    model continues the repeated span as it did the first time, the
    n-gram proposer drafts what followed it then."""
    return [s["prompt"] + s["tokens"][:seen] + s["prompt"][-span:]
            for _i, s in sorted(ref.items())]


def oracle_proposer(streams):
    """A proposer that drafts, for a row whose context is a prefix of one
    of ``streams`` (prompt + greedy tokens), that stream's continuation;
    None for any other row (the row then decodes plainly)."""
    def propose(tokens, k, max_n=4, min_n=2):
        n = len(tokens)
        for full in streams:
            if n < len(full) and list(tokens) == full[:n]:
                cont = full[n:n + k]
                return cont + [cont[-1]] * (k - len(cont))
        return None
    return propose


def spec_report(engine, stats, wall, info, tag):
    """Print a speculating serve's verify steps, drafted rows, acceptance
    rate and tokens per verify step (per drafted row); returns the
    engine's spec counters."""
    serve_report(stats, wall, info, tag)
    st = engine.stats().spec_decode_stats
    verify = sum(1 for r in info["records"] if r["kind"] == "spec")
    rate = st.num_accepted_tokens / max(st.num_draft_tokens, 1)
    per_row = 1 + st.num_accepted_tokens / max(st.num_drafts, 1)
    log(f"[{tag}] K={engine.spec_K}: {verify} verify steps, "
        f"{st.num_drafts} drafted rows, {st.num_draft_tokens} draft tokens, "
        f"{st.num_accepted_tokens} accepted (rate {rate:.3f}); "
        f"{per_row:.3f} tokens per drafted row per verify step")
    return st


def phase_spec(params, cfg, per_step):
    """Speculative decoding at full width, K = 4: a verify step's forward
    through B2 against its plain forward (``spec_plan``, phase 3's gate);
    a serve with n-gram drafts on prompts that repeat a span
    (``repeated_span_prompts``); then phase 4d's per-step workload with
    the proposer fed the per-step serve's greedy streams (the reference's forced-perfect-drafts test at full
    width): drafts must be accepted; it prints the acceptance rate, tokens
    per verify step, tok/s beside the per-step and fused serves of this
    run, and where each stream first leaves the per-step stream, with the
    top-2 margin there. Returns the kernels' launches over the forced
    serve."""
    import dynamo_tpu_torch.engine.scheduler as sched
    phase_forward(params, cfg, llama_impls(), True, plan=spec_plan)
    ref, ref_tok_s = per_step["per-step"]
    engine, served, _counts = serve_engine(
        params, cfg, (WARM_SEED,), spec_tokens=SPEC_K, spec_ngram_min=1,
        serve_kw=dict(prompts=repeated_span_prompts(ref)))
    stats, wall, info = served[0]
    check_stats(stats, cfg)
    spec_report(engine, stats, wall, info, "spec n-gram")
    del engine
    propose = sched.propose_ngram
    sched.propose_ngram = oracle_proposer(
        [s["prompt"] + s["tokens"] for s in ref.values()])
    try:
        engine, served, counts = serve_engine(params, cfg, (WARM_SEED,),
                                              spec_tokens=SPEC_K)
    finally:
        sched.propose_ngram = propose
    stats, wall, info = served[0]
    check_stats(stats, cfg)
    st = spec_report(engine, stats, wall, info, "spec forced")
    tok_s = sum(len(s["tokens"]) for s in stats.values()) / wall
    fused = PHASE4_WARM.get(cfg.model_type, {}).get("tok_s", float("nan"))
    log(f"[spec forced] {tok_s:.1f} tok/s; per-step serve {ref_tok_s:.1f}, "
        f"fused serve {fused:.1f} tok/s in this run; launches={counts}")
    report_agreement("spec forced", engine, stats, ref,
                     "the per-step serve")
    if st.num_accepted_tokens <= 0:
        raise AssertionError("no forced draft was accepted")
    if counts["paged_prefill"] <= 0:
        raise AssertionError("no verify step ran through B2")
    return counts


def phase_spec_mla(params, cfg, per_step):
    """DeepSeek-V2-Lite speculating (K = 4) through B5: phase 4's first four
    requests with the proposer fed the per-step serve's greedy streams;
    drafts must be accepted and the latent prefill kernel must run the
    verify steps. Returns the kernels' launches."""
    import dynamo_tpu_torch.engine.scheduler as sched
    ref, _tok_s = per_step["per-step"]
    propose = sched.propose_ngram
    sched.propose_ngram = oracle_proposer(
        [s["prompt"] + s["tokens"] for s in ref.values()])
    try:
        engine, served, counts = serve_engine(
            params, cfg, (WARM_SEED,), spec_tokens=SPEC_K,
            serve_kw=dict(n_req=4))
    finally:
        sched.propose_ngram = propose
    stats, wall, info = served[0]
    check_stats(stats, cfg)
    st = spec_report(engine, stats, wall, info, "spec mla")
    log(f"[spec mla] launches={counts}")
    report_agreement("spec mla", engine, stats, ref, "the per-step serve")
    if st.num_accepted_tokens <= 0 or counts["mla_prefill"] <= 0:
        raise AssertionError("DeepSeek's verify steps accepted nothing or "
                             "did not run through B5")
    return counts


# Gemma-2-27B's serving sizes: 1280 pages of 16 positions (46 layers x 16
# kv heads: 6 MB a page, 7.7 GB in all beside the 54.5 GB of weights;
# enough for phase 4's workload and the graph-vs-eager block's 1041 pages)
# and its published 8192-position context
GEMMA_SIZES = dict(SERVE_SIZES, num_pages=1280, max_context=8192)
# the served depth of three presets (their widths as published), so the
# script keeps a margin under its time limit on a slower host (whole
# runs on one H100 80GB HBM3 at 700 W: ~1300 s at full depth on a slow
# host, ~880-1035 s on others; with phase 8's pp checks 1223 and 1255 s
# on slow hosts, 941 s on another): every kernel, expert backend and
# check of their phases runs as at full depth. Gemma-2-27B's attention
# geometry stays in phase 2's rows (Gemma-2-9B serves the family at full
# depth); DeepSeek-V2-Lite keeps its dense layer and 2 of its 26 MoE
# layers
GEMMA27_LAYERS = 8          # of 46
DEEPSEEK_LAYERS = 3         # of 27
QWEN3_LAYERS = 4            # of 48
# the served depth of Llama-3.2-3B in the worker processes of phases 5,
# 6(b)-(c), 7 and 8(b) (phase 5's model directory, at its published
# widths): those phases' host work (process starts, eager steps, each
# layer's launches) sets the script's length on a slow host (at all 28
# layers: 1255 s on one, 941 s on another, as above; at 14: 797 s on the
# faster kind); the in-process phases, 6(a) and 8(a) keep all 28
ENTRY_LAYERS = 14           # of 28


def cut_depth(preset: str, layers: int):
    """``ModelConfig.<preset>()`` with ``layers`` of its layers."""
    import dataclasses

    from dynamo_tpu_torch.models.config import ModelConfig
    return dataclasses.replace(getattr(ModelConfig, preset)(),
                               num_layers=layers)


def entry_cfg():
    """Llama-3.2-3B at ``ENTRY_LAYERS``: the worker processes' model."""
    return cut_depth("llama32_3b", ENTRY_LAYERS)


def served_model_phases(name, cfg, failures, profile, plan=gemma_plan,
                        sizes=GEMMA_SIZES, per_step=True):
    """A model at full width and depth in bf16, random weights made on the
    card by its family's ``init_params`` (Gemma-2's a slab at a time):
    ``plan``'s forward check (``gemma_plan``: a prompt past the sliding
    window), phase 4's greedy serve fused (cold and warm, graph vs eager)
    at ``sizes`` and, with ``per_step``, per step. Returns the kernels'
    launches over the fused serves."""
    from dynamo_tpu_torch.models import get_family
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.perf_counter()
    params = get_family(cfg).init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {name} L={cfg.num_layers} H={cfg.hidden_size} "
        f"Hq={cfg.num_heads} Hkv={cfg.num_kv_heads} Dh={cfg.head_dim} "
        f"V={cfg.vocab_size} random weights in "
        f"{time.perf_counter() - t1:.1f} s, {tree_bytes(params) / 1e9:.2f} "
        f"GB; {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the "
        f"card")
    counts = None
    with torch.no_grad():
        run_phase(f"forward {name}",
                  lambda: phase_forward(params, cfg, llama_impls(), True,
                                        plan=plan), failures)
        served = run_phase(f"engine {name}",
                           lambda: phase_engine(params, cfg, sizes),
                           failures)
        counts, fused = served if served else (None, None)
        if fused and per_step:
            run_phase(f"per-step {name}",
                      lambda: phase_per_step(params, cfg, fused,
                                             PER_STEP_MODES[:1], sizes),
                      failures)
        if profile:
            run_phase(f"profile {name}",
                      lambda: phase_profile(params, cfg), failures)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts or {}


def phase_dispatch(params, cfg, _per_step=None, sizes=None):
    """Phase 4's two greedy serves (cold, warm) on an engine whose MoE runs
    the capacity dispatch backend (``moe_backend="dispatch"``, capacity
    factor 2): every request finished, every kernel launched, fused blocks
    replayed; the dropped assignments over both serves (``stats()``'s
    count, fetched once at the end), each warm stream's agreement with the
    dense backend's warm serve of the same requests, and the dispatch
    block's graph against its eager run (``graph_vs_eager``: the block's
    drop count is one of its graph's outputs). Returns the kernels'
    launches over the serves."""
    import dataclasses
    dcfg = dataclasses.replace(cfg, moe_backend="dispatch")
    engine, served, counts = serve_engine(params, dcfg,
                                          (COLD_SEED, WARM_SEED), sizes)
    for (stats, wall, info), tag in zip(served, ("cold", "warm")):
        serve_report(stats, wall, info, f"dispatch {tag}")
        check_stats(stats, cfg)
    dropped = engine.stats().worker_stats.moe_dropped_tokens
    log(f"[dispatch] launches={counts}; {dropped} token-expert assignments "
        f"dropped over both serves (capacity factor "
        f"{dcfg.moe_capacity_factor}, {dcfg.num_experts} experts, top-"
        f"{dcfg.num_experts_per_tok})")
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched in the "
                                 "dispatch serve")
    if engine.multistep_blocks <= 0:
        raise AssertionError("the dispatch serves ran no fused block")
    warm = served[1][0]
    report_agreement("dispatch", engine, warm,
                     PHASE4_STREAMS[cfg.model_type],
                     "the dense backend's warm serve")
    dense = PHASE4_WARM[cfg.model_type]["tok_s"]
    tok_s = sum(len(s["tokens"]) for s in warm.values()) / served[1][1]
    log(f"[dispatch] warm serve {tok_s:.1f} tok/s against the dense "
        f"backend's {dense:.1f} tok/s in this run")
    graph_vs_eager(engine)
    return counts


# Qwen3-30B-A3B's serving sizes: 1280 pages of 16 positions (4 kv heads:
# 32 KiB a layer a page; enough for phase 4's workload and the
# graph-vs-eager block's 1041 pages)
MOE_SIZES = dict(SERVE_SIZES, num_pages=1280)


def moe_phases(failures, profile):
    """Qwen3-30B-A3B at full width, ``QWEN3_LAYERS`` of its 48 layers (128
    experts) in bf16, random weights made on the card a layer at a time:
    phase 3's
    forward check (every layer's B1-B3 against the plain versions, the
    logits under phase 3's gate, the flipped top-8 routes reported: the
    gate's oracle distance flips as many), phase 4's greedy serve fused on
    the dense expert backend
    (cold, warm, graph vs eager), then on the dispatch backend
    (``phase_dispatch``); the replayed block's ms per token against the
    weight floor, and ``memory_allocated`` before and after. Returns the
    kernels' launches over the fused serves of both backends."""
    from dynamo_tpu_torch.models import moe
    cfg = cut_depth("qwen3_30b_a3b", QWEN3_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.perf_counter()
    params = moe.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    log(f"[model] qwen3_30b_a3b L={cfg.num_layers} H={cfg.hidden_size} "
        f"E={cfg.num_experts} top-{cfg.num_experts_per_tok} "
        f"V={cfg.vocab_size} random weights in "
        f"{time.perf_counter() - t1:.1f} s, {weight_bytes / 1e9:.2f} GB; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card")
    counts = {}
    with torch.no_grad():
        run_phase("forward qwen3_30b_a3b",
                  lambda: phase_forward(params, cfg, llama_impls(), True),
                  failures)
        served = run_phase("engine qwen3_30b_a3b",
                           lambda: phase_engine(params, cfg, MOE_SIZES),
                           failures)
        if served:
            counts = dict(served[0])
            got = run_phase("dispatch qwen3_30b_a3b",
                            lambda: phase_dispatch(params, cfg,
                                                   sizes=MOE_SIZES),
                            failures)
            for k, n in (got or {}).items():
                counts[k] += n
        if profile:
            run_phase("profile qwen3_30b_a3b",
                      lambda: phase_profile(params, cfg), failures)
    floor = weight_bytes / HBM_BYTES_PER_S * 1e3
    for (mt, backend, label), ms in sorted(BLOCK_MS.items()):
        if mt == cfg.model_type:
            log(f"[moe] {backend} backend, {label}: a replayed block token "
                f"{ms:.3f} ms against the {floor:.2f} ms weight floor "
                f"({weight_bytes / 1e9:.2f} GB / 3.35 TB/s; both backends "
                f"read every expert): {floor / ms:.0%} of it")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] memory_allocated before the model "
        f"{before / 2 ** 30:.2f} GiB, after it was freed "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return counts



# -- phase 8: two ranks: tp, the KV data plane over it, dp, pp, sp ---------

TP_WORLD = 2
TP_PROBE_TIMEOUT_S = 90
TP_FORWARD_TIMEOUT_S = 600
TP_B = ("paged_decode", "paged_prefill", "ragged_mixed")
# 8(a)'s KV checks: the world engine's pool holds the four prompts' 256
# blocks and 43 more, so four other prompts evict most of them; the host
# tier (whole-head blocks, as the leader gathers them) holds them and the
# other prompts' blocks the onboard evicts in turn
TP_KV_PAGES = 300
TP_KV_HOST_BLOCKS = 600


def tp_rank_main(spec_path: str, local_rank: int) -> int:
    """One rank of phase 8's worlds (``--tp-rank SPEC``): local rank 0
    starts the others (``start_local_ranks``); every rank joins the world
    on the spec's backend and runs the spec's task; each writes its result
    to ``<out>.<rank>``. Tasks: ``probe`` (one all-reduce) and ``forward``
    (``tp_forward_rank``, then ``tp_kv_rank``, ``dp_forward_rank``,
    ``dp_serve_rank``, ``pp_forward_rank``, ``pp_serve_rank``,
    ``sp_forward_rank`` and ``sp_serve_rank`` in the same processes)."""
    import datetime
    from dynamo_tpu_torch.parallel import multihost as mh
    with open(spec_path) as f:
        spec = json.load(f)
    procs = []
    if local_rank == 0:
        procs = mh.start_local_ranks(
            [sys.executable, os.path.abspath(__file__), "--tp-rank",
             spec_path], spec["world"])
    out, rank = {}, local_rank
    world = None
    try:
        world = mh.initialize_distributed(
            spec["address"], 1, 0, spec["world"], local_rank=local_rank,
            device="cuda", backend=spec["backend"],
            timeout=datetime.timedelta(seconds=TP_FORWARD_TIMEOUT_S))
        rank = world.rank
        if spec["task"] == "probe":
            import torch.distributed as dist
            x = torch.full((4,), float(rank + 1), device=world.device)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            out["sum"] = x.tolist()
        else:
            out, ctx = tp_forward_rank(world)
            t0 = time.perf_counter()
            out["kv"] = tp_kv_rank(world, ctx)
            out["kv"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["dp"] = dp_forward_rank(world, ctx)
            out["dp"]["seconds"] = time.perf_counter() - t0
            out["dp_serve"] = dp_serve_rank(world, ctx)
            t0 = time.perf_counter()
            out["pp"] = pp_forward_rank(world, ctx)
            out["pp"]["seconds"] = time.perf_counter() - t0
            out["pp_serve"] = pp_serve_rank(world, ctx)
            t0 = time.perf_counter()
            out["sp"] = sp_forward_rank(world, ctx)
            out["sp"]["seconds"] = time.perf_counter() - t0
            out["sp_serve"] = sp_serve_rank(world, ctx)
    except Exception:                      # noqa: BLE001 — reported
        out["error"] = traceback.format_exc()
    finally:
        with open(f"{spec['out']}.{rank}", "w") as f:
            json.dump(out, f)
        mh.stop_local_ranks(procs, timeout=TP_FORWARD_TIMEOUT_S)
        if "error" not in out:
            mh.shutdown_distributed()
    return 1 if "error" in out else 0


def _step_arrays(step, table, dev):
    _n, _k, toks, pos, total, new, _w = step
    return [torch.from_numpy(np.asarray(x, np.int32)).to(dev)
            for x in (toks, pos, table, total, new)]


def tp_forward_rank(world):
    """Phase 8(a) on one rank: Llama-3.2-3B's whole tree from seed 0 on
    the rank's card (phase 3's weights), phase 3's steps (prefill, mixed,
    decode: B2, B3, B1) through the kernels on the rank's shards at tp=2.
    Rank 0 first runs the same steps at tp=1 on the whole tree, through
    the kernels, their plain versions and the oracle (phase 3's gate: the
    kernels' logits may be no further from the tp=1 ones than 1.5 times
    plain vs oracle), recording each layer's attention of its own heads;
    it returns, per step, the tp=2 logits' distance to the tp=1 kernel
    forward's, the gate, and the greatest per-layer attention distance.
    Every rank returns its launches of B1-B3 in the tp=2 forward. Returns
    (result, context): the context keeps the whole tree, the plan and rank
    0's tp=1 logits for ``tp_kv_rank`` and ``dp_forward_rank``."""
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from dynamo_tpu_torch.parallel.sharding import (ModelSharding,
                                                    local_config)
    cfg = llama_cfg()
    fam = get_family(cfg)
    dev = world.device
    gen = torch.Generator(device=dev).manual_seed(0)
    full = fam.init_params(cfg, gen, device=dev)
    kernel, plain, oracle = llama_impls()
    steps, table, num_pages = llama_plan(cfg, np.random.default_rng(1))
    mesh = make_mesh(MeshSpec(tp=world.world))
    heads = cfg.num_heads // world.world
    h0 = mesh.coords["tp"] * heads

    def recorder(impl, into):
        def attn(*a, **kw):
            out = impl(*a, **kw)
            into.append(out)
            return out
        return attn

    ref = {}
    with torch.no_grad():
        if world.leader:
            caches = {k: fam.make_pages(cfg, num_pages, PS, device=dev)
                      for k in ("kernel", "plain", "oracle")}
            for step in steps:
                a = _step_arrays(step, table, dev)
                rec = []
                got = {}
                for k, impl in (("kernel", recorder(kernel[step[1]], rec)),
                                ("plain", plain[step[1]]),
                                ("oracle", oracle)):
                    got[k] = fam.forward(full, cfg, a[0], a[1], caches[k],
                                         a[2], a[3], a[4], attn_impl=impl)[0]
                ref[step[0]] = (got["kernel"], float(
                    (got["plain"] - got["oracle"]).abs().max()),
                    [r[:, :, h0:h0 + heads].clone() for r in rec])
            stage_sha = _stage_digests(caches["kernel"], PP_WORLD, table)
            del caches
        shard = ModelSharding(cfg, mesh, device=dev)
        params = shard.shard_params(full)
        gc.collect()
        torch.cuda.empty_cache()
        lcfg = local_config(cfg, mesh)
        pages = shard.shard_pages(fam.make_pages(cfg, num_pages, PS,
                                                 device=dev))
        before = {k: LAUNCHES.get(k, 0) for k in TP_B}
        out = {"rank": world.rank, "steps": {}}
        for step in steps:
            a = _step_arrays(step, table, dev)
            rec = []
            logits = fam.forward(params, lcfg, a[0], a[1], pages, a[2],
                                 a[3], a[4],
                                 attn_impl=recorder(kernel[step[1]], rec),
                                 mesh=mesh)[0]
            torch.cuda.synchronize()
            if world.leader:
                lk, odiff, ref_attn = ref[step[0]]
                real = (torch.arange(a[0].shape[1], device=dev)[None, :]
                        < a[4][:, None])
                layer = [float((x.float() - y.float()).abs()[real].max())
                         for x, y in zip(rec, ref_attn)]
                out["steps"][step[0]] = {
                    "diff": float((logits - lk).abs().max()),
                    "tol": LOGITS_VS_ORACLE * odiff, "odiff": odiff,
                    "max_logit": float(lk.abs().max()),
                    "finite": bool(torch.isfinite(logits).all()),
                    "argmax_same": float((logits.argmax(-1)
                                          == lk.argmax(-1)).float().mean()),
                    "layer_max": max(layer), "layers": len(layer),
                    "attn_max": max(float(r.float().abs().max())
                                    for r in ref_attn)}
        out["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    del params, pages
    ctx = {"full": full, "plan": (steps, table, num_pages),
           "ref": {k: v[:2] for k, v in ref.items()}}
    if world.leader:
        out["tp1_stage_sha"] = stage_sha
    return out, ctx


IPC_ROUND_TRIP = r"""
import hashlib, json, os, sys, time
sys.modules["jax"] = None
import torch
from dynamo_tpu_torch.engine.transfer import DeviceTransferPlane
from dynamo_tpu_torch.runtime.codec import pack, unpack
offer = unpack(open(sys.argv[1], "rb").read())
plane = DeviceTransferPlane()
torch.cuda.init()
t0 = time.perf_counter()
data = plane.pull(offer)
secs = time.perf_counter() - t0
host = data.contiguous().view(torch.int16).cpu().numpy()
back = plane.offer_array(data)
with open(sys.argv[2] + ".tmp", "wb") as f:
    f.write(pack(back))
os.replace(sys.argv[2] + ".tmp", sys.argv[2])
print(json.dumps({"sha256": hashlib.sha256(host.tobytes()).hexdigest(),
                  "seconds": secs, "bytes": data.nbytes}), flush=True)
while not os.path.exists(sys.argv[3]):
    time.sleep(0.05)
"""


async def _ipc_round_trip(eng, hashes, want_sha, work) -> dict:
    """The CUDA IPC plane with a world on either side: the world's leader
    offers its assembled gather of ``hashes``; a child process (no JAX)
    pulls it and offers its copy back; the leader empties the world's
    cache, pulls that offer and injects it (``inject_device_windowed``:
    on a world, the fanned-out host-values scatter), then gathers again.
    Returns whether each direction landed ``want_sha``'s bytes and the
    child's pull time."""
    from dynamo_tpu_torch.engine import transfer as tr
    from dynamo_tpu_torch.runtime.codec import pack, unpack
    plane = tr.DeviceTransferPlane()
    off = await eng.run_exclusive(plane.offer, eng, hashes)
    paths = [os.path.join(work, f"ipc-{k}") for k in ("out", "back", "done")]
    for p in paths:
        if os.path.exists(p):
            os.unlink(p)
    with open(paths[0], "wb") as f:
        f.write(pack(off))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen([sys.executable, "-c", IPC_ROUND_TRIP] + paths,
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + ENTRY_TIMEOUT_S
        while not os.path.exists(paths[1]):
            if child.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"IPC child: {child.communicate()}")
            await asyncio.sleep(0.05)
        plane.ack(off["uuid"])
        with open(paths[1], "rb") as f:
            back = unpack(f.read())
        await eng.run_exclusive(eng.allocator.clear)
        data = await asyncio.to_thread(plane.pull, back, eng.device)
        metas = [tuple(b) for b in off["blocks"]]
        n = await tr.inject_device_windowed(eng, metas, data)
        del data
    finally:
        with open(paths[2], "w"):
            pass
        out, err = child.communicate(timeout=ENTRY_TIMEOUT_S)
    if child.returncode != 0:
        raise AssertionError(f"IPC child failed:\n{err[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])

    def gather():
        by_hash = eng.allocator._by_hash
        return _sha(eng.dispatch_gather_pages(
            [by_hash[h] for h in hashes])[:, :len(hashes)])
    return {"ipc_out_equal": got["sha256"] == want_sha,
            "ipc_in_equal": n == len(hashes)
            and await eng.run_exclusive(gather) == want_sha,
            "ipc_pull": _gbs(got["bytes"], got["seconds"])}


def tp_kv_rank(world, ctx) -> dict:
    """Phase 8(a), the KV data plane on the same two ranks: a
    ``TorchEngine`` at tp=2 (``build_rank_engine`` over the whole tree:
    each rank its shards), rank 0 scheduling under a ``TieredEngine``
    (host tier, synchronous onboard), the other following. Rank 0 prefills
    6(a)'s four 1024-token prompts (256 blocks), gathers them (the
    fanned-out gather: each rank reads its kv heads, rank 0 assembles
    them) and exports them as merged frames; then: the frames injected
    into a tp=1 engine of the whole tree in this process land byte-equal;
    the CUDA IPC plane both ways (``_ipc_round_trip``) lands the same
    bytes; the world's cache emptied (``allocator.clear``) and the frames
    injected back (each rank its heads of every scatter) gather
    byte-equal; four other prompts evict the blocks (their gathers run on
    the step thread, spilled to the host tier) and the synchronous
    onboard brings them back byte-equal. Returns the checks, the gather
    and inject rates and the launches."""
    from dynamo_tpu_torch.engine import transfer as tr
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.kvbm import TieredEngine, TieredKvConfig
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel import multihost as mh
    from dynamo_tpu_torch.parallel.mesh import MeshSpec
    cfg = llama_cfg()
    dev = world.device
    sizes = dict(SERVE_SIZES, num_pages=TP_KV_PAGES)
    before = {k: LAUNCHES.get(k, 0) for k in TP_B}
    eng = mh.build_rank_engine(cfg, TorchEngineConfig(**sizes), world,
                               MeshSpec(tp=world.world), params=ctx["full"])
    if not world.leader:
        mh.follow_steps(world.fanout, eng)
        out = {"launches": {k: LAUNCHES.get(k, 0) - before[k]
                            for k in TP_B}}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return out
    fanout = mh.StepFanout(world.fanout)
    fanout.install(eng)
    block = (cfg.num_layers * 2 * cfg.num_kv_heads * PS * cfg.head_dim
             * eng.pages.element_size())
    tiered = TieredEngine(eng, TieredKvConfig(
        host_budget_bytes=TP_KV_HOST_BLOCKS * block, disk_budget_bytes=0,
        prefetch_depth_bytes=0))
    one = TorchEngine(cfg, ctx["full"], TorchEngineConfig(**sizes),
                      device=dev)
    prompts = kv_prompts(cfg.vocab_size, KV_SEED)
    other = kv_prompts(cfg.vocab_size, KV_WARM_SEED)
    res = {}

    async def checks():
        hashes = []
        for i, p in enumerate(prompts):
            fr = await _one(tiered, p, f"k{i}", prefill_only=True)
            hashes += [b[0] for b in fr[-1].kv_transfer_params["blocks"]]
        nbytes = len(hashes) * block

        def gather():
            # the fanned-out gather of every block, timed to its end
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            by_hash = eng.allocator._by_hash
            out = eng.dispatch_gather_pages([by_hash[h] for h in hashes])
            torch.cuda.synchronize()
            return out[:, :len(hashes)], time.perf_counter() - t0

        want, g_s = await eng.run_exclusive(gather)
        if want.shape[3] != cfg.num_kv_heads:
            raise AssertionError(f"the world's gather {tuple(want.shape)} "
                                 "is not the whole kv heads")
        want_sha = _sha(want)
        del want
        frames = await eng.run_exclusive(tr.export_frames, eng, hashes,
                                         "layer", 16)
        wire = []
        for f in frames:
            meta = dict(f.obj)
            meta["_raw"] = np.ascontiguousarray(f.raw).view(
                np.uint8).tobytes()
            wire.append(meta)
        if wire[0]["block_shape"] != [cfg.num_layers, 2, cfg.num_kv_heads,
                                      PS, cfg.head_dim]:
            raise AssertionError(f"frame meta {wire[0]['block_shape']}")
        # into a tp=1 engine of the whole tree, in this process
        pipe = tr.InjectPipeline(one)
        for meta in wire:
            await pipe.add_frame(meta)
        if await pipe.finish() != len(hashes):
            raise AssertionError("the tp=1 inject took a partial chain")
        by1 = one.allocator._by_hash
        got = one.dispatch_gather_pages([by1[h] for h in hashes])
        res["tp1_equal"] = _sha(got[:, :len(hashes)]) == want_sha
        del got
        res.update(await _ipc_round_trip(
            eng, hashes, want_sha, os.path.join(ROOT, "build", "tp")))
        # the world emptied, then the frames injected back
        await eng.run_exclusive(eng.allocator.clear)
        gone = sum(h not in eng.allocator._by_hash for h in hashes)
        pipe = tr.InjectPipeline(eng)
        t0 = time.perf_counter()
        for meta in wire:
            await pipe.add_frame(meta)
        n = await pipe.finish()
        inj_s = time.perf_counter() - t0
        back, _s = await eng.run_exclusive(gather)
        res["reinject_equal"] = n == len(hashes) == gone and \
            _sha(back) == want_sha
        del back
        # KVBM: other prompts evict the blocks; the onboard brings them
        for i, p in enumerate(other):
            await _one(tiered, p, f"o{i}", prefill_only=True)
        await asyncio.to_thread(tiered.flush_spills, 120.0)
        evicted = sum(h not in eng.allocator._by_hash for h in hashes)
        onboarded = 0
        for p in prompts:
            onboarded += await eng.run_exclusive(tiered._onboard_for, p)
        back, _s = await eng.run_exclusive(gather)
        # (an onboard's own page allocation may evict blocks of a later
        # prompt, which that prompt's onboard brings back in turn)
        res["kvbm_equal"] = _sha(back) == want_sha and evicted > 0 and \
            onboarded >= evicted
        del back
        st = tiered.kvbm_stats()
        res.update(blocks=len(hashes), mbytes=nbytes / 1e6,
                   gather_s=g_s, gather=_gbs(nbytes, g_s),
                   inject_s=inj_s, inject=_gbs(nbytes, inj_s),
                   scatters=eng.page_scatter_dispatches, evicted=evicted,
                   onboarded=onboarded, offloaded=tiered.offloaded,
                   host_blocks=len(tiered.host),
                   offload=_gbs(st["kvbm_offload_bytes"],
                                st["kvbm_offload_seconds"]))

    async def run():
        try:
            await checks()
        finally:
            await tiered.stop()
            await one.stop()
            await eng.run_on_step_thread(fanout.close)

    asyncio.run(asyncio.wait_for(run(), SERVE_TIMEOUT_S))
    res["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    del eng, one, tiered
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dp_forward_rank(world, ctx) -> dict:
    """Phase 8(a), dp on the same two ranks: a ``MeshSpec(dp=2)`` mesh,
    the whole tree on each rank, phase 3's steps with each rank running
    its row of the two (``DpRows``: every row's K/V gathered over dp
    before each cache write), the logits gathered over dp. Rank 0 holds
    them to its tp=1 kernel logits under phase 3's gate; every rank
    returns a digest of each written page of its cache and its launches
    of B1-B3."""
    import hashlib
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel.mesh import DpRows, MeshSpec, make_mesh
    cfg = llama_cfg()
    fam = get_family(cfg)
    dev = world.device
    kernel = llama_impls()[0]
    steps, table, num_pages = ctx["plan"]
    mesh = make_mesh(MeshSpec(dp=world.world))
    pages = fam.make_pages(cfg, num_pages, PS, device=dev)
    before = {k: LAUNCHES.get(k, 0) for k in TP_B}
    out = {"steps": {}}
    with torch.no_grad():
        for step in steps:
            a = _step_arrays(step, table, dev)
            B = a[0].shape[0]
            dp = DpRows(mesh, B // world.world, a[2], a[1], a[4])
            loc = [dp.local(x) for x in a]
            logits = dp.gather(fam.forward(
                ctx["full"], cfg, loc[0], loc[1], pages, loc[2], loc[3],
                loc[4], attn_impl=kernel[step[1]], mesh=mesh, dp=dp)[0])
            torch.cuda.synchronize()
            if world.leader:
                lk, odiff = ctx["ref"][step[0]]
                out["steps"][step[0]] = {
                    "diff": float((logits - lk).abs().max()),
                    "tol": LOGITS_VS_ORACLE * odiff,
                    "finite": bool(torch.isfinite(logits).all()),
                    "argmax_same": float((logits.argmax(-1)
                                          == lk.argmax(-1)).float().mean())}
        written = sorted({int(p) for p in table.reshape(-1) if p})
        out["pages"] = [hashlib.sha256(pages[:, p].contiguous().view(
            torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
            for p in written]
    out["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    return out


def _page_digests(pages) -> dict:
    """{page: digest} of every page of a cache that holds a nonzero
    byte."""
    import hashlib
    held = (pages != 0).flatten(2).any(-1).any(0).nonzero().flatten()
    host = pages[:, held].contiguous().view(torch.int16).cpu().numpy()
    return {int(p): hashlib.sha256(host[:, i].tobytes()).hexdigest()[:16]
            for i, p in enumerate(held.tolist())}


# 8(a)'s dp serve: four of phase 4's prompts, 16 tokens each; requests 2
# and 3 sample (3 seeded) and arrive while the others decode
DP_SERVE_N, DP_SERVE_TOKENS, DP_SERVE_PAGES = 4, 16, 512


def dp_serve_rank(world, ctx) -> dict:
    """Phase 8(a), dp through the engine on the same two ranks: a
    ``TorchEngine`` over ``MeshSpec(dp=2)`` (``build_rank_engine``: the
    whole tree on each rank), rank 0 scheduling, the other following.
    ``DP_SERVE_N`` of phase 4's prompts: greedy, then an unseeded and a
    seeded draw arriving while those decode (mixed steps); steady
    batches run as fused blocks (eager over gloo), each rank its rows
    (the batch's rows split over dp, every row's K/V written by each
    replica, the packed outputs gathered over dp). Rank 0 returns each
    request's tokens and finish and the engine's counters; every rank a
    digest of each page its cache holds (the replicas must be
    byte-equal) and its launches of B1-B3."""
    from dynamo_tpu_torch.engine.torch_engine import TorchEngineConfig
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel import multihost as mh
    from dynamo_tpu_torch.parallel.mesh import MeshSpec
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    cfg = llama_cfg()
    sizes = dict(SERVE_SIZES, num_pages=DP_SERVE_PAGES)
    before = {k: LAUNCHES.get(k, 0) for k in TP_B}
    eng = mh.build_rank_engine(cfg, TorchEngineConfig(**sizes), world,
                               MeshSpec(dp=world.world), params=ctx["full"])
    out = {}
    if world.leader:
        fanout = mh.StepFanout(world.fanout)
        fanout.install(eng)
        prompts = serve_prompts(cfg.vocab_size, 2)[:DP_SERVE_N]
        samp = {2: dict(temperature=0.8), 3: dict(temperature=0.8, seed=5)}
        started = asyncio.Event()
        streams = {}

        async def one(i):
            if i >= DP_SERVE_N - 2:
                await started.wait()
            req = PreprocessedRequest(
                token_ids=prompts[i], request_id=f"dp{i}",
                stop_conditions=StopConditions(max_tokens=DP_SERVE_TOKENS,
                                               ignore_eos=True),
                sampling_options=SamplingOptions(
                    **samp.get(i, dict(temperature=0.0))))
            toks, fin = [], None
            async for frame in eng.generate(req):
                if frame.error:
                    raise AssertionError(f"dp request {i}: {frame.error}")
                toks += frame.token_ids
                fin = frame.finish_reason
                if len(toks) >= 2:
                    started.set()
            streams[i] = {"tokens": toks, "finish": fin.value}

        async def run():
            try:
                await asyncio.gather(*(one(i) for i in range(DP_SERVE_N)))
            finally:
                await eng.stop()
                await eng.run_on_step_thread(fanout.close)

        t0 = time.perf_counter()
        asyncio.run(asyncio.wait_for(run(), SERVE_TIMEOUT_S))
        out.update(streams=streams, seconds=time.perf_counter() - t0,
                   counters={k: getattr(eng, k) for k in (
                       "dp_splits", "multistep_blocks", "mixed_steps",
                       "chained_steps", "decode_dispatches")})
    else:
        mh.follow_steps(world.fanout, eng)
    torch.cuda.synchronize()
    out["pages"] = _page_digests(eng.pages)
    out["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


PP_WORLD = 2                 # stages of 8(a)'s pp checks (14 layers each)
PP_MICRO = (1, 2)            # microbatch counts of pp_forward_rank
# 8(a)'s pp serve: four of phase 4's warm prompts, 16 tokens each
# (requests 2 and 3 sample and arrive while 0 and 1 decode); the first
# prompt's 64 blocks are then exported and injected into a tp=1 engine
PP_SERVE_N, PP_SERVE_TOKENS, PP_SERVE_PAGES = 4, 16, 512
PP_SAMPLED = {2: dict(temperature=0.8), 3: dict(temperature=0.8, seed=5)}


def _stage_digests(pages, stages: int, table) -> list:
    """A digest per pipeline stage of a whole cache's layers at every page
    ``table`` names: what each stage's slab must hold."""
    import hashlib
    written = torch.tensor(sorted({int(p) for p in np.asarray(
        table).reshape(-1) if p}), device=pages.device)
    per = pages.shape[0] // stages
    return [hashlib.sha256(pages[s * per:(s + 1) * per].index_select(
        1, written).contiguous().view(torch.int16).cpu().numpy()
        .tobytes()).hexdigest()[:16] for s in range(stages)]


def pp_forward_rank(world, ctx) -> dict:
    """Phase 8(a), pipeline parallelism on the same two ranks: a
    ``MeshSpec(pp=2)`` mesh, each rank its stage's 14 layers of the whole
    tree and of the cache (``pipeline.pp_sharding_fns``), phase 3's steps
    (prefill B2, mixed B3, decode B1) through ``pipeline_forward`` with
    the kernels, at ``PP_MICRO`` microbatch counts, each on a fresh slab.
    Rank 0 holds the logits to its tp=1 kernel logits under phase 3's
    gate; every rank returns a digest of its slab at every written page
    (to be held against its layers of rank 0's tp=1 kernel cache: pp
    splits no sum, but two microbatches halve the GEMMs' rows) and its
    launches of B1-B3."""
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from dynamo_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                    pp_sharding_fns)
    cfg = llama_cfg()
    fam = get_family(cfg)
    dev = world.device
    kernel = llama_impls()[0]
    steps, table, num_pages = ctx["plan"]
    mesh = make_mesh(MeshSpec(pp=world.world))
    shard_params, shard_pages = pp_sharding_fns(mesh, cfg, device=dev)
    params = shard_params(ctx["full"])
    before = {k: LAUNCHES.get(k, 0) for k in TP_B}
    out = {"stage": mesh.coords["pp"], "micro": {}}
    with torch.no_grad():
        for micro in PP_MICRO:
            pages = shard_pages(fam.make_pages(cfg, num_pages, PS,
                                               device=dev))
            res = {"steps": {}}
            for step in steps:
                a = _step_arrays(step, table, dev)
                logits, _ = pipeline_forward(
                    params, cfg, a[0], a[1], pages, a[2], a[3], a[4],
                    mesh=mesh, n_microbatches=micro,
                    attn_impl=kernel[step[1]])
                torch.cuda.synchronize()
                if world.leader:
                    lk, odiff = ctx["ref"][step[0]]
                    res["steps"][step[0]] = {
                        "diff": float((logits - lk).abs().max()),
                        "tol": LOGITS_VS_ORACLE * odiff,
                        "finite": bool(torch.isfinite(logits).all()),
                        "argmax_same": float((logits.argmax(-1)
                                              == lk.argmax(-1)).float()
                                             .mean())}
            res["sha"] = _stage_digests(pages, 1, table)[0]
            out["micro"][str(micro)] = res
            del pages
    out["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_serve_rank(world, ctx) -> dict:
    """Phase 8(a), pipeline parallelism through the engine on the same
    two ranks: a ``TorchEngine`` over ``MeshSpec(pp=2)``
    (``build_rank_engine``: each rank its stage), rank 0 scheduling, the
    other following. ``PP_SERVE_N`` of phase 4's warm prompts, greedy and
    sampled, two arriving while the others decode (mixed steps); steady
    batches run as fused blocks (eager over gloo), every forward through
    the stages. Then the first prompt's blocks: gathered from the world
    (each stage its layers, assembled on rank 0), exported as merged
    frames and injected into a tp=1 engine of the whole tree in this
    process, whose gather must be byte-equal. Rank 0 returns the streams,
    the counters and the check; every rank its launches of B1-B3."""
    from dynamo_tpu_torch import tokens as tk
    from dynamo_tpu_torch.engine import transfer as tr
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel import multihost as mh
    from dynamo_tpu_torch.parallel.mesh import MeshSpec
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    cfg = llama_cfg()
    sizes = dict(SERVE_SIZES, num_pages=PP_SERVE_PAGES)
    before = {k: LAUNCHES.get(k, 0) for k in TP_B}
    eng = mh.build_rank_engine(cfg, TorchEngineConfig(**sizes), world,
                               MeshSpec(pp=world.world), params=ctx["full"])
    out = {}
    if world.leader:
        fanout = mh.StepFanout(world.fanout)
        fanout.install(eng)
        prompts = serve_prompts(cfg.vocab_size, WARM_SEED)[:PP_SERVE_N]
        started = asyncio.Event()
        streams = {}

        async def one(i):
            if i >= PP_SERVE_N - 2:
                await started.wait()
            req = PreprocessedRequest(
                token_ids=prompts[i], request_id=f"pp{i}",
                stop_conditions=StopConditions(max_tokens=PP_SERVE_TOKENS,
                                               ignore_eos=True),
                sampling_options=SamplingOptions(
                    **PP_SAMPLED.get(i, dict(temperature=0.0))))
            toks, fin = [], None
            async for frame in eng.generate(req):
                if frame.error:
                    raise AssertionError(f"pp request {i}: {frame.error}")
                toks += frame.token_ids
                fin = frame.finish_reason
                if len(toks) >= 2:
                    started.set()
            streams[i] = {"tokens": toks, "finish": fin.value}

        async def frames_into_tp1():
            hashes = tk.compute_block_hash_for_seq(prompts[0], PS)
            block = (cfg.num_layers * 2 * cfg.num_kv_heads * PS
                     * cfg.head_dim * eng.pages.element_size())

            def gather(e):
                by_hash = e.allocator._by_hash
                got = e.dispatch_gather_pages([by_hash[h] for h in hashes])
                return _sha(got[:, :len(hashes)])

            want = await eng.run_exclusive(gather, eng)
            frames = await eng.run_exclusive(tr.export_frames, eng, hashes,
                                             "layer", 16)
            one = TorchEngine(cfg, ctx["full"], TorchEngineConfig(
                **dict(SERVE_SIZES, num_pages=2 * len(hashes))), device=dev)
            try:
                pipe = tr.InjectPipeline(one)
                for f in frames:
                    meta = dict(f.obj)
                    meta["_raw"] = np.ascontiguousarray(f.raw).view(
                        np.uint8).tobytes()
                    await pipe.add_frame(meta)
                n = await pipe.finish()
                got = gather(one)
            finally:
                await one.stop()
            return {"blocks": len(hashes), "mbytes": len(hashes) * block
                    / 1e6, "tp1_equal": n == len(hashes) and got == want}

        async def run():
            try:
                await asyncio.gather(*(one(i) for i in range(PP_SERVE_N)))
                out["seconds"] = time.perf_counter() - t0
                out["kv"] = await frames_into_tp1()
            finally:
                await eng.stop()
                await eng.run_on_step_thread(fanout.close)

        dev = world.device
        t0 = time.perf_counter()
        asyncio.run(asyncio.wait_for(run(), SERVE_TIMEOUT_S))
        out.update(streams=streams, counters={k: getattr(eng, k) for k in (
            "multistep_blocks", "mixed_steps", "chained_steps",
            "decode_dispatches")})
    else:
        mh.follow_steps(world.fanout, eng)
    torch.cuda.synchronize()
    out["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


SP_WORLD = 2                 # sequence-parallel ranks of 8(a)'s sp checks
# 8(a)'s ring forward: a novel prompt of SP_PROMPT tokens, then one that
# shares its first SP_PREFIX_PAGES pages and adds a novel tail of SP_TAIL
# (a prefix-hit ring step), then SP_DECODE decode steps of both rows (B1)
# over the ring-written cache; the tp=1 references prefill in chunks of
# SP_CHUNK (phase 3's)
SP_PROMPT, SP_PREFIX_PAGES, SP_TAIL, SP_CHUNK, SP_DECODE = \
    4096, 64, 1024, 512, 2
# 8(a)'s sp serve: request 0 (short, a pure prefill: B2), 1 (long: the
# ring step), 2 (short, arriving once 1 decodes: a mixed step, B3);
# greedy, SP_SERVE_TOKENS each; the ring threshold is the chunk budget
SP_SERVE_LENS, SP_SERVE_TOKENS = (384, 2048, 256), 16
SP_SERVE_SIZES = dict(SERVE_SIZES, num_pages=1024, max_context=8192)


def sp_plan(V: int, rng, dev):
    """The ring forward's steps, each (tokens, positions, table, total,
    new) on ``dev``: the novel prompt's whole prefill (row 0 of the table:
    its pages and one for its decode steps), the prefix-hit prompt's tail
    (row 1: the first SP_PREFIX_PAGES of row 0's pages, then its tail's
    and one more), then SP_DECODE decode steps of both rows (seeded
    tokens). Returns (prefills, decodes, the table, pages per cache)."""
    n_a, n_b = SP_PROMPT // PS, SP_TAIL // PS
    table = np.zeros((2, n_a + 8), np.int32)
    table[0, :n_a + 1] = np.arange(1, n_a + 2)
    table[1, :SP_PREFIX_PAGES] = np.arange(1, SP_PREFIX_PAGES + 1)
    table[1, SP_PREFIX_PAGES:SP_PREFIX_PAGES + n_b + 1] = np.arange(
        n_a + 2, n_a + n_b + 3)
    a = rng.integers(0, V, size=SP_PROMPT)
    tail = rng.integers(0, V, size=SP_TAIL)
    start = SP_PREFIX_PAGES * PS
    ends = np.array([SP_PROMPT, start + SP_TAIL])

    def t(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)
    prefills = [(t(a[None]), t(np.arange(SP_PROMPT)[None]), t(table[0:1]),
                 t([SP_PROMPT]), t([SP_PROMPT])),
                (t(tail[None]), t(np.arange(start, ends[1])[None]),
                 t(table[1:2]), t(ends[1:]), t([SP_TAIL]))]
    decodes = [(t([[7 + 2 * i], [9 + 2 * i]]), t((ends + i)[:, None]),
                t(table), t(ends + i + 1), t([1, 1]))
               for i in range(SP_DECODE)]
    return prefills, decodes, table, n_a + n_b + 3


def sp_forward_rank(world, ctx) -> dict:
    """Phase 8(a), sequence parallelism on the same two ranks: a
    ``MeshSpec(sp=2)`` mesh, the whole tree on each rank (replicated over
    sp). First the tp=1 references, each on a cache of its own, the two
    at once: rank 0 through the kernels, rank 1 through the oracle
    (``paged_attention``), which hands its logits to rank 0 over the
    world's gloo group: SP_PROMPT's prefill in chunks of SP_CHUNK (B2),
    then the prefix-hit prompt's tail the same way over the cached
    prefix, then SP_DECODE decode steps of both rows (B1). Then both ranks
    run ``parallel/ring_prefill.ring_prefill`` on the two prompts (each
    rank half the positions, the K/V round the ring, every position
    written by both replicas; the second prompt's prefix merged from the
    cache) and the decode steps through B1 over the ring-written cache.
    Rank 0 holds every logits row to the tp=1 kernel's under phase 3's
    gate rule, scaled by the kernel-vs-oracle distance of the same step;
    it reports each layer's largest cache difference from the tp=1
    kernel cache (not gated: the GEMMs see other row counts); every rank
    returns a digest of every written page of its ring cache (the
    replicas must be byte-equal) and its launches of B1-B3."""
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from dynamo_tpu_torch.parallel.ring_prefill import ring_prefill
    cfg = llama_cfg()
    fam = get_family(cfg)
    dev = world.device
    full = ctx["full"]
    kernel, _plain, oracle = llama_impls()
    prefills, decodes, table, num_pages = sp_plan(
        cfg.vocab_size, np.random.default_rng(11), dev)
    mesh = make_mesh(MeshSpec(sp=world.world))
    written = torch.tensor(sorted({int(p) for p in table.reshape(-1) if p}),
                           device=dev)
    out = {"steps": {}}
    times = out["times"] = {}
    with torch.no_grad():
        # the tp=1 references: the kernels on rank 0, the oracle on rank 1
        t0 = time.perf_counter()
        use = "kernel" if world.leader else "oracle"
        kc = fam.make_pages(cfg, num_pages, PS, device=dev)
        ref = []
        for toks, pos, tbl, total, new in prefills:
            n0 = int(pos[0, 0])
            for c0 in range(0, toks.shape[1], SP_CHUNK):
                c1 = c0 + SP_CHUNK
                lg = fam.forward(
                    full, cfg, toks[:, c0:c1], pos[:, c0:c1], kc, tbl,
                    torch.full_like(total, n0 + c1),
                    torch.full_like(new, SP_CHUNK),
                    attn_impl=(kernel["prefill"] if use == "kernel"
                               else oracle))[0]
            ref.append(lg)
        for step in decodes:
            ref.append(fam.forward(
                full, cfg, *step[:2], kc, *step[2:],
                attn_impl=(kernel["decode"] if use == "kernel"
                           else oracle))[0])
        if not world.leader:
            del kc
        # rank 1's oracle logits to rank 0, through the host (gloo)
        import torch.distributed as dist
        flat = torch.cat([x.float().reshape(-1) for x in ref]).cpu()
        dist.broadcast(flat, src=1)
        oracle_ref = [x.reshape(r.shape).to(dev) for x, r in zip(
            flat.split([r.numel() for r in ref]), ref)]
        torch.cuda.synchronize()
        times["references"] = time.perf_counter() - t0
        # the launches of this rank's ring forward and of the decode over
        # its cache (the tp=1 references are not counted)
        before = {k: LAUNCHES.get(k, 0) for k in TP_B}
        pages = fam.make_pages(cfg, num_pages, PS, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [ring_prefill(full, cfg, *step[:2], pages, *step[2:],
                            mesh=mesh)[0] for step in prefills]
        torch.cuda.synchronize()
        out["ring_s"] = times["ring"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for step in decodes:
            got.append(fam.forward(full, cfg, *step[:2], pages, *step[2:],
                                   attn_impl=kernel["decode"])[0])
        torch.cuda.synchronize()
        times["decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        names = (["ring", "prefix-hit ring"]
                 + [f"decode {i + 1}" for i in range(SP_DECODE)])
        if world.leader:
            for i, name in enumerate(names):
                lk, lo, lr = ref[i], oracle_ref[i], got[i]
                odiff = float((lk - lo).abs().max())
                out["steps"][name] = {
                    "diff": float((lr - lk).abs().max()),
                    "tol": LOGITS_VS_ORACLE * odiff, "odiff": odiff,
                    "vs_oracle": float((lr - lo).abs().max()),
                    "finite": bool(torch.isfinite(lr).all()),
                    "argmax_same": float((lr.argmax(-1)
                                          == lk.argmax(-1)).float().mean())}
            out["layer_max"] = [float((pages[layer].index_select(0, written)
                                       .float() - kc[layer].index_select(
                                           0, written).float()).abs().max())
                                for layer in range(cfg.num_layers)]
            del kc
        out["sha"] = _sha(pages.index_select(1, written))
        times["checks"] = time.perf_counter() - t0
    out["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    del pages, ref, oracle_ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_serve_rank(world, ctx) -> dict:
    """Phase 8(a), sequence parallelism through the engine on the same two
    ranks: a ``TorchEngine`` over ``MeshSpec(sp=2)`` (``build_rank_engine``:
    the whole tree on each rank), rank 0 scheduling, the other following.
    The SP_SERVE_LENS prompts, greedy: request 0 (a chunked prefill),
    request 1 (past the chunk budget: one ring step over both ranks),
    request 2 once request 1 decodes (a mixed step); the decode of all
    three replicated on both ranks (fused blocks, eager over gloo). Rank
    0 returns the tokens, the counters and the ring steps; every rank a
    digest of each page its cache holds (the replicas must be byte-equal)
    and its launches of B1-B3. The ring's numbers against tp=1 are
    ``sp_forward_rank``'s logits checks."""
    from dynamo_tpu_torch.engine.torch_engine import TorchEngineConfig
    from dynamo_tpu_torch.ops.kernels import LAUNCHES
    from dynamo_tpu_torch.parallel import multihost as mh
    from dynamo_tpu_torch.parallel.mesh import MeshSpec
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    cfg = llama_cfg()
    before = {k: LAUNCHES.get(k, 0) for k in TP_B}
    eng = mh.build_rank_engine(cfg, TorchEngineConfig(**SP_SERVE_SIZES),
                               world, MeshSpec(sp=world.world),
                               params=ctx["full"])
    rng = np.random.default_rng(13)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, size=n)))
               for n in SP_SERVE_LENS]
    out = {}

    def serve_on(engine, tag, close):
        """Serve the prompts on ``engine`` and stop it (then ``close``,
        on its step thread); (streams, seconds)."""
        started = asyncio.Event()
        streams = {}

        async def one(i):
            if i == 2:
                await started.wait()
            req = PreprocessedRequest(
                token_ids=prompts[i], request_id=f"{tag}{i}",
                stop_conditions=StopConditions(max_tokens=SP_SERVE_TOKENS,
                                               ignore_eos=True),
                sampling_options=SamplingOptions(temperature=0.0))
            toks, fin = [], None
            async for frame in engine.generate(req):
                if frame.error:
                    raise AssertionError(f"{tag} request {i}: "
                                         f"{frame.error}")
                toks += frame.token_ids
                fin = frame.finish_reason
                if i == 1 and len(toks) >= 2:
                    started.set()
            streams[i] = {"tokens": toks, "finish": fin.value}

        async def run():
            try:
                await asyncio.gather(*(one(i) for i in range(3)))
            finally:
                await engine.stop()
                await engine.run_on_step_thread(close)
        t0 = time.perf_counter()
        asyncio.run(asyncio.wait_for(run(), SERVE_TIMEOUT_S))
        return streams, time.perf_counter() - t0

    if world.leader:
        fanout = mh.StepFanout(world.fanout)
        fanout.install(eng)
        streams, secs = serve_on(eng, "sp", fanout.close)
        out.update(streams=streams, seconds=secs, counters={
            k: getattr(eng, k) for k in ("ring_steps", "mixed_steps",
                                         "multistep_blocks",
                                         "decode_dispatches")})
    else:
        mh.follow_steps(world.fanout, eng)
    torch.cuda.synchronize()
    out["pages"] = _page_digests(eng.pages)
    out["launches"] = {k: LAUNCHES.get(k, 0) - before[k] for k in TP_B}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_world(task: str, backend: str, timeout: float) -> dict:
    """Run phase 8's world of ``TP_WORLD`` ranks for ``task``; returns
    {rank: result}, with the ranks' output's tail under "log"."""
    from dynamo_tpu_torch.parallel.multihost import free_address
    work = os.path.join(ROOT, "build", "tp")
    os.makedirs(work, exist_ok=True)
    spec_path = os.path.join(work, f"{task}-{backend}.json")
    out = os.path.join(work, f"{task}-{backend}.out")
    for r in range(TP_WORLD):
        if os.path.exists(f"{out}.{r}"):
            os.unlink(f"{out}.{r}")
    with open(spec_path, "w") as f:
        json.dump({"task": task, "backend": backend, "world": TP_WORLD,
                   "address": free_address(), "out": out}, f)
    log_path = os.path.join(work, f"{task}-{backend}.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-rank",
             spec_path], cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            import signal
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    got = {}
    for r in range(TP_WORLD):
        try:
            with open(f"{out}.{r}") as f:
                got[r] = json.load(f)
        except FileNotFoundError:
            got[r] = {"error": f"rank {r} wrote no result (exit "
                               f"{proc.returncode})"}
    with open(log_path, errors="replace") as f:
        got["log"] = "\n".join(f.read().splitlines()[-12:])
    return got


def nccl_probe() -> tuple:
    """Two ranks on the cards there are over NCCL, one all-reduce: (ok,
    what it said)."""
    got = tp_world("probe", "nccl", TP_PROBE_TIMEOUT_S)
    errs = [got[r]["error"] for r in range(TP_WORLD) if "error" in got[r]]
    if not errs:
        return True, f"all-reduce sums {got[0]['sum']}"
    # the exception's own lines: the traceback's last frame onwards
    lines = errs[0].strip().splitlines()
    tail = [ln.strip() for ln in lines[max(i for i, ln in enumerate(lines)
                                           if ln.startswith("  ")) + 1:]]
    return False, " | ".join(ln for ln in tail if ln)[:600]


def tp_model_dir() -> str:
    """Phase 5's model directory (Llama-3.2-3B's widths, random weights),
    written here when phase 5 did not run."""
    model_dir = os.path.join(ROOT, "build", "serve_entry", "llama32_3b")
    if not os.path.exists(os.path.join(model_dir, "config.json")):
        write_entry_model(model_dir, entry_cfg())
    return model_dir


def tp_serve_stack(backend: str) -> "_Stack":
    """Phase 8(b)'s tp=2 worker stack, brought up (beside 8(a)'s rank
    processes): a coordinator, one worker with ``--tensor-parallel-size 2
    --random-weights --dist-backend BACKEND`` on phase 5's model directory
    and a frontend. Returns the stack, its bring-up seconds in ``up``."""
    work = os.path.join(ROOT, "build", "tp_serve")
    os.makedirs(work, exist_ok=True)
    stack = _Stack(work)
    t0 = time.perf_counter()
    try:
        stack.start_coordinator()
        stack.start_worker("tp-worker", _worker_args(
            tp_model_dir(), stack.coord,
            ["--tensor-parallel-size", str(TP_WORLD), "--dist-backend",
             backend]))
        stack.start_frontend()
        worker = stack.kids["tp-worker"]
        worker.wait_for("torch worker serving model")
        worker.wait_for(f"torch follower rank 1/{TP_WORLD} in lockstep")
        stack.up = time.perf_counter() - t0
    except Exception:
        stack.tails("tp")
        stack.stop()
        raise
    return stack


def tp_serve(backend: str, stack: "_Stack") -> dict:
    """Phase 8(b), the tp=2 worker (``tp_serve_stack``): phase 5's
    identity pass (its chats with their logprobs, echo scoring,
    embeddings: every answer checked), each chat's tokens held against
    phase 5's tp=1 worker's (reported), then one of phase 5's warm timed
    windows (TTFT and tok/s beside phase 5's). The leader alone is sent
    SIGTERM (its drain controller drains it), so that it releases its
    follower, and each rank prints its kernel launches; both must have
    launched B1, B2 and B3. Stops the stack. Returns {rank: launches}."""
    import re
    import signal
    cfg = llama_cfg()
    worker = stack.kids["tp-worker"]
    try:
        model = stack.model()
        line = [ln for ln in worker.text().splitlines()
                if "torch worker serving model" in ln][0]
        log(f"[tp] stack up in {stack.up:.1f} s (beside 8(a)): {line}")
        t1 = time.perf_counter()
        ans = entry_requests(stack.base, model, seed=5)
        check_entry_answers(ans, cfg.hidden_size)
        log(f"[tp] identity pass (4 chats, echo, embeddings) in "
            f"{time.perf_counter() - t1:.1f} s: every answer checked")
        ref = ENTRY_ANSWERS.get("first")
        if ref:
            same = total = 0
            firsts = []
            for i in range(len(ENTRY_CHAT_WORDS)):
                a = [e["token"] for e in ans[f"chat{i}"]["logprobs"]]
                b = [e["token"] for e in ref[f"chat{i}"]["logprobs"]]
                total += max(len(a), len(b))
                same += sum(x == y for x, y in zip(a, b))
                firsts.append(next((j for j, (x, y) in enumerate(zip(a, b))
                                    if x != y), None))
            log(f"[tp] chat tokens equal to phase 5's tp=1 worker's: "
                f"{same}/{total} ({same / max(total, 1):.1%}); first "
                f"differing token per chat {firsts} (reported: bf16 near "
                f"ties part, ROADMAP Queue C)")
        r = entry_window(stack.base, model, cfg.vocab_size, WARM_SEED)
        log(f"[tp] timed window (phase 4's requests, seed {WARM_SEED}) at "
            f"tp={TP_WORLD} over {backend}: {r['tokens']} tokens in "
            f"{r['wall']:.4f} s: {r['tok_s']:.2f} tok/s; client TTFT p50="
            f"{r['ttft_p50']:.4f} s max={r['ttft_max']:.4f} s mean="
            f"{r['ttft_mean']:.4f} s")
        for w in ENTRY_ANSWERS.get("warm", []):
            log(f"[tp] beside phase 5's tp=1 warm window: "
                f"{w['tok_s']:.2f} tok/s, TTFT p50={w['ttft_p50']:.4f} s "
                f"mean={w['ttft_mean']:.4f} s")
        os.kill(worker.proc.pid, signal.SIGTERM)
        worker.proc.wait(timeout=120)
        launches = {}
        for rank, pat in ((0, r"torch worker rank 0 stopped: kernel "
                              r"launches (\{.*?\})"),
                          (1, r"torch follower rank 1 released: kernel "
                              r"launches (\{.*?\})")):
            m = re.search(pat, worker.text())
            if m is None:
                raise AssertionError(f"rank {rank} printed no launches")
            launches[rank] = {k: v for k, v in json.loads(m.group(1)).items()
                              if k in TP_B}
        log(f"[tp] kernel launches per rank over the worker's life: "
            f"{launches}")
        for rank, got in launches.items():
            for k in TP_B:
                if got.get(k, 0) <= 0:
                    raise AssertionError(f"rank {rank} never launched {k}")
        return launches
    except Exception:
        stack.tails("tp")
        raise
    finally:
        stack.stop()


def tp_disagg_stack(backend: str) -> "_Stack":
    """Phase 8(b)'s disaggregated stack, brought up: on phase 5's model
    directory (random weights), a tp=2 world started as ``--disagg
    prefill --host-cache-bytes ... --dist-backend BACKEND`` beside a tp=1
    ``--disagg decode`` worker (decode-first: every prompt prefills
    remotely, on the world), a coordinator and a frontend. Returns the
    stack, its bring-up seconds in ``up``."""
    cfg = entry_cfg()
    work = os.path.join(ROOT, "build", "tp_disagg")
    os.makedirs(work, exist_ok=True)
    model_dir = tp_model_dir()
    block = cfg.num_layers * 2 * cfg.num_kv_heads * PS * cfg.head_dim * 2
    stack = _Stack(work)
    t0 = time.perf_counter()
    try:
        stack.start_coordinator()
        stack.start_worker("prefill", _worker_args(
            model_dir, stack.coord,
            ["--disagg", "prefill", "--component", "prefill",
             "--tensor-parallel-size", str(TP_WORLD), "--dist-backend",
             backend, "--host-cache-bytes", str(TP_KV_HOST_BLOCKS * block)]))
        stack.start_worker("decode", _worker_args(
            model_dir, stack.coord, ["--disagg", "decode"]))
        stack.start_frontend()
        for name in ("prefill", "decode"):
            stack.kids[name].wait_for("torch worker serving model")
        stack.kids["prefill"].wait_for(
            f"torch follower rank 1/{TP_WORLD} in lockstep")
        stack.up = time.perf_counter() - t0
    except Exception:
        stack.tails("tp")
        stack.stop()
        raise
    return stack


def tp_disagg_serve(backend: str, stack: "_Stack") -> dict:
    """Phase 8(b): the KV data plane through workers
    (``tp_disagg_stack``: a tp=2 prefill world with a host tier beside a
    tp=1 decode worker). Phase 5's identity pass through the pair: every
    answer checked (``check_entry_answers``), the echo and embeddings (the
    decode worker's own) equal to phase 5's; every chat's prefill a
    remote job of the world whose export lease was acked (none left
    pinned, none reclaimed by the TTL sweep); pulled bytes per plane and
    the world's tier counters printed; the chats' tokens held to phase
    5's tp=1 worker's (reported: bf16 near ties part). Then SIGTERM on the
    world's leader: its drain controller drains it, it releases its
    follower, and both ranks print their launches (B2 on each). Stops the
    stack. Returns {rank: launches} of the world and the decode
    worker's."""
    import re
    import signal
    cfg = llama_cfg()
    try:
        world = stack.kids["prefill"]
        model = stack.model()
        line = [ln for ln in world.text().splitlines()
                if "torch worker serving model" in ln][0]
        log(f"[tp] disaggregated stack up in {stack.up:.1f} s: {line}")
        pre0, dec0 = stack.metrics("prefill"), stack.metrics("decode")
        t1 = time.perf_counter()
        ans = entry_requests(stack.base, model, seed=5)
        check_entry_answers(ans, cfg.hidden_size)
        secs = time.perf_counter() - t1
        pre1, dec1 = stack.metrics("prefill"), stack.metrics("decode")
        chats = len(ENTRY_CHAT_WORDS)
        jobs = (_metric(pre1, "dynamo_worker_prefill_jobs_total",
                        outcome="ok")
                - _metric(pre0, "dynamo_worker_prefill_jobs_total",
                          outcome="ok"))
        pinned = _metric(pre1, "dynamo_worker_kv_exports_active")
        reclaimed = (_metric(pre1, "dynamo_worker_kv_exports_reclaimed_total")
                     - _metric(pre0,
                               "dynamo_worker_kv_exports_reclaimed_total"))
        planes = {p: int(_metric(dec1, "dynamo_worker_disagg_kv_bytes_total",
                                 direction="pulled", plane=p)
                         - _metric(dec0, "dynamo_worker_disagg_kv_bytes_total",
                                   direction="pulled", plane=p))
                  for p in ("direct", "bulk", "rpc")}
        tiers = {k: v for k, v in pre1.items() if "kvbm" in k}
        log(f"[tp] identity pass through the pair (tp=2 prefill world, tp=1 "
            f"decode worker) in {secs:.1f} s: every answer checked; remote "
            f"prefill jobs {int(jobs)} for {chats} chats and the echo "
            f"completion, export leases left "
            f"pinned {int(pinned)}, reclaimed by the TTL sweep "
            f"{int(reclaimed)}; pulled bytes by plane {planes}; the world's "
            f"tiers {tiers}")
        # the chats and the echo completion's one token, each prefilled
        # remotely
        if int(jobs) != chats + 1 or pinned or reclaimed or \
                sum(planes.values()) <= 0:
            raise AssertionError("a chat's prefill was not a remote job "
                                 "whose pull was acked")
        p5 = ENTRY_ANSWERS.get("first")
        if p5:
            # the echo's prompt logprobs and the embeddings are the decode
            # worker's own (tp=1, as phase 5's); its one generated token
            # is the world's prefill's
            same = {"echo prompt": all(ans["echo"][k][:-1] == v[:-1]
                                       for k, v in p5["echo"].items()),
                    "echo token": all(ans["echo"][k][-1:] == v[-1:]
                                      for k, v in p5["echo"].items()),
                    "embeddings": ans["embed"] == p5["embed"]}
            log(f"[tp] equal to phase 5's: {same}")
            if not (same["echo prompt"] and same["embeddings"]):
                raise AssertionError("the decode worker's echo or "
                                     "embeddings differ from phase 5's")
            same = total = 0
            firsts = []
            for i in range(chats):
                a = [e["token"] for e in ans[f"chat{i}"]["logprobs"]]
                b = [e["token"] for e in p5[f"chat{i}"]["logprobs"]]
                total += max(len(a), len(b))
                same += sum(x == y for x, y in zip(a, b))
                firsts.append(next((j for j, (x, y) in enumerate(zip(a, b))
                                    if x != y), None))
            log(f"[tp] chat tokens "
                f"equal to phase 5's tp=1 worker's: {same}/{total} "
                f"({same / max(total, 1):.1%}); first differing token per "
                f"chat {firsts} (reported: bf16 near ties part, ROADMAP "
                f"Queue C)")
        dec_launches = {k: int(_metric(dec1,
                                       "dynamo_worker_kernel_launches_total",
                                       kernel=k))
                        for k in TP_B}
        t2 = time.perf_counter()
        os.kill(world.proc.pid, signal.SIGTERM)
        world.proc.wait(timeout=120)
        text = world.text()
        if "graceful drain started (SIGTERM)" not in text:
            raise AssertionError("the world's leader did not drain")
        launches = {}
        for rank, pat in ((0, r"torch worker rank 0 stopped: kernel "
                              r"launches (\{.*?\})"),
                          (1, r"torch follower rank 1 released: kernel "
                              r"launches (\{.*?\})")):
            m = re.search(pat, text)
            if m is None:
                raise AssertionError(f"rank {rank} printed no launches")
            launches[rank] = {k: v for k, v in json.loads(m.group(1)).items()
                              if k in TP_B}
        log(f"[tp] SIGTERM: the world's leader drained and exited with "
            f"{world.proc.returncode} in {time.perf_counter() - t2:.1f} s, "
            f"its follower released; launches per rank over the world's "
            f"life {launches}, the decode worker's {dec_launches}")
        for rank, got in launches.items():
            if got.get("paged_prefill", 0) <= 0:
                raise AssertionError(f"rank {rank} never launched B2")
        if dec_launches["paged_decode"] <= 0:
            raise AssertionError("the decode worker never launched B1")
        return {**launches, "decode": dec_launches}
    except Exception:
        stack.tails("tp")
        raise
    finally:
        stack.stop()


def phase_tp() -> dict:
    """Phase 8: Llama-3.2-3B at full width and depth as a world of two
    ranks. With two or more cards: NCCL over two of them, fused blocks
    captured. With one: NCCL with two ranks on that card is tried first
    and what it says printed; where it refuses, both ranks run on the one
    card over gloo (all-reduce on CUDA tensors; fused blocks eager), which
    is a check of correctness, not a speed of parallelism. Then (a)
    ``tp_forward_rank`` under phase 3's gate, the KV data plane over the
    tp=2 cache (``tp_kv_rank``), dp=2 (``dp_forward_rank``: phase 3's
    gate, both replicas' caches equal, B1-B3 on each rank; then
    ``dp_serve_rank``: the dp=2 engine's serve, caches equal, B1-B3 on
    each rank) and pp=2 (``pp_forward_rank``: phase 3's gate at one and
    two microbatches, each stage's slab against the tp=1 cache; then
    ``pp_serve_rank``: the pp=2 engine's serve, its frames byte-equal in a
    tp=1 engine, B1-B3 on each rank) and sp=2 (``sp_forward_rank``: the
    ring's logits, novel and prefix-hit, and B1 decode over its cache
    under phase 3's gate, the replicas' ring caches byte-equal; then
    ``sp_serve_rank``: the sp=2 engine's serve, one ring step, caches
    equal, B1-B3 on each rank), and (b) ``tp_serve`` (the tp=2 worker) and
    ``tp_disagg_serve`` (the tp=2 prefill world and a tp=1 decode
    worker). Returns {"forward": {rank: launches}, "sp": {rank: launches
    of the sp checks}, "serve": {rank: launches}, "disagg": {rank or
    "decode": launches}}."""
    cards = torch.cuda.device_count()
    if cards >= TP_WORLD:
        backend = "nccl"
        log(f"[tp] {cards} cards: ranks on cuda:0..{TP_WORLD - 1} over "
            f"nccl, fused blocks captured")
    else:
        ok, said = nccl_probe()
        log(f"[tp] nccl with {TP_WORLD} ranks on {cards} card: "
            f"{'works' if ok else 'refused'}: {said}")
        backend = "nccl" if ok else "gloo"
        log(f"[tp] {cards} card: both ranks on cuda:0 over {backend} "
            f"(fused blocks {'captured' if ok else 'eager'}); a check of "
            f"correctness, not a speed of parallelism")
    # 8(b)'s tp=2 worker comes up beside 8(a)'s rank processes (the
    # disaggregated stack comes up after it: beside it, the host's cores
    # slow both about as much as the overlap saves)
    tp_model_dir()
    agg = _Bringup(tp_serve_stack, backend)
    try:
        fwd, sp = phase_tp_ranks(backend)
        serve = tp_serve(backend, agg.result())
    finally:
        agg.stop()
    return {"forward": fwd, "sp": sp, "serve": serve,
            "disagg": tp_disagg_serve(backend, tp_disagg_stack(backend))}


class _Bringup:
    """A stack's bring-up (``fn(*args)``) on a thread of its own."""

    def __init__(self, fn, *args):
        self.out = self.err = None
        self.thread = threading.Thread(target=self._run, args=(fn, args),
                                       daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.out = fn(*args)
        except BaseException as e:      # noqa: BLE001 — raised in result
            self.err = e

    def result(self):
        """The stack, once up; the bring-up's exception, if it failed."""
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self.out

    def stop(self) -> None:
        """Stop the stack, whatever became of the bring-up."""
        self.thread.join()
        if self.out is not None:
            self.out.stop()


def phase_tp_ranks(backend: str) -> tuple:
    """Phase 8(a): the world of ``tp_rank_main`` processes and its checks
    (``check_world``)."""
    t0 = time.perf_counter()
    got = tp_world("forward", backend, TP_FORWARD_TIMEOUT_S)
    return check_world(got, backend, t0)


def check_world(got: dict, backend: str, t0: float) -> tuple:
    """Phase 8(a)'s checks of the rank processes' results (``tp_world``):
    the tp=2 forward, the KV plane, the dp=2 forward and serve, the pp=2
    forward and serve (``check_pp``), the sp=2 forward and serve
    (``check_sp``). Returns ({rank: launches} over all eight, {rank:
    launches} of the sp checks alone)."""
    bad = [got[r]["error"] for r in range(TP_WORLD) if "error" in got[r]]
    if bad:
        raise AssertionError(f"tp forward failed: {bad[0]}\n{got['log']}")
    for name, st in got[0]["steps"].items():
        log(f"[tp] forward {name} at tp={TP_WORLD} over {backend}: logits vs "
            f"tp=1 max|d|={st['diff']:.4e} (tol {st['tol']:.4e} = "
            f"{LOGITS_VS_ORACLE} x plain vs oracle {st['odiff']:.4e}; "
            f"max|logits| {st['max_logit']:.4e}, argmax agreement "
            f"{st['argmax_same']:.3f}); greatest per-layer attention "
            f"distance to tp=1 {st['layer_max']:.4e} over {st['layers']} "
            f"layers (max|attention| {st['attn_max']:.4e}); finite="
            f"{st['finite']}")
        if not st["finite"] or st["diff"] > st["tol"]:
            raise AssertionError(f"tp forward {name}: outside phase 3's "
                                 f"gate")
    fwd = {r: got[r]["launches"] for r in range(TP_WORLD)}
    log(f"[tp] forward launches per rank {fwd}")
    for r, n in fwd.items():
        for k in TP_B:
            if n.get(k, 0) <= 0:
                raise AssertionError(f"tp forward: rank {r} never launched "
                                     f"{k}")
    kv = got[0]["kv"]
    log(f"[tp] KV plane at tp={TP_WORLD} over {backend} in "
        f"{kv['seconds']:.1f} s: {kv['blocks']} blocks ({kv['mbytes']:.1f} "
        f"MB of whole-head KV): the world's merged frames injected into a "
        f"tp=1 engine byte-equal {kv['tp1_equal']}; CUDA IPC from the "
        f"world's leader to a child process byte-equal "
        f"{kv['ipc_out_equal']} (pulled at {kv['ipc_pull']}), the child's "
        f"copy pulled back into the emptied world byte-equal "
        f"{kv['ipc_in_equal']}; emptied and "
        f"re-injected (each rank sent its heads of every scatter: "
        f"{kv['scatters']} in 8(a)), gathered byte-equal "
        f"{kv['reinject_equal']}; KVBM host tier: "
        f"{kv['evicted']} evicted by other prompts (offloaded "
        f"{kv['offloaded']}, {kv['host_blocks']} in the host tier, offload "
        f"{kv['offload']}), {kv['onboarded']} onboarded, byte-equal "
        f"{kv['kvbm_equal']}")
    log(f"[tp] the world's gather {kv['gather_s']:.3f} s ({kv['gather']}) "
        f"and inject pipeline {kv['inject_s']:.3f} s ({kv['inject']}), "
        f"beside phase 6(a)'s one rank: gather "
        f"{KV_LOCAL_RATES.get('gather', 'not run')}, inject pipeline "
        f"{KV_LOCAL_RATES.get('inject', 'not run')} (the world's gather "
        f"and scatter go through the host over {backend})")
    if not all(kv[k] for k in ("tp1_equal", "ipc_out_equal", "ipc_in_equal",
                                "reinject_equal", "kvbm_equal")):
        raise AssertionError("the KV plane over the tp=2 cache lost bytes")
    dpr = got[0]["dp"]
    for name, st in dpr["steps"].items():
        log(f"[tp] dp={TP_WORLD} forward {name} (each rank its row, the "
            f"whole model): logits vs tp=1 max|d|={st['diff']:.4e} (tol "
            f"{st['tol']:.4e}), argmax agreement {st['argmax_same']:.3f}, "
            f"finite={st['finite']}")
        if not st["finite"] or st["diff"] > st["tol"]:
            raise AssertionError(f"dp forward {name}: outside phase 3's "
                                 f"gate")
    same = got[0]["dp"]["pages"] == got[1]["dp"]["pages"]
    dpl = {r: got[r]["dp"]["launches"] for r in range(TP_WORLD)}
    log(f"[tp] dp={TP_WORLD}: both replicas' caches byte-equal at every "
        f"written page ({len(got[0]['dp']['pages'])} pages): {same}; "
        f"launches per rank {dpl}")
    if not same:
        raise AssertionError("the dp replicas' caches differ")
    for r, n in dpl.items():
        for k in TP_B:
            if n.get(k, 0) <= 0:
                raise AssertionError(f"dp forward: rank {r} never launched "
                                     f"{k}")
    dps = got[0]["dp_serve"]
    sl = {r: got[r]["dp_serve"]["launches"] for r in range(TP_WORLD)}
    same = got[0]["dp_serve"]["pages"] == got[1]["dp_serve"]["pages"]
    lens = {i: (len(v["tokens"]), v["finish"])
            for i, v in sorted(dps["streams"].items())}
    log(f"[tp] dp={TP_WORLD} engine (MeshSpec(dp={TP_WORLD}), the whole "
        f"model on each rank) served {len(lens)} of phase 4's requests "
        f"(2 sampled, arriving while the others decode) in "
        f"{dps['seconds']:.1f} s: (tokens, finish) {lens}; counters "
        f"{dps['counters']}; both replicas' caches byte-equal at every "
        f"held page ({len(got[0]['dp_serve']['pages'])} pages): {same}; "
        f"launches per rank {sl}")
    if not same:
        raise AssertionError("the dp engine's replicas' caches differ")
    if len(lens) != DP_SERVE_N or any(v != (DP_SERVE_TOKENS, "length")
                                      for v in lens.values()):
        raise AssertionError("a dp request lost tokens")
    if dps["counters"]["dp_splits"] <= 0 or \
            dps["counters"]["multistep_blocks"] <= 0:
        raise AssertionError("the dp engine split no dispatch or ran no "
                             "fused block")
    for r, n in sl.items():
        for k in TP_B:
            if n.get(k, 0) <= 0:
                raise AssertionError(f"dp serve: rank {r} never launched "
                                     f"{k}")
    ppl, psl = check_pp(got)
    spl = check_sp(got)
    log(f"[tp] phase 8(a) in {time.perf_counter() - t0:.1f} s")
    fwd = {r: {k: fwd[r][k] + got[r]["kv"]["launches"][k] + dpl[r][k]
               + sl[r][k] + ppl[r][k] + psl[r][k] + spl[r][k]
               for k in TP_B}
           for r in range(TP_WORLD)}
    return fwd, spl


def check_pp(got: dict) -> tuple:
    """Phase 8(a)'s pipeline checks (``pp_forward_rank``,
    ``pp_serve_rank``): the pp=2 forward's logits under phase 3's gate at
    each microbatch count, each stage's slab against its layers of the
    tp=1 kernel cache (reported), the pp=2 engine's serve (every request
    its tokens, fused blocks and mixed steps run, its greedy tokens beside
    phase 4's, its frames byte-equal in a tp=1 engine), B1-B3 on each
    rank. Returns the forward's and the serve's {rank: launches}."""
    pp = {r: got[r]["pp"] for r in range(TP_WORLD)}
    tp1 = got[0]["tp1_stage_sha"]
    for micro in PP_MICRO:
        for name, st in pp[0]["micro"][str(micro)]["steps"].items():
            log(f"[tp] pp={PP_WORLD} forward {name} at {micro} "
                f"microbatch(es) (each rank its stage's layers): logits vs "
                f"tp=1 max|d|={st['diff']:.4e} (tol {st['tol']:.4e}), "
                f"argmax agreement {st['argmax_same']:.3f}, "
                f"finite={st['finite']}")
            if not st["finite"] or st["diff"] > st["tol"]:
                raise AssertionError(f"pp forward {name} at {micro} "
                                     f"microbatch(es): outside phase 3's "
                                     f"gate")
        same = {r: pp[r]["micro"][str(micro)]["sha"] == tp1[pp[r]["stage"]]
                for r in range(TP_WORLD)}
        log(f"[tp] pp={PP_WORLD} at {micro} microbatch(es): each stage's "
            f"cache slab byte-equal to its layers of the tp=1 kernel cache "
            f"at every written page (reported, not gated): {same}")
    ppl = {r: pp[r]["launches"] for r in range(TP_WORLD)}
    log(f"[tp] pp={PP_WORLD} forward in {pp[0]['seconds']:.1f} s; launches "
        f"per rank {ppl}")
    pps = got[0]["pp_serve"]
    psl = {r: got[r]["pp_serve"]["launches"] for r in range(TP_WORLD)}
    lens = {i: (len(v["tokens"]), v["finish"])
            for i, v in sorted(pps["streams"].items())}
    ref = PHASE4_STREAMS.get(llama_cfg().model_type)
    greedy = [i for i in range(PP_SERVE_N) if i not in PP_SAMPLED]
    if ref is None:
        vs = "phase 4 not run"
    else:
        eq = sum(a == b for i in greedy for a, b in zip(
            pps["streams"][str(i)]["tokens"], ref[i]["tokens"]))
        vs = (f"{eq} / {len(greedy) * PP_SERVE_TOKENS} greedy tokens equal "
              f"to phase 4's warm serve of the same prompts (one card, "
              f"another batch)")
    kv = pps["kv"]
    log(f"[tp] pp={PP_WORLD} engine (MeshSpec(pp={PP_WORLD}), each rank "
        f"its stage) served {len(lens)} of phase 4's warm requests (2 "
        f"sampled, 2 arriving while the others decode) in "
        f"{pps['seconds']:.1f} s over gloo (a check of correctness, not a "
        f"speed): (tokens, finish) {lens}; {vs}; counters "
        f"{pps['counters']}; its first prompt's {kv['blocks']} blocks "
        f"({kv['mbytes']:.1f} MB) gathered from the stages, exported as "
        f"merged frames and injected into a tp=1 engine byte-equal "
        f"{kv['tp1_equal']}; launches per rank {psl}")
    if len(lens) != PP_SERVE_N or any(v != (PP_SERVE_TOKENS, "length")
                                      for v in lens.values()):
        raise AssertionError("a pp request lost tokens")
    if pps["counters"]["multistep_blocks"] <= 0 or \
            pps["counters"]["mixed_steps"] <= 0:
        raise AssertionError("the pp engine ran no fused block or no mixed "
                             "step")
    if not kv["tp1_equal"]:
        raise AssertionError("the pp world's frames are not byte-equal in "
                             "a tp=1 engine")
    for what, launches in (("pp forward", ppl), ("pp serve", psl)):
        for r, n in launches.items():
            for k in TP_B:
                if n.get(k, 0) <= 0:
                    raise AssertionError(f"{what}: rank {r} never "
                                         f"launched {k}")
    return ppl, psl


def check_sp(got: dict) -> dict:
    """Phase 8(a)'s sequence-parallel checks (``sp_forward_rank``,
    ``sp_serve_rank``): the ring's logits (novel and prefix-hit) and the
    decode steps over the ring-written cache under phase 3's gate rule,
    the replicas' ring caches byte-equal, the sp=2 engine's serve (one
    ring step, every request its tokens, the replicas' caches byte-equal),
    B1 on each rank in the forward and B1-B3 on each rank in the serve.
    Returns {rank: launches} over both."""
    sp = {r: got[r]["sp"] for r in range(TP_WORLD)}
    for name, st in sp[0]["steps"].items():
        log(f"[tp] sp={SP_WORLD} {name} ({SP_PROMPT}-token prompt, then "
            f"{SP_TAIL} tokens over a {SP_PREFIX_PAGES}-page prefix; each "
            f"rank half the positions): logits vs the tp=1 kernel forward "
            f"(B2 chunks of {SP_CHUNK}, B1) max|d|={st['diff']:.4e} (tol "
            f"{st['tol']:.4e} = {LOGITS_VS_ORACLE} x kernel vs oracle "
            f"{st['odiff']:.4e}); vs the oracle {st['vs_oracle']:.4e}; "
            f"argmax agreement {st['argmax_same']:.3f}, "
            f"finite={st['finite']}")
        if not st["finite"] or st["diff"] > st["tol"]:
            raise AssertionError(f"sp {name}: outside phase 3's gate")
    lm = sp[0]["layer_max"]
    same = sp[0]["sha"] == sp[1]["sha"]
    fl = {r: sp[r]["launches"] for r in range(TP_WORLD)}
    log(f"[tp] sp={SP_WORLD}: the two ring prefills in {sp[0]['ring_s']:.2f}"
        f" s over gloo (a check of correctness, not a speed); the ring "
        f"cache's largest distance to the tp=1 kernel cache at every "
        f"written page, layer by layer (reported, not gated): "
        f"{' '.join(f'{x:.3g}' for x in lm)} (largest {max(lm):.4e} at "
        f"layer {lm.index(max(lm))}); both "
        f"replicas' ring caches byte-equal: {same}; the sp checks in "
        f"{sp[0]['seconds']:.1f} s (rank 0: "
        f"{', '.join(f'{k} {v:.2f} s' for k, v in sp[0]['times'].items())}"
        f"); launches per rank {fl}")
    if not same:
        raise AssertionError("the sp replicas' ring caches differ")
    for r, n in fl.items():
        if n.get("paged_decode", 0) <= 0:
            raise AssertionError(f"sp forward: rank {r} never launched "
                                 f"paged_decode over the ring cache")
    sps = got[0]["sp_serve"]
    sl = {r: got[r]["sp_serve"]["launches"] for r in range(TP_WORLD)}
    same = got[0]["sp_serve"]["pages"] == got[1]["sp_serve"]["pages"]
    lens = {i: (len(v["tokens"]), v["finish"])
            for i, v in sorted(sps["streams"].items())}
    log(f"[tp] sp={SP_WORLD} engine (MeshSpec(sp={SP_WORLD}), the whole "
        f"model on each rank) served prompts of {SP_SERVE_LENS} tokens in "
        f"{sps['seconds']:.1f} s over gloo: (tokens, finish) {lens}; "
        f"counters {sps['counters']}; "
        f"both replicas' caches byte-equal at every held page "
        f"({len(got[0]['sp_serve']['pages'])} pages): {same}; launches per "
        f"rank {sl}")
    if not same:
        raise AssertionError("the sp engine's replicas' caches differ")
    if len(lens) != len(SP_SERVE_LENS) or any(
            v != (SP_SERVE_TOKENS, "length") for v in lens.values()):
        raise AssertionError("an sp request lost tokens")
    if sps["counters"]["ring_steps"] != 1:
        raise AssertionError(f"the sp engine ran "
                             f"{sps['counters']['ring_steps']} ring steps, "
                             f"not 1")
    for r, n in sl.items():
        for k in TP_B:
            if n.get(k, 0) <= 0:
                raise AssertionError(f"sp serve: rank {r} never launched "
                                     f"{k}")
    return {r: {k: fl[r][k] + sl[r][k] for k in TP_B}
            for r in range(TP_WORLD)}


SOURCES = {
    "paged_decode": ("dynamo_tpu_torch/ops/kernels/csrc/decode.cu",
                     "dynamo_tpu/ops/pallas/decode.py:69"),
    "paged_prefill": ("dynamo_tpu_torch/ops/kernels/csrc/prefill_sm90.cu",
                      "dynamo_tpu/ops/pallas/prefill.py:92"),
    "ragged_mixed": ("dynamo_tpu_torch/ops/kernels/csrc/prefill_sm90.cu",
                     "dynamo_tpu/ops/pallas/ragged.py:49"),
    "mla_decode": ("dynamo_tpu_torch/ops/kernels/csrc/mla_decode.cu",
                   "dynamo_tpu/ops/pallas/mla_decode.py:60"),
    "mla_prefill": ("dynamo_tpu_torch/ops/kernels/csrc/mla_prefill.cu",
                    "dynamo_tpu/ops/pallas/mla_prefill.py:65"),
}
# the shape each kernel's line reports: the main path's largest case
MAIN_CASE = {"paged_decode": 2, "paged_prefill": 0, "ragged_mixed": 0,
             "mla_decode": 2, "mla_prefill": 0}


def run_phase(name, fn, failures):
    """Run one phase, print its seconds; a failure is printed and recorded.
    Returns the phase's result (None after a failure)."""
    t0 = time.perf_counter()
    try:
        return fn()
    except Exception:                      # noqa: BLE001 — reported
        traceback.print_exc()
        failures.append(name)
        return None
    finally:
        gc.collect()
        log(f"[phase] {name} {time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated "
            f"on the card after it")


def model_phases(name, cfg, impls, strict_logits, failures, profile,
                 extras=()):
    """Random weights for ``cfg`` on the card, then its forward and serving
    phases (and the profile), then each of ``extras``: (tag, phase), a
    phase called with (params, cfg, the per-step serves of phase 4d).
    Returns the serve's launch counts, the sampled serve's and {tag: the
    extra phase's result}; the weights are freed before returning."""
    from dynamo_tpu_torch.models import get_family
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.perf_counter()
    params = get_family(cfg).init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {name} L={cfg.num_layers} H={cfg.hidden_size} "
        f"V={cfg.vocab_size} random weights in "
        f"{time.perf_counter() - t1:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card")
    counts = None
    out = {}
    with torch.no_grad():
        run_phase(f"forward {name}",
                  lambda: phase_forward(params, cfg, impls, strict_logits),
                  failures)
        served = run_phase(f"engine {name}",
                           lambda: phase_engine(params, cfg), failures)
        counts, fused = served if served else (None, None)
        per_step = None
        if fused:
            per_step = run_phase(f"per-step {name}",
                                 lambda: phase_per_step(params, cfg, fused),
                                 failures)
        sampled = run_phase(
            f"sampled {name}",
            lambda: phase_sampled(params, cfg, cfg.vocab_size == SAMPLER_V),
            failures)
        if profile:
            run_phase(f"profile {name}", lambda: phase_profile(params, cfg),
                      failures)
        for tag, fn in extras:
            if per_step is None:
                failures.append(f"{tag} {name}: no per-step serve to feed it")
                continue
            out[tag] = run_phase(f"{tag} {name}",
                                 lambda: fn(params, cfg, per_step), failures)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts or {}, sampled or {}, out


def main() -> int:
    args = sys.argv[1:]
    if "--tp-rank" in args:
        # a rank process of phase 8's worlds
        local = (int(args[args.index("--local-rank") + 1])
                 if "--local-rank" in args else 0)
        return tp_rank_main(args[args.index("--tp-rank") + 1], local)
    quick = "--quick" in args
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 2
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    failures = []
    t0 = time.perf_counter()
    try:
        info = build.build_all()
    except Exception:                      # noqa: BLE001 — reported, fatal
        traceback.print_exc()
        return 1
    log(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(info)} "
        f"with {build.nvcc_version()}")
    for name, rec in sorted(info.items()):
        # each kernel's "Compiling entry function" line, then its registers,
        # shared memory, stack and spills; ptxas's notes that it added a
        # wgmma fence (C7519) are counted, not listed
        fences = 0
        for line in rec["ptxas"].splitlines():
            if "(C7519)" in line:
                fences += 1
            elif any(w in line for w in ("entry function", "registers",
                                         "spill", "smem")):
                log(f"[ptxas] {name}: {line.strip()}")
        if fences:
            log(f"[ptxas] {name}: {fences} wgmma fences added by ptxas "
                f"(C7519)")
    results = {}
    run_phase("kernels", lambda: phase_kernels(results), failures)
    run_phase("mla kernels", lambda: phase_mla_kernels(results), failures)
    if "--sweep" in args:
        run_phase("sweep", phase_sweep, failures)
    if quick:
        log(f"[quick] kernel checks {'failed' if failures else 'passed'}")
        return 1 if failures else 0
    counts = {k: 0 for k in SOURCES}
    sampled = {k: 0 for k in SOURCES}
    entry = {}
    disagg = {}
    planner = {}
    slice_counts = {"int8": {}, "spec": {}, "gemma": {}, "dispatch": {},
                    "moe": {}, "gemma9b": {}, "llama1b": {}, "gguf": {}}
    tp = {}
    profile = "--profile" in args
    if not failures:
        # one model on the card at a time: each is freed before the next
        for name, cfg, impls, strict, extras in (
                ("llama32_3b", llama_cfg(), llama_impls(), True,
                 (("int8", phase_int8), ("spec", phase_spec))),
                ("deepseek_v2_lite",
                 cut_depth("deepseek_v2_lite", DEEPSEEK_LAYERS),
                 mla_impls(), False, (("spec", phase_spec_mla),
                                      ("dispatch", phase_dispatch)))):
            c, sc, ex = model_phases(name, cfg, impls, strict, failures,
                                     profile, extras)
            counts.update(c)
            sampled.update(sc)
            for tag, got in ex.items():
                slice_counts[tag].update(got or {})
            if name == "llama32_3b":
                # Gemma-2-27B at GEMMA27_LAYERS of its 46 layers, alone
                slice_counts["gemma"] = served_model_phases(
                    "gemma2_27b", cut_depth("gemma2_27b", GEMMA27_LAYERS),
                    failures, profile)
                # the entry points, with the in-process models freed
                entry = run_phase("serve-entry", phase_serve_entry,
                                  failures) or {}
                run_phase("loader", phase_loader, failures)
                # the KV data plane (phase 6), the model freed again
                t6 = time.perf_counter()
                run_phase("kv-local", phase_kv_local, failures)
                disagg = run_phase("disagg", phase_disagg, failures) or {}
                log(f"[phase] phase 6 {time.perf_counter() - t6:.1f} s")
                # the planner's path (phase 7): profiler, mocker, planner
                planner = run_phase("planner", phase_planner,
                                    failures) or {}
                # a world of two ranks (phase 8): tp, the KV data plane
                # over its cache, dp, pp, sp, and the disaggregated pair
                tp = run_phase("tp", phase_tp, failures) or {}
                # head_dim 256 and 64, each alone on the card, then the
                # GGUF and DeepSeek checkpoint loaders
                slice_counts["gemma9b"] = served_model_phases(
                    "gemma2_9b", ModelConfig.gemma2_9b(), failures, profile)
                slice_counts["llama1b"] = served_model_phases(
                    "llama32_1b", ModelConfig.llama32_1b(), failures,
                    profile, plan=llama_plan, sizes=SERVE_SIZES,
                    per_step=False)
                slice_counts["gguf"] = run_phase(
                    "gguf", phase_gguf, failures) or {}
                run_phase("deepseek loader", phase_deepseek_loader,
                          failures)
        # Qwen3-30B-A3B (61.1 GB of bf16), alone on the card, last
        slice_counts["moe"] = moe_phases(failures, profile)
    if failures:
        log(f"[fail] phases failed: {failures}")
        return 1
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        row = results[name][MAIN_CASE[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "launches_sampled": sampled[name],
            "launches_serve_entry": entry.get(name),
            "launches_disagg": disagg.get(name),
            "launches_planner": planner.get(name),
            "launches_int8": slice_counts["int8"].get(name),
            "launches_spec": slice_counts["spec"].get(name),
            "launches_gemma": slice_counts["gemma"].get(name),
            "launches_moe": slice_counts["moe"].get(name),
            "launches_dispatch": slice_counts["dispatch"].get(name),
            "launches_gemma9b": slice_counts["gemma9b"].get(name),
            "launches_llama1b": slice_counts["llama1b"].get(name),
            "launches_gguf": slice_counts["gguf"].get(name),
            "launches_tp_forward": {
                r: n.get(name) for r, n in tp.get("forward", {}).items()
            } if name in TP_B else None,
            "launches_tp_serve": {
                r: n.get(name) for r, n in tp.get("serve", {}).items()
            } if name in TP_B else None,
            "launches_tp_disagg": {
                r: n.get(name) for r, n in tp.get("disagg", {}).items()
            } if name in TP_B else None,
            "launches_sp": {
                r: n.get(name) for r, n in tp.get("sp", {}).items()
            } if name in TP_B else None,
            "max_abs_err": row["max_abs_err"],
            "max_err_ulps": row["max_err_ulps"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "ms_per_call": row["ms_per_call"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["label"],
            "cases": [{k: r[k] for k in ("label", "ms", "bound_ms",
                                         "plain_ms", "library_ms",
                                         "max_err_ulps")}
                      for r in results[name]]})
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    log(smi_line())               # the card's name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
