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
   for the prefill kernel's prefix-hit case, the rows past 1 ulp of the
   plain version, each against ``plain.online_attention_rows``, which
   rounds as the kernel does (p against the running max of 64-position
   chunks, where the plain version uses the row's final max); and the
   shapes of speculation and Gemma-2-27B: B1 and B3 at 32 query heads over
   16 (G = 2) with a 4096-position window, softcap 50 and contexts up to
   8192, B2 as a verify step (B = 32, S = K+1 = 5 at G = 3); and B1-B3 at
   query groups 5 (40 heads over 8, Qwen2.5-14B's), 7 (28 over 4,
   Qwen2.5-7B's) and Qwen3-30B-A3B's 8 (32 over 4);
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

Then, with the Llama model freed, Gemma-2-27B (``ModelConfig.gemma2_27b``,
46 layers at full width, 54.5 GB of random bf16 weights made on the card):
its forward on seven steps (``gemma_plan``: a 5633-token row past the
sliding layers' 4096-position window beside a 1502-token one; prefill,
mixed and decode) under phase 3's checks, and phase 4's serve fused (cold,
warm, graph vs eager) and per step; then:

5. Llama-3.2-3B served through the port's entry points, at full width and
   depth in bf16 (random weights from a seed): this script writes a model
   directory (``config.json`` at the published widths, a SentencePiece
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
3b. the full-width, full-depth DeepSeek-V2-Lite forward (random weights
    from a seed; ~31 GB bf16) on a prefill, a mixed and a decode step,
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

Last, Qwen3-30B-A3B (``ModelConfig.qwen3_30b_a3b``: 48 layers, 128 experts
of 768, top-8, 32 query heads over 4, qk-norm; 61.1 GB of random bf16
weights made on the card a layer at a time, after phase 6 has freed its
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
(``launches_disagg``), the int8 serves (``launches_int8``), Gemma-2's
fused serves (``launches_gemma``) and Qwen3-30B-A3B's serves on both
expert backends (``launches_moe``); for the latent kernels, DeepSeek's
serves on the dispatch backend (``launches_dispatch``).
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
              hkv=HKV, max_ctx=4096, sm_scale=DH ** -0.5):
    """A paged cache holding each row's context on distinct random pages in
    every layer (as many layers as ``flush_layers`` asks for timing, at
    least 2; layer 1 is checked), the page table (``max_ctx // ps`` wide,
    unused entries 0) and bf16 queries at the row's last ``q_len``
    positions; ``hq`` query heads over ``hkv`` kv heads (Llama-3.2-3B's by
    default)."""
    L = max(2, flush_layers(kv_rows_read(q_lens, ctxs, window)
                            * hkv * DH * 2 * 2))
    P = max_ctx // PS
    need = sum(-(-c // PS) for c in ctxs)
    N = need + 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    pages = torch.randn((L, N, 2, hkv, PS, DH), generator=g, device=dev,
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
    q = torch.randn((B, S, hq, DH), generator=g, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    return dict(q=q, pages=pages, layers=L,
                table=torch.from_numpy(table).to(dev),
                positions=torch.from_numpy(positions).to(dev),
                total=torch.tensor(ctxs, dtype=torch.int32, device=dev),
                q_lens=list(q_lens), ctxs=list(ctxs), window=window,
                softcap=softcap, sm_scale=sm_scale, hq=hq, hkv=hkv)


def work_of(case, S):
    """(bytes, operations) the function needs on these inputs: each live
    K/V row read once, the real query slots read once, the whole output
    written once, the table entries and lengths read; 4*Dh operations per
    (query head, visible kv position)."""
    B = len(case["ctxs"])
    win = case["window"] or 0
    kv_rows = kv_rows_read(case["q_lens"], case["ctxs"], win)
    pairs = 0
    for ql, ctx in zip(case["q_lens"], case["ctxs"]):
        for p in range(ctx - ql, ctx):
            first = max(p - win + 1, 0) if win else 0
            pairs += p + 1 - first
    hq, hkv = case["hq"], case["hkv"]
    kv_bytes = kv_rows * hkv * DH * 2 * 2
    q_bytes = sum(case["q_lens"]) * hq * DH * 2   # real query slots only
    out_bytes = B * S * hq * DH * 2               # pad slots are written zero
    meta = B * (-(-max(case["ctxs"]) // PS)) * 4 + B * 8
    return kv_bytes + q_bytes + out_bytes + meta, 4 * DH * hq * pairs


def sdpa_inputs(case, S, decode: bool, layer: int):
    """Gathered K/V [B, Hkv, T, Dh] of ``layer`` and a boolean mask for one
    ``scaled_dot_product_attention`` call computing the same function."""
    B = len(case["ctxs"])
    T = -(-max(case["ctxs"]) // PS) * PS
    tbl = case["table"][:, :T // PS].long()
    kv = case["pages"][layer][tbl]                  # [B, n, 2, Hkv, ps, Dh]
    hkv = case["hkv"]
    k = kv[:, :, 0].permute(0, 2, 1, 3, 4).reshape(B, hkv, T, DH)
    v = kv[:, :, 1].permute(0, 2, 1, 3, 4).reshape(B, hkv, T, DH)
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
        if label == PREFILL_PREFIX_LABEL:
            prefill_rows_report(case, S)
        del case


def chunked_rows(case, S, layer, b, h):
    """``online_attention_rows`` (the prefill kernel's own chunked
    rounding) for every real (query slot, head) row of sequence ``b`` and
    kv head ``h``: bf16 [q_len, G, Dh]."""
    from dynamo_tpu_torch.ops.kernels.plain import online_attention_rows
    G = HQ // HKV
    ctx, ql = case["ctxs"][b], case["q_lens"][b]
    n = -(-ctx // PS)
    kv = case["pages"][layer][case["table"][b, :n].long()]  # [n,2,Hkv,ps,Dh]
    k = kv[:, 0, h].reshape(n * PS, DH)
    v = kv[:, 1, h].reshape(n * PS, DH)
    qs = (case["q"][b, :ql, h * G:(h + 1) * G] * case["sm_scale"]).to(
        torch.bfloat16).reshape(ql * G, DH)
    qpos = (ctx - ql + torch.arange(ql, device="cuda")).repeat_interleave(G)
    return online_attention_rows(qs, k, v, qpos, ctx).reshape(ql, G, DH)


def prefill_rows_report(case, S, layer=1):
    """Phase 2's B=4 S=512 prefix-hit case, row by row: the (query slot,
    head) rows where the prefill kernel is more than 1 ulp from its plain
    version, and the kernel and the plain version each against
    ``online_attention_rows``, which rounds p against the running max of
    64-position chunks as the kernel (and the TPU kernel, per its own
    chunk) does, where the plain version rounds against the row's final
    max. Reports; the kernel check above decides."""
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    from dynamo_tpu_torch.ops.kernels.prefill import (
        paged_prefill_attention_stacked, paged_prefill_plain)
    args = (case["q"], case["pages"], layer, case["table"],
            case["positions"], case["total"], case["sm_scale"])
    out = paged_prefill_attention_stacked(*args)
    ref = paged_prefill_plain(*args)
    G = HQ // HKV
    worst = {"kernel_vs_plain": 0.0, "kernel_vs_chunked": 0.0,
             "plain_vs_chunked": 0.0}
    flagged = []
    for b, ql in enumerate(case["q_lens"]):
        for h in range(HKV):
            cols = slice(h * G, (h + 1) * G)
            mir = chunked_rows(case, S, layer, b, h)
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
    log(f"[kernel] paged_prefill B=4 S=512 rows: {len(flagged)} of "
        f"{sum(case['q_lens']) * HQ} past 1 ulp from the plain version; "
        f"max ulps kernel vs plain {worst['kernel_vs_plain']:.3f}, kernel "
        f"vs chunked rounding {worst['kernel_vs_chunked']:.3f}, plain vs "
        f"chunked rounding {worst['plain_vs_chunked']:.3f}")
    for b, slot, head, pos, kp, km, pm in flagged[:16]:
        log(f"[kernel] paged_prefill row b={b} slot={slot} head={head} "
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
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{sys_port}/metrics",
                                timeout=60) as resp:
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
    cfg = llama_cfg()
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
            f"(model {model}, worker pid {children[1].proc.pid}, "
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
                f"{WARM_SEED}, the same requests): {p4['tok_s']:.2f} tok/s, "
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


def _worker_args(model_dir, coord, extra):
    sizes = []
    for k in ("num_pages", "page_size", "max_num_seqs", "max_prefill_chunk",
              "max_context"):
        sizes += [f"--{k.replace('_', '-')}", str(SERVE_SIZES[k])]
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

    def tails(self):
        for k in self.kids.values():
            log(f"[disagg] last 40 lines of {k.name}:\n{k.tail()}")

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
    cfg = llama_cfg()
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


def gemma_phases(failures, profile):
    """Gemma-2-27B at full width and depth (46 layers) in bf16, random
    weights made on the card in bf16 a slab at a time: ``gemma_plan``'s
    forward check (a prompt past the 4096-position window), phase 4's
    greedy serve fused (cold and warm, graph vs eager) and per step.
    Returns the kernels' launches over the fused serves."""
    from dynamo_tpu_torch.models import gemma
    from dynamo_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig.gemma2_27b()
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.perf_counter()
    params = gemma.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] gemma2_27b L={cfg.num_layers} H={cfg.hidden_size} "
        f"V={cfg.vocab_size} random weights in "
        f"{time.perf_counter() - t1:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card")
    counts = None
    with torch.no_grad():
        run_phase("forward gemma2_27b",
                  lambda: phase_forward(params, cfg, llama_impls(), True,
                                        plan=gemma_plan), failures)
        served = run_phase("engine gemma2_27b",
                           lambda: phase_engine(params, cfg, GEMMA_SIZES),
                           failures)
        counts, fused = served if served else (None, None)
        if fused:
            run_phase("per-step gemma2_27b",
                      lambda: phase_per_step(params, cfg, fused,
                                             PER_STEP_MODES[:1],
                                             GEMMA_SIZES), failures)
        if profile:
            run_phase("profile gemma2_27b",
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


# Qwen3-30B-A3B's serving sizes: 1280 pages of 16 positions (48 layers x 4
# kv heads: 1.5 MiB a page, 1.9 GiB in all beside the 56.9 GiB of weights;
# enough for phase 4's workload and the graph-vs-eager block's 1041 pages)
MOE_SIZES = dict(SERVE_SIZES, num_pages=1280)


def moe_phases(failures, profile):
    """Qwen3-30B-A3B at full width and depth (48 layers, 128 experts) in
    bf16, random weights made on the card a layer at a time: phase 3's
    forward check (every layer's B1-B3 against the plain versions, the
    logits under phase 3's gate, the flipped top-8 routes reported: the
    gate's oracle distance flips as many), phase 4's greedy serve fused on
    the dense expert backend
    (cold, warm, graph vs eager), then on the dispatch backend
    (``phase_dispatch``); the replayed block's ms per token against the
    weight floor, and ``memory_allocated`` before and after. Returns the
    kernels' launches over the fused serves of both backends."""
    from dynamo_tpu_torch.models import moe
    from dynamo_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig.qwen3_30b_a3b()
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
    slice_counts = {"int8": {}, "spec": {}, "gemma": {}, "dispatch": {},
                    "moe": {}}
    profile = "--profile" in args
    if not failures:
        # one model on the card at a time: each is freed before the next
        for name, cfg, impls, strict, extras in (
                ("llama32_3b", llama_cfg(), llama_impls(), True,
                 (("int8", phase_int8), ("spec", phase_spec))),
                ("deepseek_v2_lite", ModelConfig.deepseek_v2_lite(),
                 mla_impls(), False, (("spec", phase_spec_mla),
                                      ("dispatch", phase_dispatch)))):
            c, sc, ex = model_phases(name, cfg, impls, strict, failures,
                                     profile, extras)
            counts.update(c)
            sampled.update(sc)
            for tag, got in ex.items():
                slice_counts[tag].update(got or {})
            if name == "llama32_3b":
                # Gemma-2-27B (54.5 GB of bf16), alone on the card
                slice_counts["gemma"] = gemma_phases(failures, profile)
                # the entry points, with the in-process models freed
                entry = run_phase("serve-entry", phase_serve_entry,
                                  failures) or {}
                run_phase("loader", phase_loader, failures)
                # the KV data plane (phase 6), the model freed again
                t6 = time.perf_counter()
                run_phase("kv-local", phase_kv_local, failures)
                disagg = run_phase("disagg", phase_disagg, failures) or {}
                log(f"[phase] phase 6 {time.perf_counter() - t6:.1f} s")
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
            "launches_int8": slice_counts["int8"].get(name),
            "launches_spec": slice_counts["spec"].get(name),
            "launches_gemma": slice_counts["gemma"].get(name),
            "launches_moe": slice_counts["moe"].get(name),
            "launches_dispatch": slice_counts["dispatch"].get(name),
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
