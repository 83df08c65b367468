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
   chunks, where the plain version uses the row's final max);
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
   ``TorchEngine._sample_tail`` is timed alone at B=32.

Then, with the Llama model freed, DeepSeek-V2-Lite (MLA + MoE):

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
    the graph-vs-eager block, phase 4d, then phase 4c's sampled workload.

It imports nothing of JAX and nothing of the JAX package. Every phase
prints its seconds. The last line is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels, each with its launches from its own
model's greedy serve (``launches``) and sampled serve
(``launches_sampled``).
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
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


def make_case(rng, B, q_lens, ctxs, S, window=None, softcap=None):
    """A paged cache holding each row's context on distinct random pages in
    every layer (as many layers as ``flush_layers`` asks for timing, at
    least 2; layer 1 is checked), the page table (``max_context // ps``
    wide, unused entries 0) and bf16 queries at the row's last ``q_len``
    positions."""
    L = max(2, flush_layers(kv_rows_read(q_lens, ctxs, window)
                            * HKV * DH * 2 * 2))
    P = 4096 // PS
    need = sum(-(-c // PS) for c in ctxs)
    N = need + 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    pages = torch.randn((L, N, 2, HKV, PS, DH), generator=g, device=dev,
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
    q = torch.randn((B, S, HQ, DH), generator=g, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    return dict(q=q, pages=pages, layers=L,
                table=torch.from_numpy(table).to(dev),
                positions=torch.from_numpy(positions).to(dev),
                total=torch.tensor(ctxs, dtype=torch.int32, device=dev),
                q_lens=list(q_lens), ctxs=list(ctxs), window=window,
                softcap=softcap, sm_scale=DH ** -0.5)


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
    kv_bytes = kv_rows * HKV * DH * 2 * 2
    q_bytes = sum(case["q_lens"]) * HQ * DH * 2   # real query slots only
    out_bytes = B * S * HQ * DH * 2               # pad slots are written zero
    meta = B * (-(-max(case["ctxs"]) // PS)) * 4 + B * 8
    return kv_bytes + q_bytes + out_bytes + meta, 4 * DH * HQ * pairs


def sdpa_inputs(case, S, decode: bool, layer: int):
    """Gathered K/V [B, Hkv, T, Dh] of ``layer`` and a boolean mask for one
    ``scaled_dot_product_attention`` call computing the same function."""
    B = len(case["ctxs"])
    T = -(-max(case["ctxs"]) // PS) * PS
    tbl = case["table"][:, :T // PS].long()
    kv = case["pages"][layer][tbl]                  # [B, n, 2, Hkv, ps, Dh]
    k = kv[:, :, 0].permute(0, 2, 1, 3, 4).reshape(B, HKV, T, DH)
    v = kv[:, :, 1].permute(0, 2, 1, 3, 4).reshape(B, HKV, T, DH)
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


PREFILL_PREFIX_LABEL = "B=4 S=512 prefix hits"


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


def phase_forward(params, cfg, impls, strict_logits=True):
    """The same prefill, mixed and decode steps through three forwards,
    each on its own cache: through the kernels, through the kernels' plain
    versions, and through the JAX-style oracle (``ops.attention`` for the
    Llama tree, the DeepSeek forward's own latent attention: float32 scores
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
    route moves the logits by far more than rounding."""
    from dynamo_tpu_torch.models import deepseek, get_family
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    family = get_family(cfg)
    kernel, plain, oracle = impls
    mla = oracle is None
    rng = np.random.default_rng(1)
    dev = "cuda"
    P = 4096 // PS
    layer_errs = []
    vs_oracle = []          # MLA: per layer, (kernel, plain) vs the oracle
    real_slots = None       # [B, S] bool of the step being run

    def checked(name):
        def attn(*args):
            out = kernel[name](*args)
            ref = plain[name](*args)
            layer_errs.append(float(row_ulp_error(out, ref).max()))
            if mla:
                orc = mla_oracle_latent(cfg, *args)
                vs_oracle.append(
                    (float(row_ulp_error(out, orc)[real_slots].max()),
                     float(row_ulp_error(ref, orc)[real_slots].max())))
            return out
        return attn

    # MLA + MoE: record each MoE layer's routed experts per forward
    routes = {"on": None}
    gate = deepseek._gate

    def recording_gate(cfg_, lp, x):
        w, idx = gate(cfg_, lp, x)
        if routes["on"] is not None:
            routes[routes["on"]].append(idx.sort(dim=-1).values)
        return w, idx

    impls = {"kernel": checked, "plain": lambda n: plain[n],
             "oracle": lambda n: oracle}
    caches = {k: family.make_pages(cfg, 200, PS, device=dev) for k in impls}
    table = np.zeros((2, P), np.int32)
    table[0, :64] = np.arange(1, 65)
    table[1, :64] = np.arange(65, 129)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 1024)).astype(np.int32)
    S = 512
    steps = []
    # prefill: both rows' first 512 tokens
    steps.append(("prefill", prompt[:, :S], np.tile(np.arange(S), (2, 1)),
                  [S, S], [S, S]))
    # mixed: row 0 its next chunk over its cached prefix, row 1 one token
    toks = np.zeros((2, S), np.int32)
    pos = np.zeros((2, S), np.int32)
    toks[0] = prompt[0, S:2 * S]
    pos[0] = np.arange(S, 2 * S)
    toks[1, 0] = prompt[1, S]
    pos[1, 0] = S
    steps.append(("mixed", toks, pos, [2 * S, S + 1], [S, 1]))
    # decode: one token each
    steps.append(("decode", [[7], [9]], [[2 * S], [S + 1]],
                  [2 * S + 1, S + 2], [1, 1]))
    for name, toks, pos, total, new in steps:
        a = [torch.from_numpy(np.asarray(x, np.int32)).to(dev)
             for x in (toks, pos, table, total, new)]
        S_step = a[0].shape[1]
        real_slots = (torch.arange(S_step, device=dev)[None, :]
                      < a[4][:, None])
        logits = {}
        layer_errs.clear()
        vs_oracle.clear()
        deepseek._gate = recording_gate
        try:
            for k, impl in impls.items():
                routes["on"] = k
                routes[k] = []
                logits[k], _ = family.forward(params, cfg, a[0], a[1],
                                              caches[k], a[2], a[3], a[4],
                                              attn_impl=impl(name))
        finally:
            deepseek._gate = gate
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


def route_flips(routes, real_slots):
    """Per MoE layer, the real tokens whose routed expert set differs:
    kernels vs plain and plain vs oracle."""
    out = {}
    for k, other in (("kernel", "plain"), ("oracle", "plain")):
        out[k] = [int(((a != b).any(dim=-1) & real_slots).sum())
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


async def serve(engine, n_req=10, max_tokens=32, seed=2):
    """One serve of greedy requests (prompts made from ``seed``) on a
    running engine, with a step recorder of its own. Returns (stats per
    request, wall seconds, the serve's step records, engine counters and
    graph captures / replays over it)."""
    from dynamo_tpu_torch.engine.steptrace import StepRecorder
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    engine.steptrace = StepRecorder()      # this serve's steps only
    before = {k: getattr(engine, k) for k in SERVE_COUNTERS}
    g = engine.graphs
    g0 = (len(g), g.replays) if g is not None else (0, 0)
    rng = np.random.default_rng(seed)
    V = engine.model_cfg.vocab_size
    lens = [1024, 128, 700, 512, 256, 900, 384, 1000, 640, 160][:n_req]
    prompts = [list(map(int, rng.integers(0, V, size=n))) for n in lens]
    # request 3 shares request 0's first 512 tokens (a prefix-cache hit)
    if n_req > 3:
        prompts[3] = prompts[0][:512] + prompts[3][:256]
    first_n = 6
    started = asyncio.Event()
    stats = {}

    async def one(i):
        if i >= first_n:
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
            if len(toks) >= 4:
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


def serve_engine(params, cfg, seeds, **engine_kw):
    """A fresh ``TorchEngine`` (the reference's defaults but for
    ``engine_kw``) serving ``serve()``'s workload once per seed; returns
    (engine, the serves' results, the family's kernel launches over all
    of them)."""
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    engine = TorchEngine(cfg, params,
                         TorchEngineConfig(**SERVE_SIZES, **engine_kw),
                         device="cuda")
    reset_launch_counts()
    served = run_serve(engine, seeds)
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


def phase_engine(params, cfg):
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
                                          (COLD_SEED, WARM_SEED))
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
    graph_vs_eager(engine)
    return counts, served[1][0]


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
    return x, table[:, :n].reshape(-1).long()


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
        log(f"[graphs] block B={GRAPH_B} ctx={GRAPH_CTX} w={GRAPH_W} "
            f"{label}: replay equals eager bit for bit (packed, carry, KV; "
            f"{len(engine.graphs or ()) - fresh} capture); eager {eager:.3f} ms, "
            f"graph {graph:.3f} ms per block = {eager / GRAPH_W:.3f} / "
            f"{graph / GRAPH_W:.3f} ms per token ({eager / graph:.1f}x)")


# -- phase 4d: the same serve, per step ----------------------------------------


def phase_per_step(params, cfg, fused):
    """Phase 4d: ``serve()``'s workload per step, unpipelined
    (``pipeline_decode=False``: one step, one fetch) and then pipelined
    without fusion (``decode_multistep=1``: step N+1 chained on the device
    while N is fetched), each on a fresh engine with the prompts of phase
    4's warm serve, each with phase 4's report and its per-request token
    agreement with that serve's fused streams ``fused``; where a stream
    differs, its first differing step and the top-2 logit margin there
    (one forward of the prefix alone). The pipelined serve must chain."""
    for tag, kw in (("per-step", dict(pipeline_decode=False)),
                    ("pipelined", dict(decode_multistep=1))):
        engine, served, _counts = serve_engine(params, cfg, (WARM_SEED,),
                                               **kw)
        stats, wall, info = served[0]
        serve_report(stats, wall, info, tag)
        check_stats(stats, cfg)
        same = 0
        for i, s in sorted(stats.items()):
            a, b = s["tokens"], fused[i]["tokens"]
            diff = [j for j, (p, q) in enumerate(zip(a, b)) if p != q]
            if not diff:
                same += 1
                continue
            m = first_step_margin(engine, s["prompt"], a, diff[0],
                                  dict(temperature=0.0))
            log(f"[{tag}] r{i}: {len(diff)} of {len(a)} tokens differ from "
                f"the fused serve; first at step {diff[0]}, top-2 margin "
                f"there {m:.4e}")
        log(f"[{tag}] {same} of {len(stats)} requests token for token as "
            "the fused serve")
        if tag == "pipelined" and info["chained_steps"] <= 0:
            raise AssertionError("the pipelined serve chained no step")
        del engine
        gc.collect()


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
    logits, _ = engine.family.forward(
        engine.params, cfg, t([ids]), t([list(range(n))]), pages, table,
        t([n]), t([n]), attn_impl=engine.attention[kernel])
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
        log(f"[phase] {name} {time.perf_counter() - t0:.1f} s")


def model_phases(name, cfg, impls, strict_logits, failures, profile):
    """Random weights for ``cfg`` on the card, then its forward and serving
    phases (and the profile). Returns the serve's launch counts; the
    weights are freed before returning."""
    from dynamo_tpu_torch.models import get_family
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.perf_counter()
    params = get_family(cfg).init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {name} L={cfg.num_layers} H={cfg.hidden_size} "
        f"V={cfg.vocab_size} random weights in "
        f"{time.perf_counter() - t1:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card")
    counts = None
    with torch.no_grad():
        run_phase(f"forward {name}",
                  lambda: phase_forward(params, cfg, impls, strict_logits),
                  failures)
        served = run_phase(f"engine {name}",
                           lambda: phase_engine(params, cfg), failures)
        counts, fused = served if served else (None, None)
        if fused:
            run_phase(f"per-step {name}",
                      lambda: phase_per_step(params, cfg, fused), failures)
        sampled = run_phase(
            f"sampled {name}",
            lambda: phase_sampled(params, cfg, cfg.vocab_size == SAMPLER_V),
            failures)
        if profile:
            run_phase(f"profile {name}", lambda: phase_profile(params, cfg),
                      failures)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts or {}, sampled or {}


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
    profile = "--profile" in args
    if not failures:
        # one model on the card at a time: each is freed before the next
        for name, cfg, impls, strict in (
                ("llama32_3b", llama_cfg(), llama_impls(), True),
                ("deepseek_v2_lite", ModelConfig.deepseek_v2_lite(),
                 mla_impls(), False)):
            c, sc = model_phases(name, cfg, impls, strict, failures, profile)
            counts.update(c)
            sampled.update(sc)
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
