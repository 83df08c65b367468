"""Quickest proof that the PyTorch + CUDA port serves on the GPU.

    python3 chip_smoke.py            # the whole check, on one CUDA GPU
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --profile  # and a device-time breakdown by kernel

Phases (each prints what it finds; any failure makes the exit code non-zero
and suppresses the final result line):

1. the card (``nvidia-smi``), then a build of every CUDA kernel from
   ``dynamo_tpu_torch/ops/kernels/csrc`` with ``nvcc`` for ``sm_90a``;
2. each kernel against its plain PyTorch version on the card, at the
   Llama-3.2-3B attention shapes (Hq=24, Hkv=8, Dh=128, page 16, bf16), with
   its time (CUDA events, median of 25), the plain version's, one PyTorch
   call's (``scaled_dot_product_attention`` on the gathered KV, a yardstick
   the port never calls) and the least time the card needs for the same
   work (bytes at 3.35 TB/s or operations at 989 TFLOP/s bf16, whichever is
   larger; counted from this run's inputs);
3. the full-width Llama-3.2-3B forward (random weights from a seed) on a
   prefill, a mixed and a decode step, once through the kernels and once
   through their plain versions: every layer's attention must agree within
   2 bf16 ulps per row, and the logits within 1.5 times the distance
   between the plain versions and the JAX-style oracle ``ops.attention``,
   which differ only in where they round;
4. ``TorchEngine`` serving greedy requests at full width: prompts of
   128-1024 seeded token ids, two sharing a prefix, some arriving while
   others decode; every request must finish with its tokens, no NaN, and
   the decode, prefill and ragged kernels must all have launched.

Then, with the Llama model freed, DeepSeek-V2-Lite (MLA + MoE):

2b. each latent (MLA) kernel against its plain version at V2-Lite's
    shapes (nh=16, dkv=512, dr=64, page 16, bf16), NaN in the garbage page:
    decode at B = 1, 8, 32 (contexts up to 4096, one of 1 token), prefill
    B=4 S=512 with prefix hits and a 300-token row, and a mixed batch (two
    chunks + six decode rows at S=512); within 2 bf16 ulps per (query,
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
    forwards that differ in rounding;
4b. ``TorchEngine`` serving DeepSeek-V2-Lite with phase 4's workload: every
    request finishes with 32 finite-logprob tokens and both latent kernels
    launch.

It imports nothing of JAX and nothing of the JAX package. Every phase
prints its seconds. The last line is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels, each with its launches from its own
model's serve.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# -- phase 2: kernels against their plain versions -------------------------


def make_case(rng, B, q_lens, ctxs, S, L=2, window=None, softcap=None):
    """A paged cache holding each row's context on distinct random pages,
    the page table (``max_context // ps`` wide, unused entries 0) and bf16
    queries at the row's last ``q_len`` positions."""
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
    return dict(q=q, pages=pages, layer=1,
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
    kv_rows, pairs = 0, 0
    for ql, ctx in zip(case["q_lens"], case["ctxs"]):
        lo = max(ctx - ql - win + 1, 0) if win else 0
        kv_rows += ctx - lo
        for p in range(ctx - ql, ctx):
            first = max(p - win + 1, 0) if win else 0
            pairs += p + 1 - first
    kv_bytes = kv_rows * HKV * DH * 2 * 2
    q_bytes = sum(case["q_lens"]) * HQ * DH * 2   # real query slots only
    out_bytes = B * S * HQ * DH * 2               # pad slots are written zero
    meta = B * (-(-max(case["ctxs"]) // PS)) * 4 + B * 8
    return kv_bytes + q_bytes + out_bytes + meta, 4 * DH * HQ * pairs


def sdpa_inputs(case, S, decode: bool):
    """Gathered K/V [B, Hkv, T, Dh] and a boolean mask for one
    ``scaled_dot_product_attention`` call computing the same function."""
    B = len(case["ctxs"])
    T = -(-max(case["ctxs"]) // PS) * PS
    tbl = case["table"][:, :T // PS].long()
    kv = case["pages"][case["layer"]][tbl]          # [B, n, 2, Hkv, ps, Dh]
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


def judge(name, label, run, plain, library, q_lens, work, results):
    """Hold one kernel case against its plain version: per (query slot,
    head) row within KERNEL_TOL_ULPS on the real slots, finite, pad slots
    exactly zero; then time the kernel's wrapper, the plain version and
    the library call (``library`` is None where no PyTorch call computes
    the function) and record the row with its bound."""
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    out = run()
    torch.cuda.synchronize()
    ref = plain()
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
    ms = time_ms(run)
    plain_ms = time_ms(plain, reps=10)
    lib_ms = time_ms(library) if library is not None else None
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOPS_PER_S * 1e3
    row = dict(label=label, max_abs_err=err, max_err_ulps=ulps, ms=ms,
               plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"[kernel] {name} {label}: max|d|={err:.3e} row err={ulps:.3f} "
        f"ulps (tol {KERNEL_TOL_ULPS}) "
        f"finite={finite} pad_zero={pad_zero} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib} "
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
    args = (q, case["pages"], case["layer"], case["table"],
            case["positions"][:, :1].contiguous() if decode
            else case["positions"], case["total"], case["sm_scale"])
    kw = dict(window=case["window"], softcap=case["softcap"])
    qs, k, v, mask = sdpa_inputs(case, S, decode)
    judge(name, label, lambda: fn(*args, **kw), lambda: plain(*args, **kw),
          lambda: F.scaled_dot_product_attention(
              qs, k, v, attn_mask=mask, scale=case["sm_scale"],
              enable_gqa=True),
          case["q_lens"], work_of(case, 1 if decode else S), results)


def phase_kernels(results):
    from dynamo_tpu_torch.ops.kernels.decode import (
        paged_decode_attention_stacked, paged_decode_plain)
    from dynamo_tpu_torch.ops.kernels.prefill import (
        paged_prefill_attention_stacked, paged_prefill_plain)
    from dynamo_tpu_torch.ops.kernels.ragged import (
        ragged_mixed_attention_stacked, ragged_mixed_plain)
    rng = np.random.default_rng(0)
    # B1: decode at B in {1, 8, 32}, ragged contexts up to 4096
    for B in (1, 8, 32):
        ctxs = [4096] + list(rng.integers(1, 4097, size=B - 1))
        if B > 2:
            ctxs[1] = 1
        case = make_case(rng, B, [1] * B, ctxs, 1)
        check_kernel("paged_decode", paged_decode_attention_stacked,
                     paged_decode_plain, case, 1, True, results,
                     f"B={B} ctx<={max(ctxs)}")
    case = make_case(rng, 8, [1] * 8, list(rng.integers(1500, 4097, 8)), 1,
                     window=1024, softcap=30.0)
    check_kernel("paged_decode", paged_decode_attention_stacked,
                 paged_decode_plain, case, 1, True, results,
                 "B=8 window=1024 softcap=30")
    # B2: S=512 chunks, rows with prefix hits and one partial chunk
    S = 512
    qls, ctxs = [512, 512, 512, 300], [512, 1024, 3000, 1836]
    case = make_case(rng, 4, qls, ctxs, S)
    check_kernel("paged_prefill", paged_prefill_attention_stacked,
                 paged_prefill_plain, case, S, False, results,
                 "B=4 S=512 prefix hits")
    case = make_case(rng, 2, [512, 512], [2048, 512], S, window=256,
                     softcap=50.0)
    check_kernel("paged_prefill", paged_prefill_attention_stacked,
                 paged_prefill_plain, case, S, False, results,
                 "B=2 S=512 window=256 softcap=50")
    # B3: two 512-token chunks (one over a prefix) + six decode rows
    qls = [512, 512, 1, 1, 1, 1, 1, 1]
    ctxs = [1024, 512] + list(rng.integers(64, 4097, size=6))
    case = make_case(rng, 8, qls, ctxs, S)
    check_kernel("ragged_mixed", ragged_mixed_attention_stacked,
                 ragged_mixed_plain, case, S, False, results,
                 "B=8 S=512 2 chunks + 6 decode rows")


# -- phase 2b: the latent (MLA) kernels against their plain versions -------


def make_mla_case(rng, q_lens, ctxs, S, L=2):
    """A latent cache [L, N, 2, 1, ps, dkv] holding each row's context on
    distinct random pages (slot 1: the rope key, zero past its dr columns,
    as the model writes it; the garbage page NaN), the page table
    (``max_context // ps`` wide) and queries at the row's last ``q_len``
    positions: float32 ``q_lat`` (as the model computes it) and bf16
    ``q_pe``."""
    B = len(ctxs)
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
    return dict(q_lat=q_lat, q_pe=q_pe, pages=pages, layer=1,
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
    call and the backend PyTorch picks for it."""
    import torch.nn.functional as F
    B = len(case["ctxs"])
    T = -(-max(case["ctxs"]) // PS) * PS
    tbl = case["table"][:, :T // PS].long()
    # [B, n, 2, 1, ps, dkv]
    kv = torch.nan_to_num(case["pages"][case["layer"]][tbl])
    ckv = kv[:, :, 0, 0].reshape(B, T, DKV)
    kpe = kv[:, :, 1, 0, :, :DR].reshape(B, T, DR)
    k = torch.cat([ckv, kpe], dim=-1)[:, None]
    v = ckv[:, None].contiguous()
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
            q, k, v, attn_mask=mask, scale=case["sm_scale"],
            enable_gqa=True)).name
    except Exception as e:                  # noqa: BLE001 — report only
        backend = f"unknown ({type(e).__name__})"
    return (lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=case["sm_scale"], enable_gqa=True)), \
        backend


def check_mla(name, case, S, decode, results, label):
    from dynamo_tpu_torch.ops.kernels.mla_decode import (
        mla_decode_plain, mla_paged_decode_stacked)
    from dynamo_tpu_torch.ops.kernels.mla_prefill import (
        mla_paged_prefill_stacked, mla_prefill_plain)
    c = case
    if decode:
        args = (c["q_lat"][:, :1].contiguous(), c["q_pe"][:, :1].contiguous(),
                c["pages"], c["layer"], c["table"], c["total"], c["sm_scale"])
        fn, plain = mla_paged_decode_stacked, mla_decode_plain
    else:
        args = (c["q_lat"], c["q_pe"], c["pages"], c["layer"], c["table"],
                c["positions"], c["total"], c["sm_scale"])
        fn, plain = mla_paged_prefill_stacked, mla_prefill_plain
    library, backend = mla_sdpa(case, S, decode)
    log(f"[kernel] {name} {label}: library call "
        f"scaled_dot_product_attention served by {backend}")
    judge(name, label, lambda: fn(*args), lambda: plain(*args), library,
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
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    family = get_family(cfg)
    kernel, plain, oracle = impls
    rng = np.random.default_rng(1)
    dev = "cuda"
    P = 4096 // PS
    layer_errs = []

    def checked(name):
        def attn(*args):
            out = kernel[name](*args)
            ref = plain[name](*args)
            layer_errs.append(float(row_ulp_error(out, ref).max()))
            return out
        return attn

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
        logits = {}
        layer_errs.clear()
        for k, impl in impls.items():
            logits[k], _ = family.forward(params, cfg, a[0], a[1],
                                          caches[k], a[2], a[3], a[4],
                                          attn_impl=impl(name))
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
        if diff > tol:
            log(f"[forward] {name}: logits gate exceeded ({diff:.4e} > "
                f"{tol:.4e}); reported only: the per-layer check decides "
                f"(random MoE gates can flip a near-tie route)")


# -- phase 4: the engine serving requests ----------------------------------


async def serve(engine, n_req=10, max_tokens=32):
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    rng = np.random.default_rng(2)
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
            token_ids=prompts[i], request_id=f"r{i}",
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
        stats[i] = dict(ttft=ttft, tokens=toks, logprobs=lps, finish=fin)
    t0 = time.perf_counter()
    await asyncio.gather(*(one(i) for i in range(n_req)))
    wall = time.perf_counter() - t0
    await engine.stop()
    return stats, wall


def phase_engine(params, cfg):
    """Serve ``serve()``'s workload; every request must finish with its 32
    tokens and finite logprobs, and each of the family's kernels must have
    launched. Returns those kernels' launch counts over the serve."""
    from dynamo_tpu_torch.engine.steptrace import (StepRecorder,
                                                   set_step_recorder)
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    set_step_recorder(StepRecorder())      # this serve's steps only
    engine = TorchEngine(cfg, params, TorchEngineConfig(
        num_pages=4096, page_size=PS, max_num_seqs=32, max_prefill_chunk=512,
        max_prefill_seqs=8, max_context=4096), device="cuda")
    reset_launch_counts()
    stats, wall = asyncio.run(serve(engine))
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in engine.kernel_launches}
    by_kind = {}
    for rec in engine.steptrace.snapshot(limit=4096)["records"]:
        by_kind.setdefault(rec["kind"], []).append(rec["dispatch_ms"])
    for kind, ms in sorted(by_kind.items()):
        log(f"[engine] steps kind={kind} n={len(ms)} dispatch_ms "
            f"median={float(np.median(ms)):.2f} max={max(ms):.2f}")
    n_tok = sum(len(s["tokens"]) for s in stats.values())
    ttfts = sorted(s["ttft"] for s in stats.values())
    log(f"[engine] {len(stats)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; TTFT p50={ttfts[len(ttfts) // 2]:.3f} s "
        f"max={ttfts[-1]:.3f} s; mixed_steps={engine.mixed_steps} "
        f"launches={counts}")
    for i, s in sorted(stats.items()):
        if len(s["tokens"]) != 32 or s["finish"] is None \
                or s["finish"].value != "length":
            raise AssertionError(f"request {i}: {len(s['tokens'])} tokens, "
                                 f"finish {s['finish']}")
        if not all(math.isfinite(x) for x in s["logprobs"]):
            raise AssertionError(f"request {i}: non-finite logprobs")
        if any(not (0 <= t < cfg.vocab_size) for t in s["tokens"]):
            raise AssertionError(f"request {i}: token out of vocab")
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched while serving")
    return counts


def phase_profile(params, cfg):
    """``--profile`` only: device time by kernel over a short serving run
    (4 requests of 256 prompt tokens, 16 new tokens each), from
    ``torch.profiler``; the device's busy share is the summed kernel time
    over the run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    engine = TorchEngine(cfg, params, TorchEngineConfig(
        num_pages=1024, page_size=PS, max_num_seqs=32, max_prefill_chunk=512,
        max_context=4096), device="cuda")
    asyncio.run(serve(engine, n_req=2, max_tokens=4))       # warm up
    engine = TorchEngine(cfg, params, TorchEngineConfig(
        num_pages=1024, page_size=PS, max_num_seqs=32, max_prefill_chunk=512,
        max_context=4096), device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(serve(engine, n_req=4, max_tokens=16))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    rows.sort(key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    log(f"[profile] wall={wall:.3f} s device busy={busy:.3f} s "
        f"({100 * busy / wall:.1f}%)")
    for e in rows[:12]:
        log(f"[profile] {dev_us(e) / 1e3:9.2f} ms  n={e.count:6d}  "
            f"{e.key[:90]}")


SOURCES = {
    "paged_decode": ("dynamo_tpu_torch/ops/kernels/csrc/decode.cu",
                     "dynamo_tpu/ops/pallas/decode.py:69"),
    "paged_prefill": ("dynamo_tpu_torch/ops/kernels/csrc/prefill.cu",
                      "dynamo_tpu/ops/pallas/prefill.py:92"),
    "ragged_mixed": ("dynamo_tpu_torch/ops/kernels/csrc/prefill.cu",
                     "dynamo_tpu/ops/pallas/ragged.py:49"),
    "mla_decode": ("dynamo_tpu_torch/ops/kernels/csrc/mla.cu",
                   "dynamo_tpu/ops/pallas/mla_decode.py:60"),
    "mla_prefill": ("dynamo_tpu_torch/ops/kernels/csrc/mla.cu",
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
        counts = run_phase(f"engine {name}",
                           lambda: phase_engine(params, cfg), failures)
        if profile:
            run_phase(f"profile {name}", lambda: phase_profile(params, cfg),
                      failures)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts or {}


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
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[ptxas] {name}: {line.strip()}")
    results = {}
    run_phase("kernels", lambda: phase_kernels(results), failures)
    run_phase("mla kernels", lambda: phase_mla_kernels(results), failures)
    if quick:
        log(f"[quick] kernel checks {'failed' if failures else 'passed'}")
        return 1 if failures else 0
    counts = {k: 0 for k in SOURCES}
    profile = "--profile" in args
    if not failures:
        # one model on the card at a time: each is freed before the next
        counts.update(model_phases("llama32_3b", llama_cfg(), llama_impls(),
                                   True, failures, profile))
        counts.update(model_phases(
            "deepseek_v2_lite", ModelConfig.deepseek_v2_lite(), mla_impls(),
            False, failures, profile))
    if failures:
        log(f"[fail] phases failed: {failures}")
        return 1
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        row = results[name][MAIN_CASE[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": row["max_abs_err"],
            "max_err_ulps": row["max_err_ulps"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["label"]})
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    log(smi_line())               # the card's name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
