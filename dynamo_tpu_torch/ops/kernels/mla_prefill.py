"""Latent (MLA) chunked-prefill paged attention: wrapper of
``csrc/mla_prefill.cu`` (``mla_prefill_launch``).

Replaces ``dynamo_tpu/ops/pallas/mla_prefill.py``
``mla_paged_prefill_stacked`` with the same signature (the TPU-only
``interpret`` flag dropped). It serves prefill chunks and mixed steps alike:
row b's real queries are its leading ``total_lens[b] - positions[b, 0]``
slots, and query tiles wholly past them cost no cache traffic. The kernel
reads the unscaled f32 or bf16 queries itself and rounds ``q * sm_scale``
to bf16 (``plain.mla_query``'s arithmetic), so one call runs the kernel and
its merge and nothing else. Decode rows (q_len <= ``SPLIT_Q_CAP``) spread
their context over split-KV blocks whose partials the merge kernel
finishes; the launch shape follows from tensor shapes alone
(``mla_prefill_splits``). See the source's note for the design.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import (MLA_HEAD_GROUP,
                                                check_mla_args,
                                                mla_prefill_stages)
from dynamo_tpu_torch.ops.kernels.decode import plan_splits, sm_count
from dynamo_tpu_torch.ops.kernels.plain import plain_mla_attention

# query slots per block: its 64 rows are 4 slots x 16 heads
TILE_SLOTS = 4
# rows with at most this many real queries take the split path: the
# engine's short rows are its decode rows (q_len 1); the f32 partial scratch
# [B, nh / 16, splits, cap * 16, dkv] grows with the cap
SPLIT_Q_CAP = 1
# a split's length aimed at and its least, in positions; one block of the
# kernel per SM (~218 KB of shared memory); --sweep times the length
SPLIT_POSITIONS = 512
SPLIT_MIN_POSITIONS = 128
BLOCKS_PER_SM = 1


def mla_prefill_splits(B: int, S: int, nh: int, P: int, ps: int,
                       num_sms: int) -> tuple:
    """``(n_work, splits, split_pages)`` of the MLA prefill kernel: the grid
    is ``n_work * B * nh / 16`` blocks; a long row's blocks are its
    ``ceil(S / 4)`` query tiles, a short row's its ``splits`` kv ranges of
    ``split_pages`` whole pages each, which cover the table.

    A function of shapes only, never of the row lengths (no host sync, a
    launch shape a CUDA graph can capture): ``plan_splits`` over the
    ``B * nh / 16`` (row, head group) pairs, and ``n_work`` the larger of
    the tile and split counts, so a short row's otherwise idle tiles become
    its splits."""
    n_tiles = -(-S // TILE_SLOTS)
    splits, per = plan_splits(B * max(1, nh // MLA_HEAD_GROUP), P, ps,
                              num_sms, BLOCKS_PER_SM, SPLIT_POSITIONS,
                              SPLIT_MIN_POSITIONS, max(P, 1))
    return max(n_tiles, splits), splits, per


def mla_prefill_plain(q_lat, q_pe, pages, layer_idx, page_table, positions,
                      total_lens, sm_scale):
    """The kernel's plain version: row b's queries sit at
    ``positions[b, 0] + s``; slots at or past ``total_lens[b]`` are pad."""
    return plain_mla_attention(q_lat, q_pe, pages, layer_idx, page_table,
                               positions[:, 0], total_lens, sm_scale)


def mla_paged_prefill_stacked(q_lat: torch.Tensor, q_pe: torch.Tensor,
                              pages: torch.Tensor, layer_idx,
                              page_table: torch.Tensor,
                              positions: torch.Tensor,
                              total_lens: torch.Tensor,
                              sm_scale: float) -> torch.Tensor:
    """q_lat [B, S, nh, dkv] and q_pe [B, S, nh, dr] (float32 or bfloat16,
    unscaled; scaled and rounded in the kernel; each row contiguous, the
    rows in any order, such as the model's head-major q_lat); pages
    [L, N, 2, 1, ps, dkv]; page_table [B, P]; positions [B, S]
    (row-contiguous; only column 0 is read); total_lens [B] context
    including the new tokens -> float32 [B, S, nh, dkv]."""
    if not q_lat.is_cuda:
        return mla_prefill_plain(q_lat, q_pe, pages, layer_idx, page_table,
                                 positions, total_lens, sm_scale)
    check_mla_args("mla_prefill", q_lat, q_pe, pages, layer_idx, page_table,
                   total_lens, positions)
    B, S, nh, dkv = q_lat.shape
    dr = q_pe.shape[-1]
    _L, N, _two, _one, ps, _ = pages.shape
    P = page_table.shape[1]
    dev = q_lat.device
    n_work, splits, per = mla_prefill_splits(B, S, nh, P, ps,
                                             sm_count(dev.index or 0))
    out = torch.empty((B, S, nh, dkv), dtype=torch.float32, device=dev)
    part_num = torch.empty((B, nh // MLA_HEAD_GROUP, splits,
                            SPLIT_Q_CAP * MLA_HEAD_GROUP, dkv),
                           dtype=torch.float32, device=dev)
    part_ml = torch.empty(part_num.shape[:-1] + (2,), dtype=torch.float32,
                          device=dev)
    code = build.library("mla_prefill").mla_prefill_launch(
        q_lat.data_ptr(), q_pe.data_ptr(), pages.data_ptr(), out.data_ptr(),
        part_num.data_ptr(), part_ml.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), total_lens.data_ptr(), int(layer_idx), B, S, nh,
        dkv, dr, N, ps, P, float(sm_scale),
        int(q_lat.dtype == torch.float32), int(q_pe.dtype == torch.float32),
        *q_lat.stride()[:3], *q_pe.stride()[:3], mla_prefill_stages(dkv, dr),
        SPLIT_Q_CAP, per, splits, n_work, build.stream_ptr(dev))
    build.check(code, "mla_prefill")
    LAUNCHES["mla_prefill"] += 1
    return out


__all__ = ["mla_paged_prefill_stacked", "mla_prefill_plain",
           "mla_prefill_splits", "SPLIT_Q_CAP", "TILE_SLOTS"]
