"""Latent (MLA) paged decode attention (S = 1): wrapper of
``csrc/mla_decode.cu`` (``mla_decode_launch``).

Replaces ``dynamo_tpu/ops/pallas/mla_decode.py`` ``mla_paged_decode_stacked``
and its per-layer variant ``mla_paged_decode_layer`` with the same
signatures (the TPU-only ``interpret`` flag dropped). See the source's note
for the design: split-KV, with the split count chosen here from shapes
alone (``mla_decode_splits``).
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import MLA_HEAD_GROUP, check_mla_args
from dynamo_tpu_torch.ops.kernels.decode import plan_splits, sm_count
from dynamo_tpu_torch.ops.kernels.plain import mla_query, plain_mla_attention

# a split's length aimed at and its least, in positions (the least is one
# 64-position chunk of the kernel's ring)
SPLIT_POSITIONS = 256
SPLIT_MIN_POSITIONS = 64
# the most pages a split may hold (csrc/mla_decode.cu MAX_SPLIT_PAGES: its
# page ids sit in shared memory)
SPLIT_MAX_PAGES = 256
# blocks aimed at per SM: one is resident at a time (~170 KB of shared
# memory), two waves let short rows' blocks fill in behind long ones
BLOCKS_PER_SM = 2


def mla_decode_splits(B: int, nh: int, P: int, ps: int,
                      num_sms: int) -> tuple:
    """``(splits, split_pages)`` of the split-KV MLA decode kernel:
    ``plan_splits`` over the ``B * nh / 16`` (row, head group) blocks of a
    split. A function of shapes only, never of the row lengths (no host
    sync; a launch shape a CUDA graph can capture)."""
    return plan_splits(B * max(1, nh // MLA_HEAD_GROUP), P, ps, num_sms,
                       BLOCKS_PER_SM, SPLIT_POSITIONS, SPLIT_MIN_POSITIONS,
                       SPLIT_MAX_PAGES)


def mla_decode_plain(q_lat, q_pe, pages, layer_idx, page_table, total_lens,
                     sm_scale):
    """The kernel's plain version: row b's single query sits at
    ``total_lens[b] - 1``."""
    return plain_mla_attention(q_lat, q_pe, pages, layer_idx, page_table,
                               total_lens.long() - 1, total_lens, sm_scale)


def mla_paged_decode_stacked(q_lat: torch.Tensor, q_pe: torch.Tensor,
                             pages: torch.Tensor, layer_idx,
                             page_table: torch.Tensor,
                             total_lens: torch.Tensor,
                             sm_scale: float) -> torch.Tensor:
    """q_lat [B, 1, nh, dkv] absorbed latent queries (f32 fine; scaled and
    cast in); q_pe [B, 1, nh, dr]; pages [L, N, 2, 1, ps, dkv]; page_table
    [B, P]; total_lens [B] context including the query token -> float32
    [B, 1, nh, dkv] latent attention output."""
    if q_lat.dim() != 4 or q_lat.shape[1] != 1:
        raise ValueError(f"MLA decode kernel requires S=1, got "
                         f"{tuple(q_lat.shape)}")
    if not q_lat.is_cuda:
        return mla_decode_plain(q_lat, q_pe, pages, layer_idx, page_table,
                                total_lens, sm_scale)
    check_mla_args("mla_decode", q_lat, q_pe, pages, layer_idx, page_table,
                   total_lens)
    B, _S, nh, dkv = q_lat.shape
    _L, N, _two, _one, ps, _ = pages.shape
    P = page_table.shape[1]
    dev = q_lat.device
    splits, per = mla_decode_splits(B, nh, P, ps, sm_count(dev.index or 0))
    q = mla_query(q_lat, q_pe, sm_scale, pages.dtype)
    out = torch.empty((B, 1, nh, dkv), dtype=torch.float32, device=dev)
    part_num = part_ml = None
    if splits > 1:
        part_num = torch.empty((B, nh, splits, dkv), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((B, nh, splits, 2), dtype=torch.float32,
                              device=dev)
    code = build.library("mla_decode").mla_decode_launch(
        q.data_ptr(), pages.data_ptr(), out.data_ptr(),
        None if part_num is None else part_num.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        page_table.data_ptr(), total_lens.data_ptr(), int(layer_idx), B, nh,
        dkv, q_pe.shape[-1], N, ps, P, per, splits, build.stream_ptr(dev))
    build.check(code, "mla_decode")
    LAUNCHES["mla_decode"] += 1
    return out


def mla_paged_decode_layer(q_lat: torch.Tensor, q_pe: torch.Tensor,
                           kv_layer: torch.Tensor, page_table: torch.Tensor,
                           total_lens: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    """One layer's ``[N, 2, 1, ps, dkv]`` buffer: the same kernel on a
    one-layer view of it."""
    return mla_paged_decode_stacked(q_lat, q_pe, kv_layer.unsqueeze(0), 0,
                                    page_table, total_lens, sm_scale)


__all__ = ["mla_paged_decode_stacked", "mla_paged_decode_layer",
           "mla_decode_plain", "mla_decode_splits"]
