"""Paged decode attention (S = 1): wrapper of ``csrc/decode.cu``.

Replaces ``dynamo_tpu/ops/pallas/decode.py`` ``paged_decode_attention_stacked``
with the same signature. See the source's note for the design: split-KV,
with the split count chosen here from shapes alone (``decode_splits``).
"""

from __future__ import annotations

import functools

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import (check_cuda_args, softcap_arg,
                                                window_arg)
from dynamo_tpu_torch.ops.kernels.plain import plain_paged_attention


# the split length aimed at, in positions: shorter splits pay each block's
# start-up more often, longer ones leave the card waiting on the longest
# rows; tools/decode_split_sweep.py measures the trade on the card
SPLIT_POSITIONS = 320
# the least context a split takes on, in positions: below it a block's
# pipeline barely fills before it drains
SPLIT_MIN_POSITIONS = 128
# the most pages a split may hold (csrc/decode.cu MAX_SPLIT_PAGES: its page
# ids sit in shared memory)
SPLIT_MAX_PAGES = 512
# blocks of the kernel one SM holds at once (66.5 KB of shared memory each)
BLOCKS_PER_SM = 3


def plan_splits(pairs: int, P: int, ps: int, num_sms: int,
                blocks_per_sm: int, split_positions: int,
                min_positions: int, max_pages: int) -> tuple:
    """``(splits, split_pages)`` of a split-KV kernel with ``pairs`` blocks
    per split: every split is ``split_pages`` whole pages of the ``P``-wide
    table and the splits cover it (``(splits - 1) * split_pages < P <=
    splits * split_pages``). Splits of about ``split_positions`` positions,
    more where ``pairs`` would not give every SM ``blocks_per_sm`` blocks,
    none shorter than ``min_positions`` positions or longer than
    ``max_pages`` pages."""
    if P <= 0:
        return 1, 0
    fill = -(-blocks_per_sm * num_sms // max(1, pairs))
    by_length = -(-P * ps // split_positions)
    most = max(1, (P * ps) // min_positions)
    splits = max(min(max(fill, by_length), most), -(-P // max_pages))
    splits = max(1, min(splits, P))
    per = -(-P // splits)
    return -(-P // per), per


def decode_splits(B: int, Hkv: int, P: int, ps: int,
                  num_sms: int) -> tuple:
    """``(splits, split_pages)`` of the split-KV decode kernel
    (``plan_splits`` over the ``B * Hkv`` (row, kv head) pairs).

    A function of shapes only, never of the row lengths: reading
    ``total_lens`` here would add a device sync to every decode step, and a
    data-dependent launch shape could not be captured in a CUDA graph.
    Splits of about ``SPLIT_POSITIONS`` positions, more where the pairs
    would not give every SM ``BLOCKS_PER_SM`` blocks, none shorter than
    ``SPLIT_MIN_POSITIONS`` positions or longer than ``SPLIT_MAX_PAGES``
    pages."""
    return plan_splits(B * Hkv, P, ps, num_sms, BLOCKS_PER_SM,
                       SPLIT_POSITIONS, SPLIT_MIN_POSITIONS, SPLIT_MAX_PAGES)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_decode_plain(q, pages, layer_idx, page_table, positions,
                       total_lens, sm_scale, window=None, softcap=None):
    """The kernel's plain version: the single query of row b sits at
    ``total_lens[b] - 1`` (``positions`` is not read, as in the kernel)."""
    return plain_paged_attention(q, pages, layer_idx, page_table,
                                 total_lens.long() - 1, total_lens, sm_scale,
                                 window=window, softcap=softcap)


def paged_decode_attention_stacked(q: torch.Tensor, pages: torch.Tensor,
                                   layer_idx, page_table: torch.Tensor,
                                   positions: torch.Tensor,
                                   total_lens: torch.Tensor, sm_scale: float,
                                   window=None, softcap=None) -> torch.Tensor:
    """q [B, 1, Hq, Dh]; pages [L, N, 2, Hkv, ps, Dh]; page_table [B, P];
    total_lens [B] context including the query token -> [B, 1, Hq, Dh]."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode kernel requires S=1, got {tuple(q.shape)}")
    if not q.is_cuda:
        return paged_decode_plain(q, pages, layer_idx, page_table, positions,
                                  total_lens, sm_scale, window, softcap)
    check_cuda_args("paged_decode", q, pages, layer_idx, page_table,
                    total_lens)
    B, _S, Hq, Dh = q.shape
    _L, N, _two, Hkv, ps, _ = pages.shape
    P = page_table.shape[1]
    sms = sm_count(q.device.index or 0)
    splits, per = decode_splits(B, Hkv, P, ps, sms)
    out = torch.empty_like(q)
    part_num = part_ml = None
    if splits > 1:
        part_num = torch.empty((B, Hq, splits, Dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, Hq, splits, 2), dtype=torch.float32,
                              device=q.device)
    fn = build.library("decode").paged_decode_launch
    code = fn(q.data_ptr(), pages.data_ptr(), out.data_ptr(),
              None if part_num is None else part_num.data_ptr(),
              None if part_ml is None else part_ml.data_ptr(),
              page_table.data_ptr(), total_lens.data_ptr(), int(layer_idx),
              B, Hq, Hkv, N, ps, P, per, splits, float(sm_scale),
              window_arg(window), softcap_arg(softcap),
              build.stream_ptr(q.device))
    build.check(code, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out


__all__ = ["paged_decode_attention_stacked", "paged_decode_plain",
           "decode_splits", "plan_splits", "sm_count"]
