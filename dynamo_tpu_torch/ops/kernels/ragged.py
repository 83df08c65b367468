"""Ragged mixed-step paged attention: wrapper of ``csrc/prefill_sm90.cu``
(``ragged_mixed_launch``).

Replaces ``dynamo_tpu/ops/pallas/ragged.py``
``ragged_mixed_attention_stacked`` with the same signature: a mixed step
packs prefill chunks and decode rows (q_len = 1) into one ``[B, S]`` batch;
row b's real queries are its leading ``total_lens[b] - positions[b, 0]``
slots, and query tiles wholly past them cost no cache traffic. It runs the
paged prefill kernel, whose blocks take the query tiles of long rows, and
spreads each short row's kv range over several blocks whose partials a
merge kernel finishes (split-KV, see the source's note). The launch shape
follows from tensor shapes alone (``ragged_splits``); which rows take the
split path is decided on the device from their q_len.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import (check_cuda_args, softcap_arg,
                                                window_arg)
from dynamo_tpu_torch.ops.kernels.decode import plan_splits, sm_count
from dynamo_tpu_torch.ops.kernels.prefill import paged_prefill_plain

# rows with at most this many real queries take the split path. The
# engine's short rows are its decode rows (q_len 1); a larger cap would
# multiply the f32 partial scratch ([B, Hq, splits, cap, Dh]) for rows the
# engine makes once per prompt at most (a prompt's last short chunk)
SPLIT_Q_CAP = 1
# query rows (slot, head) of one block of the kernel (csrc ROWS)
BLOCK_ROWS = 128
# a split's length aimed at and its least, in positions: a block of the
# wgmma kernel costs more to start than a decode block, so splits are
# longer than decode's (chip_smoke.py --sweep times the choice: 1024 ran
# within 1% of the fastest at the B=8 mixed case)
SPLIT_POSITIONS = 1024
SPLIT_MIN_POSITIONS = 256
# one block of the kernel per SM (65-197 KB of shared memory each, and 288
# threads of up to 224 registers)
BLOCKS_PER_SM = 1


def ragged_splits(B: int, S: int, Hkv: int, G: int, P: int, ps: int,
                  num_sms: int) -> tuple:
    """``(n_work, splits, split_pages)`` of the ragged kernel: the grid is
    ``n_work * B * Hkv`` blocks; a long row's blocks are its
    ``ceil(S / (128 // G))`` query tiles, a short row's its ``splits`` kv
    ranges of ``split_pages`` whole pages each, which cover the table.

    A function of shapes only, never of the row lengths (no host sync, a
    launch shape a CUDA graph can capture): the split count is
    ``plan_splits``' over the ``B * Hkv`` pairs, and ``n_work`` the larger
    of the tile and split counts, so a short row's otherwise idle tiles
    become its splits."""
    n_tiles = -(-S // (BLOCK_ROWS // G))
    splits, per = plan_splits(B * Hkv, P, ps, num_sms, BLOCKS_PER_SM,
                              SPLIT_POSITIONS, SPLIT_MIN_POSITIONS,
                              max(P, 1))
    return max(n_tiles, splits), splits, per


def ragged_mixed_plain(q, pages, layer_idx, page_table, positions,
                       total_lens, sm_scale, window=None, softcap=None):
    """The kernel's plain version. Pad query slots come out zero in both
    kernels, so skipped tiles and masked slots agree with the prefill
    kernel's plain version."""
    return paged_prefill_plain(q, pages, layer_idx, page_table, positions,
                               total_lens, sm_scale, window, softcap)


def ragged_mixed_attention_stacked(q: torch.Tensor, pages: torch.Tensor,
                                   layer_idx, page_table: torch.Tensor,
                                   positions: torch.Tensor,
                                   total_lens: torch.Tensor, sm_scale: float,
                                   window=None, softcap=None) -> torch.Tensor:
    """As ``paged_prefill_attention_stacked`` on a mixed batch."""
    if not q.is_cuda:
        return ragged_mixed_plain(q, pages, layer_idx, page_table, positions,
                                  total_lens, sm_scale, window, softcap)
    check_cuda_args("ragged_mixed", q, pages, layer_idx, page_table,
                    total_lens, positions)
    B, S, Hq, Dh = q.shape
    _L, N, _two, Hkv, ps, _ = pages.shape
    P = page_table.shape[1]
    n_work, splits, per = ragged_splits(B, S, Hkv, Hq // Hkv, P, ps,
                                        sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part_num = torch.empty((B, Hkv, splits, SPLIT_Q_CAP * (Hq // Hkv), Dh),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty(part_num.shape[:-1] + (2,), dtype=torch.float32,
                          device=q.device)
    code = build.library("prefill_sm90").ragged_mixed_launch(
        q.data_ptr(), pages.data_ptr(), out.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), total_lens.data_ptr(),
        int(layer_idx), B, S, Hq, Hkv, Dh, N, ps, P, float(sm_scale),
        window_arg(window), softcap_arg(softcap), part_num.data_ptr(),
        part_ml.data_ptr(), SPLIT_Q_CAP, per, splits, n_work,
        build.stream_ptr(q.device))
    build.check(code, "ragged_mixed")
    LAUNCHES["ragged_mixed"] += 1
    return out


__all__ = ["ragged_mixed_attention_stacked", "ragged_mixed_plain",
           "ragged_splits", "SPLIT_Q_CAP"]
