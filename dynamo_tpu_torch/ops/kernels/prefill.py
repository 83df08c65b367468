"""Chunked-prefill paged attention: wrapper of ``csrc/prefill_sm90.cu``
(``paged_prefill_launch``).

Replaces ``dynamo_tpu/ops/pallas/prefill.py``
``paged_prefill_attention_stacked`` with the same signature. See the
source's note for the design.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import (check_cuda_args, softcap_arg,
                                                window_arg)
from dynamo_tpu_torch.ops.kernels.plain import plain_paged_attention


def paged_prefill_plain(q, pages, layer_idx, page_table, positions,
                        total_lens, sm_scale, window=None, softcap=None):
    """The kernel's plain version: row b's queries sit at
    ``positions[b, 0] + s``; slots at or past ``total_lens[b]`` are pad."""
    return plain_paged_attention(q, pages, layer_idx, page_table,
                                 positions[:, 0], total_lens, sm_scale,
                                 window=window, softcap=softcap)


def paged_prefill_attention_stacked(q: torch.Tensor, pages: torch.Tensor,
                                    layer_idx, page_table: torch.Tensor,
                                    positions: torch.Tensor,
                                    total_lens: torch.Tensor, sm_scale: float,
                                    window=None,
                                    softcap=None) -> torch.Tensor:
    """q [B, S, Hq, Dh] (row-contiguous positions; only column 0 is read);
    pages [L, N, 2, Hkv, ps, Dh]; page_table [B, P]; total_lens [B] context
    including the new tokens -> [B, S, Hq, Dh]."""
    if not q.is_cuda:
        return paged_prefill_plain(q, pages, layer_idx, page_table,
                                   positions, total_lens, sm_scale, window,
                                   softcap)
    check_cuda_args("paged_prefill", q, pages, layer_idx, page_table,
                    total_lens, positions)
    B, S, Hq, Dh = q.shape
    _L, N, _two, Hkv, ps, _ = pages.shape
    out = torch.empty_like(q)
    code = build.library("prefill_sm90").paged_prefill_launch(
        q.data_ptr(), pages.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), total_lens.data_ptr(), int(layer_idx), B, S, Hq,
        Hkv, Dh, N, ps, page_table.shape[1], float(sm_scale), window_arg(window),
        softcap_arg(softcap), build.stream_ptr(q.device))
    build.check(code, "paged_prefill")
    LAUNCHES["paged_prefill"] += 1
    return out


__all__ = ["paged_prefill_attention_stacked", "paged_prefill_plain"]
