"""Paged decode attention (S = 1): wrapper of ``csrc/decode.cu``.

Replaces ``dynamo_tpu/ops/pallas/decode.py`` ``paged_decode_attention_stacked``
with the same signature. See the source's note for the design.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import (check_cuda_args, softcap_arg,
                                                window_arg)
from dynamo_tpu_torch.ops.kernels.plain import plain_paged_attention


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
    B, _S, Hq, _Dh = q.shape
    _L, N, _two, Hkv, ps, _ = pages.shape
    out = torch.empty_like(q)
    fn = build.library("decode").paged_decode_launch
    code = fn(q.data_ptr(), pages.data_ptr(), out.data_ptr(),
              page_table.data_ptr(), total_lens.data_ptr(), int(layer_idx),
              B, Hq, Hkv, N, ps, page_table.shape[1], float(sm_scale),
              window_arg(window), softcap_arg(softcap),
              build.stream_ptr(q.device))
    build.check(code, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out


__all__ = ["paged_decode_attention_stacked", "paged_decode_plain"]
