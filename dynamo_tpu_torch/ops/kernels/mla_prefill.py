"""Latent (MLA) chunked-prefill paged attention: wrapper of ``csrc/mla.cu``
(``mla_prefill_launch``).

Replaces ``dynamo_tpu/ops/pallas/mla_prefill.py``
``mla_paged_prefill_stacked`` with the same signature (the TPU-only
``interpret`` flag dropped). It serves prefill chunks and mixed steps alike:
row b's real queries are its leading ``total_lens[b] - positions[b, 0]``
slots, and query tiles wholly past them cost no cache traffic. See the
source's note for the design.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import check_mla_args
from dynamo_tpu_torch.ops.kernels.plain import mla_query, plain_mla_attention


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
    """q_lat [B, S, nh, dkv] (f32 fine; scaled and cast in); q_pe
    [B, S, nh, dr]; pages [L, N, 2, 1, ps, dkv]; page_table [B, P];
    positions [B, S] (row-contiguous; only column 0 is read); total_lens
    [B] context including the new tokens -> float32 [B, S, nh, dkv]."""
    if not q_lat.is_cuda:
        return mla_prefill_plain(q_lat, q_pe, pages, layer_idx, page_table,
                                 positions, total_lens, sm_scale)
    check_mla_args("mla_prefill", q_lat, q_pe, pages, layer_idx, page_table,
                   total_lens, positions)
    B, S, nh, dkv = q_lat.shape
    _L, N, _two, _one, ps, _ = pages.shape
    q = mla_query(q_lat, q_pe, sm_scale, pages.dtype)
    out = torch.empty((B, S, nh, dkv), dtype=torch.float32,
                      device=q_lat.device)
    code = build.library("mla").mla_prefill_launch(
        q.data_ptr(), pages.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), total_lens.data_ptr(), int(layer_idx), B, S, nh,
        dkv, q_pe.shape[-1], N, ps, page_table.shape[1],
        build.stream_ptr(q_lat.device))
    build.check(code, "mla_prefill")
    LAUNCHES["mla_prefill"] += 1
    return out


__all__ = ["mla_paged_prefill_stacked", "mla_prefill_plain"]
