"""Latent (MLA) paged decode attention (S = 1): wrapper of ``csrc/mla.cu``
(``mla_decode_launch``).

Replaces ``dynamo_tpu/ops/pallas/mla_decode.py`` ``mla_paged_decode_stacked``
and its per-layer variant ``mla_paged_decode_layer`` with the same
signatures (the TPU-only ``interpret`` flag dropped). See the source's note
for the design.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels._wrap import check_mla_args
from dynamo_tpu_torch.ops.kernels.plain import mla_query, plain_mla_attention


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
    q = mla_query(q_lat, q_pe, sm_scale, pages.dtype)
    out = torch.empty((B, 1, nh, dkv), dtype=torch.float32,
                      device=q_lat.device)
    code = build.library("mla").mla_decode_launch(
        q.data_ptr(), pages.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        total_lens.data_ptr(), int(layer_idx), B, nh, dkv, q_pe.shape[-1], N,
        ps, page_table.shape[1], build.stream_ptr(q_lat.device))
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
           "mla_decode_plain"]
