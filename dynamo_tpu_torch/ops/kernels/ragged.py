"""Ragged mixed-step paged attention: wrapper of ``csrc/prefill.cu``
(``ragged_mixed_launch``).

Replaces ``dynamo_tpu/ops/pallas/ragged.py``
``ragged_mixed_attention_stacked`` with the same signature: a mixed step
packs prefill chunks and decode rows (q_len = 1) into one ``[B, S]`` batch;
row b's real queries are its leading ``total_lens[b] - positions[b, 0]``
slots, and query tiles wholly past them cost no cache traffic.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels.prefill import (launch_flash,
                                                  paged_prefill_plain)


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
    return launch_flash("prefill", "ragged_mixed_launch", "ragged_mixed", q,
                        pages, layer_idx, page_table, positions, total_lens,
                        sm_scale, window, softcap)


__all__ = ["ragged_mixed_attention_stacked", "ragged_mixed_plain"]
