"""Sequence-parallel long-prompt prefill that fills the paged KV cache.

The port of ``dynamo_tpu/parallel/ring_prefill.py``: the serving
forward's contract (params, cfg, tokens, positions, pages, page_table,
total_lens, new_lens) -> (last-token logits, pages), with the sequence
axis sharded over the ``sp`` ranks and attention run as a ring
(``parallel/ring_attention.py``: K/V shards rotate round the ranks)
instead of reading the cache. One step prefills a whole prompt, its
compute and activations split ``sp`` ways, where a chunked prefill of
length S would re-read the cache O(S / chunk) times on one card. The K/V
written to the cache are what the chunked prefill writes, so decode and
the router's block hashes go on as after any prefill.

Each rank runs its ``S / sp`` positions at its ``sp`` coordinate through
the Llama tree's layer helpers (``models/llama._project_qkv`` and
``_finish_layer``, as the reference runs llama's on every family; the
engine refuses the families it cannot serve so). Per layer:

- the cache write: the cache is replicated over ``sp`` (as over ``dp``),
  so the layer's new K/V are gathered over ``sp`` first and every replica
  writes every position, and the replicas stay byte-equal;
- the ring's partials over the new tokens, merged with the partials of
  the resident prefix (the cached positions below ``positions[:, 0]``;
  none for a novel prompt, and then no chunk is read):
  ``ops.attention._attend_blockwise`` over the cache, the port's copy of
  the reference's blockwise XLA attention, which the reference's ring
  runs whatever its ``attn_impl`` is. It stands for no kernel: the
  reference reaches no Pallas kernel on this step either;
- the post-attention tail, whose row-parallel sums run over ``tp`` inside
  the rank's ``sp`` coordinate (the heads stay split over ``tp`` inside
  the ring: attention is head-local).

The logits are taken at each row's last real token: the rank holding that
position contributes its hidden row and a sum over ``sp`` (zeros
elsewhere, exact) gives every rank the same rows, so every rank samples
the same token. MLA has no ring in either package: the page size is read
from ``pages.shape[-2]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import (_finish_layer, _project_qkv,
                                           _rms_norm, head_logits)
from dynamo_tpu_torch.ops.attention import (PAGES_PER_CHUNK,
                                            _attend_blockwise,
                                            _gathered_to_bhtd, _pad_table,
                                            merge_softmax_partials,
                                            normalize_softmax_partials,
                                            write_kv)
from dynamo_tpu_torch.parallel.ring_attention import ring_attention
from dynamo_tpu_torch.parallel.sharding import local_config


def ring_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, pages: torch.Tensor,
                 page_table: torch.Tensor, total_lens: torch.Tensor,
                 new_lens: torch.Tensor, *, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-prompt prefill with the sequence axis sharded over ``sp``.

    ``cfg`` is the whole model's config; ``params`` and ``pages`` (the
    stacked cache, written in place) this rank's shards, split over
    ``tp`` as ``ModelSharding`` places them. The ring runs over the
    mesh's ``sp`` axis and the row-parallel sums over its ``tp``: the
    reference's ``sp_axis`` / ``tp_axis`` arguments, which no caller sets
    to another axis, have no counterpart. tokens/positions: [B, S] with S
    a multiple of the ``sp`` axis size, the same on every rank;
    pads masked via ``new_lens`` exactly like ``llama.forward``. Positions
    may start past 0: the resident prefix (pages below ``positions[:, 0]``
    in the table) is attended blockwise and merged into the ring's online
    softmax. Every rank of the world calls it with the same arrays.
    Returns (float32 logits [B, vocab] at each row's last real token,
    pages)."""
    sm_scale = cfg.head_dim ** -0.5
    B, S = tokens.shape
    sp, c = mesh.shape["sp"], mesh.coords["sp"]
    if S % sp:
        raise ValueError(f"padded prompt length {S} not divisible by "
                         f"sp={sp}")
    lcfg = local_config(cfg, mesh)
    Hkv, G = lcfg.num_kv_heads, lcfg.num_heads // lcfg.num_kv_heads
    Sl = S // sp
    mine = slice(c * Sl, (c + 1) * Sl)
    dev = tokens.device
    kv_valid = (torch.arange(S, device=dev)[None, :]
                < new_lens.long()[:, None])                     # [B, S]
    start = positions[:, 0]                                     # prefix len
    table = _pad_table(page_table.long(), PAGES_PER_CHUNK)
    pos = positions[:, mine]
    valid = kv_valid[:, mine]
    ps = pages.shape[-2]
    h = params["embed"][tokens[:, mine].long()]                 # [B, Sl, H]
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in layers.items()}
        q, k, v = _project_qkv(lcfg, lp, h, pos)
        # every replica writes every position: the new K/V over sp first
        kv = mesh.all_gather(torch.stack([k, v]), "sp", dim=2)
        write_kv(pages, l, kv[0], kv[1], page_table, positions, new_lens)
        ring_parts = ring_attention(q, k, v, pos, pos, valid,
                                    sm_scale=sm_scale, mesh=mesh,
                                    return_partials=True)
        layer = pages[l]

        def gather_chunk(ci, layer=layer):
            tbl = table[:, ci * PAGES_PER_CHUNK:(ci + 1) * PAGES_PER_CHUNK]
            g = layer[tbl]                     # [B, C, 2, Hkv, ps, Dh]
            return (_gathered_to_bhtd(g[:, :, 0]),
                    _gathered_to_bhtd(g[:, :, 1]))

        # cached-context partials: the new queries vs positions < start
        # (no chunk is read when there is no resident prefix)
        qg = q.reshape(B, Sl, Hkv, G, cfg.head_dim)
        ctx_parts = _attend_blockwise(
            qg, gather_chunk, page_table.shape[1], ps, PAGES_PER_CHUNK,
            pos, start, sm_scale, return_partials=True)
        num, den, _mx = merge_softmax_partials(ring_parts, ctx_parts)
        out = normalize_softmax_partials(num, den)          # [B,Hq,Sl,D]
        attn = out.transpose(1, 2).to(q.dtype)              # [B,Sl,Hq,D]
        h = _finish_layer(lcfg, lp, h, attn, mesh)
    # each row's last real token: its rank's hidden row, summed over sp
    # with zeros elsewhere (exact), so every rank projects the same rows
    last = torch.clamp(new_lens.long() - 1, min=0)
    here = (last >= c * Sl) & (last < (c + 1) * Sl)
    rows = torch.arange(B, device=dev)
    h_sel = h[rows, torch.clamp(last - c * Sl, 0, Sl - 1)]
    h_sel = mesh.all_reduce(
        torch.where(here[:, None], h_sel, torch.zeros_like(h_sel)), "sp")
    h_sel = _rms_norm(h_sel, params["final_norm"], cfg.rms_norm_eps)
    return head_logits(params, h_sel, mesh, cfg.vocab_size), pages


__all__ = ["ring_prefill"]
