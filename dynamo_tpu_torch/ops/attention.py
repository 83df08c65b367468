"""Paged attention over the page-major KV cache — the plain PyTorch oracles.

The port's copy of ``dynamo_tpu/ops/attention.py``, in PyTorch. The cache
layout is the reference's, byte for byte: ``[L, N, 2, Hkv, page_size, Dh]``
(layer, page, k/v, kv head), one page a contiguous slab holding K and V of
every kv head. Page 0 is the garbage page: pad token slots write there, so
every scatter has a static shape and no mask.

These functions are the CPU oracle the CUDA kernels (``ops/kernels/``) are
held against; the serving engine's attention goes through the kernels'
wrappers instead. Unlike JAX, ``write_kv`` updates the cache IN PLACE (the
JAX package donated the buffer to the jitted step to get the same effect).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# pages per streamed chunk on the blockwise path (reference value)
PAGES_PER_CHUNK = 8


def write_kv(pages: torch.Tensor, layer_idx: int, k_new: torch.Tensor,
             v_new: torch.Tensor, page_table: torch.Tensor,
             positions: torch.Tensor, new_lens: torch.Tensor) -> torch.Tensor:
    """Scatter new K/V into the stacked cache ``[L, N, 2, Hkv, ps, Dh]`` in
    place and return it.

    k_new/v_new: [B, S, Hkv, Dh]; page_table: [B, P]; positions: [B, S]
    absolute positions; new_lens: [B] real new tokens per row. Pad slots
    (``s >= new_lens[b]``) go to slot 0 of the garbage page 0.
    """
    page_size = pages.shape[4]
    B, S = positions.shape
    pos = positions.long()
    logical = pos // page_size
    slot = pos % page_size
    phys = torch.gather(page_table.long(), 1, logical)
    pad = (torch.arange(S, device=pos.device)[None, :]
           >= new_lens.long()[:, None])
    phys = torch.where(pad, 0, phys)
    slot = torch.where(pad, 0, slot)
    new = torch.stack([k_new, v_new], dim=2).to(pages.dtype)  # [B,S,2,Hkv,Dh]
    # [N, ps, 2, Hkv, Dh] view of this layer: (page, slot) index the rows
    layer = pages[layer_idx].permute(0, 3, 1, 2, 4)
    layer.index_put_((phys, slot), new)
    return pages


def write_kv_rows(pages: torch.Tensor, layer_idx: int, k_new: torch.Tensor,
                  v_new: torch.Tensor, page_table: torch.Tensor,
                  positions: torch.Tensor, new_lens: torch.Tensor,
                  dp=None) -> torch.Tensor:
    """``write_kv`` of a forward whose rows may be split over ``dp``
    (``parallel/mesh.DpRows``): the new K/V of every replica's rows are
    gathered first and written with the whole batch's table, positions
    and counts, so every replica's cache holds every row. Without ``dp``
    it is ``write_kv``."""
    if dp is not None:
        if k_new.shape == v_new.shape:
            kv = dp.gather(torch.stack([k_new, v_new]), dim=1)
            k_new, v_new = kv[0], kv[1]
        else:
            k_new, v_new = dp.gather(k_new), dp.gather(v_new)
        page_table, positions, new_lens = dp.write_args(positions, new_lens)
    return write_kv(pages, layer_idx, k_new, v_new, page_table, positions,
                    new_lens)


def _softcap(scores: torch.Tensor, cap) -> torch.Tensor:
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def _attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, total_lens: torch.Tensor,
            sm_scale: float, window=None, softcap=None) -> torch.Tensor:
    """qg [B,S,Hkv,G,Dh]; k/v [B,Hkv,T,Dh] -> [B,S,Hkv*G,Dh] (float32)."""
    B, S, Hkv, G, Dh = qg.shape
    T = k.shape[2]
    scores = torch.einsum("bsngd,bntd->bnsgt", qg.float(),
                          k.float()) * sm_scale
    scores = _softcap(scores, softcap)
    t_pos = torch.arange(T, device=qg.device)[None, None, :]
    causal = t_pos <= positions.long()[:, :, None]
    valid = t_pos < total_lens.long()[:, None, None]
    if window is not None:
        in_win = (window <= 0) | (t_pos > positions.long()[:, :, None]
                                  - window)
        causal = causal & in_win
    mask = (causal & valid)[:, None, :, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnsgt,bntd->bsngd", probs, v.float())
    return out.reshape(B, S, Hkv * G, Dh)


def _attend_blockwise(qg: torch.Tensor, gather_chunk, num_table_pages: int,
                      page_size: int, chunk_pages: int,
                      positions: torch.Tensor, total_lens: torch.Tensor,
                      sm_scale: float, window=None, softcap=None,
                      return_partials: bool = False):
    """Flash-style chunked attention over the paged context (online softmax
    over chunks of ``chunk_pages`` pages; chunks past the longest live
    context are never touched). Matmuls run in the cache dtype with float32
    accumulation, as the reference's.

    With ``return_partials`` it returns the un-normalised online-softmax
    state ``(num [B, Hq, S, Dh], den [B, Hq, S], mx [B, Hq, S])`` instead,
    grouped heads folded as in the reference, for
    ``merge_softmax_partials``."""
    B, S, Hkv, G, Dh = qg.shape
    span = chunk_pages * page_size
    n_static = -(-num_table_pages // chunk_pages)
    max_t = int(total_lens.max())
    n_chunks = min((max_t + span - 1) // span, n_static)
    dev = qg.device
    num = torch.zeros((B, Hkv, S, G, Dh), dtype=torch.float32, device=dev)
    den = torch.zeros((B, Hkv, S, G), dtype=torch.float32, device=dev)
    mx = torch.full((B, Hkv, S, G), NEG_INF, dtype=torch.float32, device=dev)
    pos = positions.long()
    for c in range(n_chunks):
        k, v = gather_chunk(c)
        s = torch.einsum("bsngd,bntd->bnsgt", qg.float(),
                         k.float()) * sm_scale
        s = _softcap(s, softcap)
        t_pos = c * span + torch.arange(span, device=dev)
        causal = t_pos[None, None, :] <= pos[:, :, None]
        if window is not None:
            in_win = ((window <= 0)
                      | (t_pos[None, None, :] > pos[:, :, None] - window))
            causal = causal & in_win
        valid = t_pos[None, None, :] < total_lens.long()[:, None, None]
        mask = (causal & valid)[:, None, :, None, :]
        s = torch.where(mask, s, NEG_INF)
        mx_new = torch.maximum(mx, s.amax(dim=-1))
        p = torch.exp(s - mx_new[..., None])
        p = torch.where((mx_new > NEG_INF / 2)[..., None], p, 0.0)
        scale = torch.where(mx > NEG_INF / 2, torch.exp(mx - mx_new), 0.0)
        pv = torch.einsum("bnsgt,bntd->bnsgd", p.to(v.dtype).float(),
                          v.float())
        num = num * scale[..., None] + pv
        den = den * scale + p.sum(dim=-1)
        mx = mx_new
    if return_partials:
        Hq = Hkv * G
        return (num.permute(0, 1, 3, 2, 4).reshape(B, Hq, S, Dh),
                den.permute(0, 1, 3, 2).reshape(B, Hq, S),
                mx.permute(0, 1, 3, 2).reshape(B, Hq, S))
    out = num / torch.clamp(den, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, Hkv * G, Dh)


def merge_softmax_partials(a, b):
    """Combine two un-normalised online-softmax states over DISJOINT kv
    contexts, each ``(num [..., D], den [...], mx [...])``; dead states
    (``mx == NEG_INF``: that context had no visible kv) contribute zero.
    Returns the same triple. The split-KV decode kernel
    (``ops/kernels/csrc/decode.cu``) merges its splits with this
    arithmetic."""
    num_a, den_a, mx_a = a
    num_b, den_b, mx_b = b
    mx = torch.maximum(mx_a, mx_b)
    sa = torch.where(mx_a > NEG_INF / 2, torch.exp(mx_a - mx), 0.0)
    sb = torch.where(mx_b > NEG_INF / 2, torch.exp(mx_b - mx), 0.0)
    num = num_a * sa[..., None] + num_b * sb[..., None]
    den = den_a * sa + den_b * sb
    return num, den, mx


def normalize_softmax_partials(num: torch.Tensor,
                               den: torch.Tensor) -> torch.Tensor:
    """(num, den) -> attention output; all-dead rows produce zeros."""
    return num / torch.clamp(den, min=1e-20)[..., None]


def _pad_table(page_table: torch.Tensor, chunk_pages: int) -> torch.Tensor:
    """Pad the table width to a multiple of ``chunk_pages`` with page 0."""
    rem = page_table.shape[1] % chunk_pages
    if rem:
        page_table = torch.nn.functional.pad(page_table,
                                             (0, chunk_pages - rem))
    return page_table


def _gathered_to_bhtd(g: torch.Tensor) -> torch.Tensor:
    """[B, P, Hkv, ps, Dh] gathered pages -> [B, Hkv, T, Dh]."""
    B, P, Hkv, ps, Dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * ps, Dh)


def ragged_paged_attention(q: torch.Tensor, pages: torch.Tensor, layer_idx,
                           page_table: torch.Tensor, q_starts: torch.Tensor,
                           q_lens: torch.Tensor, kv_lens: torch.Tensor,
                           sm_scale: float, window=None,
                           softcap=None) -> torch.Tensor:
    """Ragged paged attention over a FLATTENED mixed batch.

    q: [T, Hq, Dh] — row i's tokens at ``q_starts[i] .. +q_lens[i]``;
    kv_lens: [B] context per row including its new tokens (row i's token j
    sits at ``kv_lens[i] - q_lens[i] + j``). Returns [T, Hq, Dh]; pad slots
    are zeroed.
    """
    T, Hq, Dh = q.shape
    B, P = page_table.shape
    Hkv = pages.shape[3]
    ps = pages.shape[4]
    dev = q.device
    q_starts, q_lens, kv_lens = (q_starts.long(), q_lens.long(),
                                 kv_lens.long())
    t_idx = torch.arange(T, device=dev)
    ends = q_starts + q_lens
    row = (t_idx[:, None] >= ends[None, :]).sum(dim=1)
    row = torch.clamp(row, max=B - 1)
    valid = (t_idx >= q_starts[row]) & (t_idx < ends[row])
    pos = kv_lens[row] - q_lens[row] + (t_idx - q_starts[row])
    pos = torch.where(valid, pos, 0)
    tok_table = torch.where(valid[:, None], page_table.long()[row], 0)
    tok_total = torch.where(valid, kv_lens[row], 1)
    qg = q.reshape(T, 1, Hkv, Hq // Hkv, Dh)
    chunk_pages = min(PAGES_PER_CHUNK, P)
    table = _pad_table(tok_table, chunk_pages)
    layer = pages[layer_idx]

    def gather_chunk(c):
        tbl = table[:, c * chunk_pages:(c + 1) * chunk_pages]
        g = layer[tbl]                      # [T, C, 2, Hkv, ps, Dh]
        return _gathered_to_bhtd(g[:, :, 0]), _gathered_to_bhtd(g[:, :, 1])

    out = _attend_blockwise(qg, gather_chunk, P, ps, chunk_pages,
                            pos[:, None], tok_total, sm_scale,
                            window=window, softcap=softcap)
    out = out.reshape(T, Hq, Dh)
    return torch.where(valid[:, None, None], out, 0.0).to(q.dtype)


def paged_attention(q: torch.Tensor, pages: torch.Tensor, layer_idx,
                    page_table: torch.Tensor, positions: torch.Tensor,
                    total_lens: torch.Tensor, sm_scale: float,
                    window=None, softcap=None) -> torch.Tensor:
    """Attend queries to the stacked paged context.

    q: [B, S, Hq, Dh]; pages: [L, N, 2, Hkv, ps, Dh]; page_table: [B, P];
    positions: [B, S]; total_lens: [B] context including the new tokens.
    Returns [B, S, Hq, Dh] in q's dtype.
    """
    B, S, Hq, Dh = q.shape
    Hkv = pages.shape[3]
    ps = pages.shape[4]
    P = page_table.shape[1]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, Dh)
    layer = pages[layer_idx]
    if S > 1 and P > PAGES_PER_CHUNK:
        table = _pad_table(page_table.long(), PAGES_PER_CHUNK)

        def gather_chunk(c):
            tbl = table[:, c * PAGES_PER_CHUNK:(c + 1) * PAGES_PER_CHUNK]
            g = layer[tbl]                  # [B, C, 2, Hkv, ps, Dh]
            return (_gathered_to_bhtd(g[:, :, 0]),
                    _gathered_to_bhtd(g[:, :, 1]))

        return _attend_blockwise(qg, gather_chunk, P, ps, PAGES_PER_CHUNK,
                                 positions, total_lens, sm_scale,
                                 window=window,
                                 softcap=softcap).to(q.dtype)
    gathered = layer[page_table.long()]     # [B, P, 2, Hkv, ps, Dh]
    k = _gathered_to_bhtd(gathered[:, :, 0])
    v = _gathered_to_bhtd(gathered[:, :, 1])
    return _attend(qg, k, v, positions, total_lens, sm_scale,
                   window=window, softcap=softcap).to(q.dtype)


__all__ = ["write_kv", "write_kv_rows", "paged_attention",
           "ragged_paged_attention", "merge_softmax_partials",
           "normalize_softmax_partials",
           "NEG_INF"]
