"""The plain PyTorch versions of the attention kernels.

``plain_paged_attention`` computes what ``csrc/decode.cu`` and
``csrc/prefill_sm90.cu`` compute, and ``plain_mla_attention`` what
``csrc/mla_decode.cu`` and ``csrc/mla_prefill.cu`` compute, in the same arithmetic
order where it matters: q scaled by ``sm_scale`` and rounded to the working
dtype, scores in float32, softcap before the mask, masked scores replaced (a
select, never a multiply), probabilities rounded to the cache dtype before
P.V, float32 sums, pad query slots (position >= ctx) zero. The CPU path of
every wrapper and the CPU tests use them; on the card ``chip_smoke.py``
holds each kernel against its plain version.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def plain_paged_attention(q: torch.Tensor, pages: torch.Tensor,
                          layer_idx: int, page_table: torch.Tensor,
                          q_start: torch.Tensor, total_lens: torch.Tensor,
                          sm_scale: float, window=None,
                          softcap=None) -> torch.Tensor:
    """q [B, S, Hq, Dh] at positions ``q_start[b] + s``; pages
    [L, N, 2, Hkv, ps, Dh]; page_table [B, P]; total_lens [B] (ctx).
    Returns [B, S, Hq, Dh] in q's dtype."""
    B, S, Hq, Dh = q.shape
    Hkv, ps = pages.shape[3], pages.shape[4]
    P = page_table.shape[1]
    G = Hq // Hkv
    dev = q.device
    ctx = total_lens.long()
    n_pages = min(P, max(1, -(-int(ctx.max()) // ps)))
    kv = pages[layer_idx][page_table[:, :n_pages].long()]  # [B,n,2,Hkv,ps,Dh]
    T = n_pages * ps
    k = kv[:, :, 0].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, Dh).float()
    v = kv[:, :, 1].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, Dh)
    # positions past the live context (unused table entries -> garbage
    # page 0) are SELECTED away, never multiplied by a zero weight
    live = (torch.arange(T, device=dev)[None, :] < ctx[:, None])
    live = live[:, None, :, None]                             # [B,1,T,1]
    k = torch.where(live, k, 0.0)
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=dev))
    qs = (q * sm_scale).to(q.dtype).float().reshape(B, S, Hkv, G, Dh)
    s = torch.einsum("bsngd,bntd->bnsgt", qs, k)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    t = torch.arange(T, device=dev)[None, None, :]
    qpos = (q_start.long()[:, None]
            + torch.arange(S, device=dev)[None, :])[:, :, None]
    valid = (t <= qpos) & (t < ctx[:, None, None]) & (qpos < ctx[:, None, None])
    if window:
        valid &= t > qpos - window
    valid = valid[:, None, :, None, :]                       # [B,1,S,1,T]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1)
    pv = torch.einsum("bnsgt,bntd->bnsgd", p.to(pages.dtype).float(),
                      v.float())
    out = pv / torch.clamp(den, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, Hq, Dh).to(q.dtype)


def mla_query(q_lat: torch.Tensor, q_pe: torch.Tensor, sm_scale: float,
              dtype: torch.dtype) -> torch.Tensor:
    """The MLA kernels' query rows: ``[q_lat | q_pe] * sm_scale`` rounded to
    the cache dtype, ``[B, S, nh, dkv + dr]`` (the TPU kernels' callers
    scale the stacked query and cast it to the cache dtype the same way,
    ``mla_decode.py:180``, ``mla_prefill.py:201``)."""
    return (torch.cat([q_lat.float(), q_pe.float()], dim=-1)
            * sm_scale).to(dtype).contiguous()


def plain_mla_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                        pages: torch.Tensor, layer_idx: int,
                        page_table: torch.Tensor, q_start: torch.Tensor,
                        total_lens: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """The plain version of both MLA kernels (``csrc/mla_decode.cu``,
    ``csrc/mla_prefill.cu``).

    q_lat [B, S, nh, dkv] and q_pe [B, S, nh, dr] at positions
    ``q_start[b] + s``; pages [L, N, 2, 1, ps, dkv] (slot 0 the latent,
    slot 1 the rope key zero-padded to dkv); page_table [B, P]; total_lens
    [B] (ctx). Scores ``q_lat . c_kv + q_pe . k_pe`` in float32 from the
    rounded query, masked scores selected away, p rounded to the cache dtype
    before P.V (the value is the latent), float32 sums. Returns float32
    [B, S, nh, dkv]; query slots at or past ctx are zero."""
    B, S, nh, dkv = q_lat.shape
    dr = q_pe.shape[-1]
    ps = pages.shape[4]
    P = page_table.shape[1]
    dev = q_lat.device
    ctx = total_lens.long()
    n_pages = min(P, max(1, -(-int(ctx.max()) // ps)))
    kv = pages[layer_idx][page_table[:, :n_pages].long()]  # [B,n,2,1,ps,dkv]
    T = n_pages * ps
    # positions past the live context (unused table entries -> garbage
    # page 0) are SELECTED away, never multiplied by a zero weight
    live = (torch.arange(T, device=dev)[None, :] < ctx[:, None])[..., None]
    zero = torch.zeros((), dtype=pages.dtype, device=dev)
    ckv = torch.where(live, kv[:, :, 0, 0].reshape(B, T, dkv), zero)
    kpe = torch.where(live, kv[:, :, 1, 0, :, :dr].reshape(B, T, dr), zero)
    q = mla_query(q_lat, q_pe, sm_scale, pages.dtype).float()
    s = torch.einsum("bsnk,btk->bsnt", q,
                     torch.cat([ckv, kpe], dim=-1).float())
    t = torch.arange(T, device=dev)[None, None, :]
    qpos = (q_start.long()[:, None]
            + torch.arange(S, device=dev)[None, :])[:, :, None]
    real = qpos < ctx[:, None, None]                         # [B,S,1]
    valid = ((t <= qpos) & (t < ctx[:, None, None]) & real)[:, :, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1)
    pv = torch.einsum("bsnt,btk->bsnk", p.to(pages.dtype).float(),
                      ckv.float())
    return pv / torch.clamp(den, min=1e-20)[..., None]


LOG2E = 1.4426950408889634


def online_attention_rows(qs: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, qpos: torch.Tensor, ctx: int,
                          chunk: int = 64, window: int = 0,
                          softcap: float = 0.0, spans=None) -> torch.Tensor:
    """Chosen (query, head) rows of one sequence and kv head through the
    online softmax of ``csrc/prefill_sm90.cu``, where it rounds: the
    context in chunks of ``chunk`` positions from the start of its kv
    range, a running max ``m``, ``p = 2^(s log2e - m log2e)`` rounded to
    bf16 for P.V against the max SO FAR (the plain version rounds against
    the row's final max), the accumulator and row sum rescaled as the max
    grows. The TPU kernel rounds p the same way, against its own chunk's
    running max (``dynamo_tpu/ops/pallas/prefill.py:196-207``).

    Softcap ``cap * tanh(s / cap)`` before the mask; a window ``w > 0``
    masks positions ``t <= qpos - w``. ``spans``: the kv ranges ``[lo,
    hi)`` the kernel's blocks take for these rows, each its own online
    softmax, merged as ``merge_kernel`` merges split partials (weights
    ``exp(m_i - max m)``, one division at the end); one range ``[0, ctx)``
    by default.

    qs [R, Dh]: q * sm_scale already rounded to bf16; k, v [T, Dh] the
    row's context (positions 0..T-1); qpos [R] the rows' positions.
    Returns bf16 [R, Dh]."""
    R = qs.shape[0]
    dev = qs.device
    visible = min(ctx, int(qpos.max()) + 1)
    num = torch.zeros((R, qs.shape[1]), device=dev)
    den = torch.zeros(R, device=dev)
    parts = []
    for lo, hi in spans or [(0, ctx)]:
        m = torch.full((R,), NEG_INF, device=dev)
        l_run = torch.zeros(R, device=dev)
        acc = torch.zeros((R, qs.shape[1]), device=dev)
        for c0 in range(lo, min(hi, visible), chunk):
            t = torch.arange(c0, min(c0 + chunk, k.shape[0]), device=dev)
            live = (t < min(ctx, hi))[:, None]
            kc = torch.where(live, k[t].float(), 0.0)
            vc = torch.where(live, v[t].float(), 0.0)
            s = qs.float() @ kc.T                                # [R, n]
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            seen = (t[None, :] <= qpos[:, None]) & live.T
            if window:
                seen &= t[None, :] > qpos[:, None] - window
            s = torch.where(seen, s, NEG_INF)
            mx = torch.maximum(m, s.amax(dim=-1))
            ml = torch.where(mx > NEG_INF / 2, mx * LOG2E, 0.0)
            scale = torch.exp2(m * LOG2E - ml)
            m = mx
            # s * log2e - m log2e as one fused multiply-add, as the kernel
            p = torch.exp2((s.double() * LOG2E - ml.double()[:, None]).float())
            l_run = l_run * scale + p.sum(dim=-1)
            acc = acc * scale[:, None] + p.to(torch.bfloat16).float() @ vc
        parts.append((m, l_run, acc))
    top = torch.stack([m for m, _l, _a in parts]).amax(dim=0)
    for m, l_run, acc in parts:
        w = torch.where(m > NEG_INF / 2, torch.exp(m - top), 0.0)
        num = num + w[:, None] * acc
        den = den + w * l_run
    return (num / torch.clamp(den, min=1e-20)[:, None]).to(torch.bfloat16)


def row_ulp_error(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """How far a kernel's output is from its plain version, row by row.

    For each row of the last axis (one query slot and head: Dh values), the
    largest ``|out - ref|`` in bfloat16 ulps of that row's largest ``|ref|``
    (``ulp(x) = 2**(floor(log2 x) - 7)``), so the measure bites as hard on a
    long context's small averages as on a short row's unit values. A row
    whose ``ref`` is all zero (a pad slot) must match exactly: its ulp is
    taken as 2**-107, so any difference there counts past every tolerance.
    Returns the leading shape, float32."""
    d = (out.float() - ref.float()).abs().amax(dim=-1)
    scale = ref.float().abs().amax(dim=-1).clamp_min(2.0 ** -100)
    return d / torch.exp2(torch.floor(torch.log2(scale)) - 7)


__all__ = ["plain_paged_attention", "plain_mla_attention", "mla_query",
           "online_attention_rows", "row_ulp_error", "NEG_INF"]
