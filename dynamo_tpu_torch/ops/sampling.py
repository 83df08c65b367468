"""Batched on-device token sampling — the port of
``dynamo_tpu/ops/sampling.py``.

Per-request temperature / top-k / top-p / min-p over the ``TOPK_MAX``
highest logits, drawn by Gumbel-argmax; greedy rows (temperature 0) take
candidate 0. Around it: frequency / presence / repetition penalties and
logit bias over a sparse per-row window (``apply_penalties``, and the
fused block's window upkeep ``update_penalty_window`` /
``penalty_window_entries``), the guided-decoding allow-mask
(``apply_vocab_mask``), and speculative verification (``spec_verify``).

The Gumbel noise is an ARGUMENT of ``sample_tokens``: ``sampling_noise``
draws it with the reference's key schedule through ``ops/prng.py`` (JAX's
threefry, bit for bit), and a test can hand in noise of its own.

Candidates are ordered by value and, among equal values, by lower token id
first — the order ``jax.lax.top_k`` gives — so ties resolve as in the
reference (``torch.topk`` alone leaves their order unspecified).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dynamo_tpu_torch.ops import prng

TOPK_MAX = 64


def top_k_stable(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of float32 ``x [R, V]`` in ``jax.lax.top_k``'s order: value
    descending, and among equal values the lower index first — also at the
    k-th place, where a tie decides which candidates are in the set.

    One ``torch.topk`` over int64 keys that carry both: the float's bits
    mapped to an order-preserving int32 in the high word, ``V-1-index`` in
    the low word."""
    R, V = x.shape
    bits = x.float().contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)      # monotone in the float
    low = (V - 1) - torch.arange(V, device=x.device, dtype=torch.int64)
    key = (ordered.to(torch.int64) << 32) | low
    _, idx = torch.topk(key, k, dim=-1)
    return torch.gather(x, -1, idx), idx


def apply_penalties(logits: torch.Tensor, pen_ids: torch.Tensor,
                    pen_counts: torch.Tensor, pen_in_ctx: torch.Tensor,
                    freq_pen: torch.Tensor, pres_pen: torch.Tensor,
                    rep_pen: torch.Tensor,
                    pen_bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Frequency / presence / repetition penalties and logit bias over each
    row's sparse window ``pen_ids [B, W]`` (ids unique per row; pad entries
    have count 0, in-context 0 and bias 0, so they add a zero delta).

    pen_counts: [B, W] f32 occurrences among GENERATED tokens;
    pen_in_ctx: [B, W] f32 1.0 if the token is in prompt + generated;
    freq_pen / pres_pen [B] (0 = off), rep_pen [B] (1 = off, <= 0 off);
    pen_bias: optional [B, W] OpenAI logit_bias, added per entry.
    Returns float32 logits (a new tensor)."""
    logits = logits.float()
    if pen_ids.shape[1] == 0:
        return logits
    ids = pen_ids.long()
    sel = torch.gather(logits, 1, ids)                        # [B, W]
    rp = rep_pen.float()[:, None]
    rp = torch.where(rp <= 0, 1.0, rp)
    adj = torch.where(pen_in_ctx > 0,
                      torch.where(sel > 0, sel / rp, sel * rp), sel)
    adj = adj - freq_pen.float()[:, None] * pen_counts
    adj = adj - pres_pen.float()[:, None] * (pen_counts > 0).float()
    if pen_bias is not None:
        adj = adj + pen_bias
    return logits.scatter_add(1, ids, adj - sel)


def update_penalty_window(pen_ids: torch.Tensor, pen_counts: torch.Tensor,
                          pen_in_ctx: torch.Tensor, pen_n: torch.Tensor,
                          tokens: torch.Tensor, active: torch.Tensor):
    """Fold one sampled token per row into the device-resident penalty
    window (the fused block's per-step upkeep): a token already among the
    row's first ``pen_n`` slots gets its count bumped and is marked
    in-context; a new one is appended at slot ``pen_n`` (count 1,
    in-context) while capacity remains. Only ``active`` rows change.
    Returns the four updated window arrays."""
    W = pen_ids.shape[1]
    if W == 0:
        return pen_ids, pen_counts, pen_in_ctx, pen_n
    slots = torch.arange(W, device=pen_ids.device)[None, :]
    occ = slots < pen_n[:, None]
    match = (pen_ids == tokens[:, None]) & occ
    bump = match & active[:, None]
    pen_counts = pen_counts + bump.to(pen_counts.dtype)
    pen_in_ctx = torch.maximum(pen_in_ctx, bump.to(pen_in_ctx.dtype))
    can_ins = active & ~match.any(dim=1) & (pen_n < W)
    slot = (slots == pen_n[:, None]) & can_ins[:, None]
    pen_ids = torch.where(slot, tokens[:, None].to(pen_ids.dtype), pen_ids)
    pen_counts = torch.where(slot, 1.0, pen_counts).to(pen_counts.dtype)
    pen_in_ctx = torch.where(slot, 1.0, pen_in_ctx).to(pen_in_ctx.dtype)
    pen_n = pen_n + can_ins.to(pen_n.dtype)
    return pen_ids, pen_counts, pen_in_ctx, pen_n


def penalty_window_entries(prompt_ids: torch.Tensor,
                           prompt_valid: torch.Tensor,
                           pen_ids: torch.Tensor,
                           pen_n: torch.Tensor) -> torch.Tensor:
    """Which of a row's static prompt entries ``[B, S]`` the fused penalty
    step includes: those not already among the dynamic window's first
    ``pen_n`` slots, within the ``W - pen_n`` slots left, first come first
    served (what the per-step host builder backfills). Returns an
    ``[B, S]`` bool include mask."""
    W = pen_ids.shape[1]
    occ = (torch.arange(W, device=pen_ids.device)[None, None, :]
           < pen_n[:, None, None])
    in_dyn = ((prompt_ids[:, :, None] == pen_ids[:, None, :])
              & occ).any(dim=2)
    eligible = prompt_valid & ~in_dyn
    e32 = eligible.to(torch.int32)
    rank = torch.cumsum(e32, dim=1) - e32                    # exclusive
    return eligible & (pen_n[:, None] + rank < W)


def apply_vocab_mask(logits: torch.Tensor,
                     mask_words: torch.Tensor) -> torch.Tensor:
    """Guided-decoding allow-mask: ``mask_words [B, ceil(V/32)]`` holds each
    row's allowed ids as a bitfield (uint32 words, shipped as their int32
    bit patterns), expanded here; disallowed ids go to -inf. An all-ones
    row is the no-op for unconstrained rows of a constrained batch."""
    B, V = logits.shape
    if mask_words.dtype == torch.uint32:
        mask_words = mask_words.view(torch.int32)
    idx = torch.arange(V, device=logits.device)
    words = mask_words[:, idx // 32].to(torch.int32)           # [B, V]
    bits = (words >> (idx % 32).to(torch.int32)) & 1
    return torch.where(bits.bool(), logits.float(), -torch.inf)


def _masked_candidates(logits: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       min_p: Optional[torch.Tensor] = None):
    """logits [R, V] f32 -> (scaled [R, k], top_idx [R, k]): the
    temperature-scaled top-``k`` candidates with per-row top-k / top-p /
    min-p rejects at -inf (``softmax(scaled)`` is the sampled
    distribution)."""
    R, V = logits.shape
    k = min(TOPK_MAX, V)
    top_vals, top_idx = top_k_stable(logits, k)
    ranks = torch.arange(k, device=logits.device)[None, :]
    top_k = top_k.to(torch.int64)
    eff_k = torch.where(top_k > 0, torch.clamp(top_k, max=k), k)
    keep = ranks < eff_k[:, None]
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = top_vals / temp
    scaled = torch.where(keep, scaled, -torch.inf)
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p.float()[:, None]
    if min_p is not None:
        keep_p &= probs >= min_p.float()[:, None] * probs[:, :1]
    return torch.where(keep_p, scaled, -torch.inf), top_idx


def sampling_noise(rng: torch.Tensor, B: int, k: int,
                   seeds: Optional[torch.Tensor] = None,
                   seed_rng: Optional[torch.Tensor] = None,
                   seed_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Gumbel noise ``[B, k]`` the reference's ``sample_tokens`` draws
    from the step key ``rng`` (``fold_in(engine key, step)``).

    Without ``seeds``, one batch-wide draw ``gumbel(rng, (B, k))``. With
    them, a key per row: an unseeded row (seed 0) folds its batch position,
    ``fold_in(fold_in(rng, 7), row)``; a seeded row folds only its seed and
    the position of the token it samples, ``fold_in(fold_in(seed_rng,
    seed), seed_pos)``, so it replays the same under any batching."""
    if seeds is None:
        return prng.gumbel(rng, (B, k))
    dev = rng.device
    rows = prng.fold_in(prng.fold_in(rng, 7)[None, :],
                        torch.arange(B, device=dev))
    base = rng if seed_rng is None else seed_rng
    pos = (torch.zeros(B, dtype=torch.int64, device=dev) if seed_pos is None
           else seed_pos.to(torch.int64))
    seeded = prng.fold_in(prng.fold_in(base[None, :], seeds.to(torch.int64)),
                          pos)
    keys = torch.where((seeds != 0)[:, None], seeded, rows)
    return prng.gumbel(keys, (k,))


def log_softmax_at(logits: torch.Tensor, values: torch.Tensor
                   ) -> torch.Tensor:
    """``values - logsumexp(logits)`` per row (values [B] or [B, K])."""
    logz = torch.logsumexp(logits, dim=-1)
    return values - (logz if values.dim() == 1 else logz[:, None])


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, min_p: Optional[torch.Tensor] = None):
    """Sample next tokens.

    logits: [B, V] (promoted to float32); gumbel: [B, min(TOPK_MAX, V)]
    (``sampling_noise``). Returns (tokens [B] int32, logprobs [B] float32 —
    the chosen token's logprob under the GIVEN logits, before
    temperature/top-k/top-p; with penalties or a mask applied upstream,
    that is the distribution actually sampled from).
    """
    logits = logits.float()
    scaled, top_idx = _masked_candidates(logits, temperature, top_k, top_p,
                                         min_p)
    choice = torch.argmax(scaled + gumbel, dim=-1)
    choice = torch.where(temperature <= 0.0, 0, choice)
    tokens = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    chosen = torch.gather(logits, 1, tokens[:, None])[:, 0]
    return tokens.to(torch.int32), log_softmax_at(logits, chosen)


def spec_verify(logits: torch.Tensor, tokens: torch.Tensor,
                rng: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor,
                mask_words: Optional[torch.Tensor] = None):
    """Rejection-sampling verification of drafted tokens in one pass
    (Leviathan et al., with the n-gram draft as a point mass): draft ``d``
    is accepted with probability ``p(d)`` under the filtered distribution,
    and on rejection the replacement is drawn from ``p`` without ``d``.
    Greedy rows accept while the draft is the argmax.

    logits: [B, S, V], logits[:, j] predicts slot j + 1; tokens: [B, S],
    tokens[:, 0] the last accepted token, tokens[:, j >= 1] draft j;
    mask_words: optional [B, S, ceil(V/32)] per-slot guided masks.
    Returns (n_acc [B] i32, final_tok [B] i32, final_lp [B] f32 under the
    unfiltered row logits, draft_lps [B, S - 1] f32). The uniform and
    Gumbel draws use ``split(fold_in(rng, 0x5bec))``, as the reference."""
    lf = logits.float()
    B, S, V = lf.shape
    K = S - 1
    dev = lf.device
    if mask_words is not None:
        lf = apply_vocab_mask(lf.reshape(B * S, V),
                              mask_words.reshape(B * S, -1)
                              ).reshape(B, S, V)
    k = min(TOPK_MAX, V)

    def rep(a):
        return torch.repeat_interleave(a, S, dim=0)

    scaled, top_idx = _masked_candidates(
        lf.reshape(B * S, V), rep(temperature), rep(top_k), rep(top_p))
    scaled = scaled.reshape(B, S, k)
    top_idx = top_idx.reshape(B, S, k)
    q = torch.softmax(scaled, dim=-1)

    drafts = tokens[:, 1:].long()                                # [B, K]
    in_cand = top_idx[:, :K] == drafts[..., None]
    p_draft = torch.where(in_cand, q[:, :K], 0.0).sum(dim=-1)

    k_u, k_g = prng.split(prng.fold_in(rng, 0x5BEC), 2)
    u = prng.uniform(k_u, (B, K))
    greedy = (temperature <= 0.0)[:, None]
    acc = torch.where(greedy, drafts == top_idx[:, :K, 0], u < p_draft)
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)

    sel = n_acc.long()
    rows = torch.arange(B, device=dev)
    scaled_a = scaled[rows, sel]                                 # [B, k]
    idx_a = top_idx[rows, sel]
    if K > 0:
        d_rej = drafts[rows, torch.clamp(sel, max=K - 1)]
        excl = (idx_a == d_rej[:, None]) & (sel < K)[:, None]
        scaled_a = torch.where(excl, -torch.inf, scaled_a)
    gumbel = prng.gumbel(k_g, (B, k))
    choice = torch.argmax(scaled_a + gumbel, dim=-1)
    choice = torch.where(temperature <= 0.0, 0, choice)
    final_tok = torch.gather(idx_a, 1, choice[:, None])[:, 0]

    logz = torch.logsumexp(lf, dim=-1)                           # [B, S]
    if K > 0:
        d_logit = torch.gather(lf[:, :K], 2, drafts[..., None])[..., 0]
        draft_lps = d_logit - logz[:, :K]
    else:
        draft_lps = torch.zeros((B, 0), dtype=torch.float32, device=dev)
    f_logit = lf[rows, sel, final_tok]
    return (n_acc.to(torch.int32), final_tok.to(torch.int32),
            f_logit - logz[rows, sel], draft_lps)


__all__ = ["TOPK_MAX", "sample_tokens", "sampling_noise", "apply_penalties",
           "apply_vocab_mask", "update_penalty_window",
           "penalty_window_entries", "spec_verify", "top_k_stable",
           "log_softmax_at"]
