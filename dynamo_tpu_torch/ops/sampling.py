"""Batched on-device token sampling — the port of
``dynamo_tpu/ops/sampling.py`` ``sample_tokens`` / ``_masked_candidates``.

Per-request temperature / top-k / top-p / min-p over the ``TOPK_MAX``
highest logits, drawn by Gumbel-argmax; greedy rows (temperature 0) take
candidate 0. The Gumbel noise ``[B, k]`` is an ARGUMENT: the engine draws it
from its seeded ``torch.Generator``, and a test can hand in JAX's own noise
so both packages must pick the same tokens. Per-request seeds, penalties
and guided masks come later (ROADMAP A4/A8).

Candidates are ordered by value and, among equal values, by lower token id
first — the order ``jax.lax.top_k`` gives — so ties resolve as in the
reference (``torch.topk`` alone leaves their order unspecified).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def gumbel_noise(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(U))`` with U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def log_softmax_at(logits: torch.Tensor, values: torch.Tensor
                   ) -> torch.Tensor:
    """``values - logsumexp(logits)`` per row (values [B] or [B, K])."""
    logz = torch.logsumexp(logits, dim=-1)
    return values - (logz if values.dim() == 1 else logz[:, None])


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, min_p: Optional[torch.Tensor] = None):
    """Sample next tokens.

    logits: [B, V] (promoted to float32); gumbel: [B, min(TOPK_MAX, V)].
    Returns (tokens [B] int32, logprobs [B] float32 — the chosen token's
    logprob under the GIVEN logits, before temperature/top-k/top-p).
    """
    logits = logits.float()
    scaled, top_idx = _masked_candidates(logits, temperature, top_k, top_p,
                                         min_p)
    choice = torch.argmax(scaled + gumbel, dim=-1)
    choice = torch.where(temperature <= 0.0, 0, choice)
    tokens = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    chosen = torch.gather(logits, 1, tokens[:, None])[:, 0]
    return tokens.to(torch.int32), log_softmax_at(logits, chosen)


__all__ = ["TOPK_MAX", "sample_tokens", "gumbel_noise", "top_k_stable",
           "log_softmax_at"]
