"""Speculative decoding: n-gram prompt-lookup drafts + verification plans.

The reference serves speculative decoding through its CUDA engines' configs
(EAGLE for llama4, MTP for DeepSeek-R1 —
``components/backends/trtllm/engine_configs/llama4/eagle/eagle_decode.yaml``,
``.../deepseek_r1/mtp/mtp_decode.yaml``) and surfaces acceptance counters via
``SpecDecodeStats`` (``lib/llm/src/protocols/events.py`` role). This engine is
native, so the speculative loop is owned here and designed for XLA:

- the DRAFT side is host-only prompt-lookup (n-gram) proposal: no draft
  model, no extra weights, no second compiled program. The last ``n``-gram
  of prompt+generated is matched against the earlier context; the tokens
  that followed the most recent earlier occurrence become the K drafts.
  This is the same family as vLLM's ``prompt_lookup`` speculator and is
  strongest exactly where decode is weakest: long repetitive contexts
  (summarization, code edit, RAG extraction).
- the VERIFY side is ONE jitted step of static shape [B, K+1] — a tiny
  chunked-prefill-shaped program (the chunk machinery already exists) whose
  sampling tail performs exact rejection-sampling acceptance on device
  (``ops/sampling.spec_verify``). Accepted drafts keep the target model's
  distribution exactly; a greedy request degenerates to "accept while the
  draft equals the argmax", so greedy output is bit-identical with
  speculation on or off.

Token/KV bookkeeping on partial acceptance is rollback-free by design: the
verify step writes KV for all K+1 fed positions, but the scheduler only
advances ``num_computed`` over the accepted prefix; the slots holding
rejected drafts' KV are overwritten by the next step that reaches those
positions, and attention masks by true context length so they are never
read in between (see ``Scheduler.on_spec_done``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def propose_ngram(tokens: Sequence[int], k: int, max_n: int = 4,
                  min_n: int = 2) -> Optional[List[int]]:
    """Prompt-lookup draft: K continuation tokens for the current context.

    Scans n-gram sizes from ``max_n`` down to ``min_n``; for the first size
    whose context suffix re-occurs earlier, returns the ``k`` tokens that
    followed the MOST RECENT earlier occurrence (recency beats frequency for
    local repetition). Returns None when no suffix n-gram repeats — the
    caller falls back to a plain decode step, so a non-repetitive stream
    pays nothing.

    Drafts shorter than ``k`` (match near the end of context) are padded by
    repeating the final drafted token: padding only costs compute the step
    already spends, and verification rejects wrong tails for free.
    """
    arr = np.asarray(tokens, dtype=np.int64)
    L = arr.shape[0]
    if k <= 0 or L < min_n + 1:
        return None
    for n in range(min(max_n, L - 1), min_n - 1, -1):
        suffix = arr[L - n:]
        # windows starting at i cover arr[i:i+n]; exclude the suffix itself
        # (start L-n) and any window with no following token to draft
        starts = np.arange(0, L - n)
        if starts.size == 0:
            continue
        hits = np.ones(starts.size, dtype=bool)
        for j in range(n):
            hits &= arr[starts + j] == suffix[j]
        idx = np.flatnonzero(hits)
        if idx.size == 0:
            continue
        start = int(idx[-1])            # most recent earlier occurrence
        cont = arr[start + n:start + n + k]
        if cont.size == 0:
            continue
        draft = cont.tolist()
        while len(draft) < k:
            draft.append(draft[-1])
        return [int(t) for t in draft]
    return None


__all__ = ["propose_ngram"]
