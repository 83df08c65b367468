"""Backend stage: incremental detokenization + stop handling between the
engine and the frontend.

Parity: reference ``lib/llm/src/backend.rs:67-477`` (``Backend::from_mdc``,
``Decoder``/``DecodeStream``, the stop-sequence "jail", eos handling).

The *jail* holds back emitted text whenever its tail could be the start of a
stop sequence; once the tail provably can't complete any stop string, the held
text is released.  On a confirmed stop match, text is truncated at the match
and the stream finishes with ``FinishReason.STOP``.
"""

from __future__ import annotations

import logging
import time
from typing import AsyncIterator, List, Optional

from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.preprocessor.tokenizer import DecodeStream, HfTokenizer
from dynamo_tpu_torch.protocols.common import (
    BackendOutput,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)

logger = logging.getLogger(__name__)


def _longest_suffix_prefix(text: str, stops: List[str]) -> int:
    """Length of the longest suffix of ``text`` that is a proper prefix of any
    stop string (i.e. text that must stay jailed)."""
    best = 0
    for stop in stops:
        maxlen = min(len(text), len(stop) - 1)
        for n in range(maxlen, 0, -1):
            if stop.startswith(text[-n:]):
                best = max(best, n)
                break
    return best


class StopJail:
    """Streaming stop-sequence matcher over text deltas."""

    def __init__(self, stops: List[str]):
        self.stops = [s for s in stops if s]
        self._held = ""
        self.matched: Optional[str] = None

    def push(self, delta: str) -> str:
        """Feed a text delta; returns text safe to emit now.  After a match,
        ``self.matched`` is set and everything from the stop string on is
        swallowed."""
        if self.matched is not None:
            return ""
        if not self.stops:
            return delta
        text = self._held + delta
        # earliest occurrence in the text wins, not list order
        best_idx, best_stop = -1, None
        for stop in self.stops:
            idx = text.find(stop)
            if idx >= 0 and (best_idx < 0 or idx < best_idx):
                best_idx, best_stop = idx, stop
        if best_stop is not None:
            self.matched = best_stop
            self._held = ""
            return text[:best_idx]
        keep = _longest_suffix_prefix(text, self.stops)
        self._held = text[len(text) - keep:] if keep else ""
        return text[:len(text) - keep] if keep else text

    def flush(self) -> str:
        """Release any jailed text at end of stream (no match happened)."""
        out, self._held = self._held, ""
        return out


class Backend:
    """Per-model detokenizer stage factory."""

    def __init__(self, card: ModelDeploymentCard,
                 tokenizer: Optional[HfTokenizer] = None):
        self.card = card
        self.tokenizer = tokenizer if tokenizer is not None else card.load_tokenizer()

    def _logprob_entry(self, piece: str, logprob: Optional[float],
                       top: Optional[dict], num_top: int) -> dict:
        """One OpenAI ``logprobs.content[]`` element (chat format; the
        completions route reshapes these into the legacy arrays).

        ``piece`` is the token's TRUE text delta from the incremental
        decoder — concatenating ``bytes`` across entries reconstructs the
        stream exactly (a token mid-multibyte contributes "" now and the
        full character lands on the completing token), unlike decoding the
        id in isolation, which yields U+FFFD for byte-fallback tokens.
        Alternatives are decoded in isolation (no stream position exists
        for a token that wasn't chosen).

        Reference surface: ``lib/llm/src/protocols/openai`` logprobs types;
        the engines there populate them via vLLM — here the native engine's
        top-K step outputs feed them directly."""
        entry = {"token": piece, "logprob": logprob,
                 "bytes": list(piece.encode("utf-8"))}
        if top:
            ranked = sorted(top.items(), key=lambda kv: -kv[1])[:num_top]
            entry["top_logprobs"] = [
                {"token": (t := self.tokenizer.decode([tid],
                                                      skip_special_tokens=False)),
                 "logprob": lp, "bytes": list(t.encode("utf-8"))}
                for tid, lp in ranked]
        return entry

    async def transform(self, request: PreprocessedRequest,
                        engine_stream: AsyncIterator[LLMEngineOutput]
                        ) -> AsyncIterator[BackendOutput]:
        """Wrap an engine output stream with detokenization + stop handling."""
        decoder = self.tokenizer.decode_stream()
        jail = StopJail(request.stop_conditions.stop or [])
        eos_ids = set(request.eos_token_ids or self.card.eos_token_ids)
        ignore_eos = request.stop_conditions.ignore_eos
        stop_ids = set(request.stop_conditions.stop_token_ids or [])
        completion = 0
        # None = logprobs off; 0 = sampled token only; N = +N alternatives
        want_logprobs = request.sampling_options.logprobs
        # detokenize stage accounting: the per-frame decode work is
        # interleaved with engine frames, so it's accumulated and recorded
        # as ONE retroactive span at stream end (utils/tracing)
        detok_s = 0.0

        try:
            async for out in engine_stream:
                if out.error:
                    yield BackendOutput(error=out.error,
                                        finish_reason=FinishReason.ERROR)
                    return
                _t0 = time.perf_counter()
                emit_ids: List[int] = []
                pieces: List[str] = []
                lp_content: Optional[List[dict]] = (
                    [] if want_logprobs is not None else None)
                finish: Optional[FinishReason] = out.finish_reason
                for j, tok in enumerate(out.token_ids):
                    completion += 1
                    if not ignore_eos and tok in eos_ids:
                        finish = FinishReason.EOS
                        break
                    if tok in stop_ids:
                        finish = FinishReason.STOP
                        break
                    emit_ids.append(tok)
                    piece = decoder.step(tok)
                    pieces.append(piece)
                    if lp_content is not None:
                        lp = (out.log_probs[j]
                              if out.log_probs and j < len(out.log_probs)
                              else None)
                        top = (out.top_logprobs[j]
                               if out.top_logprobs
                               and j < len(out.top_logprobs) else None)
                        lp_content.append(self._logprob_entry(
                            piece, lp, top, want_logprobs))
                text = jail.push("".join(pieces)) if pieces else ""
                if jail.matched is not None:
                    finish = FinishReason.STOP
                    if lp_content:
                        # drop entries for tokens the jail trimmed (the stop
                        # string itself). Approximate across frames: text
                        # may include chars the jail held from earlier
                        # frames whose entries already went out, which only
                        # errs toward keeping a boundary token.
                        kept, acc = [], 0
                        for e in lp_content:
                            if acc >= len(text):
                                break
                            kept.append(e)
                            acc += len(e["token"])
                        lp_content = kept
                detok_s += time.perf_counter() - _t0
                if finish is not None:
                    if jail.matched is None:
                        text += jail.flush()
                    yield BackendOutput(
                        token_ids=emit_ids, text=text or None,
                        finish_reason=finish,
                        cum_log_probs=out.cum_log_probs, log_probs=out.log_probs,
                        logprobs_content=lp_content or None,
                        prompt_tokens=out.prompt_tokens or len(request.token_ids),
                        completion_tokens=out.completion_tokens or completion,
                        cached_tokens=out.cached_tokens)
                    return
                if emit_ids or text:
                    yield BackendOutput(
                        token_ids=emit_ids, text=text or None,
                        cum_log_probs=out.cum_log_probs, log_probs=out.log_probs,
                        logprobs_content=lp_content or None)
            # engine ended without a finish reason: surface what we have
            tail = jail.flush()
            yield BackendOutput(
                token_ids=[], text=tail or None, finish_reason=FinishReason.LENGTH,
                prompt_tokens=len(request.token_ids), completion_tokens=completion)
        finally:
            # Deterministically close the engine hop on early exit (stop match,
            # client disconnect): propagates GeneratorExit down the chain so
            # remote streams send a cancel frame instead of generating on.
            aclose = getattr(engine_stream, "aclose", None)
            if aclose is not None:
                await aclose()
            if detok_s > 0:
                # retroactive span: the accumulated decode time, anchored so
                # it ends now (the stage breakdown cares about the total,
                # not the interleaving)
                from dynamo_tpu_torch.utils.tracing import get_tracer
                now = time.time()
                get_tracer().record("detokenize", now - detok_s, now,
                                    attrs={"accumulated": True})


__all__ = ["Backend", "StopJail"]
