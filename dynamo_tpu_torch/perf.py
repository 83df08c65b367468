"""Stream-level performance capture and analysis.

Parity: reference ``lib/llm/src/perf.rs:84-296`` (``record_stream`` ->
``RecordedStream`` of ``TimestampedResponse``) plus the latency summary the
reference computes in its benchmark tooling: TTFT, inter-token latency
percentiles, tokens/sec. Logprob analytics (``perf/logprobs.rs``): per-token
chosen-logprob capture with low-confidence ("close call") detection.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional


@dataclass
class TimestampedResponse:
    t: float          # seconds since stream start
    item: Any


@dataclass
class RecordedStream:
    started_at: float = 0.0
    responses: List[TimestampedResponse] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.responses)

    # -- latency analysis --------------------------------------------------

    def token_times(self) -> List[float]:
        """Arrival time of each token (frames may carry several tokens)."""
        out: List[float] = []
        for r in self.responses:
            ids = getattr(r.item, "token_ids", None)
            if ids is None and isinstance(r.item, dict):
                ids = r.item.get("token_ids")
            out.extend([r.t] * len(ids or []))
        return out

    def summary(self) -> Dict[str, float]:
        times = self.token_times()
        if not times:
            return {"tokens": 0}
        ttft = times[0]
        gaps = [b - a for a, b in zip(times, times[1:]) if b >= a]
        total = times[-1]
        out = {
            "tokens": float(len(times)),
            "ttft_s": ttft,
            "total_s": total,
            "tokens_per_s": (len(times) / total) if total > 0 else 0.0,
        }
        if gaps:
            s = sorted(gaps)
            out["itl_mean_s"] = sum(gaps) / len(gaps)
            out["itl_p50_s"] = s[len(s) // 2]
            out["itl_p99_s"] = s[min(len(s) - 1, int(len(s) * 0.99))]
        return out

    # -- logprob analysis --------------------------------------------------

    def logprobs(self) -> List[float]:
        out: List[float] = []
        for r in self.responses:
            lp = getattr(r.item, "log_probs", None)
            if lp is None and isinstance(r.item, dict):
                lp = r.item.get("log_probs")
            out.extend(lp or [])
        return out

    def close_calls(self, threshold: float = -0.693) -> int:
        """Tokens whose chosen logprob is below ``threshold`` (default ln 0.5
        — the model was less than 50% sure). Parity in intent with the
        reference's close-logprob detection (``perf/logprobs.rs``)."""
        return sum(1 for lp in self.logprobs() if lp < threshold)

    def top_logprobs(self) -> List[Dict[int, float]]:
        """Per-token top-K alternatives ({token_id: logprob}), flattened."""
        out: List[Dict[int, float]] = []
        for r in self.responses:
            top = getattr(r.item, "top_logprobs", None)
            if top is None and isinstance(r.item, dict):
                top = r.item.get("top_logprobs")
            out.extend(top or [])
        return out

    def logprob_analysis(self) -> "LogprobAnalysis":
        return LogprobAnalysis.from_tokens(self.logprobs(),
                                           self.top_logprobs())


@dataclass
class CloseCall:
    """One near-tied sampling decision (the reference reports these per
    position so regressions that flip outputs can be localized)."""

    position: int
    margin: float              # top-1 minus top-2 logprob (nats)
    chosen_logprob: float
    candidates: List[float]    # top-K logprobs, best first


@dataclass
class LogprobAnalysis:
    """Distribution analytics over sampled logprobs + top-K alternatives.

    Parity: reference ``lib/llm/src/perf/logprobs.rs`` (sequence logprob
    distributions, close-call detection on top-1/top-2 margins, rank
    tracking, per-position entropy). ``margins[i]`` is the logprob gap
    between the best and second-best candidate at step i — the decisive
    confidence signal the reference uses to find tokens a nearly-tied
    distribution could flip; ``ranks[i]`` is the sampled token's position
    in the top-K (0 = argmax, K = fell outside); ``entropies[i]`` is the
    distribution entropy over the observed top-K plus the residual tail
    mass as one bucket (a lower bound on full-vocab entropy — exact over
    the head, collapsing the tail)."""

    chosen: List[float] = field(default_factory=list)
    margins: List[float] = field(default_factory=list)
    ranks: List[int] = field(default_factory=list)
    entropies: List[float] = field(default_factory=list)
    tops: List[List[float]] = field(default_factory=list)

    @classmethod
    def from_tokens(cls, chosen: List[float],
                    tops: List[Dict[int, float]]) -> "LogprobAnalysis":
        import math
        margins: List[float] = []
        ranks: List[int] = []
        entropies: List[float] = []
        top_vals: List[List[float]] = []
        for i, top in enumerate(tops):
            vals = sorted(top.values(), reverse=True)
            top_vals.append(vals)
            if len(vals) >= 2:
                margins.append(vals[0] - vals[1])
            if i < len(chosen):
                # rank by count of alternatives strictly better than chosen
                ranks.append(sum(1 for v in vals if v > chosen[i] + 1e-9))
            if vals:
                # entropy over top-K probabilities + one residual bucket
                # for the unobserved tail (treats the tail as a single
                # outcome, so this lower-bounds full-vocab entropy over
                # the tail while being exact over the head)
                probs = [math.exp(v) for v in vals]
                tail = max(0.0, 1.0 - sum(probs))
                if tail > 1e-12:
                    probs.append(tail)
                entropies.append(-sum(p * math.log(p)
                                      for p in probs if p > 0.0))
        return cls(chosen=list(chosen), margins=margins, ranks=ranks,
                   entropies=entropies, tops=top_vals)

    @classmethod
    def from_openai_chunks(cls, chunks: List[Any]) -> "LogprobAnalysis":
        """Build the analysis from recorded OpenAI chat chunks (dicts or
        chunk objects with ``choices[].logprobs.content`` entries) — the
        reference analyzes recorded response streams the same way
        (``perf/logprobs.rs`` over SSE captures), so analytics work on
        what actually crossed the wire, not only engine-internal frames."""
        chosen: List[float] = []
        tops: List[Dict[int, float]] = []
        for ch in chunks:
            d = ch if isinstance(ch, dict) else getattr(
                ch, "to_dict", lambda: {})()
            for choice in d.get("choices", []):
                content = ((choice.get("logprobs") or {}).get("content")
                           or [])
                for entry in content:
                    chosen.append(float(entry.get("logprob", 0.0)))
                    alt = {i: float(t.get("logprob", 0.0))
                           for i, t in enumerate(
                               entry.get("top_logprobs") or [])}
                    tops.append(alt)
        return cls.from_tokens(chosen, tops)

    # -- scalars -------------------------------------------------------------

    def mean_logprob(self) -> float:
        return sum(self.chosen) / len(self.chosen) if self.chosen else 0.0

    def perplexity(self) -> float:
        """exp(-mean logprob) of the sampled sequence."""
        import math
        return math.exp(-self.mean_logprob()) if self.chosen else 1.0

    def close_calls(self, margin_threshold: float = 0.1) -> int:
        """Steps where the top-2 candidates were within ``margin_threshold``
        nats — a tiny numerics or sampling change could flip the output."""
        return sum(1 for m in self.margins if m <= margin_threshold)

    def close_call_details(self, margin_threshold: float = 0.1
                           ) -> List[CloseCall]:
        """The near-tied positions themselves, with their candidate sets
        (reference behavior: localize WHICH tokens could flip, not just
        how many)."""
        out: List[CloseCall] = []
        for i, vals in enumerate(self.tops):
            if len(vals) >= 2 and vals[0] - vals[1] <= margin_threshold:
                out.append(CloseCall(
                    position=i, margin=vals[0] - vals[1],
                    chosen_logprob=(self.chosen[i]
                                    if i < len(self.chosen) else 0.0),
                    candidates=list(vals)))
        return out

    def low_confidence_spans(self, margin_threshold: float = 0.1,
                             min_len: int = 2) -> List[tuple]:
        """(start, end) position ranges of >= ``min_len`` CONSECUTIVE
        close calls — sustained uncertainty (hallucination-prone spans)
        rather than isolated coin flips."""
        flags = [len(v) >= 2 and v[0] - v[1] <= margin_threshold
                 for v in self.tops]
        spans: List[tuple] = []
        start = None
        for i, f in enumerate(flags + [False]):
            if f and start is None:
                start = i
            elif not f and start is not None:
                if i - start >= min_len:
                    spans.append((start, i))
                start = None
        return spans

    def non_greedy_tokens(self) -> int:
        """Sampled tokens that were NOT the argmax (rank > 0)."""
        return sum(1 for r in self.ranks if r > 0)

    def rank_histogram(self) -> Dict[int, int]:
        hist: Dict[int, int] = {}
        for r in self.ranks:
            hist[r] = hist.get(r, 0) + 1
        return hist

    def mean_entropy(self) -> float:
        return (sum(self.entropies) / len(self.entropies)
                if self.entropies else 0.0)

    def summary(self) -> Dict[str, float]:
        out = {
            "tokens": float(len(self.chosen)),
            "mean_logprob": self.mean_logprob(),
            "perplexity": self.perplexity(),
            "close_calls": float(self.close_calls()),
            "non_greedy_tokens": float(self.non_greedy_tokens()),
            "mean_entropy": self.mean_entropy(),
        }
        if self.margins:
            s = sorted(self.margins)
            out["margin_p50"] = s[len(s) // 2]
            out["margin_min"] = s[0]
        if self.entropies:
            e = sorted(self.entropies)
            out["entropy_p90"] = e[min(len(e) - 1, int(len(e) * 0.9))]
        return out


async def record_stream(stream: AsyncIterator[Any],
                        into: Optional[RecordedStream] = None
                        ) -> AsyncIterator[Any]:
    """Pass-through wrapper that timestamps every frame into ``into``."""
    rec = into if into is not None else RecordedStream()
    rec.started_at = time.perf_counter()
    async for item in stream:
        rec.responses.append(
            TimestampedResponse(time.perf_counter() - rec.started_at, item))
        yield item


__all__ = ["RecordedStream", "TimestampedResponse", "record_stream",
           "LogprobAnalysis", "CloseCall"]
