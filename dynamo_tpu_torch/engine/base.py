"""Engine protocol + echo test engine.

Parity: reference ``lib/runtime/src/engine.rs`` (``AsyncEngine`` trait) and
``lib/llm/src/engines.rs`` (echo engines used for pipeline tests).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)


class EngineBase:
    """Protocol: stream LLMEngineOutput frames for a preprocessed request."""

    async def generate(self, request: PreprocessedRequest,
                       ctx=None) -> AsyncIterator[LLMEngineOutput]:
        raise NotImplementedError
        yield  # pragma: no cover

    async def start(self) -> None:  # optional lifecycle
        pass

    async def stop(self) -> None:
        pass


class EchoEngine(EngineBase):
    """Echoes the prompt tokens back, one frame per token, with an optional
    per-token delay (for streaming/timing tests)."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    async def generate(self, request: PreprocessedRequest,
                       ctx=None) -> AsyncIterator[LLMEngineOutput]:
        import time
        t0 = time.time()
        max_tokens = request.stop_conditions.max_tokens or len(request.token_ids)
        n = min(len(request.token_ids), max_tokens)
        # first-frame stage stamps, same shape the scheduled engine loop
        # emits — so tracing tests get queue/prefill/decode spans without a
        # real engine (queue is zero-width; "prefill" is the per-token delay
        # before the first frame)
        def first_timings():
            return {"enqueued_unix": t0, "admitted_unix": t0,
                    "first_unix": time.time()}
        for i in range(n):
            if ctx is not None and getattr(ctx, "cancelled", False):
                yield LLMEngineOutput(finish_reason=FinishReason.CANCELLED)
                return
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
            yield LLMEngineOutput(token_ids=[request.token_ids[i]],
                                  timings=first_timings() if i == 0 else None)
        yield LLMEngineOutput(
            finish_reason=FinishReason.LENGTH,
            timings=first_timings() if n == 0 else None,
            prompt_tokens=len(request.token_ids), completion_tokens=n)


__all__ = ["EngineBase", "EchoEngine"]
