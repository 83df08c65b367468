"""Wire protocols: the port's copies of ``dynamo_tpu/protocols/common.py``
(internal request/response types), ``events.py`` (KV events and worker
metrics), ``openai.py`` (OpenAI API types) and ``sse.py`` (the SSE codec)."""

from dynamo_tpu_torch.protocols.common import (
    BackendOutput,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

__all__ = [
    "BackendOutput",
    "FinishReason",
    "LLMEngineOutput",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
]
