"""Wire protocols the engine speaks: the port's copies of
``dynamo_tpu/protocols/common.py`` and ``events.py``."""

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
