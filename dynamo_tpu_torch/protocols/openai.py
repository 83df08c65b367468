"""OpenAI-compatible API types (chat completions, completions, embeddings).

Pydantic models used by the HTTP frontend for request validation and response
serialization, including streaming delta chunks.  The ``nvext``-style extension
field is carried as ``extensions`` (annotations etc.).

Parity: reference ``lib/llm/src/protocols/openai/`` (chat_completions,
completions, embeddings, nvext) — see SURVEY.md §2.2.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import BaseModel, ConfigDict, Field


class Extensions(BaseModel):
    """Framework extension fields (reference: ``nvext.rs``)."""

    model_config = ConfigDict(extra="allow")
    annotations: Optional[List[str]] = None
    ignore_eos: Optional[bool] = None
    greed_sampling: Optional[bool] = None
    # per-request end-to-end deadline override (seconds from arrival);
    # takes precedence over the X-Request-Timeout header and the service's
    # configured default
    timeout_s: Optional[float] = None


class ChatMessage(BaseModel):
    model_config = ConfigDict(extra="allow")
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    tool_call_id: Optional[str] = None

    def text_content(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        # multimodal content parts: concatenate text parts
        return "".join(
            p.get("text", "") for p in self.content if isinstance(p, dict) and p.get("type") == "text"
        )


class StreamOptions(BaseModel):
    include_usage: bool = False


class ChatCompletionRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    messages: List[ChatMessage]
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None  # extension (vLLM-style)
    n: int = 1
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    stop: Optional[Union[str, List[str]]] = None
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    min_tokens: Optional[int] = None  # extension
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None  # extension
    logit_bias: Optional[Dict[str, float]] = None
    min_p: Optional[float] = Field(default=None, ge=0.0, le=1.0)  # vLLM-style
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    seed: Optional[int] = None
    user: Optional[str] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Union[str, Dict[str, Any]]] = None
    # OpenAI structured outputs: {"type": "text" | "json_object"} or
    # {"type": "json_schema", "json_schema": {"schema": {...}, ...}}
    response_format: Optional[Dict[str, Any]] = None
    nvext: Optional[Extensions] = None

    def stop_list(self) -> Optional[List[str]]:
        if self.stop is None:
            return None
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def effective_max_tokens(self) -> Optional[int]:
        return self.max_completion_tokens or self.max_tokens

    def guided_spec(self) -> Optional[Dict[str, Any]]:
        """Map response_format to the engine's guided-decoding spec
        (``engine/guided.py``); raises ValueError on malformed input."""
        rf = self.response_format
        if not rf:
            return None
        kind = rf.get("type")
        if kind in (None, "text"):
            return None
        if kind == "json_object":
            return {"mode": "json"}
        if kind == "json_schema":
            js = rf.get("json_schema") or {}
            if not isinstance(js, dict):
                raise ValueError(
                    "response_format.json_schema must be an object")
            schema = js.get("schema")
            if not isinstance(schema, dict):
                raise ValueError(
                    "response_format.json_schema.schema must be an object")
            return {"mode": "json_schema", "schema": schema}
        raise ValueError(f"unsupported response_format type {kind!r}")


class CompletionRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
    suffix: Optional[str] = None
    max_tokens: Optional[int] = 16
    min_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: int = 1
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    logprobs: Optional[int] = None
    echo: bool = False
    stop: Optional[Union[str, List[str]]] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    logit_bias: Optional[Dict[str, float]] = None
    min_p: Optional[float] = Field(default=None, ge=0.0, le=1.0)  # vLLM-style
    seed: Optional[int] = None
    user: Optional[str] = None
    nvext: Optional[Extensions] = None

    def stop_list(self) -> Optional[List[str]]:
        if self.stop is None:
            return None
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


class EmbeddingRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    input: Union[str, List[str], List[int], List[List[int]]]
    encoding_format: Literal["float", "base64"] = "float"
    dimensions: Optional[int] = None
    user: Optional[str] = None


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    prompt_tokens_details: Optional[Dict[str, int]] = None


class ChoiceLogprobs(BaseModel):
    content: Optional[List[Dict[str, Any]]] = None


class ChatChoice(BaseModel):
    index: int = 0
    message: ChatMessage
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogprobs] = None


class ChatCompletionResponse(BaseModel):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int
    model: str
    choices: List[ChatChoice]
    usage: Optional[Usage] = None
    system_fingerprint: Optional[str] = None


class DeltaMessage(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None


class ChatChunkChoice(BaseModel):
    index: int = 0
    delta: DeltaMessage
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogprobs] = None


class ChatCompletionChunk(BaseModel):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int
    model: str
    choices: List[ChatChunkChoice]
    usage: Optional[Usage] = None


class CompletionChoice(BaseModel):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class CompletionResponse(BaseModel):
    id: str
    object: Literal["text_completion"] = "text_completion"
    created: int
    model: str
    choices: List[CompletionChoice]
    usage: Optional[Usage] = None


class EmbeddingData(BaseModel):
    object: Literal["embedding"] = "embedding"
    index: int
    embedding: Union[List[float], str]


class EmbeddingResponse(BaseModel):
    object: Literal["list"] = "list"
    data: List[EmbeddingData]
    model: str
    usage: Optional[Usage] = None


class ModelInfo(BaseModel):
    id: str
    object: Literal["model"] = "model"
    created: int = 0
    owned_by: str = "dynamo_tpu"


class ModelList(BaseModel):
    object: Literal["list"] = "list"
    data: List[ModelInfo] = Field(default_factory=list)


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now_unix() -> int:
    return int(time.time())


__all__ = [
    "Extensions",
    "ChatMessage",
    "StreamOptions",
    "ChatCompletionRequest",
    "CompletionRequest",
    "EmbeddingRequest",
    "Usage",
    "ChatChoice",
    "ChatCompletionResponse",
    "DeltaMessage",
    "ChatChunkChoice",
    "ChatCompletionChunk",
    "CompletionChoice",
    "CompletionResponse",
    "EmbeddingData",
    "EmbeddingResponse",
    "ModelInfo",
    "ModelList",
    "new_request_id",
    "now_unix",
]
