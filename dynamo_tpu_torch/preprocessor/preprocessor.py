"""OpenAIPreprocessor: OpenAI request -> PreprocessedRequest (fwd) and
LLMEngineOutput/BackendOutput stream -> OpenAI deltas (bwd).

Parity: reference ``lib/llm/src/preprocessor.rs:92-424`` (forward:
template + tokenize + sampling/stop extraction + annotations) and the
``DeltaGenerator`` SSE backward pass (``preprocessor.rs:320-424``).
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple, Union

from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.preprocessor.template import PromptFormatter
from dynamo_tpu_torch.preprocessor.tokenizer import HfTokenizer
from dynamo_tpu_torch.protocols.common import (
    BackendOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatChunkChoice,
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChoiceLogprobs,
    CompletionRequest,
    DeltaMessage,
    Usage,
    new_request_id,
    now_unix,
)

logger = logging.getLogger(__name__)

# frontend-side guided-spec validation cache: apps typically post the SAME
# json_schema on every request, and compiling a grammar per request on the
# service event loop would be pure waste — remember which canonical specs
# compiled cleanly (the worker keeps its own grammar cache for serving)
_GUIDED_OK: Dict[str, bool] = {}
_GUIDED_OK_CAP = 128


def _validate_guided_spec(spec: Dict[str, Any]) -> None:
    import json as _json

    key = _json.dumps(spec, sort_keys=True)
    if _GUIDED_OK.get(key):
        return
    from dynamo_tpu_torch.engine.guided import compile_guided
    compile_guided(spec)   # raises GuidedUnsupported (a ValueError)
    if len(_GUIDED_OK) >= _GUIDED_OK_CAP:
        _GUIDED_OK.pop(next(iter(_GUIDED_OK)))
    _GUIDED_OK[key] = True

# annotation keys (parity: reference nvext annotations "formatted_prompt",
# "token_ids", "query_instance_id")
ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"
ANNOTATION_QUERY_INSTANCE_ID = "query_instance_id"


class OpenAIPreprocessor:
    """Stateless per-model request preprocessor."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Optional[HfTokenizer] = None):
        self.card = card
        self.tokenizer = tokenizer if tokenizer is not None else card.load_tokenizer()
        self.formatter = PromptFormatter(card.chat_template)

    # -- forward pass ------------------------------------------------------

    def preprocess_chat(self, req: ChatCompletionRequest,
                        request_id: Optional[str] = None) -> PreprocessedRequest:
        prompt = self.formatter.render(
            [m.model_dump(exclude_none=True) for m in req.messages],
            add_generation_prompt=True,
            tools=req.tools)
        token_ids = self.tokenizer.encode(prompt)
        out = self._build(req, token_ids, request_id)
        annotations = (req.nvext.annotations if req.nvext else None) or []
        out.annotations = list(annotations)
        if ANNOTATION_FORMATTED_PROMPT in annotations:
            out.annotations_payload[ANNOTATION_FORMATTED_PROMPT] = prompt
        if ANNOTATION_TOKEN_IDS in annotations:
            out.annotations_payload[ANNOTATION_TOKEN_IDS] = list(token_ids)
        return out

    def preprocess_completion(self, req: CompletionRequest,
                              request_id: Optional[str] = None) -> PreprocessedRequest:
        prompt = req.prompt
        if isinstance(prompt, str):
            token_ids = self.tokenizer.encode(prompt)
        elif prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)  # pre-tokenized
        else:
            raise ValueError("batch prompts must be fanned out by the caller")
        out = self._build(req, token_ids, request_id)
        out.annotations = list((req.nvext.annotations if req.nvext else None) or [])
        return out

    # fallback when the card predates the field: the engine's default
    # sparse penalty window (JaxEngineConfig.penalty_window)
    MAX_LOGIT_BIAS = 32

    def _validate_logit_bias(self, lb):
        if not lb:
            return None
        # the SERVING engine's configured window (advertised on the model
        # card by the worker, like num_top_logprobs) — a deployment with a
        # narrower window must reject wide logit_bias instead of silently
        # dropping entries on device
        limit = getattr(self.card, "penalty_window", self.MAX_LOGIT_BIAS)
        if len(lb) > limit:
            raise ValueError(
                f"logit_bias supports at most {limit} entries on this "
                f"model's serving engine, got {len(lb)}")
        vocab = self.tokenizer.vocab_size
        out = {}
        for k, v in lb.items():
            try:
                t = int(k)
            except (TypeError, ValueError):
                raise ValueError(f"logit_bias key {k!r} is not a token id")
            if not 0 <= t < vocab:
                raise ValueError(
                    f"logit_bias token id {t} outside the vocab "
                    f"(size {vocab})")
            out[t] = float(v)
        return out

    def _build(self, req: Union[ChatCompletionRequest, CompletionRequest],
               token_ids: List[int], request_id: Optional[str]) -> PreprocessedRequest:
        if len(token_ids) >= self.card.context_length:
            raise ValueError(
                f"prompt is {len(token_ids)} tokens but the model context "
                f"length is {self.card.context_length}")
        max_tokens = (req.effective_max_tokens()
                      if isinstance(req, ChatCompletionRequest) else req.max_tokens)
        budget = self.card.context_length - len(token_ids)
        max_tokens = min(max_tokens, budget) if max_tokens is not None else budget
        ignore_eos = bool(req.nvext.ignore_eos) if (
            req.nvext and req.nvext.ignore_eos is not None) else False
        stop_conditions = StopConditions(
            max_tokens=max_tokens,
            stop=req.stop_list(),
            min_tokens=req.min_tokens,
            ignore_eos=ignore_eos,
        )
        # OpenAI logprobs: chat gates a count behind a bool (logprobs=true +
        # top_logprobs=N); legacy completions passes the count directly.
        # sampling.logprobs None = off, 0 = sampled token only, N = +N tops.
        if isinstance(req, ChatCompletionRequest):
            logprobs = ((req.top_logprobs or 0) if req.logprobs else None)
        else:
            logprobs = req.logprobs
        if logprobs is not None:
            # OpenAI caps top_logprobs at 20; the serving engine computes
            # exactly card.num_top_logprobs alternatives per token, so the
            # accepted range is the min of the two — never silently fewer
            # than the request asked for
            engine_k = getattr(self.card, "num_top_logprobs", 20)
            logprobs = min(logprobs, 20, engine_k)
        # guided decoding. A FORCED tool call (tool_choice 'required' /
        # named) is the stronger contract and wins over response_format —
        # and its validation (unknown function, required-without-tools ->
        # 400) runs regardless. A tool's own parameter schema may use
        # keywords the grammar cannot enforce; degrade its arguments to
        # any-object rather than rejecting the user's tools (unlike
        # response_format, that schema is OURS, not the client's explicit
        # ask).
        guided = None
        if isinstance(req, ChatCompletionRequest):
            from dynamo_tpu_torch.preprocessor.tools import (
                degrade_tool_spec, forced_tool_guided_spec)
            forced = forced_tool_guided_spec(req.tools, req.tool_choice)
            if forced is not None:
                try:
                    _validate_guided_spec(forced)
                except ValueError:
                    forced = degrade_tool_spec(forced)
                    _validate_guided_spec(forced)
                guided = forced
            else:
                # response_format: the client's own schema — bad specs
                # 400 here instead of erroring the worker stream
                guided = req.guided_spec()
                if guided is not None:
                    _validate_guided_spec(guided)
        sampling = SamplingOptions(
            temperature=req.temperature,
            top_p=req.top_p,
            top_k=req.top_k,
            frequency_penalty=req.frequency_penalty,
            presence_penalty=req.presence_penalty,
            repetition_penalty=req.repetition_penalty,
            logit_bias=self._validate_logit_bias(req.logit_bias),
            min_p=req.min_p,
            seed=req.seed,
            n=req.n,
            logprobs=logprobs,
            guided=guided,
        )
        return PreprocessedRequest(
            token_ids=token_ids,
            request_id=request_id or new_request_id("req"),
            model=req.model,
            stop_conditions=stop_conditions,
            sampling_options=sampling,
            eos_token_ids=list(self.card.eos_token_ids),
            mdc_sum=self.card.checksum(),
        )


class DeltaGenerator:
    """Backward pass: BackendOutput stream -> OpenAI chat-completion chunks.

    Parity: reference ``DeltaGenerator`` (``preprocessor.rs:320-424``).
    """

    def __init__(self, model: str, request_id: Optional[str] = None,
                 include_usage: bool = False):
        self.id = request_id or new_request_id()
        self.model = model
        self.created = now_unix()
        self.include_usage = include_usage
        self._first = True
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self.cached_tokens: Optional[int] = None

    def chunk_from(self, out: BackendOutput) -> List[ChatCompletionChunk]:
        chunks: List[ChatCompletionChunk] = []
        self.completion_tokens += len(out.token_ids)
        if out.prompt_tokens is not None:
            self.prompt_tokens = out.prompt_tokens
        if out.completion_tokens is not None:
            self.completion_tokens = out.completion_tokens
        if out.cached_tokens is not None:
            self.cached_tokens = out.cached_tokens
        role = "assistant" if self._first else None
        self._first = False
        # emit on logprob entries too: a frame whose tokens decoded to no
        # text yet (partial UTF-8 held by the decode stream) still carries
        # per-token logprobs that must not be dropped
        if out.text or role is not None or out.logprobs_content:
            logprobs = (ChoiceLogprobs(content=out.logprobs_content)
                        if out.logprobs_content else None)
            chunks.append(ChatCompletionChunk(
                id=self.id, created=self.created, model=self.model,
                choices=[ChatChunkChoice(
                    delta=DeltaMessage(role=role, content=out.text or ""),
                    logprobs=logprobs)]))
        if out.finish_reason is not None:
            chunks.append(ChatCompletionChunk(
                id=self.id, created=self.created, model=self.model,
                choices=[ChatChunkChoice(
                    delta=DeltaMessage(),
                    finish_reason=out.finish_reason.to_openai())]))
        return chunks

    def usage_chunk(self) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id, created=self.created, model=self.model, choices=[],
            usage=Usage(
                prompt_tokens=self.prompt_tokens,
                completion_tokens=self.completion_tokens,
                total_tokens=self.prompt_tokens + self.completion_tokens,
                # OpenAI prompt-caching surface: how many prompt tokens
                # were served from the prefix cache
                prompt_tokens_details=(
                    {"cached_tokens": self.cached_tokens}
                    if self.cached_tokens is not None else None)))


__all__ = ["OpenAIPreprocessor", "DeltaGenerator",
           "ANNOTATION_FORMATTED_PROMPT", "ANNOTATION_TOKEN_IDS",
           "ANNOTATION_QUERY_INSTANCE_ID"]
