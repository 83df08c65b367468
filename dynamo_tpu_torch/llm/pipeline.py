"""Service pipelines: Frontend -> Preprocessor -> [operators...] -> Backend.

Parity: reference ``entrypoint/input/common.rs:126-155`` (``build_pipeline``)
and ``discovery/watcher.rs:163-310`` (client pipeline built per discovered
model). The engine hop is COMPOSED from generic operators
(``llm/operators.py`` — the ``pipeline/nodes.rs`` role): RemotePipeline is
``link([Migration], router_sink)``, LocalEnginePipeline is
``link([], engine_sink)``, and ``ComposedPipeline`` accepts any operator
chain so deployments can insert their own stages without forking these
classes.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, AsyncIterator, Dict, Optional

from dynamo_tpu_torch.backend import Backend
from dynamo_tpu_torch.engine.base import EngineBase
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.preprocessor.preprocessor import DeltaGenerator
from dynamo_tpu_torch.protocols.common import (
    BackendOutput,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    ChatCompletionChunk,
    CompletionRequest,
)
from dynamo_tpu_torch.runtime.push_router import PushRouter


async def _deadline_guard(stream: AsyncIterator[LLMEngineOutput],
                          deadline_unix: float
                          ) -> AsyncIterator[LLMEngineOutput]:
    """Enforce a request deadline between frames of an engine stream.

    The remote hop already enforces in ``ResponseStream``; this covers
    in-process engines (``LocalEnginePipeline`` — the single-process
    server), so ``X-Request-Timeout`` / ``nvext.timeout_s`` behave the
    same on every topology.  Closing the underlying generator (the raise
    unwinds through the service layer's ``aclose``) releases the engine's
    scheduler slot."""
    from dynamo_tpu_torch.runtime.rpc import DeadlineExceededError
    it = stream.__aiter__()
    try:
        while True:
            remaining = deadline_unix - time.time()
            try:
                if remaining <= 0:
                    raise asyncio.TimeoutError
                out = await asyncio.wait_for(it.__anext__(), timeout=remaining)
            except asyncio.TimeoutError:
                raise DeadlineExceededError(
                    "request deadline exceeded mid-stream") from None
            except StopAsyncIteration:
                return
            yield out
    finally:
        # deterministic engine-slot release on any unwind (deadline, client
        # disconnect): the guard owns the inner stream now, so the service
        # layer's aclose() stops at the guard unless it forwards
        aclose = getattr(stream, "aclose", None)
        if aclose is not None:
            await aclose()


class ServicePipeline:
    """Base: owns preprocessor + backend; subclasses provide the engine hop."""

    def __init__(self, card: ModelDeploymentCard):
        self.card = card
        self.preprocessor = OpenAIPreprocessor(card)
        self.backend = Backend(card, tokenizer=self.preprocessor.tokenizer)

    # subclasses implement: stream LLMEngineOutput for a preprocessed request
    def engine_stream(self, request: PreprocessedRequest
                      ) -> AsyncIterator[LLMEngineOutput]:
        raise NotImplementedError

    def _deadlined_stream(self, request: PreprocessedRequest
                          ) -> AsyncIterator[LLMEngineOutput]:
        """The engine hop, with deadline enforcement when the request
        carries one (no-op wrapper otherwise)."""
        stream = self.engine_stream(request)
        if request.deadline_unix is None:
            return stream
        return _deadline_guard(stream, request.deadline_unix)

    def prepare_chat(self, req: ChatCompletionRequest,
                     request_id: Optional[str] = None,
                     deadline_unix: Optional[float] = None):
        """Preprocess only; lets the HTTP layer inspect annotations before
        streaming.  Returns (PreprocessedRequest, DeltaGenerator).

        ``deadline_unix`` stamps the end-to-end request deadline onto the
        preprocessed request; the remote hop propagates it to the worker and
        enforces it between frames."""
        from dynamo_tpu_torch.utils.tracing import get_tracer
        with get_tracer().span("tokenize") as sp:
            preprocessed = self.preprocessor.preprocess_chat(req, request_id)
            sp.set_attr("prompt_tokens", len(preprocessed.token_ids))
        if deadline_unix is not None:
            preprocessed.deadline_unix = deadline_unix
        delta = DeltaGenerator(
            model=req.model, request_id=request_id,
            include_usage=bool(req.stream_options and req.stream_options.include_usage))
        return preprocessed, delta

    async def run_chat(self, preprocessed: PreprocessedRequest,
                       delta: DeltaGenerator
                       ) -> AsyncIterator[ChatCompletionChunk]:
        async for out in self.backend.transform(
                preprocessed, self._deadlined_stream(preprocessed)):
            for chunk in delta.chunk_from(out):
                yield chunk
        # always emit the final usage chunk; the streaming HTTP layer drops it
        # unless the client asked via stream_options.include_usage
        yield delta.usage_chunk()

    async def generate_chat(self, req: ChatCompletionRequest,
                            request_id: Optional[str] = None
                            ) -> AsyncIterator[ChatCompletionChunk]:
        """Full chat pipeline: returns a stream of OpenAI chunk objects."""
        preprocessed, delta = self.prepare_chat(req, request_id)
        async for chunk in self.run_chat(preprocessed, delta):
            yield chunk

    async def generate_completion(self, req: CompletionRequest,
                                  request_id: Optional[str] = None,
                                  deadline_unix: Optional[float] = None
                                  ) -> AsyncIterator[BackendOutput]:
        """Completions pipeline: streams BackendOutput (text deltas)."""
        from dynamo_tpu_torch.utils.tracing import get_tracer
        with get_tracer().span("tokenize") as sp:
            preprocessed = self.preprocessor.preprocess_completion(
                req, request_id)
            sp.set_attr("prompt_tokens", len(preprocessed.token_ids))
        if deadline_unix is not None:
            preprocessed.deadline_unix = deadline_unix
        async for out in self.backend.transform(
                preprocessed, self._deadlined_stream(preprocessed)):
            yield out

    def _embedding_token_lists(self, req) -> "list[list[int]]":
        """Normalize an EmbeddingRequest's input into token id lists."""
        inputs = req.input
        if isinstance(inputs, str):
            inputs = [inputs]
        elif inputs and isinstance(inputs[0], int):
            inputs = [inputs]  # single pre-tokenized prompt
        return [item if isinstance(item, list)
                else self.preprocessor.tokenizer.encode(item)
                for item in inputs]

    async def generate_embeddings(self, req) -> "tuple[list, int]":
        """Tokenize the input(s) and embed. Returns (vectors, prompt_tokens).
        Raises NotImplementedError when this pipeline's engine can't embed."""
        raise NotImplementedError("this pipeline does not serve embeddings")

    async def score_prompt(self, token_ids):
        """Per-token prompt logprobs for the legacy completions ``echo``
        surface. Returns (lps, top_ids, top_lps) arrays aligned with
        ``token_ids``. NotImplementedError when the engine can't score."""
        raise NotImplementedError("this pipeline does not score prompts")

    def resolve_annotations(self, preprocessed: PreprocessedRequest) -> bool:
        """Fill router-level annotation responses. Returns True if the
        request is annotation-only (answered without generating)."""
        return False


class LocalEnginePipeline(ServicePipeline):
    """Pipeline with an in-process engine (reference: EngineConfig::StaticCore)."""

    def __init__(self, card: ModelDeploymentCard, engine: EngineBase):
        super().__init__(card)
        from dynamo_tpu_torch.llm.operators import engine_sink, link
        self.engine = engine
        self._source = link([], engine_sink(engine))

    def engine_stream(self, request: PreprocessedRequest
                      ) -> AsyncIterator[LLMEngineOutput]:
        return self._source(request)

    async def generate_embeddings(self, req) -> "tuple[list, int]":
        embed = getattr(self.engine, "embed", None)
        if embed is None:
            raise NotImplementedError("engine has no embedding path")
        token_lists = self._embedding_token_lists(req)
        vectors = await embed(token_lists)
        return ([[float(x) for x in v] for v in vectors],
                sum(len(t) for t in token_lists))

    async def score_prompt(self, token_ids):
        score = getattr(self.engine, "score", None)
        if score is None:
            raise NotImplementedError("engine has no prompt-scoring path")
        [(lps, tids, tlps)] = await score([list(token_ids)])
        return lps, tids, tlps


class ComposedPipeline(ServicePipeline):
    """Pipeline whose engine hop is an arbitrary operator chain over a
    sink (``llm/operators.py``) — the extension point for custom stages
    (rate limiting, frame auditing, shadow traffic, ...)."""

    def __init__(self, card: ModelDeploymentCard, operators, sink):
        super().__init__(card)
        from dynamo_tpu_torch.llm.operators import link
        self._source = link(operators, sink)

    def engine_stream(self, request: PreprocessedRequest
                      ) -> AsyncIterator[LLMEngineOutput]:
        return self._source(request)


class RemotePipeline(ServicePipeline):
    """Pipeline routing to remote workers through a PushRouter, with the
    migration (retry-on-stream-drop) operator built in:
    ``link([MigrationOperator], router_sink(router))``."""

    def __init__(self, card: ModelDeploymentCard, router: PushRouter,
                 migration_limit: Optional[int] = None,
                 aux_endpoint=None):
        super().__init__(card)
        from dynamo_tpu_torch.llm.operators import (
            MigrationOperator, link, router_sink)
        self.router = router
        self.migration_limit = (migration_limit if migration_limit is not None
                                else card.migration_limit)
        self._source = link([MigrationOperator(self.migration_limit)],
                            router_sink(router))
        # workers' one-shot aux plane (embeddings + prompt scoring);
        # client created lazily on first use
        self._aux_endpoint = aux_endpoint
        self._aux_client = None

    async def _aux_call(self, payload: dict) -> dict:
        if self._aux_endpoint is None:
            raise NotImplementedError(
                "this deployment exposes no aux (embed/score) plane")
        if self._aux_client is None:
            self._aux_client = await self._aux_endpoint.client()
        import random
        ids = self._aux_client.instance_ids()
        if not ids:
            raise NotImplementedError(
                "no worker serves the aux (embed/score) plane")
        stream = await self._aux_client.direct(payload, random.choice(ids))
        async for item in stream:
            err = item.get("error") if isinstance(item, dict) else None
            if err:
                # typed by the worker: "value" = bad request (400-class),
                # anything else = the capability is absent (501-class)
                if item.get("kind") == "value":
                    raise ValueError(err)
                raise NotImplementedError(err)
            return item
        raise ConnectionError("aux stream ended without a response")

    async def generate_embeddings(self, req) -> "tuple[list, int]":
        token_lists = self._embedding_token_lists(req)
        resp = await self._aux_call(
            {"op": "embed", "token_lists": token_lists})
        return resp["vectors"], sum(len(t) for t in token_lists)

    async def score_prompt(self, token_ids):
        import numpy as np
        resp = await self._aux_call(
            {"op": "score", "token_lists": [list(token_ids)]})
        [s] = resp["scores"]
        return (np.asarray(s["lps"], np.float32),
                np.asarray(s["top_ids"], np.int32),
                np.asarray(s["top_lps"], np.float32))

    def resolve_annotations(self, preprocessed: PreprocessedRequest) -> bool:
        from dynamo_tpu_torch.preprocessor.preprocessor import (
            ANNOTATION_QUERY_INSTANCE_ID)
        if ANNOTATION_QUERY_INSTANCE_ID not in preprocessed.annotations:
            return False
        find = getattr(self.router, "find_best_match", None)
        if find is None:
            return False
        # the routing decision without routing (parity: reference
        # kv_router.rs:331-337 query_instance_id annotation)
        worker, overlap = find(preprocessed.token_ids)
        preprocessed.annotations_payload[ANNOTATION_QUERY_INSTANCE_ID] = {
            "worker_instance_id": f"{worker:x}",
            "overlap_blocks": overlap,
        }
        return True

    def engine_stream(self, request: PreprocessedRequest
                      ) -> AsyncIterator[LLMEngineOutput]:
        return self._source(request)

    def _deadlined_stream(self, request: PreprocessedRequest
                          ) -> AsyncIterator[LLMEngineOutput]:
        # the remote hop already enforces the deadline between frames in
        # ResponseStream (and the worker drops expired work); wrapping it
        # again would only add a second wait_for timer per frame
        return self.engine_stream(request)


__all__ = ["ServicePipeline", "LocalEnginePipeline", "RemotePipeline",
           "ComposedPipeline"]
