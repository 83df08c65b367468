"""Typed OpenAI HTTP client for dynamo_tpu frontends.

Parity: reference ``lib/llm/src/http/client.rs`` (typed
chat/completions/models client with SSE streaming and aggregation) — the
piece early tests hand-rolled with raw aiohttp calls.

Responses parse into the same pydantic models the server serializes
(``protocols/openai.py``), so client code gets attribute access and
validation instead of dict spelunking:

    async with OpenAIClient("http://host:8080") as c:
        resp = await c.chat([{"role": "user", "content": "hi"}],
                            model="llama", max_tokens=32)
        async for chunk in c.chat_stream([...], model="llama"):
            ...
"""

from __future__ import annotations

import json
from typing import Any, AsyncIterator, Dict, List, Optional

import aiohttp

from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionResponse,
    CompletionResponse,
    EmbeddingResponse,
    ModelList,
)


class HttpClientError(RuntimeError):
    """Non-2xx response; carries status and the server's error body."""

    def __init__(self, status: int, body: Any):
        self.status = status
        self.body = body
        message = body
        if isinstance(body, dict):
            message = (body.get("error") or {}).get("message", body)
        super().__init__(f"HTTP {status}: {message}")


class OpenAIClient:
    """Async typed client over one frontend base URL."""

    def __init__(self, base_url: str,
                 timeout: Optional[float] = 300.0):
        self.base = base_url.rstrip("/")
        self._timeout = aiohttp.ClientTimeout(total=timeout)
        self._session: Optional[aiohttp.ClientSession] = None

    async def __aenter__(self) -> "OpenAIClient":
        self._session = aiohttp.ClientSession(timeout=self._timeout)
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    def _s(self) -> aiohttp.ClientSession:
        if self._session is None:
            self._session = aiohttp.ClientSession(timeout=self._timeout)
        return self._session

    async def _post_json(self, path: str, body: Dict[str, Any]) -> Any:
        async with self._s().post(self.base + path, json=body) as r:
            payload = await r.json(content_type=None)
            if r.status // 100 != 2:
                raise HttpClientError(r.status, payload)
            return payload

    # -- surfaces ----------------------------------------------------------

    async def models(self) -> ModelList:
        async with self._s().get(self.base + "/v1/models") as r:
            payload = await r.json(content_type=None)
            if r.status // 100 != 2:
                raise HttpClientError(r.status, payload)
            return ModelList.model_validate(payload)

    async def health(self) -> Dict[str, Any]:
        async with self._s().get(self.base + "/health") as r:
            return await r.json(content_type=None)

    async def chat(self, messages: List[Dict[str, Any]], *, model: str,
                   **params) -> ChatCompletionResponse:
        body = {"model": model, "messages": messages, "stream": False,
                **params}
        return ChatCompletionResponse.model_validate(
            await self._post_json("/v1/chat/completions", body))

    async def chat_stream(self, messages: List[Dict[str, Any]], *,
                          model: str, **params
                          ) -> AsyncIterator[ChatCompletionChunk]:
        body = {"model": model, "messages": messages, "stream": True,
                **params}
        async with self._s().post(self.base + "/v1/chat/completions",
                                  json=body) as r:
            if r.status // 100 != 2:
                raise HttpClientError(r.status,
                                      await r.json(content_type=None))
            async for data in _sse_data(r):
                yield ChatCompletionChunk.model_validate(data)

    async def completion(self, prompt: str, *, model: str,
                         **params) -> CompletionResponse:
        body = {"model": model, "prompt": prompt, "stream": False, **params}
        return CompletionResponse.model_validate(
            await self._post_json("/v1/completions", body))

    async def completion_stream(self, prompt: str, *, model: str, **params
                                ) -> AsyncIterator[CompletionResponse]:
        body = {"model": model, "prompt": prompt, "stream": True, **params}
        async with self._s().post(self.base + "/v1/completions",
                                  json=body) as r:
            if r.status // 100 != 2:
                raise HttpClientError(r.status,
                                      await r.json(content_type=None))
            async for data in _sse_data(r):
                yield CompletionResponse.model_validate(data)

    async def embeddings(self, inputs, *, model: str,
                         **params) -> EmbeddingResponse:
        body = {"model": model, "input": inputs, **params}
        return EmbeddingResponse.model_validate(
            await self._post_json("/v1/embeddings", body))


async def _sse_data(resp: aiohttp.ClientResponse) -> AsyncIterator[Any]:
    """Decode `data:` SSE lines until [DONE]; surfaces in-stream errors."""
    async for raw in resp.content:
        line = raw.decode("utf-8", errors="replace").strip()
        if not line.startswith("data:"):
            continue
        payload = line[5:].strip()
        if payload == "[DONE]":
            return
        data = json.loads(payload)
        if isinstance(data, dict) and "error" in data:
            raise HttpClientError(resp.status, data)
        yield data


__all__ = ["OpenAIClient", "HttpClientError"]
