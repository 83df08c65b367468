"""OpenAI-compatible HTTP service (aiohttp).

Parity: reference ``lib/llm/src/http/service/`` (axum): ``/v1/chat/completions``,
``/v1/completions``, ``/v1/models``, ``/health``, ``/live``, ``/metrics``,
``/clear_kv_blocks``; SSE streaming with client-disconnect detection; stream
aggregation for non-streaming requests; per-request Prometheus metrics.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time
from typing import Any, Dict, List, Optional

from aiohttp import web
from pydantic import ValidationError

from dynamo_tpu_torch.http.metrics import FrontendMetrics, RequestTimer
from dynamo_tpu_torch.llm.model_manager import ModelManager
from dynamo_tpu_torch.protocols import sse
from dynamo_tpu_torch.protocols.common import FinishReason
from dynamo_tpu_torch.runtime.rpc import DeadlineExceededError
from dynamo_tpu_torch.runtime.system_server import (
    trace_get_response,
    trace_list_response,
)
from dynamo_tpu_torch.utils.tracing import get_tracer
from dynamo_tpu_torch.protocols.openai import (
    ChatChoice,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatMessage,
    ChoiceLogprobs,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    ModelInfo,
    ModelList,
    Usage,
    new_request_id,
    now_unix,
)

logger = logging.getLogger(__name__)

# upper bound on the OpenAI `n` parameter (choices per request): each
# choice is an independent engine generation — unbounded n would be a
# one-request DoS on scheduler admission
MAX_CHOICES = 16


def _legacy_logprobs(entries: List[dict], offset_start: int = 0):
    """Chat-style logprob entries -> the legacy completions logprobs object
    (tokens / token_logprobs / top_logprobs / text_offset). Returns the
    object and the next character offset (streaming keeps it cumulative)."""
    out = {"tokens": [], "token_logprobs": [], "top_logprobs": [],
           "text_offset": []}
    off = offset_start
    for e in entries:
        out["tokens"].append(e["token"])
        out["token_logprobs"].append(e["logprob"])
        out["top_logprobs"].append(
            {t["token"]: t["logprob"]
             for t in e.get("top_logprobs", [])} or None)
        out["text_offset"].append(off)
        off += len(e["token"])
    return out, off


def _merge_choice_usage(usage: "Usage", u: "Usage", i: int) -> None:
    """Fold one choice's usage into the request total: prompt tokens count
    ONCE, completion tokens sum, and prompt-caching details come from
    CHOICE 0 only — later concurrent choices hit the prefix cache choice 0
    just populated, which would claim a cold prompt was served cached."""
    usage.prompt_tokens = u.prompt_tokens
    usage.completion_tokens += u.completion_tokens
    if i == 0 and u.prompt_tokens_details is not None:
        usage.prompt_tokens_details = u.prompt_tokens_details


def _error(status: int, message: str, etype: str = "invalid_request_error") -> web.Response:
    return web.json_response(
        {"error": {"message": message, "type": etype, "code": status}},
        status=status)


async def _sse_error(resp: web.StreamResponse, exc: Exception,
                     err_type: str) -> None:
    """Terminal SSE error event + [DONE] — once streaming has begun the 200
    status line is already on the wire, so errors ride the event stream."""
    await resp.write(sse.encode_data(
        {"error": {"message": str(exc), "type": err_type}}))
    await resp.write(sse.encode_done())


class HttpService:
    """The frontend HTTP server; routes into a ModelManager's pipelines."""

    def __init__(self, manager: ModelManager, host: str = "0.0.0.0",
                 port: int = 8080, metrics: Optional[FrontendMetrics] = None,
                 request_timeout_s: float = 0.0,
                 max_inflight: int = 0, max_model_inflight: int = 0,
                 shed_retry_after_s: float = 1.0,
                 slo_ttft_s: float = 0.0, slo_itl_s: float = 0.0):
        self.manager = manager
        self.host = host
        self.port = port
        self.metrics = metrics or FrontendMetrics(
            slo_ttft_s=slo_ttft_s, slo_itl_s=slo_itl_s)
        # SLO targets apply to a caller-supplied FrontendMetrics too —
        # the service flags are authoritative when set
        if slo_ttft_s > 0:
            self.metrics.slo_ttft_s = float(slo_ttft_s)
        if slo_itl_s > 0:
            self.metrics.slo_itl_s = float(slo_itl_s)
        # request-lifecycle robustness knobs (see utils/config.RuntimeConfig):
        # default end-to-end deadline (0 = none) and overload high-water
        # marks (0 = unlimited) for total / per-model concurrent requests
        self.request_timeout_s = request_timeout_s
        self.max_inflight = max_inflight
        self.max_model_inflight = max_model_inflight
        self.shed_retry_after_s = shed_retry_after_s
        self._inflight_total = 0
        self._inflight_by_model: Dict[str, int] = {}
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.router.add_post("/v1/chat/completions", self.handle_chat)
        self.app.router.add_post("/v1/responses", self.handle_responses)
        self.app.router.add_post("/v1/completions", self.handle_completions)
        self.app.router.add_post("/v1/embeddings", self.handle_embeddings)
        self.app.router.add_get("/v1/models", self.handle_models)
        self.app.router.add_get("/health", self.handle_health)
        self.app.router.add_get("/live", self.handle_live)
        self.app.router.add_get("/healthz", self.handle_live)
        self.app.router.add_get("/healthz/ready", self.handle_ready)
        self.app.router.add_get("/metrics", self.handle_metrics)
        self.app.router.add_get("/v1/traces", self.handle_traces)
        self.app.router.add_get("/v1/traces/{trace_id}", self.handle_trace)
        self.app.router.add_post("/clear_kv_blocks", self.handle_clear_kv)
        self._runner: Optional[web.AppRunner] = None
        self._clear_kv_hook = None  # async () -> dict
        # the process's CoordClient (attach_coord): /healthz/ready turns
        # 503 while its supervised connection is down, so load balancers
        # drain traffic away from a control-plane outage
        self._coord = None
        # the process tracer: every request opens a root span here; the
        # flight recorder behind /v1/traces and the per-stage histogram
        # (metrics.stage) both hang off it
        self.tracer = get_tracer()
        if not self.tracer.service:
            self.tracer.service = "frontend"

    async def start(self) -> "HttpService":
        self.metrics.stage.attach(self.tracer)
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            self.port = self._runner.addresses[0][1]
        logger.info("http service on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        self.metrics.stage.detach(self.tracer)
        if self._runner is not None:
            await self._runner.cleanup()

    # -- handlers ----------------------------------------------------------

    async def handle_health(self, request: web.Request) -> web.Response:
        return web.json_response({
            "status": "healthy" if self.manager.names() else "no_models",
            "models": self.manager.names()})

    async def handle_live(self, request: web.Request) -> web.Response:
        return web.json_response({"live": True})

    def attach_coord(self, coord) -> "object":
        """Wire the process's ``CoordClient`` into this service: its
        connection health gates ``GET /healthz/ready`` and its supervision
        counters join /metrics (``dynamo_coord_*``).  Returns the metrics
        collector for symmetry with ``FrontendMetrics.attach_coord``."""
        self._coord = coord
        return self.metrics.attach_coord(coord)

    async def handle_ready(self, request: web.Request) -> web.Response:
        """Readiness (vs. /healthz liveness, always 200): 503 while the
        coordinator connection is down — discovery is frozen, so new
        requests would only pile onto stale routing state."""
        from dynamo_tpu_torch.runtime.system_server import coord_ready_reasons
        reasons = coord_ready_reasons(self._coord)
        if not self.manager.names():
            reasons.append("no models registered")
        ready = not reasons
        return web.json_response(
            {"ready": ready, "reasons": reasons,
             "models": self.manager.names()},
            status=200 if ready else 503)

    async def handle_metrics(self, request: web.Request) -> web.Response:
        return web.Response(body=self.metrics.render(),
                            content_type="text/plain", charset="utf-8")

    async def handle_models(self, request: web.Request) -> web.Response:
        models = ModelList(data=[
            ModelInfo(id=name, created=now_unix()) for name in self.manager.names()])
        return web.json_response(models.model_dump())

    async def handle_traces(self, request: web.Request) -> web.Response:
        return trace_list_response(self.tracer, request)

    async def handle_trace(self, request: web.Request) -> web.Response:
        return trace_get_response(self.tracer,
                                  request.match_info["trace_id"])

    async def handle_clear_kv(self, request: web.Request) -> web.Response:
        if self._clear_kv_hook is None:
            return web.json_response({"cleared": []})
        return web.json_response(await self._clear_kv_hook())

    def set_clear_kv_hook(self, hook) -> None:
        self._clear_kv_hook = hook

    @staticmethod
    def _stamp_rid(resp: web.StreamResponse,
                   request_id: str) -> web.StreamResponse:
        """X-Request-Id on an unprepared response (streamed responses set
        it in their constructor headers — after ``prepare`` it's too
        late)."""
        if not resp.prepared:
            resp.headers["X-Request-Id"] = request_id
        return resp

    # -- overload shedding + deadlines -------------------------------------

    def _shed_or_admit(self, model: str,
                       endpoint: str) -> Optional[web.Response]:
        """Admission control: returns a 503 + Retry-After response when a
        high-water mark is hit, else admits (callers MUST pair with
        ``_release`` in a finally).  Shed requests are counted in
        ``dynamo_frontend_requests_shed_total``."""
        if self.max_inflight and self._inflight_total >= self.max_inflight:
            reason = "inflight_high_water"
        elif (self.max_model_inflight
              and self._inflight_by_model.get(model, 0)
              >= self.max_model_inflight):
            reason = "model_inflight_high_water"
        else:
            self._inflight_total += 1
            self._inflight_by_model[model] = \
                self._inflight_by_model.get(model, 0) + 1
            return None
        self.metrics.shed_total.labels(model, endpoint, reason).inc()
        self.metrics.requests_total.labels(model, endpoint, "503").inc()
        # a shed request is an SLO miss for goodput accounting — the
        # client got a 503 instead of tokens
        self.metrics.record_slo_shed()
        resp = _error(503, "server overloaded; retry later", "overloaded")
        resp.headers["Retry-After"] = str(
            max(1, math.ceil(self.shed_retry_after_s)))
        return resp

    def _release(self, model: str) -> None:
        self._inflight_total = max(0, self._inflight_total - 1)
        n = self._inflight_by_model.get(model, 0) - 1
        if n <= 0:
            self._inflight_by_model.pop(model, None)
        else:
            self._inflight_by_model[model] = n

    def _resolve_deadline(self, http_req: web.Request,
                          nvext=None) -> Optional[float]:
        """Absolute unix deadline for a request: per-request override
        (``nvext.timeout_s``, then the ``X-Request-Timeout`` header, seconds)
        falling back to the configured service default; None = no deadline.
        Raises ValueError (-> 400) on a malformed or non-positive override."""
        timeout: Optional[float] = None
        if nvext is not None and getattr(nvext, "timeout_s", None) is not None:
            timeout = float(nvext.timeout_s)
        else:
            hdr = http_req.headers.get("X-Request-Timeout")
            if hdr is not None:
                try:
                    timeout = float(hdr)
                except ValueError:
                    raise ValueError(
                        f"invalid X-Request-Timeout header: {hdr!r}") from None
        if timeout is not None and (not math.isfinite(timeout)
                                    or timeout <= 0):
            # JSON NaN/Infinity parse fine and would defeat the deadline
            raise ValueError("request timeout must be positive and finite")
        if timeout is None:
            timeout = self.request_timeout_s
        if not timeout or timeout <= 0:
            return None
        return time.time() + timeout

    async def handle_embeddings(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.protocols.openai import (
            EmbeddingData, EmbeddingRequest, EmbeddingResponse)
        try:
            req = EmbeddingRequest.model_validate(await request.json())
        except (ValidationError, json.JSONDecodeError, UnicodeDecodeError) as e:
            return _error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return _error(404, f"model {req.model!r} not found")
        if req.dimensions is not None and req.dimensions <= 0:
            # before the forward pass — an invalid ask must not pay for
            # the model compute it then discards
            return _error(400, "dimensions must be positive")
        shed = self._shed_or_admit(req.model, "embeddings")
        if shed is not None:
            return shed
        request_id = new_request_id("embd")
        try:
            vectors, prompt_tokens = await pipeline.generate_embeddings(req)
        except NotImplementedError as e:
            return self._stamp_rid(_error(501, str(e)), request_id)
        except Exception as e:  # noqa: BLE001
            logger.exception("embeddings failed")
            return self._stamp_rid(_error(500, str(e), "internal_error"),
                                   request_id)
        finally:
            self._release(req.model)
        if req.dimensions is not None and vectors:
            if req.dimensions > len(vectors[0]):
                return self._stamp_rid(_error(
                    400, f"dimensions={req.dimensions} exceeds the "
                         f"model's embedding width {len(vectors[0])}"),
                    request_id)
            # OpenAI-style dimensionality reduction: truncate (vectors are
            # mean-pooled hidden states, not unit-norm — no renormalize)
            vectors = [v[:req.dimensions] for v in vectors]
        if req.encoding_format == "base64":
            # the official openai client requests base64 BY DEFAULT and
            # decodes little-endian float32 bytes
            import base64

            import numpy as _np
            vectors = [base64.b64encode(
                _np.asarray(v, _np.dtype("<f4")).tobytes()).decode()
                for v in vectors]
        resp = EmbeddingResponse(
            data=[EmbeddingData(index=i, embedding=v)
                  for i, v in enumerate(vectors)],
            model=req.model,
            usage=Usage(prompt_tokens=prompt_tokens,
                        total_tokens=prompt_tokens))
        return self._stamp_rid(
            web.json_response(resp.model_dump(exclude_none=True)),
            request_id)

    async def handle_chat(self, request: web.Request) -> web.StreamResponse:
        try:
            req = ChatCompletionRequest.model_validate(await request.json())
        except (ValidationError, json.JSONDecodeError, UnicodeDecodeError) as e:
            return _error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return _error(404, f"model {req.model!r} not found", "model_not_found")
        if not 1 <= req.n <= MAX_CHOICES:
            return _error(400, f"n must be between 1 and {MAX_CHOICES}")
        try:
            deadline = self._resolve_deadline(request, req.nvext)
        except ValueError as e:
            return _error(400, str(e))
        shed = self._shed_or_admit(req.model, "chat")
        if shed is not None:
            return shed
        # the frontend mints the request id ONCE: it rides every RPC hop's
        # headers (so worker logs/counters see the same id), names the root
        # trace span, and returns to the client as X-Request-Id
        request_id = new_request_id()
        timer = RequestTimer(self.metrics, req.model, "chat")
        root = self.tracer.start_trace("http_request", attrs={
            "request_id": request_id, "model": req.model,
            "endpoint": "chat"})
        try:
            if req.stream:
                return await self._stream_chat(request, req, pipeline,
                                               request_id, timer, deadline)
            return self._stamp_rid(await self._aggregate_chat(
                req, pipeline, request_id, timer, deadline), request_id)
        except ValueError as e:
            timer.done("400")
            root.set_error(str(e))
            return self._stamp_rid(_error(400, str(e)), request_id)
        except DeadlineExceededError as e:
            timer.done("504")
            root.set_error(str(e))
            return self._stamp_rid(_error(504, str(e), "deadline_exceeded"),
                                   request_id)
        except ConnectionResetError:
            timer.done("499")  # client went away mid-write
            root.set_error("client disconnected")
            raise
        except ConnectionError as e:
            timer.done("503")
            root.set_error(str(e))
            return self._stamp_rid(
                _error(503, str(e), "service_unavailable"), request_id)
        except asyncio.CancelledError:
            timer.done("499")
            root.set_error("cancelled")
            raise
        except Exception as e:
            logger.exception("chat handler error")
            timer.done("500")
            root.set_error(str(e))
            return self._stamp_rid(_error(500, str(e), "internal_error"),
                                   request_id)
        finally:
            self._release(req.model)
            root.finish()

    async def _stream_chat(self, http_req: web.Request,
                           req: ChatCompletionRequest, pipeline,
                           request_id: str, timer: RequestTimer,
                           deadline: Optional[float] = None
                           ) -> web.StreamResponse:
        # preprocess before preparing the response so validation errors can
        # still produce a clean HTTP 400
        preprocessed, delta = pipeline.prepare_chat(req, request_id,
                                                    deadline_unix=deadline)
        annotation_only = pipeline.resolve_annotations(preprocessed)
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
            "X-Request-Id": request_id})
        await resp.prepare(http_req)
        if annotation_only:
            # e.g. query_instance_id: answer with the annotation events and
            # no generation (parity: reference annotation short-circuit)
            for name, value in preprocessed.annotations_payload.items():
                await resp.write(sse.SseEvent(
                    event=name,
                    data=json.dumps(value, separators=(",", ":"))).encode())
            await resp.write(sse.encode_done())
            timer.done("200", prompt_tokens=len(preprocessed.token_ids))
            await resp.write_eof()
            return resp
        status = "200"
        include_usage = bool(req.stream_options and req.stream_options.include_usage)
        if max(1, req.n or 1) > 1:
            return await self._stream_chat_multi(
                resp, req, pipeline, request_id, timer,
                (preprocessed, delta), include_usage, deadline)
        gen = pipeline.run_chat(preprocessed, delta)
        emitted_tokens = 0
        try:
            # requested annotations (formatted_prompt, token_ids, ...) ride as
            # named SSE events ahead of the deltas (parity: nvext annotations)
            for name, value in preprocessed.annotations_payload.items():
                await resp.write(sse.SseEvent(
                    event=name,
                    data=json.dumps(value, separators=(",", ":"))).encode())
            # tool-call extraction needs the COMPLETE message, which only
            # exists when the finish chunk arrives — so with tools active
            # the finish chunk (and anything after it, e.g. the usage
            # chunk) is HELD, and flushed at stream end with its
            # finish_reason rewritten to "tool_calls" + the parsed
            # delta.tool_calls when the text parses as calls. The client
            # sees exactly one finish_reason, agreeing with the aggregated
            # path; text deltas stream untouched either way.
            match_tools = bool(req.tools) and req.tool_choice != "none"
            stream_text: List[str] = []
            held: List[dict] = []
            async for chunk in gen:
                if chunk.usage is not None and not chunk.choices:
                    if not include_usage:
                        continue  # client didn't opt into the usage chunk
                if match_tools:
                    for choice in chunk.choices:
                        if choice.delta.content:
                            stream_text.append(choice.delta.content)
                # token accounting from the delta generator's counter (a chunk
                # may carry text from several tokens; chunks != tokens)
                timer.on_token(delta.completion_tokens - emitted_tokens)
                emitted_tokens = delta.completion_tokens
                payload = chunk.model_dump(exclude_none=True)
                if match_tools and (held or any(
                        c.finish_reason for c in chunk.choices)):
                    held.append(payload)
                    continue
                await resp.write(sse.encode_data(payload))
            if match_tools:
                from dynamo_tpu_torch.preprocessor.tools import parse_tool_calls
                calls = parse_tool_calls("".join(stream_text),
                                         req.tool_choice or "auto")
                if calls and held:
                    for choice in held[0].get("choices", []):
                        if choice.get("finish_reason"):
                            choice["finish_reason"] = "tool_calls"
                            choice.setdefault("delta", {})["tool_calls"] = \
                                calls
                for payload in held:
                    await resp.write(sse.encode_data(payload))
            await resp.write(sse.encode_done())
        except (ConnectionResetError, asyncio.CancelledError):
            # client disconnected: stop generating (parity: disconnect.rs)
            status = "499"
            raise
        except DeadlineExceededError as e:
            # mid-stream deadline: a clean typed SSE error, no migration
            # replay (the router never saw a connection-shaped failure)
            status = "504"
            await _sse_error(resp, e, "deadline_exceeded")
        except Exception as e:
            logger.exception("stream error for %s", request_id)
            status = "500"
            await _sse_error(resp, e, "internal_error")
        finally:
            await gen.aclose()
            timer.done(status)
            if status not in ("200",):
                sp = self.tracer.current_span()
                if sp is not None:
                    sp.set_error(f"stream ended with status {status}")
        await resp.write_eof()
        return resp

    async def _stream_chat_multi(self, resp, req, pipeline,
                                 request_id: str, timer: RequestTimer,
                                 first_prepared, include_usage: bool,
                                 deadline: Optional[float] = None):
        """n > 1 streaming: the n choice generators run concurrently and
        their chunks interleave on one SSE stream, each rewritten to its
        choice index (standard OpenAI multi-choice streaming). Tool-call
        extraction is n==1-only (the single-finish-chunk rewrite does not
        compose with interleaved choices); tool-JSON streams as text here.
        Per-choice usage chunks aggregate into ONE final usage chunk."""
        n = req.n
        pairs = [first_prepared] + [
            self._prepare_choice(req, pipeline, request_id, i, deadline)
            for i in range(1, n)]
        # requested annotations ride ahead of the deltas, same as n == 1
        for name, value in first_prepared[0].annotations_payload.items():
            await resp.write(sse.SseEvent(
                event=name,
                data=json.dumps(value, separators=(",", ":"))).encode())
        # bounded: the pumps await put() when the client reads slowly, so
        # generation paces to the SSE write rate instead of accumulating
        # chunks without backpressure (as the n==1 path's implicit
        # pacing does). 8 chunks/choice of slack keeps the choices
        # interleaving without coupling their schedulers.
        queue: asyncio.Queue = asyncio.Queue(maxsize=8 * n)

        async def pump(i, pre, d):
            gen = pipeline.run_chat(pre, d)
            try:
                try:
                    async for chunk in gen:
                        await queue.put((i, chunk))
                finally:
                    await gen.aclose()
                await queue.put((i, None))
            except asyncio.CancelledError:
                # the consumer cancelled us (client gone): it will never
                # get() again, so a sentinel put on the now-bounded queue
                # could block forever — skip it and exit cancelled
                raise
            except Exception as e:  # noqa: BLE001 — surface per stream
                await queue.put((i, e))

        tasks = [asyncio.create_task(pump(i, pre, d))
                 for i, (pre, d) in enumerate(pairs)]
        status = "200"
        usage = Usage()
        emitted = [0] * n
        try:
            live = n
            while live:
                i, chunk = await queue.get()
                if chunk is None:
                    live -= 1
                    continue
                if isinstance(chunk, Exception):
                    raise chunk
                if chunk.usage is not None and not chunk.choices:
                    _merge_choice_usage(usage, chunk.usage, i)
                    continue
                # token accounting from stream i's delta counter (a chunk
                # may carry several tokens; chunks != tokens)
                d = pairs[i][1]
                timer.on_token(d.completion_tokens - emitted[i])
                emitted[i] = d.completion_tokens
                payload = chunk.model_dump(exclude_none=True)
                payload["id"] = request_id
                for c in payload.get("choices", []):
                    c["index"] = i
                await resp.write(sse.encode_data(payload))
            if include_usage:
                usage.total_tokens = (usage.prompt_tokens
                                      + usage.completion_tokens)
                await resp.write(sse.encode_data({
                    "id": request_id, "object": "chat.completion.chunk",
                    "created": now_unix(), "model": req.model,
                    "choices": [],
                    "usage": usage.model_dump(exclude_none=True)}))
            await resp.write(sse.encode_done())
        except (ConnectionResetError, asyncio.CancelledError):
            status = "499"
            raise
        except DeadlineExceededError as e:
            status = "504"
            await _sse_error(resp, e, "deadline_exceeded")
        except Exception as e:  # noqa: BLE001
            logger.exception("multi-choice stream error for %s", request_id)
            status = "500"
            await _sse_error(resp, e, "internal_error")
        finally:
            for t in tasks:
                t.cancel()
            timer.done(status)
        await resp.write_eof()
        return resp

    @staticmethod
    def _choice_identity(request_id: str, seed, index: int):
        """(rid, seed) for choice ``index`` of an n-way request — ONE
        convention for chat and legacy completions: distinct engine
        request ids keep the n generations independent, and a seeded
        request offsets the seed per choice so choices differ while each
        remains reproducible."""
        rid = request_id if index == 0 else f"{request_id}-c{index}"
        return rid, (seed + index if seed is not None and index else seed)

    def _prepare_choice(self, req, pipeline, request_id: str, index: int,
                        deadline: Optional[float] = None):
        """(preprocessed, delta) for choice ``index`` of an n-way chat."""
        rid, seed = self._choice_identity(request_id, req.seed, index)
        preprocessed, delta = pipeline.prepare_chat(req, rid,
                                                    deadline_unix=deadline)
        preprocessed.sampling_options.seed = seed
        return preprocessed, delta

    async def _collect_chat(self, req: ChatCompletionRequest, pipeline,
                            request_id: str, timer: RequestTimer,
                            prepared=None, deadline: Optional[float] = None):
        """Drain the chunk stream; returns (text, finish_reason,
        lp_entries, usage) — shared by the aggregated chat response and
        the /v1/responses bridge."""
        text_parts: List[str] = []
        lp_entries: List[dict] = []
        finish_reason: Optional[str] = None
        usage = Usage()
        preprocessed, delta = (prepared if prepared is not None
                               else pipeline.prepare_chat(
                                   req, request_id, deadline_unix=deadline))
        gen = pipeline.run_chat(preprocessed, delta)
        emitted_tokens = 0
        try:
            async for chunk in gen:
                for choice in chunk.choices:
                    if choice.delta.content:
                        text_parts.append(choice.delta.content)
                    if choice.logprobs and choice.logprobs.content:
                        lp_entries.extend(choice.logprobs.content)
                    if choice.finish_reason:
                        finish_reason = choice.finish_reason
                if chunk.usage is not None:
                    usage = chunk.usage
                timer.on_token(delta.completion_tokens - emitted_tokens)
                emitted_tokens = delta.completion_tokens
        finally:
            await gen.aclose()
        return "".join(text_parts), finish_reason, lp_entries, usage

    async def _aggregate_chat(self, req: ChatCompletionRequest, pipeline,
                              request_id: str, timer: RequestTimer,
                              deadline: Optional[float] = None
                              ) -> web.Response:
        """Aggregate the chunk stream into one response (parity:
        ``protocols/openai/chat_completions/aggregator.rs``); ``n > 1``
        runs the choices CONCURRENTLY (the engine batches them like any
        other traffic, sharing the prompt via the prefix cache)."""
        n = max(1, req.n or 1)
        tasks = [asyncio.create_task(
            self._collect_chat(req, pipeline, request_id, timer,
                               prepared=self._prepare_choice(
                                   req, pipeline, request_id, i, deadline)))
            for i in range(n)]
        try:
            results = await asyncio.gather(*tasks)
        except BaseException:
            # one choice failed: stop the surviving generations instead of
            # letting them decode to max_tokens for a response nobody gets
            for t in tasks:
                t.cancel()
            raise
        choices = []
        usage = Usage()
        for i, (text, finish_reason, lp_entries, u) in enumerate(results):
            tool_calls: Optional[List[dict]] = None
            if req.tools:
                # tool-call extraction on the aggregated message (parity:
                # ToolCallingMatcher in the reference aggregator,
                # lib/llm/src/preprocessor/tools.rs)
                from dynamo_tpu_torch.preprocessor.tools import parse_tool_calls
                calls = parse_tool_calls(text, req.tool_choice or "auto")
                if calls:
                    tool_calls = calls
            choices.append(ChatChoice(
                index=i,
                message=ChatMessage(
                    role="assistant",
                    content=None if tool_calls else text,
                    tool_calls=tool_calls),
                finish_reason=("tool_calls" if tool_calls
                               else finish_reason or "stop"),
                logprobs=(ChoiceLogprobs(content=lp_entries)
                          if lp_entries else None)))
            _merge_choice_usage(usage, u, i)
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        body = ChatCompletionResponse(
            id=request_id, created=now_unix(), model=req.model,
            choices=choices, usage=usage)
        timer.done("200", usage.prompt_tokens)
        return web.json_response(body.model_dump(exclude_none=True))

    # fields the /v1/responses bridge does not implement: their presence
    # gets a 501 instead of silently changed semantics (parity:
    # validate_response_unsupported_fields, lib/llm/src/protocols/openai/
    # validate.rs)
    _RESPONSES_UNSUPPORTED = (
        "previous_response_id", "tools", "tool_choice", "reasoning",
        "store", "truncation", "include", "parallel_tool_calls",
        "background")

    async def handle_responses(self, request: web.Request) -> web.Response:
        """OpenAI Responses API, bridged through chat completions (parity:
        ``handler_responses``, ``lib/llm/src/http/service/openai.rs:583`` —
        text-only input, converted to a one-user-message chat request,
        aggregated, and shaped back into a Response object)."""
        try:
            raw = await request.json()
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return _error(400, f"invalid request: {e}")
        if not isinstance(raw, dict):
            return _error(400, "invalid request: expected an object")
        bad = [k for k in self._RESPONSES_UNSUPPORTED
               if raw.get(k) not in (None, [], {}, False)]
        if bad:
            return _error(501, f"unsupported field(s): {', '.join(bad)}",
                          "not_implemented")
        if raw.get("stream"):
            return _error(501, "streaming responses are not implemented",
                          "not_implemented")
        if not isinstance(raw.get("input"), str):
            return _error(501, "only text input is supported",
                          "not_implemented")
        model = raw.get("model") or ""
        pipeline = self.manager.get(model)
        if pipeline is None:
            return _error(404, f"model {model!r} not found",
                          "model_not_found")
        messages = []
        if isinstance(raw.get("instructions"), str) and raw["instructions"]:
            # Responses API system prompt -> chat system message
            messages.append({"role": "system",
                             "content": raw["instructions"]})
        messages.append({"role": "user", "content": raw["input"]})
        # Responses API structured outputs: text.format carries the schema
        # INLINE ({"type": "json_schema", "schema": ..., "name": ...});
        # map to the chat response_format shape the engine understands
        response_format = None
        text_cfg = raw.get("text")
        if text_cfg not in (None, {}):
            if not isinstance(text_cfg, dict):
                return _error(400, "text must be an object")
            unknown = set(text_cfg) - {"format"}
            if unknown:
                return _error(
                    501, f"unsupported text field(s): {sorted(unknown)}",
                    "not_implemented")
            fmt = text_cfg.get("format") or {}
            if not isinstance(fmt, dict):
                return _error(400, "text.format must be an object")
            kind = fmt.get("type")
            if kind in (None, "text"):
                pass
            elif kind == "json_object":
                response_format = {"type": "json_object"}
            elif kind == "json_schema":
                response_format = {
                    "type": "json_schema",
                    "json_schema": {"name": fmt.get("name", "schema"),
                                    "schema": fmt.get("schema")}}
            else:
                return _error(400,
                              f"unsupported text.format type {kind!r}")
        try:
            chat = ChatCompletionRequest(
                model=model,
                messages=messages,
                temperature=raw.get("temperature"),
                top_p=raw.get("top_p"),
                max_tokens=raw.get("max_output_tokens"),
                response_format=response_format,
            )
        except ValidationError as e:
            return _error(400, f"invalid request: {e}")
        try:
            deadline = self._resolve_deadline(request)
        except ValueError as e:
            return _error(400, str(e))
        shed = self._shed_or_admit(model, "responses")
        if shed is not None:
            return shed
        request_id = new_request_id("resp")
        timer = RequestTimer(self.metrics, model, "responses")
        root = self.tracer.start_trace("http_request", attrs={
            "request_id": request_id, "model": model,
            "endpoint": "responses"})
        try:
            text, _finish, _lps, usage = await self._collect_chat(
                chat, pipeline, request_id, timer, deadline=deadline)
        except ValueError as e:  # same mapping as handle_chat
            timer.done("400")
            root.set_error(str(e))
            return self._stamp_rid(_error(400, str(e)), request_id)
        except DeadlineExceededError as e:
            timer.done("504")
            root.set_error(str(e))
            return self._stamp_rid(_error(504, str(e), "deadline_exceeded"),
                                   request_id)
        except ConnectionError as e:
            timer.done("503")
            root.set_error(str(e))
            return self._stamp_rid(
                _error(503, str(e), "service_unavailable"), request_id)
        except Exception as e:  # noqa: BLE001 — surface as API error
            timer.done("500")
            root.set_error(str(e))
            logger.exception("responses request %s failed", request_id)
            return self._stamp_rid(_error(500, str(e), "internal_error"),
                                   request_id)
        finally:
            self._release(model)
            root.finish()
        timer.done("200", usage.prompt_tokens)
        return self._stamp_rid(web.json_response({
            "id": request_id,
            "object": "response",
            "created_at": now_unix(),
            "model": model,
            "status": "completed",
            "output": [{
                "type": "message",
                "id": new_request_id("msg"),
                "role": "assistant",
                "status": "completed",
                "content": [{"type": "output_text", "text": text,
                             "annotations": []}],
            }],
            "usage": {"input_tokens": usage.prompt_tokens,
                      "output_tokens": usage.completion_tokens,
                      "total_tokens": usage.total_tokens,
                      # Responses-API prompt-caching surface
                      "input_tokens_details": {
                          "cached_tokens": (usage.prompt_tokens_details
                                            or {}).get("cached_tokens", 0)}},
        }), request_id)

    async def handle_completions(self, request: web.Request) -> web.StreamResponse:
        try:
            req = CompletionRequest.model_validate(await request.json())
        except (ValidationError, json.JSONDecodeError, UnicodeDecodeError) as e:
            return _error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return _error(404, f"model {req.model!r} not found", "model_not_found")
        if not 1 <= req.n <= MAX_CHOICES:
            return _error(400, f"n must be between 1 and {MAX_CHOICES}")
        n = req.n
        if req.stream and n > 1:
            return _error(501, "streaming with n > 1 is not implemented "
                          "for legacy completions", "not_implemented")
        try:
            deadline = self._resolve_deadline(request, req.nvext)
        except ValueError as e:
            return _error(400, str(e))
        shed = self._shed_or_admit(req.model, "completions")
        if shed is not None:
            return shed
        request_id = new_request_id("cmpl")
        timer = RequestTimer(self.metrics, req.model, "completions")
        root = self.tracer.start_trace("http_request", attrs={
            "request_id": request_id, "model": req.model,
            "endpoint": "completions"})
        try:
            # echo: return the prompt (and, with logprobs, per-prompt-token
            # logprobs — the lm-eval loglikelihood surface) ahead of any
            # generated text. Scoring is a one-shot dense forward
            # (engine.score); max_tokens=0 makes the request pure scoring.
            # Inside the try so every early exit closes the request timer
            # and unexpected failures map like any other handler error.
            echo_text, echo_entries, echo_ids = "", None, None
            if req.echo:
                if req.stream:
                    timer.done("501")
                    return _error(501, "echo with streaming is not "
                                  "implemented", "not_implemented")
                p = req.prompt
                if (isinstance(p, list) and p
                        and isinstance(p[0], (str, list))):
                    if len(p) > 1:
                        timer.done("501")
                        return _error(501, "echo with multiple prompts is "
                                      "not implemented", "not_implemented")
                    p = p[0]
                    # the generation half must see the SAME unwrapped
                    # prompt (preprocess rejects list prompts)
                    req = req.model_copy(update={"prompt": p})
                tok = pipeline.preprocessor.tokenizer
                echo_ids = list(p) if isinstance(p, list) else tok.encode(p)
                if not echo_ids:
                    raise ValueError("echo needs a non-empty prompt")
                ds = tok.decode_stream(skip_special_tokens=False)
                pieces = [ds.step(int(t)) for t in echo_ids]
                echo_text = "".join(pieces)
                if req.logprobs is not None:
                    try:
                        lps, tids, tlps = await pipeline.score_prompt(
                            echo_ids)
                    except NotImplementedError as e:
                        timer.done("501")
                        return _error(501, str(e), "not_implemented")
                    echo_entries = []
                    # alternatives per position: up to min(requested N,
                    # the engine's num_top_logprobs) — the same cap the
                    # generation path advertises via the model card
                    n_top = min(req.logprobs, tids.shape[1])
                    for j, piece in enumerate(pieces):
                        e = {"token": piece,
                             "logprob": None if j == 0 else float(lps[j]),
                             "top_logprobs": []}
                        if j > 0 and n_top > 0:
                            e["top_logprobs"] = [
                                {"token": tok.decode(
                                    [int(tids[j, k])],
                                    skip_special_tokens=False),
                                 "logprob": float(tlps[j, k])}
                                for k in range(n_top)]
                        echo_entries.append(e)
            if req.stream:
                return await self._stream_completion(request, req, pipeline,
                                                     request_id, timer,
                                                     deadline)

            async def one_choice(i: int):
                rid, seed = self._choice_identity(request_id, req.seed, i)
                req_i = (req if i == 0
                         else req.model_copy(update={"seed": seed}))
                text_parts: List[str] = []
                lp_entries: List[dict] = []
                finish = None
                u = Usage()
                gen = pipeline.generate_completion(req_i, rid,
                                                   deadline_unix=deadline)
                try:
                    async for out in gen:
                        if out.error:
                            raise RuntimeError(out.error)
                        if out.text:
                            text_parts.append(out.text)
                            timer.on_token(len(out.token_ids) or 1)
                        if out.logprobs_content:
                            lp_entries.extend(out.logprobs_content)
                        if out.finish_reason is not None:
                            finish = out.finish_reason.to_openai()
                            u = Usage(
                                prompt_tokens=out.prompt_tokens or 0,
                                completion_tokens=out.completion_tokens or 0,
                                total_tokens=(out.prompt_tokens or 0)
                                + (out.completion_tokens or 0),
                                prompt_tokens_details=(
                                    {"cached_tokens": out.cached_tokens}
                                    if out.cached_tokens is not None
                                    else None))
                finally:
                    await gen.aclose()
                return "".join(text_parts), finish, lp_entries, u

            if req.echo and req.max_tokens == 0:
                # pure scoring: no generation at all. Only an EXPLICIT 0 —
                # a JSON null means "the default", like the non-echo path
                u0 = Usage(prompt_tokens=len(echo_ids),
                           total_tokens=len(echo_ids))
                results = [("", "length", [], u0) for _ in range(n)]
            else:
                tasks = [asyncio.create_task(one_choice(i))
                         for i in range(n)]
                try:
                    results = await asyncio.gather(*tasks)
                except BaseException:
                    for t in tasks:
                        t.cancel()
                    raise
            usage = Usage()
            choices = []
            for i, (text, finish, lp_entries, u) in enumerate(results):
                if req.echo:
                    text = echo_text + text
                    if echo_entries is not None:
                        lp_entries = echo_entries + lp_entries
                choices.append(CompletionChoice(
                    index=i, text=text,
                    finish_reason=finish or "stop",
                    logprobs=(_legacy_logprobs(lp_entries)[0]
                              if lp_entries else None)))
                _merge_choice_usage(usage, u, i)
            usage.total_tokens = (usage.prompt_tokens
                                  + usage.completion_tokens)
            body = CompletionResponse(
                id=request_id, created=now_unix(), model=req.model,
                choices=choices, usage=usage)
            timer.done("200", usage.prompt_tokens)
            return self._stamp_rid(
                web.json_response(body.model_dump(exclude_none=True)),
                request_id)
        except ValueError as e:
            timer.done("400")
            root.set_error(str(e))
            return self._stamp_rid(_error(400, str(e)), request_id)
        except DeadlineExceededError as e:
            timer.done("504")
            root.set_error(str(e))
            return self._stamp_rid(_error(504, str(e), "deadline_exceeded"),
                                   request_id)
        except ConnectionResetError:
            timer.done("499")
            root.set_error("client disconnected")
            raise
        except ConnectionError as e:
            timer.done("503")
            root.set_error(str(e))
            return self._stamp_rid(
                _error(503, str(e), "service_unavailable"), request_id)
        except asyncio.CancelledError:
            timer.done("499")
            root.set_error("cancelled")
            raise
        except Exception as e:
            logger.exception("completions handler error")
            timer.done("500")
            root.set_error(str(e))
            return self._stamp_rid(_error(500, str(e), "internal_error"),
                                   request_id)
        finally:
            self._release(req.model)
            root.finish()

    async def _stream_completion(self, http_req: web.Request,
                                 req: CompletionRequest, pipeline,
                                 request_id: str, timer: RequestTimer,
                                 deadline: Optional[float] = None
                                 ) -> web.StreamResponse:
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Request-Id": request_id})
        await resp.prepare(http_req)
        status = "200"
        created = now_unix()
        gen = pipeline.generate_completion(req, request_id,
                                           deadline_unix=deadline)
        lp_offset = 0
        try:
            async for out in gen:
                if out.error:
                    raise RuntimeError(out.error)
                # logprobs_content gates emission too: a frame may carry
                # token logprobs whose text is still held by the decoder
                if out.text or out.logprobs_content or (
                        out.finish_reason is not None):
                    timer.on_token(len(out.token_ids) or (1 if out.text else 0))
                    lp_obj = None
                    if out.logprobs_content:
                        lp_obj, lp_offset = _legacy_logprobs(
                            out.logprobs_content, lp_offset)
                    chunk = CompletionResponse(
                        id=request_id, created=created, model=req.model,
                        choices=[CompletionChoice(
                            text=out.text or "",
                            finish_reason=(out.finish_reason.to_openai()
                                           if out.finish_reason else None),
                            logprobs=lp_obj)])
                    await resp.write(sse.encode_data(
                        chunk.model_dump(exclude_none=True)))
            await resp.write(sse.encode_done())
        except (ConnectionResetError, asyncio.CancelledError):
            status = "499"
            raise
        except DeadlineExceededError as e:
            status = "504"
            await _sse_error(resp, e, "deadline_exceeded")
        except Exception as e:
            logger.exception("completion stream error for %s", request_id)
            status = "500"
            await _sse_error(resp, e, "internal_error")
        finally:
            await gen.aclose()
            timer.done(status)
        await resp.write_eof()
        return resp


__all__ = ["HttpService"]
