"""Composable pipeline operators over engine-frame streams.

Parity: the reference's generic pipeline graph — ``ServiceFrontend`` /
``Operator`` (forward+backward edges) / ``ServiceBackend`` linked with
``.link()`` (``lib/runtime/src/pipeline/nodes.rs``, ``context.rs``) — whose
only in-tree production instance is the Migration operator sitting between
the preprocessor and the router (``migration.rs``). Here the same
composability is expressed the Python way:

- a **Source** is ``async fn(request) -> AsyncIterator[LLMEngineOutput]``
  (the sink at the end of a chain: a router hop, a local engine, a mock);
- an **Operator** wraps a downstream Source: it may rewrite the request,
  retry it, or transform/observe frames flowing back up;
- ``link(operators, sink)`` folds them into a single Source.

``ServicePipeline`` subclasses build their engine hop from these, so a
custom deployment can insert its own operators (rate limiting, frame
auditing, shadow traffic, ...) without forking the pipeline classes —
``ComposedPipeline`` takes any operator chain directly.
"""

from __future__ import annotations

import logging
from typing import AsyncIterator, Callable, List, Optional, Sequence

from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.rpc import StreamEndedError
from dynamo_tpu_torch.utils.tracing import (
    SPANS_FRAME_KEY,
    StageStitcher,
    get_tracer,
)

logger = logging.getLogger(__name__)

Source = Callable[[PreprocessedRequest], AsyncIterator[LLMEngineOutput]]


class Operator:
    """One pipeline stage: sees the request on the way down and every
    frame on the way back up."""

    def call(self, request: PreprocessedRequest,
             next_source: Source) -> AsyncIterator[LLMEngineOutput]:
        raise NotImplementedError


def link(operators: Sequence[Operator], sink: Source) -> Source:
    """Fold operators (outermost first) around the sink into one Source
    (the reference's ``.link()`` chain building,
    ``pipeline/nodes.rs``)."""
    source = sink
    for op in reversed(list(operators)):
        def bound(req, _op=op, _next=source):
            return _op.call(req, _next)
        source = bound
    return source


class MigrationOperator(Operator):
    """Retry-on-stream-drop with token continuation — and, when the
    dropped worker shipped a resume token, live resumption.

    On a mid-stream drop the request is rebuilt with the tokens generated
    so far appended and re-issued to the downstream source — the request
    migrates to another worker (reference ``migration.rs:38-131``; the
    drop signal is the missing ``final`` sentinel, surfaced as
    ``StreamEndedError``).

    A gracefully DRAINING worker ends each stream with a migration frame
    (``kv_transfer_params["migration"]``, never yielded downstream)
    carrying a resume token: the committed KV block chain pinned under an
    export lease plus the sampling budgets already consumed. The rebuild
    then attaches the token, so the survivor pulls the pinned pages and
    admits with the full prefix cached (``mode="resume"``) — from the
    client's point of view the stream just keeps emitting, with no
    recomputed prefill. A token whose ``tokens_done`` disagrees with what
    this operator actually yielded is discarded (safe replay beats a
    desynced resume)."""

    def __init__(self, migration_limit: int = 3):
        self.migration_limit = migration_limit

    async def call(self, request: PreprocessedRequest,
                   next_source: Source) -> AsyncIterator[LLMEngineOutput]:
        from dynamo_tpu_torch.engine.loop import migration_token

        generated: List[int] = []  # tokens already yielded downstream
        attempt = 0
        req = request
        resume = None  # resume token from a draining worker, if any
        while True:
            try:
                async for out in next_source(req):
                    tok = migration_token(out)
                    if tok is not None:
                        # internal frame: stash the token, never yield it —
                        # the stream is about to break through the
                        # failover path
                        resume = tok
                        continue
                    generated.extend(out.token_ids)
                    yield out
                    if out.finish_reason is not None:
                        return
                return  # clean final without an explicit finish frame
            except (StreamEndedError, ConnectionError) as e:
                attempt += 1
                if attempt > self.migration_limit:
                    logger.error("request %s exhausted %d migrations: %s",
                                 request.request_id, self.migration_limit, e)
                    yield LLMEngineOutput(
                        error="stream ended before generation completed "
                              f"(after {attempt - 1} migrations)",
                        finish_reason=FinishReason.ERROR)
                    return
                if resume is not None and not resume.get("blocks"):
                    resume = None  # empty token = explicit replay marker
                if (resume is not None and
                        resume.get("tokens_done") != len(generated)):
                    # the worker froze a different stream state than the
                    # client saw — resume would desync; replay is safe
                    logger.warning(
                        "request %s resume token desynced (worker froze "
                        "%s tokens, client saw %d); replaying",
                        request.request_id, resume.get("tokens_done"),
                        len(generated))
                    resume = None
                if resume is not None:
                    # content-level cross-check on top of the count: the
                    # token carries the stream's generated tail — if it
                    # differs from what the client actually received, the
                    # pinned KV belongs to a different stream state
                    tail = (resume.get("sampling") or {}).get("stop_tail")
                    if tail and list(tail) != generated[-len(tail):]:
                        logger.warning(
                            "request %s resume token tail mismatch; "
                            "replaying", request.request_id)
                        resume = None
                mode = "resume" if resume is not None else "replay"
                req = self._rebuild(request, generated, attempt, resume)
                span = get_tracer().current_span()
                if span is not None:
                    # the migration keeps the SAME trace: the event marks
                    # where the first worker's spans stop and the
                    # survivor's begin, and whether the survivor resumes
                    # the pinned KV or replays from scratch
                    span.add_event("migration", attempt=attempt,
                                   tokens_done=len(generated),
                                   mode=mode,
                                   resumed_tokens=(len(generated)
                                                   if mode == "resume"
                                                   else 0),
                                   error=str(e))
                logger.warning(
                    "migrating request %s (attempt %d/%d, %d tokens done, "
                    "mode=%s)", request.request_id, attempt,
                    self.migration_limit, len(generated), mode)
                resume = None  # consumed; the next leg ships its own

    @staticmethod
    def _rebuild(original: PreprocessedRequest,
                 generated: List[int],
                 attempt: int = 0,
                 resume: Optional[dict] = None) -> PreprocessedRequest:
        req = PreprocessedRequest.from_dict(original.to_dict())
        req.token_ids = list(original.token_ids) + list(generated)
        # the receiving worker counts replays/resumes it absorbs
        # (dynamo_worker_migration_replays_total{mode})
        req.migration_attempt = attempt
        # a derived id per attempt: an engine that sees a reused
        # request_id refuses it, and a replay CAN land
        # back on the worker that still holds the original stream's state
        if original.request_id:
            req.request_id = f"{original.request_id}~m{attempt}"
        # the appended tail is generated output, not prompt: the engine
        # reconstructs penalty windows (and budget accounting) from this
        req.resumed_tokens = len(generated)
        sc = req.stop_conditions
        if sc.max_tokens is not None:
            sc.max_tokens = max(1, sc.max_tokens - len(generated))
        if sc.min_tokens is not None:
            # the survivor counts generated tokens from zero again
            sc.min_tokens = max(0, sc.min_tokens - len(generated))
        if resume is not None:
            from dynamo_tpu_torch.engine.loop import MIGRATION_KEY
            req.kv_transfer_params = {MIGRATION_KEY: dict(resume)}
        return req


def router_sink(router) -> Source:
    """Terminal source: one streamed hop through a PushRouter.

    The request deadline and frontend-minted request id ride the RPC ``req``
    frame headers (trace context is injected by the connection itself) so the
    worker can drop expired work and log under the same id; the returned
    ``ResponseStream`` enforces the deadline between frames
    (``DeadlineExceededError`` — which this sink does NOT translate, so the
    migration operator never replays expired requests).  Worker-shipped trace
    spans on the final frame are adopted into the local tracer so the
    frontend's flight recorder holds the stitched tree."""
    from dynamo_tpu_torch.runtime.rpc import request_headers

    async def source(request: PreprocessedRequest):
        tracer = get_tracer()
        async for payload in router.generate_stream(
                request.to_dict(),
                headers=request_headers(request.deadline_unix,
                                        request.request_id)):
            if isinstance(payload, dict) and SPANS_FRAME_KEY in payload:
                tracer.adopt(payload.pop(SPANS_FRAME_KEY))
            yield LLMEngineOutput.from_dict(payload)

    return source


def engine_sink(engine) -> Source:
    """Terminal source: a local in-process engine.  Stage spans
    (queue/prefill/decode) come from the engine's first-frame timing stamps,
    the same stitching the remote worker handler does — so the single-process
    server gets the identical per-stage breakdown."""

    async def source(request: PreprocessedRequest):
        stitcher = StageStitcher(get_tracer(),
                                 skip_decode=request.prefill_only)
        try:
            async for out in engine.generate(request):
                stitcher.on_frame(out)
                yield out
        finally:
            stitcher.close()

    return source


__all__ = ["Operator", "Source", "link", "MigrationOperator",
           "router_sink", "engine_sink"]
