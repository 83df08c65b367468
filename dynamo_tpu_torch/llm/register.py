"""Worker-side model registration and engine serving.

Parity: reference ``register_llm`` (bindings ``rust/lib.rs:133-178``) +
``LocalModel.attach`` (``local_model.rs:220+``): build the MDC, publish the
ModelEntry into the coordinator KV under the worker's lease, and serve the
engine's ``generate`` endpoint.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.engine.base import EngineBase
from dynamo_tpu_torch.model_card import ModelDeploymentCard, ModelEntry
from dynamo_tpu_torch.protocols.common import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.runtime.component import Endpoint, ServedEndpoint
from dynamo_tpu_torch.runtime.coordinator import replay_registry
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

logger = logging.getLogger(__name__)


def engine_handler(engine: EngineBase,
                   resume_admission: Optional[Any] = None) -> Callable:
    """Bridge an EngineBase into an RPC endpoint handler (dict payloads).

    Deadline enforcement: a request that arrives already expired is refused
    before it touches the scheduler, and one that expires mid-generation is
    cancelled between frames — either way the worker stops generating tokens
    nobody is waiting for (the caller's ``ResponseStream`` raised
    ``DeadlineExceededError`` at the same deadline).

    Tracing: each request opens a hop span from the inbound RPC trace
    context; the engine's first-frame timing stamps become queue/prefill
    spans, the tail a decode span, and every span of this worker's fragment
    (including adopted disagg sub-hops) ships back to the caller on the
    final frame (``trace_spans``) so the frontend's flight recorder holds
    one stitched tree.  Admission outcomes feed the worker-side counters
    (``dynamo_worker_requests_total``).

    Migration: an inbound resume token (``kv_transfer_params["migration"]``
    on a migration re-issue from the frontend) is handed to
    ``resume_admission`` (``worker/drain.ResumeAdmission``), which pulls
    the draining worker's pinned KV so admission resumes instead of
    recomputing; without one the token is stripped and the request replays.
    An OUTBOUND migration frame (this engine is draining) is relayed with
    this worker's trace fragment attached and the stream is ended through
    the failover path (``StreamMigrationSignal`` -> ``drop``), so the
    frontend's MigrationOperator fires immediately."""

    async def handler(payload: Any, ctx) -> AsyncIterator[Any]:
        from dynamo_tpu_torch.engine.loop import MIGRATION_KEY, migration_token
        from dynamo_tpu_torch.protocols.common import FinishReason
        from dynamo_tpu_torch.runtime.rpc import StreamMigrationSignal
        from dynamo_tpu_torch.utils.tracing import (
            SPANS_FRAME_KEY, StageStitcher, get_tracer)
        from dynamo_tpu_torch.worker.metrics import get_worker_metrics
        tracer = get_tracer()
        metrics = get_worker_metrics()
        request = PreprocessedRequest.from_dict(payload)
        # same dict guard migration_token() applies to frames: a
        # malformed token is stripped-and-replayed, never forwarded
        inbound_resume = (request.kv_transfer_params or {}).get(
            MIGRATION_KEY)
        if not isinstance(inbound_resume, dict):
            inbound_resume = None if inbound_resume is None else {}
        hop = tracer.start_hop(
            "worker.generate",
            headers=getattr(ctx, "headers", None),
            attrs={"request_id": request.request_id,
                   "endpoint": getattr(ctx, "endpoint", ""),
                   "prompt_tokens": len(request.token_ids)})
        if request.migration_attempt:
            mode = ("resume" if (inbound_resume or {}).get("blocks")
                    else "replay")
            metrics.migration_replays.labels(mode).inc()
            hop.set_attr("migration_attempt", request.migration_attempt)
            hop.set_attr("migration_mode", mode)
            if request.resumed_tokens:
                hop.set_attr("resumed_tokens", request.resumed_tokens)
        if ctx is not None and getattr(ctx, "deadline_expired", False):
            logger.warning("request %s arrived with its deadline already "
                           "expired; dropping", request.request_id)
            metrics.requests_total.labels("refused_expired").inc()
            hop.set_error("request deadline expired before admission")
            final = LLMEngineOutput(
                error="request deadline expired before admission",
                finish_reason=FinishReason.ERROR).to_dict()
            final[SPANS_FRAME_KEY] = tracer.finish_hop(hop)
            yield final
            return
        if inbound_resume is not None:
            # consume the token NOW: downstream (engine, disagg handler)
            # must never mistake it for a prefill-first KV handoff. Runs
            # AFTER the deadline refusal — an already-expired migrated
            # request must not trigger a pointless cross-worker KV pull —
            # and skips the pull when THIS engine is draining too
            # (rolling restart overlap): generate() is about to bounce
            # the request with a replay marker anyway
            request.kv_transfer_params = None
            draining = (getattr(engine, "draining", False)
                        or getattr(getattr(engine, "engine", None),
                                   "draining", False))
            if resume_admission is not None and not draining:
                await resume_admission.admit(request, inbound_resume,
                                             span=hop)
        metrics.requests_total.labels("admitted").inc()
        stitcher = StageStitcher(tracer, parent=hop,
                                 skip_decode=request.prefill_only)
        try:
            async for out in engine.generate(request, ctx):
                stitcher.on_frame(out)
                if (ctx is not None
                        and getattr(ctx, "deadline_expired", False)
                        and out.finish_reason is None):
                    # nobody is waiting for this stream anymore: release the
                    # scheduler slot (cooperative cancel; closing the
                    # generator also runs engine.generate's finally ->
                    # scheduler.cancel)
                    logger.warning("request %s exceeded its deadline "
                                   "mid-generation; cancelling",
                                   request.request_id)
                    ctx.cancel()
                    metrics.requests_total.labels("deadline_cancelled").inc()
                    hop.set_error("request deadline exceeded mid-generation")
                    stitcher.close()
                    # explicit error frame, not a bare return: if the
                    # worker's clock runs ahead of the caller's, the
                    # caller's own deadline hasn't tripped yet — a clean
                    # ``final`` would surface as a 200 with silently
                    # truncated output
                    final = LLMEngineOutput(
                        error="request deadline exceeded mid-generation",
                        finish_reason=FinishReason.ERROR).to_dict()
                    final[SPANS_FRAME_KEY] = tracer.finish_hop(hop)
                    yield final
                    return
                if (out.finish_reason is None
                        and migration_token(out) is not None):
                    # this engine is draining: ship the resume token as the
                    # stream's last data frame (with this worker's trace
                    # fragment, so the handoff is attributable), then end
                    # the stream through the failover path — the caller's
                    # MigrationOperator resumes it on a survivor
                    stitcher.close()
                    hop.set_attr("migrated_out", True)
                    final = out.to_dict()
                    final[SPANS_FRAME_KEY] = tracer.finish_hop(hop)
                    yield final
                    raise StreamMigrationSignal(request.request_id)
                if out.finish_reason is not None:
                    if out.error:
                        metrics.requests_total.labels("error").inc()
                        hop.set_error(out.error)
                    elif request.prefill_only and out.kv_transfer_params:
                        # disagg prefill leg: pin the advertised blocks
                        # under a TTL'd export lease so they can neither be
                        # evicted before the decode side pulls them nor
                        # stay pinned forever if that decoder crashes —
                        # the puller acks via the kv_export endpoint
                        from dynamo_tpu_torch.engine.transfer import (
                            stamp_export_lease)
                        await stamp_export_lease(
                            engine, out.kv_transfer_params, span=hop)
                    stitcher.close()
                    final = out.to_dict()
                    final[SPANS_FRAME_KEY] = tracer.finish_hop(hop)
                    yield final
                    return
                yield out.to_dict()
        finally:
            # caller cancelled / connection dropped mid-stream: the
            # fragment still lands in THIS worker's flight recorder (kept
            # by the always-keep-errored rule) even though nothing ships
            if not hop.finished:
                stitcher.close()
                hop.set_error("stream closed before completion")
                hop.finish()

    return handler


async def serve_engine(endpoint: Endpoint, engine: EngineBase,
                       stats_provider: Optional[Callable[[], Any]] = None,
                       resume_admission: Optional[Any] = None
                       ) -> ServedEndpoint:
    """Serve an engine's generate loop on a runtime endpoint."""
    await engine.start()
    return await endpoint.serve(engine_handler(engine, resume_admission),
                                stats_provider=stats_provider)


AUX_ENDPOINT = "aux"


def aux_handler(engine: EngineBase):
    """One-shot auxiliary ops next to the generate plane: embeddings and
    prompt scoring (echo + logprobs). Unary request/response over the
    same RPC plane — this is what lets DISTRIBUTED frontends serve
    /v1/embeddings and completions echo, not just in-process pipelines."""

    async def handler(payload, ctx):
        op = (payload or {}).get("op")
        token_lists = (payload or {}).get("token_lists") or []
        try:
            if op == "embed" and hasattr(engine, "embed"):
                vectors = await engine.embed(token_lists)
                yield {"vectors": [[float(x) for x in row]
                                   for row in vectors]}
                return
            if op == "score" and hasattr(engine, "score"):
                outs = await engine.score(token_lists)
                yield {"scores": [
                    {"lps": [float(x) for x in lps],
                     "top_ids": [[int(i) for i in r] for r in tids],
                     "top_lps": [[float(x) for x in r] for r in tlps]}
                    for lps, tids, tlps in outs]}
                return
        except ValueError as e:
            # typed: the frontend maps "value" to a 400-class error and
            # anything else to 501 — never by matching message text
            yield {"error": str(e), "kind": "value"}
            return
        except NotImplementedError as e:
            yield {"error": str(e), "kind": "unsupported"}
            return
        yield {"error": f"unsupported aux op {op!r}", "kind": "unsupported"}

    return handler


async def serve_aux(component, engine: EngineBase) -> ServedEndpoint:
    """Serve the aux plane on a component (alongside ``generate``)."""
    return await component.endpoint(AUX_ENDPOINT).serve(aux_handler(engine))


def _model_replay(coord) -> dict:
    """name -> (entry, lease) this process registered: register_llm can run
    more than once (model reload/replace, repeated test registrations on a
    shared client), so the shared registry replaces instead of accumulating
    superseded cards."""
    async def _republish(reg: dict) -> None:
        for name, (entry, lease) in list(reg.items()):
            # a restarted (possibly state-wiped) coordinator re-learns the
            # card under the CURRENT primary lease id — which the resync may
            # just have re-granted, moving the entry to a new
            # models/{name}/{lease:x} key (frontends absorb the churn
            # through their models/ watch)
            await coord.put(entry.key(lease.lease_id), entry.to_json(),
                            lease_id=lease.lease_id)
            logger.info("re-published model %s after coordinator resync",
                        name)

    return replay_registry(coord, "_model_replay", dict, _republish)


async def register_llm(drt: DistributedRuntime, endpoint: Endpoint,
                       card: ModelDeploymentCard,
                       model_type: str = "chat") -> ModelEntry:
    """Publish the model registration so frontends can discover it.

    The entry is written under the worker's primary lease: if the worker dies,
    the registration vanishes with the lease and frontends drop the model.
    """
    entry = ModelEntry(
        name=card.name, namespace=endpoint.namespace,
        component=endpoint.component, endpoint=endpoint.name,
        model_type=model_type, card=card)
    lease = await drt.primary_lease()
    await drt.coord.put(entry.key(lease.lease_id), entry.to_json(),
                        lease_id=lease.lease_id)
    _model_replay(drt.coord)[card.name] = (entry, lease)
    logger.info("registered model %s at %s", card.name, endpoint.path)
    return entry


__all__ = ["register_llm", "serve_engine", "engine_handler"]
