"""Shared continuous-batching engine loop.

Everything between the scheduler and the caller-facing ``generate`` stream is
execution-agnostic: admission, the step loop, stop conditions, cancellation,
KV-event draining, metrics. ``ScheduledEngineBase`` owns all of that;
subclasses provide only ``_execute_plan`` — the actual compute for one step:

- ``TorchEngine`` (``torch_engine.py``): the model step in PyTorch, with
  hand-written CUDA attention kernels on the GPU.

This module is the port's own copy of ``dynamo_tpu/engine/loop.py``; its
imports and prose differ, and one behaviour: the loop's thread work
(steps, fetches, the exclusive lane) is tracked (``_to_thread``) and
``stop()`` waits for it, and no pool thread holds such a call's engine
after its result is out (``_CallOnce``). A cancelled loop leaves such a
call running in its thread, and a pool thread keeps its work item a
moment after the result; either held the engine, its cache and its
weights after ``stop()`` returned (the KVBM test that drops a stopped
tiered engine failed on a loaded host). An engine may also name the
executor those calls run on (``_step_executor``): a rank of a
multi-process world runs them all on one thread, which issues its
collectives in one order.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import (
    Any,
    AsyncIterator,
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Tuple,
)

import numpy as np

from dynamo_tpu_torch.engine.base import EngineBase
from dynamo_tpu_torch.engine.pages import PageAllocator
from dynamo_tpu_torch.engine.steptrace import get_step_recorder
from dynamo_tpu_torch.engine.scheduler import (
    DecodeBatch,
    MixedStepBatch,
    MultiStepBatch,
    Phase,
    PrefillBatch,
    Scheduler,
    SchedulerConfig,
    Sequence,
    SpecDecodeBatch,
    StepPlan,
)
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.protocols.events import ForwardPassMetrics, KvCacheEvent

logger = logging.getLogger(__name__)

# how long stop() waits for the loop's calls still running in threads
THREAD_STOP_TIMEOUT_S = 60.0


class _CallOnce:
    """``fn(*args)`` for an executor, which drops ``fn`` and ``args`` as it
    runs: a pool thread keeps its work item (this object) until after the
    result is delivered, and the loop's calls are bound methods of the
    engine, so a held item would keep the engine, its cache and its
    weights alive past ``stop()``."""

    __slots__ = ("fn", "args")

    def __init__(self, fn: Callable, args: tuple):
        self.fn, self.args = fn, args

    def __call__(self) -> Any:
        fn, args = self.fn, self.args
        self.fn = self.args = None
        return fn(*args)

# kv_transfer_params key carrying a stream's migration/resume token: a
# frame with this key is the LAST frame of a gracefully-drained stream.
# An empty token ({}) means "replay from scratch on a survivor"; a
# populated one carries the pinned-KV resume state (blocks under an
# export lease + sampling budgets) the survivor admits against.
MIGRATION_KEY = "migration"


def migration_token(out: "LLMEngineOutput") -> Optional[dict]:
    """The migration/resume token on a frame, or None for ordinary
    frames — the one place the frame shape is interpreted (engine loop,
    serving handler, and migration operator all key on it)."""
    if out.kv_transfer_params is None:
        return None
    tok = out.kv_transfer_params.get(MIGRATION_KEY)
    return tok if isinstance(tok, dict) else None


class ScheduledEngineBase(EngineBase):
    """Continuous batching over a PageAllocator; subclasses do the math."""

    def __init__(self, num_pages: int, page_size: int, max_num_seqs: int,
                 max_prefill_chunk: int, max_context: int,
                 max_prefill_seqs: int = 8,
                 ring_threshold: Optional[int] = None,
                 spec_tokens: int = 0, spec_ngram_max: int = 4,
                 spec_ngram_min: int = 2, spec_chain_break: int = 8,
                 decode_multistep: int = 1, mixed_batch: bool = True,
                 decode_progress_every: int = 2):
        if max_context % page_size:
            raise ValueError("max_context must be a multiple of page_size")
        self.max_context = max_context
        self.allocator = PageAllocator(num_pages, page_size)
        self.scheduler = Scheduler(self.allocator, SchedulerConfig(
            max_num_seqs=max_num_seqs, max_prefill_chunk=max_prefill_chunk,
            max_prefill_seqs=max_prefill_seqs,
            ring_threshold=ring_threshold,
            spec_tokens=spec_tokens, spec_ngram_max=spec_ngram_max,
            spec_ngram_min=spec_ngram_min,
            spec_chain_break=spec_chain_break,
            decode_multistep=decode_multistep, mixed_batch=mixed_batch,
            decode_progress_every=decode_progress_every))
        self.scheduler.max_context_hint = max_context
        self._queues: Dict[str, asyncio.Queue] = {}
        self._work = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        # the loop's calls running in threads (``_to_thread``)
        self._thread_work: set = set()
        # None: the default pool; an engine of a rank world sets a
        # single-thread executor, so every call that reaches a collective
        # runs on one thread in the order the loop issues it
        self._step_executor = None
        self._stopping = False
        self.kv_event_cb: Optional[Callable[[List[KvCacheEvent]], None]] = None
        # supervision: called when the engine loop DIES (exception — not a
        # clean stop()). A worker wires this to runtime shutdown so its
        # lease/registration vanish and routers stop sending traffic to a
        # zombie (reference: CriticalTaskExecutionHandle,
        # lib/runtime/src/utils/task.rs)
        self.on_loop_exit: Optional[Callable[[], None]] = None
        # multihost divergence detection: called with (step_id, ok) after
        # every step resolves; the fanout relays outcomes to followers so a
        # follower-local failure against a leader success is caught instead
        # of silently diverging KV state
        self.step_outcome_cb: Optional[Callable[[Optional[int], bool],
                                                None]] = None
        # work serialized with the step loop (KV transfers, offload/onboard):
        # drained between steps so nothing else ever touches pages/allocator
        # while a (pages-donating) jitted step is in flight
        self._exclusive: Deque[Tuple[Callable, tuple, asyncio.Future]] = deque()
        # graceful drain: once set, new requests are refused with a replay
        # marker (the router is already routing around this worker) and
        # ``drain_migrate`` freezes the in-flight ones. The loop itself
        # keeps running — it still serves the exclusive-window KV exports
        # survivors pull the frozen sequences' pinned pages through.
        # ``_drain_leases`` holds the lease ids the freeze granted, so the
        # drain controller waits on exactly those (not unrelated exports).
        self.draining = False
        self._drain_leases: List[int] = []
        # step flight recorder: every dispatch stamps one StepRecord into
        # the process-wide ring (engine/steptrace.py); subclasses report
        # their padded shapes via ``last_padded`` and first-call jit
        # compiles via ``drain_compile_events`` so both occupancy and
        # mid-run compiles are attributable from GET /v1/steptrace
        self.steptrace = get_step_recorder()
        self.last_padded: Optional[Tuple[int, int]] = None
        self._last_dispatch_end: Optional[float] = None

    # -- subclass hook -----------------------------------------------------

    def validate_request(self, request: PreprocessedRequest
                         ) -> Optional[str]:
        """Per-request admission check beyond size limits; subclasses
        return an error string to fail the request before it queues
        (the JAX engine rejects unsupported guided specs here)."""
        return None

    def _execute_plan(self, plan: StepPlan
                      ) -> Tuple[np.ndarray, np.ndarray, Optional[dict]]:
        """Run one step; returns (sampled_tokens, logprobs, extras) aligned
        with the plan (prefill: one entry per plan.chunks; decode: one entry
        per plan.seqs). ``extras`` optionally carries per-row top-K
        alternatives (``top_ids``/``top_lps`` [B, K]) for the OpenAI
        logprobs surface, or None. Runs in a worker thread — must not touch
        scheduler state."""
        raise NotImplementedError

    # Optional pipelined-decode hooks (the JAX engine implements; others
    # other subclasses leave pipelining off). dispatch_* return an opaque
    # on-device handle without blocking; fetch_packed blocks on it.
    supports_pipelining = False

    def dispatch_decode(self, plan):               # pragma: no cover - hook
        raise NotImplementedError

    def dispatch_chained(self, plan, prev_handle):  # pragma: no cover - hook
        raise NotImplementedError

    def fetch_packed(self, handle):                 # pragma: no cover - hook
        raise NotImplementedError

    # Optional FUSED decode hooks (both engines implement):
    # dispatch_multistep runs ``plan.width`` decode steps in one dispatch
    # (on-device sampling + stop checks) and returns an opaque handle;
    # ``prev_handle`` chains the block from the previous block's on-device
    # carry. fetch_packed_block blocks on a handle and returns
    # (sampled [B, w], logprobs [B, w], extras) aligned with plan.seqs.
    supports_multistep = False

    @property
    def multistep_unsupported_reason(self) -> Optional[str]:
        """Why ``supports_multistep`` is False on an engine whose config
        ASKED for fusion (spec/multihost — mesh sharding is NOT a reason:
        sharded engines run the fused block with explicit shardings), or
        None when it is off by configuration / actually supported — feeds
        the ``dynamo_worker_multistep_fallback_total{reason}`` counter."""
        return None

    def dispatch_multistep(self, plan, prev_handle=None):  # pragma: no cover
        raise NotImplementedError

    def fetch_packed_block(self, handle):           # pragma: no cover - hook
        raise NotImplementedError

    def drain_compile_events(self) -> List[dict]:
        """Buffered first-call jit-compile events since the last drain
        (``{"kind", "batch", "width", "seconds"}`` dicts). The jit engine
        overrides this; engines with no compile step have none."""
        return []

    # -- step flight recorder ----------------------------------------------

    def _stamp_dispatch(self, kind: str, plan, t_d0: float,
                        plan_ms: float = 0.0, fallback: str = "",
                        chained: bool = False):
        """Stamp one dispatch into the step ring: queue/pool pressure at
        plan time, real-vs-padded tokens (``last_padded`` from the
        subclass), the gap since the previous dispatch returned (host
        overhead between dispatches), and any compile events the engine
        buffered during this dispatch — those also land on every live
        request the step served (``Sequence.compile_ms``), so a mid-run
        compile shows up in the request's own trace. Returns the live
        ring record (or None when disabled)."""
        st = self.steptrace
        t_d1 = time.perf_counter()
        gap_ms = 0.0
        if self._last_dispatch_end is not None:
            gap_ms = max(0.0, (t_d0 - self._last_dispatch_end) * 1000.0)
        self._last_dispatch_end = t_d1
        seqs = getattr(plan, "seqs", ()) if plan is not None else ()
        rec = None
        if st.enabled:
            rows = len(seqs)
            width = getattr(plan, "width", 0) or 0
            if kind == "multistep":
                tokens_real = rows * width
            elif kind in ("prefill", "mixed"):
                chunks = getattr(plan, "chunks", ()) or ()
                dec = getattr(plan, "decode_seqs", ()) or ()
                rows = len(chunks) + len(dec)
                tokens_real = sum(c.length for c in chunks) + len(dec)
            elif kind == "spec":
                drafts = getattr(plan, "drafts", None)
                k = drafts.shape[1] if drafts is not None else 0
                tokens_real = rows * (k + 1)
            else:
                tokens_real = rows
            padded = self.last_padded
            if padded is not None:
                batch = padded[0]
                tokens_padded = padded[0] * padded[1]
            else:
                batch = rows
                tokens_padded = tokens_real
            mgr = getattr(self, "_export_leases", None)
            rec = st.record(
                kind, width=width, rows=rows, batch=batch,
                tokens_real=tokens_real, tokens_padded=tokens_padded,
                queue_depth=len(self.scheduler.waiting),
                running=len(self.scheduler.active),
                pool_free=self.allocator.num_free,
                pool_pinned=mgr.pinned_pages if mgr is not None else 0,
                plan_ms=plan_ms, dispatch_ms=(t_d1 - t_d0) * 1000.0,
                gap_ms=gap_ms, fallback=fallback, chained=chained)
        self.last_padded = None
        for ev in self.drain_compile_events():
            st.note_compile(ev.get("kind", kind), ev["seconds"], rec)
            for seq in seqs:
                seq.compile_ms += ev["seconds"] * 1000.0
                seq.compile_events += 1
        if plan is not None:
            plan._steprec = rec
        return rec

    def _consume_fallback(self) -> str:
        fb = getattr(self.scheduler, "last_fallback", "")
        self.scheduler.last_fallback = ""
        return fb

    # -- frame emission ----------------------------------------------------

    def _emit(self, seq: Sequence, out: LLMEngineOutput) -> None:
        if not seq.timings_sent and (out.token_ids
                                     or out.finish_reason is not None):
            # first content-bearing frame: ship the stage boundaries so the
            # serving layer can stitch queue/prefill/decode trace spans
            # (utils/tracing.StageStitcher) without reaching into the engine
            seq.timings_sent = True
            t = {"enqueued_unix": seq.enqueued_unix,
                 "first_unix": time.time()}
            if seq.admitted_unix is not None:
                t["admitted_unix"] = seq.admitted_unix
            if seq.cached_tokens:
                t["cached_tokens"] = float(seq.cached_tokens)
            if seq.compile_ms:
                # a jit compile stalled this request before first token
                # (cold bucket): ship-and-clear so a later decode-path
                # compile isn't double counted on the final frame
                t["compile_ms"] = seq.compile_ms
                t["compile_events"] = float(seq.compile_events)
                seq.compile_ms = 0.0
                seq.compile_events = 0
            if out.timings:
                # a final frame that is ALSO the first (1-token streams)
                # carries both the stage stamps and the decode counters
                t.update(out.timings)
            out.timings = t
        q = self._queues.get(seq.request.request_id)
        if q is not None:
            q.put_nowait(out)

    def _finish(self, seq: Sequence, reason: FinishReason,
                token: Optional[int] = None,
                logprob: Optional[float] = None,
                kv_transfer_params: Optional[dict] = None,
                top: Optional[Dict[int, float]] = None) -> None:
        self.scheduler.finish(seq)
        self.release_request(seq.request.request_id)
        out = LLMEngineOutput(
            token_ids=[token] if token is not None else [],
            log_probs=[logprob] if logprob is not None else None,
            top_logprobs=[top] if top is not None else None,
            finish_reason=reason,
            prompt_tokens=seq.num_prompt,
            completion_tokens=len(seq.generated),
            cached_tokens=seq.cached_tokens,
            kv_transfer_params=kv_transfer_params,
        )
        if seq.decode_dispatches:
            # decode-stage accounting for the tracing layer: how many
            # tokens the decode tail produced and how many jitted
            # dispatches they cost (a fused block is ONE dispatch) —
            # StageStitcher turns these into decode-span attrs
            out.timings = {"decode_steps": float(seq.decode_steps),
                           "decode_dispatches": float(seq.decode_dispatches)}
            if seq.multistep_fallbacks:
                # fused-path refusals that touched this sequence: the
                # decode span carries the count so a slow stream is
                # attributable to fallbacks without cross-referencing
                # the worker counter
                out.timings["multistep_fallbacks"] = float(
                    seq.multistep_fallbacks)
        if seq.compile_ms and seq.timings_sent:
            # compile landed AFTER the first frame (a cold decode/fused
            # bucket mid-stream): ride the final frame's timings — when
            # this IS the first frame _emit ships it instead
            if out.timings is None:
                out.timings = {}
            out.timings["compile_ms"] = seq.compile_ms
            out.timings["compile_events"] = float(seq.compile_events)
            seq.compile_ms = 0.0
            seq.compile_events = 0
        self._emit(seq, out)

    def release_request(self, request_id: str) -> None:
        """Per-request device-sampling state teardown hook. Called for
        every finished/cancelled sequence; the jit engine overrides it to
        drop the row's guided-FSM / penalty bookkeeping from the device
        sampling cache (its batch-composition key must change so the next
        block is not built over a dead row's slot). Base engines keep no
        such state."""

    def multistep_guided_check(self, seq: Sequence) -> None:
        """Cross-check hook after a fused block appended tokens to a
        GUIDED row. The jit engine overrides it to re-derive the row's
        automaton state on the host (a mirror walk over ``seq.generated``)
        and flag divergence from the device transition table. Base
        engines run guided rows per-step only — nothing to check."""

    def _accept_token(self, seq: Sequence, token: int, logprob: float,
                      top: Optional[Dict[int, float]] = None) -> None:
        """Append a sampled token and resolve stop conditions."""
        req = seq.request
        sc = req.stop_conditions
        seq.tokens.append(token)
        seq.generated.append(token)
        n = len(seq.generated)
        min_ok = sc.min_tokens is None or n >= sc.min_tokens
        if (not sc.ignore_eos and min_ok and token in req.eos_token_ids):
            self._finish(seq, FinishReason.EOS, token, logprob, top=top)
            return
        if min_ok and sc.stop_token_ids and token in sc.stop_token_ids:
            self._finish(seq, FinishReason.STOP, token, logprob, top=top)
            return
        max_new = sc.max_tokens if sc.max_tokens is not None else (
            self.max_context - seq.num_prompt)
        if n >= max_new or len(seq) >= self.max_context:
            self._finish(seq, FinishReason.LENGTH, token, logprob, top=top)
            return
        self._emit(seq, LLMEngineOutput(
            token_ids=[token], log_probs=[logprob],
            top_logprobs=[top] if top is not None else None))

    def _plan_spec_appends(self, seq: Sequence,
                           cand: List[Tuple[int, float, int]]
                           ) -> Tuple[List[Tuple[int, float, int]], int]:
        """Stop-aware truncation of one row's verify-step candidates
        (accepted drafts + the final sampled token, each tagged with its
        chunk slot for the logprobs surface), WITHOUT mutating the
        sequence: returns (tokens to append, count that are drafts).
        Mirrors ``_accept_token``'s stop checks exactly — the subsequent
        real appends re-derive the same conclusions from the same data;
        keep the two in sync."""
        sc = seq.request.stop_conditions
        req = seq.request
        n_gen, length = len(seq.generated), len(seq)
        max_new = sc.max_tokens if sc.max_tokens is not None else (
            self.max_context - seq.num_prompt)
        out: List[Tuple[int, float, int]] = []
        n_draft = 0
        for idx, (tok, lp, pos) in enumerate(cand):
            out.append((tok, lp, pos))
            if idx < len(cand) - 1:
                n_draft += 1
            n_gen += 1
            length += 1
            min_ok = sc.min_tokens is None or n_gen >= sc.min_tokens
            if ((not sc.ignore_eos and min_ok and tok in req.eos_token_ids)
                    or (min_ok and sc.stop_token_ids
                        and tok in sc.stop_token_ids)
                    or n_gen >= max_new or length >= self.max_context):
                break
        return out, n_draft

    def _process_spec(self, plan: SpecDecodeBatch, sampled: np.ndarray,
                      logprobs: np.ndarray, extras: dict) -> None:
        """Resolve one verify step: advance KV accounting over each row's
        accepted prefix, then append accepted drafts + the final token."""
        acc = extras["spec_acc"]
        dlps = extras["spec_lps"]
        top_ids = extras.get("spec_top_ids")    # [B, K+1, Ktop] or None

        def top_for(i: int, pos: int, seq: Sequence
                    ) -> Optional[Dict[int, float]]:
            # chunk slot `pos` predicts the token appended at candidate
            # index pos (drafts 0..a-1 at their own slots, the final
            # token at slot n_acc) — same OpenAI surface the plain step
            # packs, per position
            if top_ids is None or seq.request.sampling_options.logprobs \
                    is None:
                return None
            return {int(t): float(l) for t, l in
                    zip(top_ids[i, pos], extras["spec_top_lps"][i, pos])}

        advances: List[int] = []
        appends: List[Optional[List[Tuple[int, float, int]]]] = []
        for i, seq in enumerate(plan.seqs):
            if seq.phase is not Phase.RUNNING or seq.cancelled:
                # as the plain decode path: slot 0's KV (the real last
                # token) is computed; nothing is appended
                advances.append(1)
                appends.append(None)
                continue
            cand = [(int(plan.drafts[i, j]), float(dlps[i, j]), j)
                    for j in range(int(acc[i]))]
            cand.append((int(sampled[i]), float(logprobs[i]), int(acc[i])))
            toks, n_draft = self._plan_spec_appends(seq, cand)
            advances.append(1 + n_draft)
            appends.append(toks)
        self.scheduler.on_spec_done(
            plan, advances,
            accepted=[int(acc[i]) for i in range(len(plan.seqs))])
        for i, (seq, toks) in enumerate(zip(plan.seqs, appends)):
            if toks is None:
                if seq.cancelled and seq.phase is Phase.RUNNING:
                    self._finish(seq, FinishReason.CANCELLED)
                continue
            seq.decode_dispatches += 1
            for tok, lp, pos in toks:
                seq.decode_steps += 1
                self._accept_token(seq, tok, lp, top_for(i, pos, seq))
                if seq.phase is not Phase.RUNNING:
                    break
        self.scheduler.commit_spec(plan)
        events = self.allocator.drain_events()
        if events and self.kv_event_cb is not None:
            self.kv_event_cb(events)
        if self.step_outcome_cb is not None:
            self.step_outcome_cb(getattr(plan, "_step_id", None), True)

    def _process_multistep(self, plan: MultiStepBatch, sampled: np.ndarray,
                           logprobs: np.ndarray,
                           extras: Optional[dict] = None) -> None:
        """Resolve one fused block: re-derive each row's stop point from
        the SAME rules the device applied (``_plan_spec_appends`` mirrors
        ``_accept_token`` exactly), advance KV accounting over the written
        prefix, then stream the tokens out — one frame per token per row,
        so a token never waits on the rest of its block being processed."""
        top_ids = extras.get("top_ids") if extras else None  # [B, w, K]

        def top_for(i: int, j: int, seq: Sequence
                    ) -> Optional[Dict[int, float]]:
            if (top_ids is None
                    or seq.request.sampling_options.logprobs is None):
                return None
            return {int(t): float(l) for t, l in
                    zip(top_ids[i, j], extras["top_lps"][i, j])}

        advances: List[int] = []
        appends: List[Optional[List[Tuple[int, float, int]]]] = []
        for i, seq in enumerate(plan.seqs):
            if seq.phase is not Phase.RUNNING:
                # finished before this (chained) block ran: the device
                # carry had the row dead from block start — nothing written
                advances.append(0)
                appends.append(None)
                continue
            if seq.cancelled:
                # the device doesn't know about cancellation: it kept
                # writing, but only slot 0 (the fed real token) lands on a
                # position with a host-side token — later slots stay
                # uncommitted garbage (the on_multistep_done safety rule)
                advances.append(1)
                appends.append(None)
                continue
            cand = [(int(sampled[i, j]), float(logprobs[i, j]), j)
                    for j in range(plan.width)]
            toks, _ = self._plan_spec_appends(seq, cand)
            advances.append(len(toks))
            appends.append(toks)
        self.scheduler.on_multistep_done(plan, advances)
        for i, (seq, toks) in enumerate(zip(plan.seqs, appends)):
            if toks is None:
                if seq.cancelled and seq.phase is Phase.RUNNING:
                    self._finish(seq, FinishReason.CANCELLED)
                continue
            seq.decode_dispatches += 1
            for tok, lp, j in toks:
                seq.decode_steps += 1
                self._accept_token(seq, tok, lp, top_for(i, j, seq))
                if seq.phase is not Phase.RUNNING:
                    break
            if seq.request.sampling_options.guided:
                # host-side automaton walk over what the block actually
                # appended: catches device/host transition-table drift
                # before the next block samples from a wrong state
                self.multistep_guided_check(seq)
        self.scheduler.commit_block(plan)
        events = self.allocator.drain_events()
        if events and self.kv_event_cb is not None:
            self.kv_event_cb(events)
        if self.step_outcome_cb is not None:
            self.step_outcome_cb(getattr(plan, "_step_id", None), True)

    def _process(self, plan: StepPlan, sampled: np.ndarray,
                 logprobs: np.ndarray,
                 extras: Optional[dict] = None) -> None:
        if isinstance(plan, SpecDecodeBatch):
            self._process_spec(plan, sampled, logprobs, extras)
            return

        def top_for(i: int, seq: Sequence) -> Optional[Dict[int, float]]:
            # host dict building + per-token wire bytes only for requests
            # that asked (the device-side top-k is compiled in regardless)
            if extras is None or seq.request.sampling_options.logprobs is None:
                return None
            return {int(t): float(l) for t, l in
                    zip(extras["top_ids"][i], extras["top_lps"][i])}

        self.scheduler.on_step_done(plan)
        if isinstance(plan, (PrefillBatch, MixedStepBatch)):
            for i, chunk in enumerate(plan.chunks):
                seq = chunk.seq
                if seq.cancelled:
                    self._finish(seq, FinishReason.CANCELLED)
                elif chunk.is_last:
                    if seq.request.prefill_only:
                        # disagg prefill worker: one token, KV stays cached;
                        # the final frame advertises the transferable blocks
                        tok = int(sampled[i])
                        seq.tokens.append(tok)
                        seq.generated.append(tok)
                        blocks = seq.tokens.blocks[:seq.committed_pages]
                        params = {
                            "blocks": [[b.block_hash, b.local_hash,
                                        b.parent_hash if b.position else None]
                                       for b in blocks],
                            "page_size": self.allocator.page_size,
                            "num_tokens_cached": len(blocks)
                            * self.allocator.page_size,
                        }
                        self._finish(seq, FinishReason.LENGTH, tok,
                                     float(logprobs[i]),
                                     kv_transfer_params=params)
                    else:
                        self._accept_token(seq, int(sampled[i]),
                                           float(logprobs[i]),
                                           top_for(i, seq))
            # mixed step: the tail rows are decode rows riding the same
            # dispatch — resolve them with the plain decode semantics
            for j, seq in enumerate(getattr(plan, "decode_seqs", ()),
                                    start=len(plan.chunks)):
                if seq.phase is not Phase.RUNNING:
                    continue  # finished/preempted during this step
                if seq.cancelled:
                    self._finish(seq, FinishReason.CANCELLED)
                    continue
                seq.decode_dispatches += 1
                seq.decode_steps += 1
                self._accept_token(seq, int(sampled[j]), float(logprobs[j]),
                                   top_for(j, seq))
        else:
            for i, seq in enumerate(plan.seqs):
                if seq.phase is not Phase.RUNNING:
                    continue  # finished/preempted during this step
                if seq.cancelled:
                    self._finish(seq, FinishReason.CANCELLED)
                    continue
                seq.decode_dispatches += 1
                seq.decode_steps += 1
                self._accept_token(seq, int(sampled[i]), float(logprobs[i]),
                                   top_for(i, seq))
        # always drain (unbounded growth otherwise); publish if anyone listens
        events = self.allocator.drain_events()
        if events and self.kv_event_cb is not None:
            self.kv_event_cb(events)
        if self.step_outcome_cb is not None:
            self.step_outcome_cb(getattr(plan, "_step_id", None), True)

    # -- serialized out-of-band work ---------------------------------------

    async def run_exclusive(self, fn: Callable, *args) -> Any:
        """Run ``fn(*args)`` in a worker thread, serialized with the step
        loop: no jitted step is in flight while ``fn`` runs, and the loop
        doesn't dispatch the next step until it returns.

        Required for anything that reads or reassigns ``engine.pages`` or
        mutates allocator state from outside the loop (KV block
        export/inject, tier offload/onboard) — ``pages`` is donated through
        every step, so a concurrent step would invalidate the buffer
        mid-read or clobber the write.
        """
        await self.start()
        if self._loop_task is not None and self._loop_task.done():
            raise RuntimeError("engine loop is dead")
        fut = asyncio.get_running_loop().create_future()
        self._exclusive.append((fn, args, fut))
        self._work.set()
        return await fut

    async def _drain_exclusive(self) -> None:
        while self._exclusive:
            fn, args, fut = self._exclusive.popleft()
            if fut.done():
                continue
            t_d0 = time.perf_counter()
            try:
                res = await self._to_thread(fn, *args)
            except asyncio.CancelledError:
                # loop task cancelled mid-drain (stop()): the item is already
                # popped, so fail its future here or the caller hangs forever
                if not fut.done():
                    fut.set_exception(RuntimeError("engine stopped"))
                raise
            except Exception as e:  # noqa: BLE001 — relay to the caller
                if not fut.done():
                    fut.set_exception(e)
            else:
                if not fut.done():
                    fut.set_result(res)
            # exclusive-window work (KV export gathers, tier offload,
            # drain freezes) shows up on the step timeline as its own
            # kind, so a stalled KV pull is visible as the gap's cause
            self._stamp_dispatch("gather", None, t_d0)

    # -- the engine loop ---------------------------------------------------

    def _drain_reaped(self) -> None:
        for seq in self.scheduler.drain_reaped():
            self._emit(seq, LLMEngineOutput(finish_reason=FinishReason.CANCELLED,
                                            prompt_tokens=seq.num_prompt,
                                            completion_tokens=len(seq.generated)))

    async def _loop(self) -> None:
        try:
            await self._loop_body()
        except BaseException as e:
            if not self._stopping:
                # the loop is dead: every in-flight and queued request
                # would otherwise hang forever on a queue nobody fills —
                # fail them all NOW (found live: a host-side bookkeeping
                # bug froze every open stream with zero signal)
                logger.exception("engine loop died")
                self._fail_all_requests(e)
                if self.on_loop_exit is not None:
                    try:
                        self.on_loop_exit()
                    except Exception:
                        logger.exception("on_loop_exit hook failed")
            raise
        finally:
            # whether stopped or crashed, nobody will drain the queue again —
            # fail pending exclusive work so callers don't hang forever
            self._fail_exclusive("engine loop exited")

    def _fail_all_requests(self, e: BaseException) -> None:
        """Terminate every active and waiting stream with an ERROR frame."""
        err = f"engine loop died: {e}"
        for seq in list(self.scheduler.active.values()):
            try:
                self.scheduler.finish(seq)
            except Exception:  # noqa: BLE001 — emit the frame regardless
                logger.exception("finish during loop-death cleanup failed")
            self._emit(seq, LLMEngineOutput(
                finish_reason=FinishReason.ERROR, error=err))
        while self.scheduler.waiting:
            seq = self.scheduler.waiting.popleft()
            self._emit(seq, LLMEngineOutput(
                finish_reason=FinishReason.ERROR, error=err))
        self._drain_reaped()

    def _fail_exclusive(self, reason: str) -> None:
        while self._exclusive:
            _fn, _args, fut = self._exclusive.popleft()
            if not fut.done():
                fut.set_exception(RuntimeError(reason))

    def _fail_plan(self, plan: StepPlan, e: BaseException) -> None:
        logger.exception("engine step failed")
        for seq in plan.seqs:
            self.scheduler.finish(seq)
            self._emit(seq, LLMEngineOutput(
                finish_reason=FinishReason.ERROR, error=str(e)))
        if self.step_outcome_cb is not None:
            self.step_outcome_cb(getattr(plan, "_step_id", None), False)

    async def _loop_body(self) -> None:
        # pending = a dispatched decode step whose results are still on
        # device: (plan, handle). While it is in flight the scheduler may
        # plan the NEXT decode step chained to its on-device tokens; the
        # host then fetches the pending step's results while the chained
        # step executes — the device->host readback is fully hidden in
        # steady-state decode.
        pending: Optional[Tuple[StepPlan, Any]] = None

        def fetch_fn(plan):
            return (self.fetch_packed_block
                    if isinstance(plan, MultiStepBatch) else self.fetch_packed)

        def process_fn(plan):
            return (self._process_multistep
                    if isinstance(plan, MultiStepBatch) else self._process)

        async def flush() -> None:
            nonlocal pending
            if pending is None:
                return
            plan, handle = pending
            pending = None
            t_u0 = time.perf_counter()
            try:
                result = await self._to_thread(fetch_fn(plan), handle)
            except Exception as e:  # noqa: BLE001
                self._fail_plan(plan, e)
                return
            process_fn(plan)(plan, *result)
            self.steptrace.note_unpack(
                getattr(plan, "_steprec", None),
                (time.perf_counter() - t_u0) * 1000.0)

        while not self._stopping:
            if self._exclusive:
                await flush()
                await self._drain_exclusive()
            if pending is not None:
                prev_plan, prev_handle = pending
                t_p0 = time.perf_counter()
                if isinstance(prev_plan, MultiStepBatch):
                    chained = (self.scheduler.plan_multistep_chained(prev_plan)
                               if self.supports_multistep else None)
                else:
                    chained = (self.scheduler.plan_chained(prev_plan)
                               if self.supports_pipelining else None)
                plan_ms = (time.perf_counter() - t_p0) * 1000.0
                if chained is not None:
                    pending = None
                    t_d0 = time.perf_counter()
                    try:
                        if isinstance(chained, MultiStepBatch):
                            kind = "multistep"
                            handle = await self._to_thread(
                                self.dispatch_multistep, chained, prev_handle)
                        else:
                            kind = "chained"
                            handle = await self._to_thread(
                                self.dispatch_chained, chained, prev_handle)
                    except Exception as e:  # noqa: BLE001
                        # finish step/block N first so survivors' state is
                        # consistent, then fail the chained victims
                        try:
                            result = await self._to_thread(
                                fetch_fn(prev_plan), prev_handle)
                            process_fn(prev_plan)(prev_plan, *result)
                        except Exception as e2:  # noqa: BLE001
                            self._fail_plan(prev_plan, e2)
                        self._fail_plan(chained, e)
                        continue
                    self._stamp_dispatch(kind, chained, t_d0,
                                         plan_ms=plan_ms, chained=True)
                    pending = (chained, handle)
                    # overlap: unpack step/block N (streaming its tokens
                    # out) while N+1 runs on device
                    t_u0 = time.perf_counter()
                    try:
                        result = await self._to_thread(
                            fetch_fn(prev_plan), prev_handle)
                    except Exception as e:  # noqa: BLE001
                        self._fail_plan(prev_plan, e)
                        continue
                    process_fn(prev_plan)(prev_plan, *result)
                    self.steptrace.note_unpack(
                        getattr(prev_plan, "_steprec", None),
                        (time.perf_counter() - t_u0) * 1000.0)
                    continue
                await flush()
            t_p0 = time.perf_counter()
            plan = self.scheduler.schedule()
            self._drain_reaped()
            if plan is None:
                self._work.clear()
                if self.scheduler.waiting:
                    if not self.scheduler.active:
                        # nothing running and the head request still cannot be
                        # admitted: it can never fit — fail it
                        seq = self.scheduler.waiting.popleft()
                        self._emit(seq, LLMEngineOutput(
                            finish_reason=FinishReason.ERROR,
                            error="request cannot fit in KV cache"))
                        continue
                    # cache full; yield to let running streams drain, retry
                    await asyncio.sleep(0.005)
                    self._last_dispatch_end = None  # idle, not a stall
                    continue
                await self._work.wait()
                self._last_dispatch_end = None      # idle, not a stall
                continue
            if isinstance(plan, DecodeBatch):
                ms = None
                if self.supports_multistep:
                    ms = self.scheduler.plan_multistep(plan)
                else:
                    reason = self.multistep_unsupported_reason
                    if reason is not None:
                        self.scheduler.record_fallback(reason, plan.seqs)
                plan_ms = (time.perf_counter() - t_p0) * 1000.0
                if ms is not None:
                    t_d0 = time.perf_counter()
                    try:
                        handle = await self._to_thread(
                            self.dispatch_multistep, ms, None)
                    except Exception as e:  # noqa: BLE001
                        self._fail_plan(ms, e)
                        continue
                    self._stamp_dispatch("multistep", ms, t_d0,
                                         plan_ms=plan_ms)
                    pending = (ms, handle)
                    continue
                if self.supports_pipelining:
                    t_d0 = time.perf_counter()
                    try:
                        handle = await self._to_thread(
                            self.dispatch_decode, plan)
                    except Exception as e:  # noqa: BLE001
                        self._fail_plan(plan, e)
                        continue
                    self._stamp_dispatch("decode", plan, t_d0,
                                         plan_ms=plan_ms,
                                         fallback=self._consume_fallback())
                    pending = (plan, handle)
                    continue
            plan_ms = (time.perf_counter() - t_p0) * 1000.0
            if isinstance(plan, SpecDecodeBatch):
                kind = "spec"
            elif isinstance(plan, MixedStepBatch):
                kind = "mixed"
            elif isinstance(plan, PrefillBatch):
                kind = "prefill"
            else:
                kind = "decode"
            t_d0 = time.perf_counter()
            try:
                result = await self._to_thread(self._execute_plan, plan)
            except Exception as e:  # noqa: BLE001 — engine must not die silently
                self._fail_plan(plan, e)
                continue
            rec = self._stamp_dispatch(kind, plan, t_d0, plan_ms=plan_ms,
                                       fallback=self._consume_fallback())
            sampled, logprobs, extras = result
            t_u0 = time.perf_counter()
            self._process(plan, sampled, logprobs, extras)
            self.steptrace.note_unpack(
                rec, (time.perf_counter() - t_u0) * 1000.0)

    async def start(self) -> None:
        if self._loop_task is None:
            self._stopping = False
            self._loop_task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        self._stopping = True
        self._work.set()
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._loop_task = None
        if self._thread_work:
            # a step, fetch or exclusive call the cancel left running in its
            # thread: nothing of the engine runs once stop() returns
            _done, left = await asyncio.wait(list(self._thread_work),
                                             timeout=THREAD_STOP_TIMEOUT_S)
            if left:
                logger.warning("engine stop: %d thread call(s) still "
                               "running after %.0f s", len(left),
                               THREAD_STOP_TIMEOUT_S)
        self._fail_exclusive("engine stopped")

    async def _to_thread(self, fn: Callable, *args) -> Any:
        """``asyncio.to_thread`` for the loop's own work, tracked: when the
        loop is cancelled the call goes on in its thread to its end, and
        ``stop()`` waits for it. The executor's thread holds its work item
        a moment after the call's result is out; the call (``_CallOnce``)
        lets go of ``fn`` and its arguments before that, so the engine is
        not held by a thread once ``stop()`` has seen the call end."""
        call = _CallOnce(fn, args)
        if self._step_executor is not None:
            task = asyncio.get_running_loop().run_in_executor(
                self._step_executor, call)
        else:
            task = asyncio.ensure_future(asyncio.to_thread(call))
        self._thread_work.add(task)
        task.add_done_callback(self._thread_done)
        return await asyncio.shield(task)

    def _thread_done(self, task: asyncio.Task) -> None:
        self._thread_work.discard(task)
        if not task.cancelled():
            task.exception()    # the awaiting side raised it, or was gone

    # -- graceful drain ----------------------------------------------------

    async def drain_migrate(self, resume_extras: Optional[dict] = None
                            ) -> Dict[str, int]:
        """Freeze every in-flight sequence at a step boundary and hand its
        stream to the migration layer.

        Runs serialized with the step loop (``run_exclusive``), so no step
        is in flight while sequences are frozen: each active sequence's
        full pages are committed to the prefix cache, pinned under a TTL'd
        export lease, and a resume token (block chain + lease + sampling
        budgets + ``resume_extras`` — the worker's pull coordinates) is
        emitted as the stream's last frame. The serving layer relays the
        token and ends the stream through the failover path, so the
        frontend's MigrationOperator turns it into a *resume* on a
        survivor. Sequences with nothing committed (still queued, early
        prefill) get an empty token — a plain replay. Engines that cannot
        export KV (the mocker) always emit empty tokens.

        Idempotent; returns ``{"resume": n, "replay": m}`` counts."""
        self.draining = True
        self._work.set()
        extras = dict(resume_extras or {})
        # only engines whose pages hold real, exportable KV can offer a
        # resume (the export handlers gather through this same hook)
        can_export = hasattr(self, "dispatch_gather_pages")
        try:
            frames, ttl = await self.run_exclusive(
                self._freeze_sync, extras, can_export)
        except RuntimeError:
            # loop dead or stopped: _fail_all_requests already terminated
            # every stream — nothing left to migrate
            return {"resume": 0, "replay": 0}
        counts = {"resume": 0, "replay": 0}
        for rid, out in frames:
            tok = migration_token(out)
            if tok is not None:
                counts["resume" if tok.get("blocks") else "replay"] += 1
                if tok.get("lease") is not None:
                    self._drain_leases.append(tok["lease"])
            q = self._queues.get(rid)
            if q is not None:
                q.put_nowait(out)
        if ttl is not None:
            from dynamo_tpu_torch.engine.transfer import get_export_leases
            mgr = get_export_leases(self)
            if mgr is not None:
                mgr.arm_sweep(ttl)
        if counts["resume"] or counts["replay"]:
            logger.info("drain froze %d stream(s): %d resumable, %d replay",
                        counts["resume"] + counts["replay"],
                        counts["resume"], counts["replay"])
        return counts

    def _freeze_sync(self, extras: dict, can_export: bool):
        """Exclusive-window half of ``drain_migrate``: commit, pin, build
        the per-stream migration frames. Returns (frames, lease_ttl)."""
        sched = self.scheduler
        frames: List[Tuple[str, LLMEngineOutput]] = []
        from dynamo_tpu_torch.engine.transfer import export_ttl_s, get_export_leases
        mgr = get_export_leases(self) if can_export else None
        ttl = None
        # queued-but-unadmitted requests: nothing computed — replay markers
        while sched.waiting:
            seq = sched.waiting.popleft()
            seq.phase = Phase.FINISHED
            if seq.cancelled:
                frames.append((seq.request.request_id, LLMEngineOutput(
                    finish_reason=FinishReason.CANCELLED,
                    prompt_tokens=seq.num_prompt, completion_tokens=0)))
                continue
            frames.append((seq.request.request_id,
                           LLMEngineOutput(kv_transfer_params={
                               MIGRATION_KEY: {}})))
        for seq in list(sched.active.values()):
            rid = seq.request.request_id
            if seq.cancelled:
                sched.finish(seq)
                frames.append((rid, LLMEngineOutput(
                    finish_reason=FinishReason.CANCELLED,
                    prompt_tokens=seq.num_prompt,
                    completion_tokens=len(seq.generated))))
                continue
            sched._commit_full_pages(seq)
            resume: dict = {}
            blocks = seq.tokens.blocks[:seq.committed_pages]
            if mgr is not None and blocks and not seq.request.prefill_only:
                ttl = export_ttl_s() if ttl is None else ttl
                lease, pinned = mgr.grant_sync(
                    [b.block_hash for b in blocks], ttl)
                sc = seq.request.stop_conditions
                n = len(seq.generated)
                # tokens the STREAM generated across all legs: an earlier
                # migration's output rides the rebuilt prompt's tail
                # (request.resumed_tokens), this leg's is seq.generated —
                # tokens_done and the stop tail must be cumulative or a
                # SECOND drain of the same stream would always fail the
                # operator's desync check and degrade to a full replay
                resumed0 = seq.request.resumed_tokens or 0
                toks = list(seq.request.token_ids)
                stream_gen = toks[len(toks) - resumed0:] + \
                    list(seq.generated)
                resume = {
                    "blocks": [[b.block_hash, b.local_hash,
                                b.parent_hash if b.position else None]
                               for b in blocks],
                    "page_size": self.allocator.page_size,
                    "num_tokens_cached": len(blocks)
                    * self.allocator.page_size,
                    "tokens_done": resumed0 + n,
                    # sampling state for the survivor: remaining budgets
                    # (leg-relative; diagnostic), the rng step position,
                    # and the stream's generated tail — the migration
                    # operator verifies the tail against the client-side
                    # stream before trusting the token (content-level
                    # desync check on top of the tokens_done count)
                    "sampling": {
                        "rng_step": seq.decode_steps,
                        "max_tokens_left": (sc.max_tokens - n
                                            if sc.max_tokens is not None
                                            else None),
                        "min_tokens_left": max(0, (sc.min_tokens or 0) - n),
                        "stop_tail": stream_gen[-4:],
                    },
                    **extras,
                }
                if lease is not None:
                    resume["lease"] = lease
                if pinned < len(blocks):
                    logger.warning(
                        "drain pinned %d/%d pages of %s (lease cap); the "
                        "unpinned tail may be evicted before the pull",
                        pinned, len(blocks), rid)
            sched.finish(seq)  # releases the seq's refs; leased pages stay
            frames.append((rid, LLMEngineOutput(
                kv_transfer_params={MIGRATION_KEY: resume})))
        return frames, ttl

    # -- public API --------------------------------------------------------

    async def generate(self, request: PreprocessedRequest,
                       ctx=None) -> AsyncIterator[LLMEngineOutput]:
        await self.start()
        if (self._loop_task is not None and self._loop_task.done()
                and not self._stopping):
            # the loop died earlier: requests arriving AFTER
            # _fail_all_requests ran would otherwise enqueue onto a
            # scheduler no loop will ever drain
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                  error="engine loop is dead")
            return
        rid = request.request_id or f"req-{id(request):x}"
        request.request_id = rid
        if self.draining:
            # the router is already routing around this worker; a request
            # that raced the announcement is handed straight back to the
            # migration layer (empty token = replay on a survivor) instead
            # of being admitted onto an engine that is shutting down
            yield LLMEngineOutput(kv_transfer_params={MIGRATION_KEY: {}})
            return
        if rid in self._queues:
            # a reused request id would silently clobber the first stream's
            # queue (its finally would then pop THIS stream's queue and the
            # second caller hangs forever) — refuse loudly instead; replay
            # and resume admissions derive unique ids for this reason
            yield LLMEngineOutput(
                finish_reason=FinishReason.ERROR,
                error=(f"duplicate request_id {rid!r}: a request with this "
                       "id is already in flight on this engine"))
            return
        if len(request.token_ids) >= self.max_context:
            yield LLMEngineOutput(
                finish_reason=FinishReason.ERROR,
                error=(f"prompt of {len(request.token_ids)} tokens exceeds "
                       f"max context {self.max_context}"))
            return
        err = self.validate_request(request)
        if err is not None:
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                  error=err)
            return
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = q
        try:
            try:
                self.scheduler.add_request(request)
            except RuntimeError as e:
                yield LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                      error=str(e))
                return
            self._work.set()
            while True:
                cancelled = (ctx is not None
                             and getattr(ctx, "cancelled", False))
                if cancelled:
                    self.scheduler.cancel(rid)
                    self._work.set()
                if ctx is None:
                    out = await q.get()
                else:
                    # poll the context so a cancel set while we're blocked
                    # still terminates the stream
                    try:
                        out = await asyncio.wait_for(q.get(), timeout=0.05)
                    except asyncio.TimeoutError:
                        continue
                yield out
                if out.finish_reason is not None:
                    return
                if migration_token(out) is not None:
                    # drain froze this sequence: the token is the stream's
                    # last frame — the serving layer relays it and breaks
                    # the stream through the failover path
                    return
        finally:
            self.scheduler.cancel(rid)
            self._queues.pop(rid, None)
            self._work.set()

    def stats(self) -> ForwardPassMetrics:
        return self.scheduler.metrics()


__all__ = ["ScheduledEngineBase", "MIGRATION_KEY", "migration_token"]
