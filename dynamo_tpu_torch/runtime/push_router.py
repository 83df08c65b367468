"""PushRouter: load-balancing request fan-out with fault detection.

Parity: reference ``lib/runtime/src/pipeline/network/egress/push_router.rs``
(``RouterMode::{RoundRobin, Random, Direct, KV}``, NoResponders/stream-drop
instance-down marking).  The KV mode lives in ``dynamo_tpu_torch.kv_router`` and
wraps this router.

``RouterMode.COST`` adds the failure-aware policy (``runtime/resilience.py``):
min-cost selection over EWMA TTFT + in-flight + scraped queue depth, gated by
per-instance circuit breakers, with deadline-aware budgeted retries and
optional hedged dispatch.  When no policy is attached the legacy modes run
the exact pre-policy code path — round-robin stays byte-stable as the
fallback.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import random
import time
from typing import Any, AsyncIterator, Dict, Optional, Tuple

from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.resilience import RouterPolicy
from dynamo_tpu_torch.utils.aio import decorrelated_jitter, reap_task
from dynamo_tpu_torch.runtime.rpc import (
    DEADLINE_HEADER,
    REQUEST_ID_HEADER,
    DeadlineExceededError,
    ResponseStream,
    StreamEndedError,
)

logger = logging.getLogger(__name__)


class RouterMode(enum.Enum):
    ROUND_ROBIN = "round-robin"
    RANDOM = "random"
    DIRECT = "direct"
    KV = "kv"
    COST = "cost"


class PushRouter:
    """Routes requests across an endpoint's live instances."""

    def __init__(self, client: Client, mode: RouterMode = RouterMode.ROUND_ROBIN,
                 retries: int = 3, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 policy: Optional[RouterPolicy] = None):
        self.client = client
        self.mode = mode
        self.retries = retries
        # decorrelated-jitter backoff between failover attempts: during an
        # outage a tight retry loop hammers the surviving instances at the
        # exact moment they're absorbing the failed one's traffic (0 = off)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rr = 0
        if policy is None and mode is RouterMode.COST:
            policy = RouterPolicy()
        self.policy = policy
        if policy is not None:
            policy.attach_client(client)
        self._stats_task: Optional[asyncio.Task] = None

    def select_instance(self, exclude: Optional[set] = None) -> int:
        iid, _ = self._select(exclude)
        return iid

    def _select(self, exclude: Optional[set] = None
                ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """Pick an instance; returns (iid, score inputs or None)."""
        ids = sorted(self.client.instance_ids())
        if not ids:
            raise ConnectionError(
                f"no instances available for {self.client.endpoint.path}")
        if exclude:
            remaining = [i for i in ids if i not in exclude]
            ids = remaining or ids  # every instance tried: round again
        if self.policy is not None:
            allowed = [i for i in ids if self.policy.breakers.allow(i)]
            # every breaker open: degrade to the full set rather than refuse —
            # an all-open board means the fleet is sick, not that no work
            # should be attempted
            ids = allowed or ids
            if self.mode is RouterMode.COST:
                return self.policy.select(ids)
        if self.mode == RouterMode.RANDOM:
            return random.choice(ids), None
        chosen = ids[self._rr % len(ids)]
        self._rr += 1
        return chosen, None

    async def _open(self, payload: Any, instance_id: Optional[int],
                    headers: Optional[Dict[str, Any]]
                    ) -> "tuple[int, ResponseStream, Optional[Dict[str, Any]]]":
        """Open a response stream; returns (chosen_instance_id, stream,
        score inputs).

        Connect-level failures on router-selected instances fail over to other
        instances (up to ``retries``) and mark the unreachable one down.  A
        caller-pinned ``instance_id`` is never silently rerouted.  With a
        policy attached, failover re-dispatches spend the frontend-wide retry
        budget and respect the request deadline against the target's EWMA
        TTFT.
        """
        last_err: Optional[Exception] = None
        attempts = max(1, self.retries)
        sleep_s = self.backoff_base_s
        deadline = (headers or {}).get(DEADLINE_HEADER)
        tried: set = set()
        inputs: Optional[Dict[str, Any]] = None
        pol = self.policy
        for attempt in range(attempts):
            if deadline is not None and time.time() >= deadline:
                # failover must not hold a request past its deadline, nor
                # dispatch already-expired work a worker will only drop
                raise DeadlineExceededError(
                    "request deadline exceeded during failover")
            if instance_id is not None:
                iid = instance_id
            else:
                iid, inputs = self._select(exclude=tried)
            if pol is not None:
                if attempt > 0:
                    # a failover re-dispatch is a retry: it must fit the
                    # fleet-wide budget (no retry storms during brownouts)
                    # and the target must plausibly beat the deadline
                    if not pol.budget.try_spend():
                        pol.stats.retries["denied"] += 1
                        raise ConnectionError(
                            f"retry budget exhausted for "
                            f"{self.client.endpoint.path}: {last_err}")
                    if not pol.can_redispatch(iid, deadline):
                        raise DeadlineExceededError(
                            "remaining deadline below target's expected TTFT; "
                            "not re-dispatching")
                    pol.stats.retries["connect"] += 1
                pol.breakers.on_dispatch(iid)
            try:
                return iid, await self.client.direct(payload, iid, headers), inputs
            except ConnectionError as e:
                last_err = e
                tried.add(iid)
                if pol is not None:
                    pol.on_failure(iid, "connect")
                self.client.report_instance_down(iid)
                if instance_id is not None:
                    break  # caller pinned the instance; don't fail over silently
                if attempt + 1 < attempts and self.backoff_base_s > 0:
                    sleep_s = decorrelated_jitter(
                        sleep_s, self.backoff_base_s, self.backoff_cap_s)
                    if deadline is not None:
                        sleep_s = min(sleep_s, max(0.0, deadline - time.time()))
                    await asyncio.sleep(sleep_s)
        raise ConnectionError(
            f"all attempts to reach {self.client.endpoint.path} failed: {last_err}")

    async def generate(self, payload: Any, instance_id: Optional[int] = None,
                       headers: Optional[Dict[str, Any]] = None) -> ResponseStream:
        _iid, stream, _inputs = await self._open(payload, instance_id, headers)
        return stream

    async def generate_stream(self, payload: Any,
                              instance_id: Optional[int] = None,
                              headers: Optional[Dict[str, Any]] = None
                              ) -> AsyncIterator[Any]:
        """Convenience: iterate response payloads; marks the instance down on
        mid-stream drop and re-raises ``StreamEndedError`` for the migration
        operator to handle."""
        if self.policy is None:
            # legacy path, kept verbatim: RouterMode round-robin/random must
            # stay byte-stable as the no-policy fallback
            iid, stream, _ = await self._open(payload, instance_id, headers)
            try:
                async for item in stream:
                    yield item
            except StreamEndedError:
                self.client.report_instance_down(iid)
                raise
            finally:
                # Consumer stopped early (stop string, disconnect,
                # GeneratorExit): tell the worker to abort generation instead
                # of streaming into a queue nobody reads.
                if not stream.finished:
                    await stream.cancel()
            return
        async for item in self._generate_stream_policy(
                payload, instance_id, headers):
            yield item

    # -- policy-path streaming ---------------------------------------------

    async def _generate_stream_policy(self, payload: Any,
                                      instance_id: Optional[int],
                                      headers: Optional[Dict[str, Any]]
                                      ) -> AsyncIterator[Any]:
        pol = self.policy
        self._ensure_stats_loop()
        deadline = (headers or {}).get(DEADLINE_HEADER)
        if instance_id is None:
            # every router-selected first attempt earns the fleet its
            # fractional retry credit
            pol.budget.deposit()
        t0 = time.monotonic()
        iid, stream, inputs = await self._open(payload, instance_id, headers)
        pol.begin(iid)
        if instance_id is None:
            # pinned dispatches (KV mode, migration resume) count their
            # decision at the layer that actually chose the worker
            pol.stats.decisions[self.mode.value] += 1
            self._export_decision(iid, inputs)
        it = stream.__aiter__()
        first: Any = None
        exhausted = False
        got_first = False
        try:
            # hedged dispatch: only for router-selected requests, and never
            # for a migration replay — a hedged replay would run the same
            # resume on two workers and double-count migration_replays
            hedge_ok = (pol.cfg.hedge and instance_id is None
                        and not (isinstance(payload, dict)
                                 and payload.get("migration_attempt")))
            t_first = t0
            if hedge_ok:
                (iid, stream, it, first, exhausted,
                 t_first) = await self._hedged_first(
                    payload, headers, iid, stream, it, deadline, t0)
                got_first = True
            if got_first:
                if first is not None:
                    # dispatch-relative: a hedge winner's EWMA reflects the
                    # worker's own TTFT, not the hedge delay it waited out
                    pol.observe_ttft(iid, time.monotonic() - t_first)
                    yield first
            while not exhausted:
                try:
                    item = await it.__anext__()
                except StopAsyncIteration:
                    break
                if not got_first:
                    got_first = True
                    pol.observe_ttft(iid, time.monotonic() - t0)
                yield item
            pol.on_success(iid, time.monotonic() - t0)
        except StreamEndedError:
            pol.on_failure(iid, "stream_drop")
            self.client.report_instance_down(iid)
            raise
        except DeadlineExceededError:
            pol.on_failure(iid, "timeout")
            raise
        finally:
            pol.end(iid)
            if not stream.finished:
                await stream.cancel()

    async def _hedged_first(self, payload: Any,
                            headers: Optional[Dict[str, Any]], iid: int,
                            stream: ResponseStream, it: Any,
                            deadline: Optional[float], t0: float):
        """Race the primary's first frame against a hedge on the next-best
        instance; first winner cancels the loser.  Returns the winning
        (iid, stream, iterator, first_item, exhausted, dispatch_time)."""
        pol = self.policy
        primary = asyncio.ensure_future(it.__anext__())
        done, _ = await asyncio.wait({primary}, timeout=pol.hedge_delay_s())
        if done:
            first, exhausted = self._unpack_first(primary)
            return iid, stream, it, first, exhausted, t0
        hedge = await self._fire_hedge(payload, headers, iid, deadline)
        if hedge is None:
            return iid, stream, it, *(await self._await_first(primary)), t0
        hiid, hstream = hedge
        t_hedge = time.monotonic()
        pol.begin(hiid)
        hit = hstream.__aiter__()
        htask = asyncio.ensure_future(hit.__anext__())
        arms = {primary: (iid, stream, it, t0),
                htask: (hiid, hstream, hit, t_hedge)}
        pending = {primary, htask}
        errors: Dict[asyncio.Future, BaseException] = {}
        # inflight contract with the caller: the caller began the primary and
        # will end whichever iid this returns; here we end every *other*
        # begun side exactly once (``ended`` guards the double-elimination
        # paths), and on the both-failed raise the primary stays "begun" for
        # the caller's finally
        ended: set = set()
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                # prefer the primary when both finished in the same tick
                winner = None
                for t in sorted(done, key=lambda t: 0 if t is primary else 1):
                    exc = t.exception()
                    if exc is None or isinstance(exc, StopAsyncIteration):
                        winner = t
                        break
                    errors[t] = exc
                    wiid, wstream = arms[t][0], arms[t][1]
                    pol.on_failure(wiid, "stream_drop"
                                   if isinstance(exc, StreamEndedError)
                                   else "connect")
                    if isinstance(exc, (ConnectionError, StreamEndedError)):
                        self.client.report_instance_down(wiid)
                    if t is htask and t not in ended:
                        pol.end(wiid)
                        ended.add(t)
                    if not wstream.finished:
                        await wstream.cancel()
                if winner is None:
                    continue  # a side failed; keep waiting on the other
                # cancel a still-pending loser (slow, not failed: no breaker
                # penalty) and settle inflight for every non-winner side
                for t in pending:
                    t.cancel()
                pending = set()
                loser = htask if winner is primary else primary
                liid, lstream = arms[loser][0], arms[loser][1]
                if loser not in ended:
                    pol.end(liid)
                    ended.add(loser)
                if loser is primary:
                    # the primary produced nothing in this long: feed the
                    # elapsed time to the latency book as a TTFT lower
                    # bound, so the scorer (and slow-call breaker
                    # accounting) learn to route around a consistently
                    # slow instance the hedge keeps beating
                    pol.observe_ttft(liid, time.monotonic() - t0)
                if not lstream.finished:
                    await lstream.cancel()
                pol.stats.hedges["won" if winner is htask else "lost"] += 1
                first, exhausted = self._unpack_first(winner)
                wiid, wstream, wit, t_win = arms[winner]
                return wiid, wstream, wit, first, exhausted, t_win
            # both sides failed: surface the primary's error (the hedge was
            # opportunistic); the caller's finally settles the primary
            raise errors.get(primary) or next(iter(errors.values()))
        finally:
            for t in (primary, htask):
                if not t.done():
                    t.cancel()

    async def _fire_hedge(self, payload: Any,
                          headers: Optional[Dict[str, Any]],
                          primary_iid: int, deadline: Optional[float]
                          ) -> Optional[Tuple[int, ResponseStream]]:
        """Open the hedge stream on the next-best instance, if the fleet,
        deadline, and retry budget allow.  Returns None when no hedge fires."""
        pol = self.policy
        try:
            alt, _ = self._select(exclude={primary_iid})
        except ConnectionError:
            return None
        if alt == primary_iid:
            return None  # single-instance fleet: nowhere to hedge
        if not pol.can_redispatch(alt, deadline):
            # satellite-1 guard: an expired hedge is never dispatched
            pol.stats.hedges["expired"] += 1
            return None
        if not pol.budget.try_spend():
            pol.stats.hedges["denied"] += 1
            return None
        hpayload = payload
        hheaders = headers
        if isinstance(payload, dict) and payload.get("request_id"):
            hpayload = dict(payload)
            hpayload["request_id"] = f"{payload['request_id']}~h1"
        if headers and headers.get(REQUEST_ID_HEADER):
            hheaders = dict(headers)
            hheaders[REQUEST_ID_HEADER] = f"{headers[REQUEST_ID_HEADER]}~h1"
        pol.breakers.on_dispatch(alt)
        try:
            stream = await self.client.direct(hpayload, alt, hheaders)
        except ConnectionError:
            pol.on_failure(alt, "connect")
            self.client.report_instance_down(alt)
            return None
        pol.stats.hedges["fired"] += 1
        span = self._current_span()
        if span is not None:
            span.add_event("hedge", instance=f"{alt:x}",
                           delay_s=round(pol.hedge_delay_s(), 4))
        return alt, stream

    @staticmethod
    def _unpack_first(task: "asyncio.Future") -> Tuple[Any, bool]:
        try:
            return task.result(), False
        except StopAsyncIteration:
            return None, True

    @staticmethod
    async def _await_first(task: "asyncio.Future") -> Tuple[Any, bool]:
        try:
            return await task, False
        except StopAsyncIteration:
            return None, True

    # -- decision tracing ---------------------------------------------------

    @staticmethod
    def _current_span():
        try:
            from dynamo_tpu_torch.utils.tracing import get_tracer
            return get_tracer().current_span()
        except Exception:
            return None

    def _export_decision(self, iid: int,
                         inputs: Optional[Dict[str, Any]]) -> None:
        """Land the decision's score inputs on the request's current span —
        retrievable post-hoc from /v1/traces (the ROADMAP's "debuggable
        post-hoc" requirement)."""
        span = self._current_span()
        if span is None:
            return
        span.set_attr("router.policy", self.mode.value)
        span.set_attr("router.instance", f"{iid:x}")
        for key, value in (inputs or {}).items():
            span.set_attr(f"router.{key}", value)

    # -- stats scrape loop ---------------------------------------------------

    def _ensure_stats_loop(self) -> None:
        """COST mode polls the ``__stats__`` plane for queue depth / active
        slots; started lazily from the first routed request so the router
        needs no explicit async start hook."""
        if (self.mode is not RouterMode.COST or self.policy is None
                or self.policy.cfg.stats_interval_s <= 0):
            return
        if self._stats_task is None or self._stats_task.done():
            self._stats_task = asyncio.create_task(self._stats_loop())

    async def _stats_loop(self) -> None:
        while True:
            try:
                scraped = await self.client.scrape_stats()
                self.policy.ingest_scrape(scraped, self.client.endpoint.path)
                self.policy.prune(set(self.client.instance_ids()))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.debug("router stats scrape failed", exc_info=True)
            await asyncio.sleep(self.policy.cfg.stats_interval_s)

    async def close(self) -> None:
        await reap_task(self._stats_task)
        self._stats_task = None


__all__ = ["PushRouter", "RouterMode"]
