"""Disaggregated prefill/decode: the decode-side orchestration.

Decode-first flow, capability parity with the reference's vLLM disagg path
(SURVEY §3.4; ``components/backends/vllm/src/dynamo/vllm/handlers.py:107-183``):
the decode worker receives the request, round-robins it to a prefill worker
with ``prefill_only`` set, receives the first token plus
``kv_transfer_params`` (the prefix's block hashes), pulls those KV blocks
over the runtime RPC plane (``engine/transfer.py`` — the NIXL replacement),
injects them into the local cache, and decodes from the prefix hit.

Short prompts skip the remote hop: ``max_local_prefill_length`` is
hot-reloaded from the coordinator KV (parity: ``DisaggRouterConf`` etcd watch,
``lib/llm/src/disagg_router.rs:25-120``). If no prefill worker is live, or the
remote leg fails, the decode worker silently falls back to local prefill —
disagg is an optimization, never a point of failure.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from typing import Any, AsyncIterator, Dict, Optional

from dynamo_tpu_torch.engine.torch_engine import TorchEngine
from dynamo_tpu_torch.engine.transfer import (
    FRAME_WIRE_VERSION,
    KV_EXPORT_DIRECT_ENDPOINT,
    BlockPayload,
    FrameIntegrityError,
    InjectPipeline,
    inject_device_windowed,
    kv_shard_payload,
    pump_bulk_frames,
    stamp_export_lease,
)
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.rpc import DeadlineExceededError, request_headers
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.utils.aio import reap_task
from dynamo_tpu_torch.utils.tracing import (
    SPANS_FRAME_KEY,
    StageStitcher,
    get_tracer,
)

logger = logging.getLogger(__name__)

KV_EXPORT_ENDPOINT = "kv_export"


class KvBandwidthBook:
    """Per-plane KV-transfer bandwidth EWMAs (bulk / rpc / direct).

    Each completed pull leg contributes one (bytes, wall-seconds) sample
    for the plane that served it; the EWMA smooths transient dips while
    tracking a degrading link within a few pulls. Surfaced on the worker
    ``__stats__`` plane (``worker/main.worker_stats`` merges
    ``snapshot()`` as ``kv_transfer``) so the frontend cost router and
    fleet tooling see per-plane transfer health alongside queue depth —
    no Prometheus scrape in the routing path."""

    _ALPHA = 0.3  # weight of the newest sample

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ewma: Dict[str, float] = {}
        self._bytes: Dict[str, int] = {}
        self._samples: Dict[str, int] = {}

    def note(self, plane: str, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return  # empty or unmeasured leg: no bandwidth information
        bw = nbytes / seconds
        with self._lock:
            prev = self._ewma.get(plane)
            self._ewma[plane] = bw if prev is None else (
                self._ALPHA * bw + (1.0 - self._ALPHA) * prev)
            self._bytes[plane] = self._bytes.get(plane, 0) + int(nbytes)
            self._samples[plane] = self._samples.get(plane, 0) + 1

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {p: {"bw_bytes_per_s": round(self._ewma[p], 1),
                        "bytes_total": self._bytes[p],
                        "samples": self._samples[p]}
                    for p in sorted(self._ewma)}


_kv_bw_book: Optional[KvBandwidthBook] = None


def get_kv_bandwidth_book() -> KvBandwidthBook:
    """Process-wide bandwidth book (pull paths write, __stats__ reads)."""
    global _kv_bw_book
    if _kv_bw_book is None:
        _kv_bw_book = KvBandwidthBook()
    return _kv_bw_book


def make_device_transfer_plane(engine: TorchEngine):
    """A ``DeviceTransferPlane`` (CUDA IPC) for this engine, or None when
    the device-direct path does not apply: the engine's cache is not on a
    CUDA device (the CPU has no IPC handles), as the reference returns
    None without its transfer API."""
    if not engine.pages.is_cuda:
        return None
    from dynamo_tpu_torch.engine.transfer import DeviceTransferPlane
    return DeviceTransferPlane()


def disagg_conf_key(namespace: str) -> str:
    return f"disagg/{namespace}/conf"


def prefill_queue_name(namespace: str) -> str:
    """Coordinator work-queue carrying prefill jobs (the JetStream prefill
    queue role — reference ``rust/llm/nats.rs:109`` ``NatsQueue``, flow in
    ``docs/architecture/dynamo_flow.md`` S7-S10)."""
    return f"prefill/{namespace}"


def prefill_reply_subject(namespace: str, rid: str) -> str:
    return f"{namespace}.prefill_reply.{rid}"


class PrefillQueueWorker:
    """Prefill-side queue consumer: pulls jobs, prefills, publishes the
    result (first token + kv_transfer_params + where to fetch the blocks).

    Queue semantics give disagg what round-robin cannot: jobs wait for the
    FIRST FREE prefill worker (not a blindly-chosen one), depth is a real
    backlog signal for the planner, and adding a worker immediately drains
    the queue."""

    def __init__(self, engine: TorchEngine, drt: DistributedRuntime,
                 namespace: str, instance_id: int, bulk_address: str = "",
                 concurrency: int = 2, direct_address: str = ""):
        self.engine = engine
        self.drt = drt
        self.namespace = namespace
        self.instance_id = instance_id
        self.bulk_address = bulk_address
        self.direct_address = direct_address
        self.concurrency = concurrency
        self._tasks: list = []
        self.jobs_done = 0

    async def start(self) -> "PrefillQueueWorker":
        for i in range(self.concurrency):
            self._tasks.append(asyncio.create_task(
                self._pull_loop(), name=f"prefill-queue-{i}"))
        return self

    async def stop(self) -> None:
        for t in self._tasks:
            await reap_task(t)

    async def _pull_loop(self) -> None:
        from dynamo_tpu_torch.runtime import codec
        queue = prefill_queue_name(self.namespace)
        while True:
            try:
                pulled = await self.drt.coord.queue_pull(queue)
            except ConnectionError:
                # coordinator outage: park until the supervised client
                # reconnects (a queued pull doesn't survive the server's
                # session, so just re-issue it), or exit on permanent close
                try:
                    await self.drt.coord.wait_connected()
                except ConnectionError:
                    return  # gone for good; runtime shutdown handles the rest
                # the write side can fail before the read loop marks the
                # connection down, making wait_connected return immediately;
                # yield briefly so the retry can't hot-spin
                await asyncio.sleep(0.05)
                continue
            if pulled is None:
                continue
            raw, age_s = pulled
            job = None
            try:
                job = codec.unpack(raw)
                outcome = await self._run_job(job, age_s)
                self.jobs_done += 1
            except Exception:  # noqa: BLE001 — one bad job must not kill
                outcome = "failed"
                logger.exception("prefill queue job failed")
                if job is None and isinstance(raw, (bytes, bytearray)):
                    logger.warning("undecodable prefill job dropped")
            from dynamo_tpu_torch.worker.metrics import count_metric
            count_metric("prefill_jobs", outcome)

    async def _run_job(self, job: dict, age_s: float = 0.0) -> str:
        """Run one queued prefill job; returns its outcome label
        (``ok``/``failed``/``stale`` — ``dynamo_worker_prefill_jobs_total``)."""
        from dynamo_tpu_torch.runtime import codec
        tracer = get_tracer()
        # the decode side packed its trace context into the job (the queue
        # rides the coordinator, not RPC headers): this worker's fragment
        # stitches under the decode worker's prefill span
        hop = tracer.start_hop("prefill_worker.job",
                               headers=job.get("trace"),
                               attrs={"request_id":
                                      job.get("req", {}).get("request_id",
                                                             ""),
                                      "queued_s": round(age_s, 6)})
        # staleness by TIME QUEUED (measured on the coordinator's single
        # clock — immune to cross-host wall-clock skew): past the decode
        # side's reply timeout, nobody is waiting for this job
        if age_s > job.get("ttl", float("inf")):
            logger.info("dropping stale prefill job %s (queued %.1fs)",
                        job.get("req", {}).get("request_id"), age_s)
            hop.set_attr("outcome", "stale")
            hop.add_event("stale_drop", queued_s=round(age_s, 3),
                          ttl=job.get("ttl"))
            tracer.finish_hop(hop)  # fragment stays in this recorder
            return "stale"
        stitcher = StageStitcher(tracer, parent=hop, skip_decode=True)
        # pre-set so the finally's publish can never NameError, even on a
        # BaseException (cancellation) out of the engine stream
        reply = {"out": None, "instance_id": self.instance_id}
        outcome = "failed"
        try:
            req = PreprocessedRequest.from_dict(job["req"])
            req.prefill_only = True
            final: Optional[LLMEngineOutput] = None
            async for out in self.engine.generate(req):
                stitcher.on_frame(out)
                if out.finish_reason is not None:
                    final = out
            if final is not None and final.error:
                hop.set_error(final.error)
            elif final is not None and final.kv_transfer_params:
                # pin the advertised blocks until the decode side acks the
                # pull (or the TTL GC reclaims them — crashed decoder)
                await stamp_export_lease(self.engine,
                                         final.kv_transfer_params,
                                         span=hop)
            if final is not None and not final.error:
                outcome = "ok"
            reply = {
                "out": final.to_dict() if final is not None else None,
                "instance_id": self.instance_id,
                "bulk_address": self.bulk_address,
                "direct_address": self.direct_address,
            }
        except Exception as e:  # noqa: BLE001 — reply even on failure, so
            # the decode side falls back immediately instead of waiting out
            # its queue timeout
            hop.set_error(repr(e))
            reply = {"out": None, "instance_id": self.instance_id}
            raise
        finally:
            stitcher.close()
            hop.set_attr("outcome", outcome)
            reply[SPANS_FRAME_KEY] = tracer.finish_hop(hop)
            await self.drt.coord.publish(job["reply"], codec.pack(reply))
        return outcome


class DisaggConfig:
    """Hot-reloadable disagg policy."""

    def __init__(self, max_local_prefill_length: int = 0):
        # prompts up to this length prefill locally; 0 = always remote
        self.max_local_prefill_length = max_local_prefill_length

    @classmethod
    def from_json(cls, raw: bytes) -> "DisaggConfig":
        d = json.loads(raw)
        return cls(max_local_prefill_length=int(
            d.get("max_local_prefill_length", 0)))


class KvBlockPuller:
    """Transport-ladder KV block pull: device-direct -> bulk -> RPC, with
    per-block resumability, wire-v4 checksum NACKs, per-plane byte/trace
    accounting, and export-lease acks.

    Extracted from ``DisaggDecodeHandler`` so the graceful-drain resume
    path (``worker/drain.ResumeAdmission``) pulls a draining worker's
    pinned sequence KV through the exact machinery the disagg prefill
    handoff uses — one pull implementation, two callers. The clients are
    attached by the owner (they need a started runtime); a missing
    direct client/plane simply skips that rung of the ladder."""

    def __init__(self, engine: TorchEngine, kv_client=None,
                 kv_direct_client=None, direct_plane=None):
        self.engine = engine
        self.kv_client = kv_client
        self.kv_direct_client = kv_direct_client
        # device-direct pull plane (engine/transfer.DeviceTransferPlane):
        # built by the owner when the engine's cache is on a CUDA
        # device (CPU engines keep the host planes)
        self.direct_plane = direct_plane
        # bound on one device-direct pull; past it the (abandoned) pull
        # thread is left behind and the transport ladder falls to bulk
        self.direct_pull_timeout = 60.0
        # circuit breaker: a timed-out address is skipped for this long
        # (each timeout strands a 60s executor thread — without the
        # breaker a black-holed peer would saturate the default executor
        # and wedge even the bulk fallback's to_thread calls)
        self.direct_down_window = 300.0
        self.direct_down_until: dict = {}
        # bulk addresses already pre-warmed (one background warmup per
        # peer: later fetches find pooled connections with ramped kernel
        # buffers instead of paying the cold-socket penalty)
        self.bulk_warmed: set = set()
        # resume attempts per host plane after a mid-pull failure: each
        # re-pulls only the blocks not yet committed (DYN_KV_PULL_RETRIES)
        try:
            self.pull_resume_attempts = max(0, int(os.environ.get(
                "DYN_KV_PULL_RETRIES", "1")))
        except (TypeError, ValueError):
            logger.warning("malformed DYN_KV_PULL_RETRIES %r; using 1",
                           os.environ.get("DYN_KV_PULL_RETRIES"))
            self.pull_resume_attempts = 1
        # diagnostics of the most recent block pull (tests, debugging)
        self.last_pull_stats: dict = {}

    async def pull_blocks(self, hashes: list, iid: int,
                           bulk_address: str = "",
                           direct_address: str = "",
                           lease: Optional[int] = None) -> None:
        """Fetch + inject the prefix blocks from prefill worker ``iid``.

        Transport ladder: DEVICE-DIRECT (CUDA IPC offers — blocks move
        chip-to-chip with no host bounce, the NIXL RDMA role) when both
        sides run it, else the bulk data plane (raw sockets, unix-first),
        else batched two-part frames on the RPC plane.

        Fault tolerance: per-block commit state is the allocator's
        content-addressed registry itself, so a mid-pull failure (socket
        reset, corrupt frame, peer death) resumes by re-pulling ONLY the
        blocks not yet committed — first on the same plane, then down the
        ladder — instead of discarding committed work. Wire-v4 frames are
        checksum-verified before staging; a bad frame NACKs (aborts the
        stream) and is re-pulled, never injected. On the way out the
        export ``lease`` is acked (best-effort; the prefill side's TTL GC
        covers a lost ack)."""
        inst = self.kv_client.get_instance(iid)
        if not bulk_address and inst is not None:
            bulk_address = inst.bulk_address
        if not direct_address and inst is not None:
            direct_address = inst.direct_address
        tracer = get_tracer()
        kv_span = tracer.start_span(
            "kv_transfer", attrs={"blocks": len(hashes),
                                  "instance": f"{iid:x}"})

        def _count_bytes(n: int, plane: str) -> None:
            # per-plane attrs: a ladder fall-through (direct pull ok, inject
            # failed, bulk finished the job) must not attribute one plane's
            # bytes to another; "plane" records the plane that served the
            # tail of the transfer
            kv_span.set_attr("plane", plane)
            kv_span.set_attr(
                f"bytes_{plane}",
                int(kv_span.attrs.get(f"bytes_{plane}", 0)) + int(n))
            kv_span.set_attr(
                "bytes", int(kv_span.attrs.get("bytes", 0)) + int(n))
            try:
                from dynamo_tpu_torch.worker.metrics import get_worker_metrics
                get_worker_metrics().disagg_kv_bytes.labels(
                    "pulled", plane).inc(int(n))
            except Exception:  # noqa: BLE001 — accounting must not fail IO
                logger.exception("kv byte accounting failed")

        # per-phase wall time (recv = socket/pull wait, stage = host copy
        # into the scatter buffer, upload = host->device transfer, scatter
        # = exclusive-window commits): the bulk-vs-e2e gap lives in these
        phases = {"recv_s": 0.0, "stage_s": 0.0, "upload_s": 0.0,
                  "scatter_s": 0.0}
        try:
            await self._pull_blocks_inner(hashes, iid, bulk_address,
                                          direct_address, _count_bytes,
                                          kv_span, phases)
        except BaseException as e:
            kv_span.set_error(repr(e))
            raise
        finally:
            for k, v in phases.items():
                if v:
                    kv_span.set_attr(k[:-2] + "_ms", round(v * 1e3, 3))
            try:
                if lease is not None:
                    # ack whatever the outcome: this decode worker never
                    # comes back for more of THIS pull (a failed tail
                    # recomputes locally), so the prefill side can unpin
                    # now instead of waiting out the TTL
                    acked = await self._ack_export_lease(iid, lease)
                    kv_span.set_attr("lease_acked", acked)
            finally:
                # a cancellation landing on the ack await must not leave
                # the span unfinished
                kv_span.finish()

    async def _ack_export_lease(self, iid: int, lease: int) -> bool:
        try:
            stream = await self.kv_client.direct(
                {"ack_lease": int(lease)}, iid)
            async for _ in stream:
                pass
            return True
        except Exception as e:  # noqa: BLE001 — the TTL GC covers it
            logger.debug("export lease %s ack to %x failed (%s); TTL "
                         "covers", lease, iid, e)
            return False

    def missing(self, hashes: list) -> list:
        """The per-block commit state IS the allocator's content-addressed
        registry: a block that committed (this pull, an earlier attempt,
        or any other request) is resident and never re-pulled."""
        resident = self.engine.allocator._by_hash
        return [h for h in hashes if h not in resident]

    def _note_resume(self, kv_span, plane: str, committed: int,
                     remaining: int) -> None:
        kv_span.add_event("pull_resumed", plane=plane, committed=committed,
                          remaining=remaining)
        from dynamo_tpu_torch.worker.metrics import count_metric
        count_metric("kv_pull_resumes")

    @staticmethod
    def _note_corrupt(kv_span, plane: str, err) -> None:
        kv_span.add_event("frame_corrupt", plane=plane, error=str(err))
        from dynamo_tpu_torch.worker.metrics import count_metric
        count_metric("kv_frames_corrupt")

    @staticmethod
    def _note_shard_bytes(kv_span, meta, nbytes: int) -> None:
        """Per-shard byte attrs on the kv_transfer span (wire-v5 frames
        carry their shard index): ``bytes_shard{i}`` sums each shard's
        wire bytes next to the per-plane totals, so an imbalanced or
        stalled shard stream is attributable without a rerun."""
        sh = (meta or {}).get("shard")
        if sh is None:
            return
        try:
            kv_span.set_attr("shards", int(sh["count"]))
            key = f"bytes_shard{int(sh['index'])}"
            kv_span.set_attr(
                key, int(kv_span.attrs.get(key, 0)) + int(nbytes))
        except Exception:  # noqa: BLE001 — accounting must not fail IO
            logger.debug("shard byte accounting failed", exc_info=True)

    async def _pull_blocks_inner(self, hashes: list, iid: int,
                                 bulk_address: str, direct_address: str,
                                 _count_bytes, kv_span, phases) -> None:
        injected = total = 0
        retries = 0
        resumed_blocks = 0  # blocks NOT re-pulled thanks to commit state
        bulk_done = False
        want = self.missing(hashes)
        if len(want) < len(hashes):
            kv_span.set_attr("resident_blocks", len(hashes) - len(want))
        self.last_pull_stats = {"retries": 0, "resumed_blocks": 0,
                                "injected": 0, "corrupt": 0}

        def finish_stats():
            kv_span.set_attr("injected", injected)
            if retries:
                kv_span.set_attr("retries", retries)
                kv_span.set_attr("resumed_blocks", resumed_blocks)
            self.last_pull_stats.update(retries=retries,
                                        resumed_blocks=resumed_blocks,
                                        injected=injected)

        if not want:
            finish_stats()
            return
        now = time.monotonic()
        # prune expired breaker entries: prefill restarts advertise fresh
        # ephemeral ports, so per-address state must not grow unbounded
        self.direct_down_until = {a: t for a, t in
                                   self.direct_down_until.items()
                                   if t > now}
        if (direct_address and self.direct_plane is not None
                and direct_address not in self.direct_down_until):
            offer = None
            try:
                offer_stream = await self.kv_direct_client.direct(
                    {"block_hashes": want}, iid)
                async for o in offer_stream:
                    offer = o
                if offer and offer.get("uuid") is not None:
                    # the network pull runs OUTSIDE the engine's exclusive
                    # window (it touches no engine state) with a timeout —
                    # a stalled transfer connection must never wedge the
                    # decode loop; only the fast device scatter is
                    # exclusive. A timed-out pull abandons its thread,
                    # evicts the connection, opens the circuit breaker for
                    # the address, and falls down the ladder.
                    t0 = time.perf_counter()
                    data = await asyncio.wait_for(
                        asyncio.to_thread(self.direct_plane.pull, offer),
                        timeout=self.direct_pull_timeout)
                    _dt = time.perf_counter() - t0
                    phases["recv_s"] += _dt
                    _count_bytes(getattr(data, "nbytes", 0), "direct")
                    get_kv_bandwidth_book().note(
                        "direct", getattr(data, "nbytes", 0), _dt)
                    # commit in bounded windows, one minimal exclusive
                    # scatter each: decode steps interleave with a large
                    # direct-plane inject instead of stalling behind it
                    metas = [(b[0], b[1], b[2])
                             for b in offer["blocks"]]
                    t0 = time.perf_counter()
                    injected = await inject_device_windowed(
                        self.engine, metas, data[:, :len(metas)])
                    phases["scatter_s"] += time.perf_counter() - t0
                    logger.debug("device-direct pull injected %d blocks "
                                 "from %x", injected, iid)
                    await self._ack_offer(iid, offer["uuid"])
                    finish_stats()
                    return
                # empty offer: blocks evicted remotely OR the peer's offer
                # table is full — fall through to the host planes (the
                # bulk fetch serves the full-table case; the evicted case
                # costs one empty round trip)
            except asyncio.TimeoutError:
                self.direct_plane.evict(offer["address"] if offer
                                         else direct_address)
                self.direct_down_until[direct_address] = (
                    time.monotonic() + self.direct_down_window)
                logger.warning(
                    "device-direct KV pull from %s timed out after %.0fs; "
                    "skipping the plane for %.0fs", direct_address,
                    self.direct_pull_timeout, self.direct_down_window)
            except Exception as e:  # noqa: BLE001 — fall down the ladder
                logger.warning("device-direct KV pull from %s failed (%s); "
                               "trying the bulk plane", direct_address, e)
        # resume budget per host plane: a failed attempt re-pulls only the
        # still-missing blocks before falling down the ladder
        attempts_per_plane = 1 + self.pull_resume_attempts
        if bulk_address:
            from dynamo_tpu_torch.runtime.bulk import prewarm_async
            if bulk_address not in self.bulk_warmed:
                # background warmup: THIS fetch still rides a cold socket,
                # but every later fetch to the peer finds a pooled, ramped
                # connection (and concurrent pulls find extra capacity).
                # A warmup that fails outright un-marks the address so a
                # later pull retries (peer briefly unreachable).
                self.bulk_warmed.add(bulk_address)
                prewarm_async(
                    bulk_address, f"{iid:x}",
                    on_fail=lambda a=bulk_address:
                        self.bulk_warmed.discard(a))
            for attempt in range(attempts_per_plane):
                want = self.missing(hashes)
                if not want:
                    bulk_done = True
                    break
                if attempt:
                    retries += 1
                    resumed_blocks = len(hashes) - len(want)
                    self._note_resume(kv_span, "bulk", resumed_blocks,
                                      len(want))
                pipe = InjectPipeline(self.engine)
                seen_windows: set = set()
                bulk_bytes = [0]  # wire bytes this attempt, for the EWMA

                def on_meta(meta, nbytes):
                    nonlocal total
                    _count_bytes(nbytes, "bulk")
                    bulk_bytes[0] += int(nbytes)
                    self._note_shard_bytes(kv_span, meta, nbytes)
                    if meta.get("shard") is not None:
                        # count each block window once, not per shard slice
                        key = tuple(b[0] for b in meta["blocks"])
                        if key in seen_windows:
                            return
                        seen_windows.add(key)
                    total += len(meta["blocks"])

                try:
                    # stream-and-stage (engine/transfer.pump_bulk_frames):
                    # frames stage/commit while later frames are still on
                    # the wire, wire buffers recycle through the pipeline.
                    # A sharded cache advertises its shard layout so a
                    # same-layout exporter streams per-shard frames
                    # (wire v5) instead of host-gathered merged frames.
                    _recv = await pump_bulk_frames(
                        pipe, bulk_address, KV_EXPORT_ENDPOINT,
                        {"block_hashes": want,
                         "wire": FRAME_WIRE_VERSION,
                         **kv_shard_payload(self.engine)},
                        f"{iid:x}", 60.0, on_meta)
                    phases["recv_s"] += _recv
                    get_kv_bandwidth_book().note(
                        "bulk", bulk_bytes[0], _recv)
                    injected += await pipe.finish()
                    bulk_done = True
                    break
                except FrameIntegrityError as e:
                    # checksum NACK: the corrupted frame was rejected
                    # before staging (never injected) and the stream
                    # aborted; committed frames stay, the resume re-pulls
                    # the rest
                    injected += pipe.injected
                    self.last_pull_stats["corrupt"] += 1
                    self._note_corrupt(kv_span, "bulk", e)
                    logger.warning("bulk KV frame from %s failed checksum "
                                   "(%s); re-pulling missing blocks",
                                   bulk_address, e)
                except Exception as e:  # noqa: BLE001 — bulk plane broke
                    # mid-pull (socket reset, worker bound to 127.0.0.1
                    # across hosts, peer death): resume on this plane,
                    # then the RPC export path below — never waste the
                    # completed remote prefill over a transport problem.
                    # pump already reaped its fetch thread and in-flight
                    # commits; whatever committed cleanly stays (content-
                    # addressed blocks are never wasted, every retry
                    # dedups against them).
                    injected += pipe.injected
                    logger.warning("bulk KV fetch from %s failed (%s); %s",
                                   bulk_address, e,
                                   "resuming missing blocks"
                                   if attempt + 1 < attempts_per_plane
                                   else "falling back to the RPC export "
                                        "path")
                finally:
                    for k, v in pipe.timings.items():
                        phases[k] += v
        if not bulk_done:
            last_err = None
            for attempt in range(attempts_per_plane):
                want = self.missing(hashes)
                if not want:
                    last_err = None
                    break
                if attempt or (bulk_address and injected):
                    # count a ladder/same-plane resume whenever committed
                    # work is being carried over into a new attempt
                    retries += 1
                    resumed_blocks = len(hashes) - len(want)
                    self._note_resume(kv_span, "rpc", resumed_blocks,
                                      len(want))
                def note_blocks(n: int) -> None:
                    nonlocal total
                    total += n

                def note_injected(n: int) -> None:
                    nonlocal injected
                    injected += n

                try:
                    await self._pull_rpc(want, iid, _count_bytes, phases,
                                         note_blocks, note_injected,
                                         kv_span)
                    last_err = None
                    break
                except FrameIntegrityError as e:
                    last_err = e
                    self.last_pull_stats["corrupt"] += 1
                    self._note_corrupt(kv_span, "rpc", e)
                    logger.warning("RPC KV frame from %x failed checksum "
                                   "(%s); re-pulling missing blocks",
                                   iid, e)
                except Exception as e:  # noqa: BLE001 — retried below
                    last_err = e
                    logger.warning("RPC KV fetch from %x failed (%s)",
                                   iid, e)
            if last_err is not None:
                finish_stats()
                raise last_err
        if total:
            logger.debug("injected %d/%d transferred blocks",
                         injected, total)
        finish_stats()

    async def _pull_rpc(self, want: list, iid: int, _count_bytes,
                        phases, note_blocks, note_injected,
                        kv_span=None) -> None:
        """One RPC-plane pull attempt of ``want`` through the staged
        pipeline. Blocks injected are reported through ``note_injected``
        — on the failure path too, so partial commits reaped by the drain
        still count (the caller's resume dedups against them)."""
        from dynamo_tpu_torch.runtime.codec import release_buffer

        kv_stream = await self.kv_client.direct(
            {"block_hashes": want, "wire": FRAME_WIRE_VERSION,
             **kv_shard_payload(self.engine)}, iid)
        # batched two-part frames through the staged pipeline: frame k
        # stages/commits while frame k+1 is still in flight (zero
        # msgpack re-copies). Old exporters answering with the
        # per-block schema ride the same pipeline via add_blocks.
        pipe = InjectPipeline(self.engine)
        seen_windows: set = set()
        rpc_bytes = 0
        rpc_recv = 0.0
        try:
            t0 = time.perf_counter()
            async for frame in kv_stream:
                _dt = time.perf_counter() - t0
                rpc_recv += _dt
                phases["recv_s"] += _dt
                if "_raw" in frame:
                    _count_bytes(len(frame["_raw"]), "rpc")
                    rpc_bytes += len(frame["_raw"])
                    if kv_span is not None:
                        self._note_shard_bytes(kv_span, frame,
                                               len(frame["_raw"]))
                    if frame.get("shard") is not None:
                        key = tuple(b[0] for b in frame["blocks"])
                        if key not in seen_windows:
                            seen_windows.add(key)
                            note_blocks(len(frame["blocks"]))
                        # fall through to staging either way
                    else:
                        note_blocks(len(frame["blocks"]))
                    # pipeline recycles the pooled trailer buffer
                    # once its bytes are consumed
                    await pipe.add_frame(frame, release=release_buffer)
                else:  # pre-batched single-block schema
                    note_blocks(1)
                    await pipe.add_blocks(
                        [BlockPayload.from_wire(frame)])
                t0 = time.perf_counter()
            note_injected(await pipe.finish())
            get_kv_bandwidth_book().note("rpc", rpc_bytes, rpc_recv)
        except BaseException:
            note_injected(await pipe.drain())
            raise
        finally:
            for k, v in pipe.timings.items():
                phases[k] += v

    async def _ack_offer(self, iid: int, uuid: int) -> None:
        """Release the peer's pinned device-direct offer. Retried once —
        a lost ack leaves the gathered array pinned in the peer's HBM
        until its offer TTL — and counted
        (``dynamo_worker_kv_offer_acks_total``)."""
        acked = False
        for attempt in range(2):
            try:
                ack = await self.kv_direct_client.direct(
                    {"ack": int(uuid)}, iid)
                async for _ in ack:
                    pass
                acked = True
                break
            except Exception as e:  # noqa: BLE001 — retry once, then TTL
                logger.debug("device-direct offer ack to %x failed "
                             "(attempt %d: %s)", iid, attempt + 1, e)
        if not acked:
            logger.warning("device-direct offer %s ack to %x failed "
                           "twice; peer unpins at its offer TTL",
                           uuid, iid)
        from dynamo_tpu_torch.worker.metrics import count_metric
        count_metric("kv_offer_acks", "ok" if acked else "failed")


class DisaggDecodeHandler:
    """Wraps a decode engine with the remote-prefill leg."""

    def __init__(self, engine: TorchEngine, drt: DistributedRuntime,
                 namespace: str, prefill_component: str,
                 conf: Optional[DisaggConfig] = None,
                 use_queue: bool = True, queue_timeout: float = 30.0,
                 strategy: str = "decode_first"):
        self.engine = engine
        self.drt = drt
        self.namespace = namespace
        self.prefill_component = prefill_component
        self.conf = conf or DisaggConfig()
        # prefill-queue leg (reference PrefillQueue): jobs go to the first
        # FREE worker; disable to force the direct round-robin leg only
        self.use_queue = use_queue
        self.queue_timeout = queue_timeout
        # "prefill_first": this decode worker only ACCEPTS forwarded
        # requests (kv_transfer_params inbound) and never initiates the
        # remote-prefill leg itself
        self.strategy = strategy
        self._gen_client = None
        self._router: Optional[PushRouter] = None
        self._conf_watch = None
        self._conf_task: Optional[asyncio.Task] = None
        # the transport-ladder pull machinery (device-direct -> bulk ->
        # RPC, resumable, checksum-NACKing) lives in KvBlockPuller so the
        # drain/migration resume path (worker/drain.ResumeAdmission) can
        # reuse it verbatim; clients are attached in start()
        self._puller = KvBlockPuller(self.engine)

    # -- puller surface (delegated; tests monkeypatch/inspect these) -------

    @property
    def _kv_client(self):
        return self._puller.kv_client

    @property
    def _kv_direct_client(self):
        return self._puller.kv_direct_client

    @property
    def _direct_plane(self):
        return self._puller.direct_plane

    @property
    def direct_pull_timeout(self) -> float:
        return self._puller.direct_pull_timeout

    @direct_pull_timeout.setter
    def direct_pull_timeout(self, v: float) -> None:
        self._puller.direct_pull_timeout = v

    @property
    def _direct_down_until(self) -> dict:
        return self._puller.direct_down_until

    @property
    def _bulk_warmed(self) -> set:
        return self._puller.bulk_warmed

    @property
    def last_pull_stats(self) -> dict:
        return self._puller.last_pull_stats

    def _missing_blocks(self, hashes: list) -> list:
        return self._puller.missing(hashes)

    async def _pull_blocks(self, hashes: list, iid: int,
                           bulk_address: str = "",
                           direct_address: str = "",
                           lease: Optional[int] = None) -> None:
        await self._puller.pull_blocks(hashes, iid,
                                       bulk_address=bulk_address,
                                       direct_address=direct_address,
                                       lease=lease)

    async def start(self) -> "DisaggDecodeHandler":
        ns = self.drt.namespace(self.namespace)
        comp = ns.component(self.prefill_component)
        self._gen_client = await comp.endpoint("generate").client()
        self._puller.kv_client = await comp.endpoint(
            KV_EXPORT_ENDPOINT).client()
        self._puller.kv_direct_client = await comp.endpoint(
            KV_EXPORT_DIRECT_ENDPOINT).client()
        self._puller.direct_plane = make_device_transfer_plane(self.engine)
        self._router = PushRouter(self._gen_client, RouterMode.ROUND_ROBIN)
        self._conf_watch = await self.drt.coord.watch_prefix(
            disagg_conf_key(self.namespace))
        for _key, value in self._conf_watch.snapshot:
            self._apply_conf(value)
        self._conf_task = asyncio.create_task(self._conf_loop())
        return self

    async def stop(self) -> None:
        await reap_task(self._conf_task)
        if self._conf_watch is not None:
            try:
                await self._conf_watch.cancel()
            except Exception:
                pass
        for c in (self._gen_client, self._kv_client,
                  self._kv_direct_client):
            if c is not None:
                await c.close()

    def _apply_conf(self, raw: bytes) -> None:
        try:
            self.conf = DisaggConfig.from_json(raw)
            logger.info("disagg conf updated: max_local_prefill_length=%d",
                        self.conf.max_local_prefill_length)
        except Exception:
            logger.exception("bad disagg conf %r", raw)

    async def _conf_loop(self) -> None:
        async for ev in self._conf_watch:
            if ev.type == "put" and ev.value is not None:
                self._apply_conf(ev.value)

    # -- the disagg leg ----------------------------------------------------

    def _use_remote_prefill(self, request: PreprocessedRequest) -> bool:
        if self.strategy == "prefill_first":
            return False
        if not self._gen_client.instance_ids():
            return False
        n = len(request.token_ids)
        if n <= self.conf.max_local_prefill_length:
            return False
        # migration re-issue: the prompt is already (mostly) resident
        # locally — a resume just pulled its pinned KV, or a replay's
        # prefix survives in the cache — so remote prefill would
        # recompute what local admission adopts for free. Gated on
        # resumed_tokens: ordinary requests skip the O(prompt) hash walk
        # on this hot path (admission computes the chain anyway)
        resident = 0
        if request.resumed_tokens:
            resident = self._resumable_blocks(request) \
                * self.engine.allocator.page_size
        return (n - resident) > self.conf.max_local_prefill_length

    async def _queue_prefill(self, preq: PreprocessedRequest
                             ) -> Optional[LLMEngineOutput]:
        """Prefill via the coordinator work queue: push the job, await the
        reply event, pull the KV blocks from whichever prefill worker took
        it. Returns None on timeout/failure (caller falls back to the
        direct round-robin leg, then to local prefill)."""
        from dynamo_tpu_torch.runtime import codec
        # no queue consumers -> don't park the request behind a timeout;
        # the direct round-robin leg handles pre-queue prefill workers
        depth, pullers = await self.drt.coord.queue_depth(
            prefill_queue_name(self.namespace))
        if pullers == 0 and depth == 0:
            return None
        rid = preq.request_id or f"pf-{id(preq):x}"
        subject = prefill_reply_subject(self.namespace, rid)
        # a DISTINCT request id for the queued copy: if this leg times out
        # and the direct leg re-sends rid to the same worker, a late queue
        # pull must not collide in the engine's request_id-keyed state
        preq = PreprocessedRequest.from_dict(preq.to_dict())
        preq.request_id = f"{rid}-q"
        preq.prefill_only = True
        tracer = get_tracer()
        sub = await self.drt.subscribe_events(subject)
        try:
            with tracer.span("prefill", attrs={"remote": True,
                                               "leg": "queue"}) as psp:
                await self.drt.coord.queue_push(
                    prefill_queue_name(self.namespace),
                    codec.pack({"req": preq.to_dict(), "reply": subject,
                                "ttl": self.queue_timeout,
                                # the prefill worker's fragment parents here
                                "trace": psp.headers() or None}))
                try:
                    _subj, reply = await asyncio.wait_for(
                        sub.__anext__(), timeout=self.queue_timeout)
                except asyncio.TimeoutError:
                    logger.warning("prefill queue reply timed out after "
                                   "%.1fs", self.queue_timeout)
                    psp.set_error("prefill queue reply timeout")
                    return None
                tracer.adopt(reply.get(SPANS_FRAME_KEY))
                if not reply.get("out"):
                    return None
                final = LLMEngineOutput.from_dict(reply["out"])
                if final.error:
                    psp.set_error(final.error)
                    return None
            params = final.kv_transfer_params or {}
            hashes = [b[0] for b in params.get("blocks", [])]
            if hashes:
                await self._pull_blocks(
                    hashes, reply["instance_id"],
                    bulk_address=reply.get("bulk_address", ""),
                    direct_address=reply.get("direct_address", ""),
                    lease=params.get("lease"))
            return final
        finally:
            try:
                await sub.cancel()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    def _pick_prefill_instance(self, exclude: set) -> Optional[int]:
        """Round-robin the next prefill instance, skipping ``exclude``
        (failed legs of this request); None when no other instance is
        live."""
        ids = [i for i in sorted(self._gen_client.instance_ids())
               if i not in exclude]
        if not ids:
            return None
        try:
            iid = self._router.select_instance()
        except ConnectionError:
            return None
        return iid if iid not in exclude else ids[0]

    def _resumable_blocks(self, request: PreprocessedRequest) -> int:
        """Leading prompt blocks ALREADY committed locally (a partially
        successful pull) — the local-prefill fallback resumes from them
        via normal prefix-match admission instead of recomputing."""
        try:
            from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
            alloc = self.engine.allocator
            return alloc.peek_prefix(compute_block_hash_for_seq(
                request.token_ids, alloc.page_size))
        except Exception:  # noqa: BLE001 — accounting only
            return 0

    async def _remote_prefill(self, request: PreprocessedRequest
                              ) -> Optional[LLMEngineOutput]:
        """Run the prefill leg; returns the final prefill frame (first token +
        kv_transfer_params) or None on any failure (-> local fallback).
        Tries the prefill queue first (workers pull when free — reference
        PrefillQueue role), then the direct round-robin leg — retried ONCE
        on an alternate instance (deadline budget allowing) before giving
        up, so a single crashed prefill worker doesn't cost the whole
        prompt a local re-prefill. The fallback itself resumes from
        whatever blocks a partial pull already committed (prefix-match
        admission picks them up)."""
        preq = PreprocessedRequest.from_dict(request.to_dict())
        preq.prefill_only = True
        if self.use_queue:
            try:
                final = await self._queue_prefill(preq)
            except Exception as e:  # noqa: BLE001 — queue leg must not fail
                logger.warning("prefill queue leg failed (%s); trying "
                               "direct", e)
                final = None
            if final is not None:
                return final
        tracer = get_tracer()
        tried: set = set()
        for attempt in range(2):
            iid = self._pick_prefill_instance(tried)
            if iid is None:
                break
            if attempt and preq.deadline_unix is not None \
                    and preq.deadline_unix - time.time() <= 0:
                # out of deadline budget: a failover leg would prefill for
                # a caller whose request already expired
                logger.warning("skipping prefill failover: deadline spent")
                break
            try:
                final: Optional[LLMEngineOutput] = None
                # the end-to-end deadline and request id ride the internal
                # hop too (trace context auto-injected by the connection),
                # so a stuck prefill worker can't hold the decode worker
                # past it
                with tracer.span("prefill",
                                 attrs={"remote": True, "leg": "direct",
                                        "instance": f"{iid:x}",
                                        "retries": attempt}) as psp:
                    stream = await self._gen_client.direct(
                        preq.to_dict(), iid,
                        request_headers(preq.deadline_unix,
                                        preq.request_id))
                    async for payload in stream:
                        if isinstance(payload, dict) \
                                and SPANS_FRAME_KEY in payload:
                            tracer.adopt(payload.pop(SPANS_FRAME_KEY))
                        out = LLMEngineOutput.from_dict(payload)
                        if out.finish_reason is not None:
                            final = out
                    if final is None or final.error:
                        psp.set_error((final.error if final is not None
                                       else None)
                                      or "no final prefill frame")
                        raise RuntimeError(
                            (final.error if final is not None else None)
                            or "no final prefill frame")
                params = final.kv_transfer_params or {}
                hashes = [b[0] for b in params.get("blocks", [])]
                if hashes:
                    await self._pull_blocks(hashes, iid,
                                            lease=params.get("lease"))
                if attempt:
                    self._count_failover("ok")
                return final
            except DeadlineExceededError:
                # the request is already expired: a local-prefill fallback
                # would burn the longest class of prompts for a caller
                # that's gone
                raise
            except Exception as e:  # noqa: BLE001 — disagg must never fail
                # a request: any remote-leg error (connection, malformed
                # frame, inject failure) retries an alternate instance,
                # then falls back to local prefill
                tried.add(iid)
                if attempt:
                    self._count_failover("failed")
                retry = (attempt == 0
                         and self._pick_prefill_instance(tried) is not None)
                logger.warning(
                    "remote prefill on %x failed (%s); %s", iid, e,
                    "retrying an alternate instance" if retry
                    else "falling back local",
                    exc_info=not isinstance(e, ConnectionError))
                if not retry and attempt == 0:
                    break
        resumed = self._resumable_blocks(request)
        if resumed:
            logger.info("local prefill fallback resumes from %d committed "
                        "block(s)", resumed)
        return None

    @staticmethod
    def _count_failover(outcome: str) -> None:
        from dynamo_tpu_torch.worker.metrics import count_metric
        count_metric("prefill_failovers", outcome)

    async def _inbound_prefill(self, request: PreprocessedRequest
                               ) -> Optional[LLMEngineOutput]:
        """PREFILL-FIRST inbound leg: the request arrives WITH
        ``kv_transfer_params`` already attached (a prefill worker computed
        the prefix and forwarded the request here — reference:
        ``DisaggregationStrategy.PREFILL_FIRST``,
        ``trtllm/utils/request_handlers/handler_base.py:34-60``). Pull the
        advertised blocks and synthesize the first-token frame; any failure
        returns None and the prompt prefills locally (the blocks are an
        optimization, the token ids are the truth)."""
        params = request.kv_transfer_params or {}
        blocks = params.get("blocks") or []
        if not blocks or "first_token" not in params:
            return None
        request.kv_transfer_params = None  # consumed; never forward again
        try:
            hashes = [b[0] for b in blocks]
            await self._pull_blocks(hashes, int(params.get("instance_id", 0)),
                                    bulk_address=params.get("bulk_address",
                                                            ""),
                                    direct_address=params.get(
                                        "direct_address", ""),
                                    lease=params.get("lease"))
        except Exception as e:  # noqa: BLE001 — prefix pull is best-effort
            logger.warning("inbound prefill block pull failed (%s); "
                           "decoding with local prefill", e)
        return LLMEngineOutput(
            token_ids=[int(params["first_token"])],
            log_probs=([float(params["logprob"])]
                       if params.get("logprob") is not None else None),
            finish_reason=FinishReason.LENGTH)

    async def generate(self, request: PreprocessedRequest,
                       ctx=None) -> AsyncIterator[LLMEngineOutput]:
        first: Optional[LLMEngineOutput] = None
        if getattr(self.engine, "draining", False):
            # a request that raced the drain announcement: don't burn a
            # remote prefill for an engine that will refuse it — the
            # engine's replay marker sends it straight back to the
            # frontend's migration layer
            pass
        elif request.kv_transfer_params:
            first = await self._inbound_prefill(request)
        elif self._use_remote_prefill(request):
            first = await self._remote_prefill(request)
        async for out in _continue_after_first(self.engine, request, first,
                                               ctx):
            yield out


async def _continue_after_first(engine: TorchEngine,
                                request: PreprocessedRequest,
                                first: Optional[LLMEngineOutput],
                                ctx=None) -> AsyncIterator[LLMEngineOutput]:
    """Stream a request on ``engine`` given an optional handed-off FIRST
    token (a completed remote/local prefill leg): emit it, resolve its
    stop conditions (EOS / stop tokens / max_tokens), then decode the rest
    with the token appended to the prompt — the one shared continuation
    for the decode-first, prefill-first-inbound, and prefill-first-local-
    fallback paths, so their stop semantics can never drift apart."""
    if first is not None and first.token_ids:
        tok = first.token_ids[0]
        yield LLMEngineOutput(token_ids=[tok], log_probs=first.log_probs)
        sc = request.stop_conditions
        done = ((not sc.ignore_eos and tok in request.eos_token_ids)
                or (sc.stop_token_ids and tok in sc.stop_token_ids)
                or (sc.max_tokens is not None and sc.max_tokens <= 1))
        if done:
            yield LLMEngineOutput(
                finish_reason=first.finish_reason,
                prompt_tokens=len(request.token_ids),
                completion_tokens=1)
            return
        request = PreprocessedRequest.from_dict(request.to_dict())
        request.token_ids = list(request.token_ids) + [tok]
        # the handed-off token is GENERATED output riding the prompt:
        # penalties keep counting it, and a later graceful drain's
        # resume token counts it in its cumulative tokens_done (the
        # frontend's desync check compares against the client-side
        # stream, which includes it)
        request.resumed_tokens = (request.resumed_tokens or 0) + 1
        if request.stop_conditions.max_tokens is not None:
            request.stop_conditions.max_tokens -= 1
    async for out in engine.generate(request, ctx):
        if (first is not None and out.finish_reason is not None
                and out.completion_tokens is not None):
            # the handed-off first token counts as completion, not prompt
            out.prompt_tokens = (out.prompt_tokens or 1) - 1
            out.completion_tokens = out.completion_tokens + 1
        yield out


class PrefillFirstHandler:
    """PREFILL-FIRST entry: this (prefill) worker receives the request,
    prefills locally, attaches ``kv_transfer_params`` (block hashes + where
    to fetch them + the first token), and forwards the request to a decode
    worker, relaying its stream. The mirror of ``DisaggDecodeHandler``'s
    decode-first flow, selectable per deployment (reference:
    ``handler_base.py:34-60`` ``DisaggregationStrategy``)."""

    def __init__(self, engine: TorchEngine, drt: DistributedRuntime,
                 namespace: str, decode_component: str,
                 instance_id: int = 0, bulk_address: str = "",
                 direct_address: str = ""):
        self.engine = engine
        self.drt = drt
        self.namespace = namespace
        self.decode_component = decode_component
        self.instance_id = instance_id
        self.bulk_address = bulk_address
        self.direct_address = direct_address
        self._decode_client = None
        self._router: Optional[PushRouter] = None

    async def start(self) -> "PrefillFirstHandler":
        comp = self.drt.namespace(self.namespace).component(
            self.decode_component)
        self._decode_client = await comp.endpoint("generate").client()
        self._router = PushRouter(self._decode_client, RouterMode.ROUND_ROBIN)
        return self

    async def stop(self) -> None:
        if self._decode_client is not None:
            await self._decode_client.close()

    async def generate(self, request: PreprocessedRequest,
                       ctx=None) -> AsyncIterator[LLMEngineOutput]:
        if not self._decode_client.instance_ids():
            # no decode workers live: serve the whole request here rather
            # than fail (disagg is an optimization, never a point of
            # failure)
            async for out in self.engine.generate(request, ctx):
                yield out
            return
        preq = PreprocessedRequest.from_dict(request.to_dict())
        preq.request_id = f"{request.request_id}-pf"
        preq.prefill_only = True
        final: Optional[LLMEngineOutput] = None
        stitcher = StageStitcher(get_tracer(), skip_decode=True)
        try:
            async for out in self.engine.generate(preq):
                stitcher.on_frame(out)
                if out.finish_reason is not None:
                    final = out
        finally:
            stitcher.close()
        if final is None or final.error or not final.token_ids:
            logger.warning("local prefill leg failed; serving fully local")
            async for out in self.engine.generate(request, ctx):
                yield out
            return
        fwd = PreprocessedRequest.from_dict(request.to_dict())
        params = dict(final.kv_transfer_params or {})
        # pin the advertised blocks until the decode side acks its pull
        # (or the TTL GC reclaims — decode worker crashed)
        lease = await stamp_export_lease(self.engine, params)
        params["first_token"] = final.token_ids[0]
        if final.log_probs:
            params["logprob"] = final.log_probs[0]
        params["instance_id"] = self.instance_id
        params["bulk_address"] = self.bulk_address
        if self.direct_address:
            params["direct_address"] = self.direct_address
        fwd.kv_transfer_params = params
        relayed = False
        try:
            tracer = get_tracer()
            iid = self._router.select_instance()
            stream = await self._decode_client.direct(
                fwd.to_dict(), iid,
                request_headers(fwd.deadline_unix, fwd.request_id))
            async for payload in stream:
                if isinstance(payload, dict) and SPANS_FRAME_KEY in payload:
                    # decode worker's fragment: adopt so it ships upward
                    # with THIS worker's hop spans
                    tracer.adopt(payload.pop(SPANS_FRAME_KEY))
                out = LLMEngineOutput.from_dict(payload)
                # the decode worker already turned its timing stamps into
                # spans; relaying them would double-stitch queue/prefill
                out.timings = None
                relayed = relayed or bool(out.token_ids)
                yield out
            return
        except DeadlineExceededError:
            raise  # expired request: never restart it locally
        except Exception as e:  # noqa: BLE001 — decode hop failed: the
            # prefix is still cached here, finish the request locally —
            # but ONLY if nothing was relayed yet. After a partial relay a
            # local restart would repeat tokens the client already has;
            # surface the break instead (the frontend's migration layer
            # handles mid-stream worker loss).
            if relayed:
                logger.warning("decode stream broke mid-relay (%s)", e)
                yield LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                      error=f"decode worker lost: {e}")
                return
            logger.warning("decode forward failed (%s); continuing local", e)
            if lease is not None:
                # nobody will ever pull this export: unpin now rather than
                # waiting out the TTL
                from dynamo_tpu_torch.engine.transfer import release_export_lease
                await release_export_lease(self.engine, lease)
            async for out in _continue_after_first(self.engine, request,
                                                   final, ctx):
                yield out


__all__ = ["DisaggDecodeHandler", "PrefillFirstHandler", "DisaggConfig",
           "KvBlockPuller",
           "disagg_conf_key", "KV_EXPORT_ENDPOINT"]
