"""Graceful drain & live decode migration: the worker-side lifecycle.

A decode worker leaving the fleet on purpose (SIGTERM, ``POST /drain`` on
the system server, a planner scale-down) should not cost its in-flight
streams a full replay. The drain protocol, end to end:

1. **Announce** — every served endpoint re-puts its instance record with
   ``draining`` set (``ServedEndpoint.announce_draining``); routers exclude
   the instance from selection the moment their watch delivers the re-put,
   while the instance stays directly addressable for KV pulls.
2. **Freeze** — ``engine.drain_migrate`` (``engine/loop.py``) freezes each
   in-flight sequence at a step boundary: commits its full pages to the
   prefix cache, pins them under a TTL'd export lease, and emits a resume
   token (block chain + lease + sampling budgets + this worker's pull
   coordinates) as the stream's last frame. The serving layer relays the
   token and ends the stream through the failover path
   (``StreamMigrationSignal`` -> ``drop``), so the frontend's
   ``MigrationOperator`` re-issues the request on a survivor immediately.
3. **Resume** (survivor side) — ``ResumeAdmission`` pulls the pinned pages
   over the transport ladder (``worker/disagg.KvBlockPuller`` — the same
   machinery the disagg prefill handoff uses), acks the lease, and normal
   prefix-match admission adopts the resident chain: the request admits
   with ``cached_tokens`` covering everything already computed and decode
   continues from the next token — bit-identical for greedy/seeded rows
   (sampling is position-keyed).
4. **Wait & exit** — the draining worker waits (bounded by
   ``DYN_DRAIN_TIMEOUT_S``) for survivors to ack the export leases, then
   shuts its runtime down. A ``kill -9`` at ANY point degrades to the
   crash behavior: keepalive detects the death, lease GC unpins, and the
   migration operator replays from scratch — migration is strictly an
   upgrade, never a new failure mode.

Observability: ``dynamo_worker_drain_state`` (0 serving / 1 draining /
2 drained), ``dynamo_worker_migrated_sequences_total{ok|fallback}`` on the
draining side, ``dynamo_worker_migration_replays_total{mode}`` on the
receiving side, and ``mode``/``resumed_tokens`` attrs on the frontend's
``migration`` trace event.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

logger = logging.getLogger(__name__)

# default bound on the post-freeze wait for survivors to pull + ack the
# pinned KV; past it the worker exits anyway (the TTL GC on nothing — the
# process is dying — and the survivors' resume pulls simply fail over to
# replay). Env DYN_DRAIN_TIMEOUT_S overrides.
DRAIN_TIMEOUT_S = 30.0


def drain_timeout_s() -> float:
    raw = os.environ.get("DYN_DRAIN_TIMEOUT_S")
    if raw is None:
        return DRAIN_TIMEOUT_S
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        logger.warning("malformed DYN_DRAIN_TIMEOUT_S %r; using %.0f",
                       raw, DRAIN_TIMEOUT_S)
        return DRAIN_TIMEOUT_S


def _drain_engine(engine):
    """The object carrying ``drain_migrate`` (unwraps one wrapper layer —
    ``TieredEngine.engine``, ``DisaggDecodeHandler.engine``)."""
    for cand in (engine, getattr(engine, "engine", None)):
        if cand is not None and hasattr(cand, "drain_migrate"):
            return cand
    return None


class ResumeAdmission:
    """Survivor-side half of live migration: turn an inbound resume token
    into resident KV before admission.

    ``engine_handler`` (``llm/register.py``) hands every inbound
    ``kv_transfer_params["migration"]`` token here. The token's block
    chain was committed by the draining worker under the SAME chained
    content hashes this engine computes for the rebuilt prompt (original
    prompt + generated tokens), so after the pull the scheduler's normal
    prefix-match admission adopts the chain — ``cached_tokens`` covers
    everything already computed and the stream continues from the next
    token. Every failure degrades to a replay (the token ids carry the
    whole prompt); resume is an optimization, never a gate."""

    def __init__(self, engine, kv_client=None):
        from dynamo_tpu_torch.worker.disagg import KvBlockPuller

        self.engine = engine
        self.puller = KvBlockPuller(engine, kv_client=kv_client)

    @property
    def kv_client(self):
        return self.puller.kv_client

    @kv_client.setter
    def kv_client(self, client) -> None:
        self.puller.kv_client = client

    async def admit(self, request, token: Dict[str, Any],
                    span=None) -> bool:
        """Pull the token's pinned blocks so admission resumes; returns
        True when the full advertised chain is resident afterwards."""
        blocks = token.get("blocks") or []
        if not blocks or self.engine is None:
            return False
        hashes = [b[0] for b in blocks]
        ok = False
        try:
            missing = self.puller.missing(hashes)
            if missing:
                iid = int(token.get("instance_id", 0) or 0)
                await self.puller.pull_blocks(
                    hashes, iid,
                    bulk_address=str(token.get("bulk_address", "") or ""),
                    lease=token.get("lease"))
            elif token.get("lease") is not None:
                # nothing to pull (all resident) — still ack so the
                # draining worker unpins now instead of at its timeout
                iid = int(token.get("instance_id", 0) or 0)
                await self.puller._ack_export_lease(iid,
                                                    int(token["lease"]))
            ok = not self.puller.missing(hashes)
        except Exception as e:  # noqa: BLE001 — resume must never fail the
            # request: missing blocks just recompute (replay semantics)
            logger.warning("resume pull for %s failed (%s); admission "
                           "falls back to recompute", request.request_id, e)
        if span is not None:
            span.set_attr("resume_blocks", len(blocks))
            span.set_attr("resume_resident",
                          len(blocks) - len(self.puller.missing(hashes)))
            span.set_attr("resume_ok", ok)
        if not ok:
            logger.info(
                "resume admission for %s incomplete (%d/%d blocks "
                "resident); missing prefix recomputes",
                request.request_id,
                len(blocks) - len(self.puller.missing(hashes)), len(blocks))
        return ok


class DrainController:
    """Worker-side drain orchestration: announce -> freeze -> wait -> exit.

    One controller per worker process, shared by the SIGTERM handler, the
    system server's ``POST /drain``, and (in tests) the ``WorkerDrain``
    fault harness — all of them drive the same staged methods, so chaos
    drills exercise exactly the production path. ``drain()`` is
    idempotent: concurrent triggers await the first run."""

    STATE = {"serving": 0, "draining": 1, "drained": 2}

    def __init__(self, engine, served: Iterable = (),
                 resume_extras: Optional[dict] = None,
                 on_drained=None, timeout_s: Optional[float] = None):
        self.engine = engine
        self.served = list(served)
        # the pull coordinates survivors need, stamped into every resume
        # token: this worker's instance id (for kv_export .direct calls)
        # and, when it runs a bulk server, its bulk address
        self.resume_extras = dict(resume_extras or {})
        self.on_drained = on_drained
        self.timeout_s = timeout_s
        self.state = "serving"
        self.counts: Dict[str, int] = {}
        self._task: Optional[asyncio.Task] = None

    # -- state --------------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self.state != "serving"

    def _set_state(self, state: str) -> None:
        self.state = state
        try:
            from dynamo_tpu_torch.worker.metrics import get_worker_metrics
            get_worker_metrics().drain_state.set(self.STATE[state])
        except Exception:  # noqa: BLE001 — accounting never gates the drain
            pass

    # -- staged protocol ----------------------------------------------------

    async def announce(self) -> None:
        """Flag every served endpoint as draining so routers route around
        this worker (new work stops arriving before anything freezes)."""
        for se in self.served:
            try:
                await se.announce_draining()
            except Exception:  # noqa: BLE001 — refusal-and-replay covers
                logger.warning("drain announcement failed", exc_info=True)

    async def freeze(self) -> Dict[str, int]:
        """Freeze the in-flight streams into resume/replay handoffs and
        count them (``dynamo_worker_migrated_sequences_total``)."""
        eng = _drain_engine(self.engine)
        if eng is None:
            self.counts = {"resume": 0, "replay": 0}
            return self.counts
        counts = await eng.drain_migrate(resume_extras=self.resume_extras)
        self.counts = counts
        from dynamo_tpu_torch.worker.metrics import count_metric
        if counts.get("resume"):
            count_metric("migrated_sequences", "ok", inc=counts["resume"])
        if counts.get("replay"):
            count_metric("migrated_sequences", "fallback",
                         inc=counts["replay"])
        return counts

    async def wait_leases(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for survivors to pull + ack the KV the FREEZE pinned
        (bounded). Only the drain's own lease ids are waited on —
        unrelated export leases (an orphaned disagg handoff waiting out
        its TTL, a peer-tier pull) must not stall the exit. Returns True
        when every drain lease was released in time."""
        from dynamo_tpu_torch.engine.transfer import get_export_leases
        eng = _drain_engine(self.engine)
        mgr = get_export_leases(eng) if eng is not None else None
        ids = list(getattr(eng, "_drain_leases", ()) or ())
        if mgr is None or not ids:
            return True
        timeout = drain_timeout_s() if timeout_s is None else timeout_s
        deadline = time.monotonic() + timeout
        while any(mgr.holds(i) for i in ids):
            if time.monotonic() >= deadline:
                logger.warning(
                    "drain timeout (%.1fs): %d drain lease(s) still "
                    "pinned; exiting anyway — survivors fall back to "
                    "replay", timeout,
                    sum(1 for i in ids if mgr.holds(i)))
                return False
            await asyncio.sleep(0.05)
        return True

    # -- the one-shot entrypoint --------------------------------------------

    def trigger(self, reason: str = "signal") -> "asyncio.Task":
        """Start (or join) the drain from a sync context (signal handler,
        HTTP route)."""
        if self._task is None:
            if self.state == "serving":
                # flip synchronously so the caller (signal handler, HTTP
                # route) observes the transition before the task runs
                self._set_state("draining")
            self._task = asyncio.ensure_future(self.drain(reason))
        return self._task

    async def drain(self, reason: str = "request") -> Dict[str, int]:
        if self._task is not None and self._task is not asyncio.current_task():
            return await asyncio.shield(self._task)
        # register ourselves so a concurrent trigger() (SIGTERM racing
        # POST /drain, or either racing a direct drain() call) joins this
        # run instead of starting a second announce/freeze pass
        self._task = asyncio.current_task()
        if self.state == "drained":
            return self.counts
        self._set_state("draining")
        logger.info("graceful drain started (%s)", reason)
        t0 = time.monotonic()
        await self.announce()
        counts = await self.freeze()
        acked = await self.wait_leases(self.timeout_s)
        self._set_state("drained")
        logger.info(
            "drain complete in %.2fs: %d resumable + %d replay stream(s) "
            "handed off%s", time.monotonic() - t0,
            counts.get("resume", 0), counts.get("replay", 0),
            "" if acked else " (lease-ack wait timed out)")
        if self.on_drained is not None:
            try:
                self.on_drained()
            except Exception:  # noqa: BLE001
                logger.exception("on_drained hook failed")
        return counts


def install_signal_drain(controller: DrainController) -> bool:
    """Route SIGTERM into a graceful drain (the k8s/preemption path).
    Returns False when signal handlers cannot be installed here (non-main
    thread, non-unix) — the worker still drains via ``POST /drain``."""
    import signal

    try:
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGTERM,
                                lambda: controller.trigger("SIGTERM"))
        return True
    except (NotImplementedError, RuntimeError, ValueError):
        logger.debug("SIGTERM drain handler unavailable", exc_info=True)
        return False


__all__ = ["ResumeAdmission", "DrainController", "install_signal_drain",
           "drain_timeout_s", "DRAIN_TIMEOUT_S"]
