"""Planner connectors: how scale decisions become running workers.

Parity: reference ``planner/local_connector.py`` (circus process watchers) and
``kubernetes_connector.py`` (DynamoGraphDeployment CRD patch). Here:

- ``LocalConnector`` is a **fleet supervisor**: it owns worker subprocesses
  directly (no circus dependency) and closes the planner loop over the
  worker lifecycle primitives (readiness, drain) —

  * scale-down drains: a shrink sends ``POST /drain`` to the worker's
    system server (SIGTERM fallback — both enter the graceful-drain path of
    ``worker/drain.py``) and escalates to SIGKILL only after the drain
    budget (``DYN_DRAIN_TIMEOUT_S`` + margin) expires, so a planner
    decision can never lose a stream;
  * scale-up is readiness-gated: a spawned worker only counts toward
    ``counts()`` (and the replicas gauge the capacity math sees) once its
    ``/healthz/ready`` returns 200 — the planner never banks on a worker
    still compiling;
  * crashes heal: a worker that exits without being asked is logged with
    its exit code and log tail, counted
    (``dynamo_planner_worker_crashes_total{role}``), and replaced under a
    decorrelated-jitter restart backoff; K crashes inside a sliding window
    trip a crash-loop hold-down (``_crash_loop_holds_total``) instead of a
    fork bomb.

- ``KvConnector`` publishes the desired counts to the coordinator KV
  (``planner/{namespace}/desired``); a cluster operator (the k8s
  reconciler in deploy/) watches that key and patches the deployment —
  same division of labor as the CRD patch without requiring a k8s API
  in-process.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from dynamo_tpu_torch.planner.metrics import count_metric, set_replicas
from dynamo_tpu_torch.utils.aio import decorrelated_jitter, reap_task
from dynamo_tpu_torch.worker.drain import drain_timeout_s

logger = logging.getLogger(__name__)

ROLES = ("prefill", "decode")


def planner_desired_key(namespace: str) -> str:
    return f"planner/{namespace}/desired"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class WorkerHandle:
    """One supervised worker process."""

    proc: asyncio.subprocess.Process
    role: str
    gen: int                      # spawn ordinal (log file name)
    port: int = 0                 # per-worker system-server port (0 = none)
    log_path: Optional[str] = None
    log_file: Optional[object] = None
    spawned_at: float = 0.0
    ready: bool = False           # /healthz/ready returned 200
    stopping: bool = False        # supervisor asked it to exit
    watch: Optional[asyncio.Task] = field(default=None, repr=False)
    probe: Optional[asyncio.Task] = field(default=None, repr=False)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def log_tail(self, limit: int = 800) -> str:
        if not self.log_path:
            return ""
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - limit))
                return f.read().decode("utf-8", "replace").strip()
        except OSError:
            return ""


class LocalConnector:
    """Spawns/drains/heals local worker processes to match desired counts."""

    def __init__(self, prefill_cmd: Sequence[str], decode_cmd: Sequence[str],
                 term_grace_s: Optional[float] = None,
                 drain_margin_s: float = 5.0,
                 probe_ready: bool = True,
                 heal: bool = True,
                 backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0,
                 crash_loop_threshold: int = 5,
                 crash_loop_window_s: float = 60.0,
                 crash_loop_hold_s: float = 60.0,
                 supervise_interval_s: float = 0.2,
                 probe_interval_s: float = 0.1,
                 log_dir: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None):
        self.prefill_cmd = list(prefill_cmd)
        self.decode_cmd = list(decode_cmd)
        self.term_grace_s = term_grace_s
        self.drain_margin_s = drain_margin_s
        self.probe_ready = probe_ready
        self.heal = heal
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.crash_loop_threshold = crash_loop_threshold
        self.crash_loop_window_s = crash_loop_window_s
        self.crash_loop_hold_s = crash_loop_hold_s
        self.supervise_interval_s = supervise_interval_s
        self.probe_interval_s = probe_interval_s
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="dyn-planner-")
        self.extra_env = dict(extra_env or {})
        self.desired: Dict[str, int] = {r: 0 for r in ROLES}
        self._fleets: Dict[str, List[WorkerHandle]] = {r: [] for r in ROLES}
        self._gen = 0
        # spawns in flight (fork+exec is async): reserved so the heal loop
        # and a concurrent scale() can't both fill the same slot
        self._pending: Dict[str, int] = {r: 0 for r in ROLES}
        self._backoff: Dict[str, float] = {r: 0.0 for r in ROLES}
        self._next_spawn_at: Dict[str, float] = {r: 0.0 for r in ROLES}
        self._crash_times: Dict[str, List[float]] = {r: [] for r in ROLES}
        self._hold_until: Dict[str, float] = {r: 0.0 for r in ROLES}
        self._stop_tasks: set = set()
        self._supervise_task: Optional[asyncio.Task] = None
        self._closed = False

    # -- observed state ---------------------------------------------------

    def counts(self) -> Dict[str, int]:
        """READY workers per role — what the capacity math may bank on."""
        return {r: sum(1 for h in f if h.ready and not h.stopping)
                for r, f in self._fleets.items()}

    def alive_counts(self) -> Dict[str, int]:
        """All live (possibly still-compiling) workers the supervisor owns,
        plus spawns still in flight."""
        return {r: self._pending[r] + sum(1 for h in f if not h.stopping)
                for r, f in self._fleets.items()}

    def held_roles(self) -> List[str]:
        now = time.monotonic()
        return [r for r in ROLES if self._hold_until[r] > now]

    def effective_term_grace_s(self) -> float:
        """SIGKILL escalation deadline for a shrink. Never undercuts the
        drain budget: an explicit ``term_grace_s`` below
        ``DYN_DRAIN_TIMEOUT_S`` + margin would SIGKILL a worker mid-
        migration, losing the very streams the drain was freezing."""
        budget = drain_timeout_s() + self.drain_margin_s
        if self.term_grace_s is None:
            return budget
        return max(self.term_grace_s, budget)

    async def wait_ready(self, role: str, n: int,
                         timeout: float = 60.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while self.counts()[role] < n:
            if asyncio.get_running_loop().time() >= deadline:
                raise TimeoutError(
                    f"{role} pool never reached {n} ready "
                    f"(have {self.counts()[role]})")
            await asyncio.sleep(0.05)

    # -- spawn / readiness ------------------------------------------------

    async def _spawn(self, role: str) -> WorkerHandle:
        cmd = list(self.prefill_cmd if role == "prefill" else self.decode_cmd)
        self._gen += 1
        gen = self._gen
        env = dict(os.environ)
        env.update(self.extra_env)
        port = 0
        if self.probe_ready:
            # every worker gets its own system server: the readiness gate,
            # the drain endpoint, and per-worker /metrics all ride it
            port = _free_port()
            env["DYN_SYSTEM_ENABLED"] = "1"
            env["DYN_SYSTEM_PORT"] = str(port)
        log_path = os.path.join(self.log_dir, f"{role}-g{gen}.log")
        log_file = open(log_path, "ab")
        self._pending[role] += 1
        try:
            proc = await asyncio.create_subprocess_exec(
                *cmd, stdout=log_file, stderr=asyncio.subprocess.STDOUT,
                env=env)
            h = WorkerHandle(proc=proc, role=role, gen=gen, port=port,
                             log_path=log_path, log_file=log_file,
                             spawned_at=time.monotonic())
            self._fleets[role].append(h)
        except BaseException:
            log_file.close()
            raise
        finally:
            self._pending[role] -= 1
        h.watch = asyncio.create_task(self._watch(h))
        if self.probe_ready:
            h.probe = asyncio.create_task(self._probe_ready(h))
        else:
            h.ready = True
            self._update_gauge(role)
        logger.info("spawned %s worker pid=%d port=%d log=%s",
                    role, proc.pid, port, log_path)
        return h

    async def _probe_ready(self, h: WorkerHandle) -> None:
        import aiohttp
        url = f"http://127.0.0.1:{h.port}/healthz/ready"
        timeout = aiohttp.ClientTimeout(total=1.0)
        async with aiohttp.ClientSession(timeout=timeout) as s:
            while not h.stopping:
                try:
                    async with s.get(url) as resp:
                        if resp.status == 200:
                            h.ready = True
                            # a worker that came up clean resets the pool's
                            # restart backoff
                            self._backoff[h.role] = 0.0
                            self._update_gauge(h.role)
                            logger.info("%s worker pid=%d ready",
                                        h.role, h.pid)
                            return
                except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                    pass
                await asyncio.sleep(self.probe_interval_s)

    # -- exit handling / healing ------------------------------------------

    async def _watch(self, h: WorkerHandle) -> None:
        await h.proc.wait()
        self._on_exit(h)

    def _on_exit(self, h: WorkerHandle) -> None:
        if h.probe is not None:
            h.probe.cancel()
        if h.log_file is not None:
            try:
                h.log_file.close()
            except OSError:
                pass
        fleet = self._fleets[h.role]
        if h in fleet:
            fleet.remove(h)
        was_ready = h.ready
        h.ready = False
        self._update_gauge(h.role)
        rc = h.proc.returncode
        if h.stopping:
            logger.info("stopped %s worker pid=%d rc=%s", h.role, h.pid, rc)
            return
        tail = h.log_tail()
        logger.warning("%s worker pid=%d crashed rc=%s%s",
                       h.role, h.pid, rc,
                       f"\n--- log tail ---\n{tail}" if tail else "")
        count_metric("worker_crashes_total", h.role)
        if not self.heal or self._closed:
            return
        now = time.monotonic()
        times = self._crash_times[h.role]
        times.append(now)
        times[:] = [t for t in times if now - t <= self.crash_loop_window_s]
        if (len(times) >= self.crash_loop_threshold
                and self._hold_until[h.role] <= now):
            self._hold_until[h.role] = now + self.crash_loop_hold_s
            count_metric("crash_loop_holds_total")
            logger.error(
                "%s pool crash-looping (%d exits in %.0fs) — holding down "
                "for %.0fs instead of respawning; inspect %s",
                h.role, len(times), self.crash_loop_window_s,
                self.crash_loop_hold_s, self.log_dir)
        # decorrelated jitter: replacements from many crashes spread out
        # instead of hammering the coordinator in lockstep
        self._backoff[h.role] = decorrelated_jitter(
            self._backoff[h.role], self.backoff_base_s, self.backoff_cap_s)
        self._next_spawn_at[h.role] = now + self._backoff[h.role]
        if not was_ready:
            # died while still compiling: likely a config problem, keep the
            # backoff growing rather than resetting on the next spawn
            logger.warning("%s worker pid=%d died before becoming ready",
                           h.role, h.pid)

    async def _supervise(self) -> None:
        """Heal loop: replace crashed workers up to the desired counts,
        respecting restart backoff and crash-loop hold-downs."""
        while not self._closed:
            await asyncio.sleep(self.supervise_interval_s)
            if not self.heal:
                continue
            now = time.monotonic()
            for role in ROLES:
                if self._hold_until[role] > now:
                    continue
                if self._next_spawn_at[role] > now:
                    continue
                if self.alive_counts()[role] < self.desired[role]:
                    try:
                        await self._spawn(role)
                    except Exception:  # noqa: BLE001 — keep supervising
                        logger.exception("heal respawn of %s failed", role)
                        self._backoff[role] = decorrelated_jitter(
                            self._backoff[role], self.backoff_base_s,
                            self.backoff_cap_s)
                        self._next_spawn_at[role] = (
                            time.monotonic() + self._backoff[role])

    def _ensure_supervisor(self) -> None:
        if self._supervise_task is None or self._supervise_task.done():
            self._supervise_task = asyncio.create_task(self._supervise())

    def _update_gauge(self, role: str) -> None:
        set_replicas(role, self.counts()[role])

    # -- shrink (drain-aware) ---------------------------------------------

    async def _drain_request(self, h: WorkerHandle) -> bool:
        """Ask the worker to drain via its system server; True on 2xx."""
        if not h.port:
            return False
        import aiohttp
        try:
            timeout = aiohttp.ClientTimeout(total=2.0)
            async with aiohttp.ClientSession(timeout=timeout) as s:
                async with s.post(
                        f"http://127.0.0.1:{h.port}/drain") as resp:
                    return resp.status < 300
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            return False

    async def _stop_worker(self, h: WorkerHandle) -> None:
        """Graceful drain -> wait out the drain budget -> SIGKILL."""
        grace = self.effective_term_grace_s()
        drained = await self._drain_request(h)
        if not drained:
            # SIGTERM enters the same drain path (install_signal_drain)
            try:
                h.proc.terminate()
            except ProcessLookupError:
                return
        try:
            await asyncio.wait_for(asyncio.shield(h.proc.wait()),
                                   timeout=grace)
        except asyncio.TimeoutError:
            logger.warning(
                "%s worker pid=%d still alive %.1fs after drain request — "
                "escalating to SIGKILL", h.role, h.pid, grace)
            try:
                h.proc.kill()
            except ProcessLookupError:
                pass
            await h.proc.wait()

    def _shrink(self, role: str, n: int) -> None:
        """Drain the n newest workers (oldest keep their warm caches).
        Runs as tracked background tasks so a slow drain never blocks the
        planner loop; ``quiesce()`` awaits them."""
        candidates = [h for h in self._fleets[role] if not h.stopping]
        for h in reversed(candidates[-n:] if n else []):
            h.stopping = True
            self._update_gauge(role)
            task = asyncio.create_task(self._stop_worker(h))
            self._stop_tasks.add(task)
            task.add_done_callback(self._stop_tasks.discard)

    async def quiesce(self) -> None:
        """Wait for every in-flight drain/stop to finish."""
        while self._stop_tasks:
            await asyncio.gather(*list(self._stop_tasks),
                                 return_exceptions=True)

    # -- the connector API -------------------------------------------------

    async def scale(self, prefill: int, decode: int,
                    prefill_config=None, decode_config=None) -> None:
        # process connector: parallelism config changes need a relaunch
        # with different flags; counts-only here
        self._ensure_supervisor()
        self.desired = {"prefill": prefill, "decode": decode}
        for role, want in self.desired.items():
            have = self.alive_counts()[role]
            if want > have:
                for _ in range(want - have):
                    await self._spawn(role)
            elif want < have:
                self._shrink(role, have - want)

    async def close(self, force: bool = False) -> None:
        """Stop everything. ``force`` skips the drain (tests/teardown)."""
        self._closed = True
        self.heal = False
        await reap_task(self._supervise_task)
        self._supervise_task = None
        self.desired = {r: 0 for r in ROLES}
        if force:
            for fleet in self._fleets.values():
                for h in list(fleet):
                    h.stopping = True
                    try:
                        h.proc.kill()
                    except ProcessLookupError:
                        pass
        else:
            for role in ROLES:
                self._shrink(role, len(self._fleets[role]))
        await self.quiesce()
        for fleet in self._fleets.values():
            for h in list(fleet):
                await h.proc.wait()
                self._on_exit(h)


class KvConnector:
    """Publishes desired counts for an external reconciler (k8s operator).

    The supervisor duties split by deployment shape: ``LocalConnector``
    owns the whole lifecycle (spawn/drain/heal) in-process, while here the
    planner only *decides* — the operator watching
    ``planner/{namespace}/desired`` owns readiness gating and restarts
    (k8s probes and pod restart policy are its native forms of the same
    machinery)."""

    def __init__(self, drt, namespace: str):
        self.drt = drt
        self.namespace = namespace

    async def scale(self, prefill: int, decode: int,
                    prefill_config=None, decode_config=None) -> None:
        desired = {"prefill": prefill, "decode": decode}
        if prefill_config:
            desired["prefill_config"] = prefill_config
        if decode_config:
            desired["decode_config"] = decode_config
        await self.drt.coord.put(
            planner_desired_key(self.namespace),
            json.dumps(desired).encode())


__all__ = ["LocalConnector", "KvConnector", "WorkerHandle",
           "planner_desired_key"]
