"""Planner process: ``python -m dynamo_tpu_torch.planner.main``.

Parity: reference ``planner_sla.py`` entrypoint. Scrapes the frontend's
/metrics, predicts load, scales prefill/decode worker fleets through the
chosen connector.
"""

from __future__ import annotations

import argparse
import asyncio
import shlex

from dynamo_tpu_torch.planner.connectors import KvConnector, LocalConnector
from dynamo_tpu_torch.planner.metrics_source import PrometheusSource
from dynamo_tpu_torch.planner.perf_interpolation import PerfInterpolator
from dynamo_tpu_torch.planner.planner_core import Planner, PlannerConfig, SloSpec
from dynamo_tpu_torch.utils.logging import configure_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dynamo_tpu planner")
    p.add_argument("--metrics-url", default="http://127.0.0.1:8080/metrics")
    p.add_argument("--profile", required=True,
                   help="perf profile JSON (see planner/perf_interpolation.py)")
    p.add_argument("--interval", type=float, default=30.0)
    p.add_argument("--predictor", default="ewma",
                   choices=["constant", "ewma", "trend", "seasonal"])
    p.add_argument("--ttft-slo", type=float, default=0.5)
    p.add_argument("--itl-slo", type=float, default=0.05)
    p.add_argument("--min-prefill", type=int, default=1)
    p.add_argument("--max-prefill", type=int, default=16)
    p.add_argument("--min-decode", type=int, default=1)
    p.add_argument("--max-decode", type=int, default=16)
    p.add_argument("--connector", choices=["local", "kv"], default="local")
    p.add_argument("--prefill-cmd", default="",
                   help="command line to spawn one prefill worker (local)")
    p.add_argument("--decode-cmd", default="",
                   help="command line to spawn one decode worker (local)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address (kv connector)")
    p.add_argument("--namespace", default="dynamo")
    # fleet-supervisor knobs (local connector)
    p.add_argument("--no-heal", action="store_true",
                   help="disable crash-healing (supervise counts only)")
    p.add_argument("--term-grace-s", type=float, default=None,
                   help="SIGKILL escalation deadline for a drain-down "
                        "(clamped up to DYN_DRAIN_TIMEOUT_S + margin)")
    p.add_argument("--crash-loop-threshold", type=int, default=5,
                   help="crashes inside the window that trip hold-down")
    p.add_argument("--crash-loop-window-s", type=float, default=60.0)
    p.add_argument("--crash-loop-hold-s", type=float, default=60.0)
    p.add_argument("--worker-log-dir", default=None,
                   help="directory for per-worker log files (default: "
                        "a fresh temp dir)")
    return p


async def amain(args: argparse.Namespace) -> None:
    from dynamo_tpu_torch.planner.perf_interpolation import MultiPerfInterpolator
    # handles both flat and parallelism-sweep profile schemas
    interp = MultiPerfInterpolator.from_file(args.profile)
    source = PrometheusSource(args.metrics_url)
    if args.connector == "local":
        if not args.prefill_cmd or not args.decode_cmd:
            raise SystemExit("--prefill-cmd/--decode-cmd required for local")
        connector = LocalConnector(
            shlex.split(args.prefill_cmd), shlex.split(args.decode_cmd),
            term_grace_s=args.term_grace_s, heal=not args.no_heal,
            crash_loop_threshold=args.crash_loop_threshold,
            crash_loop_window_s=args.crash_loop_window_s,
            crash_loop_hold_s=args.crash_loop_hold_s,
            log_dir=args.worker_log_dir)
    else:
        from dynamo_tpu_torch.planner.metrics_source import QueueAwareSource
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
        drt = await DistributedRuntime.create(coordinator=args.coordinator)
        connector = KvConnector(drt, args.namespace)
        # prefill-queue backlog rides the same coordinator connection
        source = QueueAwareSource(source, drt, args.namespace)
    planner = Planner(
        PlannerConfig(interval_s=args.interval, predictor=args.predictor,
                      min_prefill=args.min_prefill,
                      max_prefill=args.max_prefill,
                      min_decode=args.min_decode,
                      max_decode=args.max_decode),
        SloSpec(ttft_s=args.ttft_slo, itl_s=args.itl_slo),
        interp, source, connector)
    # the planner's own system server (DYN_SYSTEM_ENABLED=1): replicas,
    # decision counts, crash/hold counters on /metrics
    from dynamo_tpu_torch.planner.metrics import get_planner_metrics
    from dynamo_tpu_torch.runtime.system_server import SystemServer
    system = SystemServer.from_env(registry=get_planner_metrics().registry)
    if system is not None:
        system.health.register("planner", ready=True)
        await system.start()
    print("planner running", flush=True)
    try:
        # bootstrap the fleet to the configured floor: Planner.step only
        # calls the connector when a decision DIFFERS from current, and
        # current starts at (min_prefill, min_decode) — without this, an
        # idle start would never spawn the first worker
        await connector.scale(args.min_prefill, args.min_decode)
        await planner.run()
    finally:
        if system is not None:
            await system.stop()
        close = getattr(connector, "close", None)
        if close is not None:
            await close()


def main() -> None:
    configure_logging()
    try:
        asyncio.run(amain(build_parser().parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
