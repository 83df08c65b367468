"""OpenAI frontend: HTTP service + model discovery + router in one process.

Parity: reference ``components/frontend/src/dynamo/frontend/main.py`` —
flags ``--router-mode {round-robin,random,kv}``, ``--kv-overlap-score-weight``,
``--router-temperature``, ``--http-port``; plus ``--standalone`` to embed a
coordinator (for single-node / dev runs).
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from dynamo_tpu_torch.http.service import HttpService
from dynamo_tpu_torch.llm.model_manager import ModelManager, ModelWatcher
from dynamo_tpu_torch.runtime.push_router import RouterMode
from dynamo_tpu_torch.runtime.resilience import RouterPolicyConfig
from dynamo_tpu_torch.runtime.runtime import DEFAULT_COORDINATOR, DistributedRuntime
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="dynamo_tpu OpenAI frontend")
    parser.add_argument("--coordinator", default=DEFAULT_COORDINATOR)
    parser.add_argument("--standalone", action="store_true",
                        help="embed a coordinator in this process")
    parser.add_argument("--http-host", default="0.0.0.0")
    parser.add_argument("--http-port", type=int, default=8080)
    parser.add_argument("--router-mode", default="round-robin",
                        choices=["round-robin", "random", "kv", "cost"])
    parser.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    parser.add_argument("--router-temperature", type=float, default=0.0)
    parser.add_argument("--no-kv-events", action="store_true",
                        help="KV router predicts cache contents instead of "
                             "subscribing to worker events")
    # fleet-wide KV reuse (docs/deployment.md "Fleet-wide KV reuse"):
    # consult the coordinator-backed global prefix index so prefix-heavy
    # requests route to holders anywhere in the fleet, priced against the
    # kv_transfer plane bandwidth EWMAs
    parser.add_argument("--kv-global-index", action="store_true",
                        help="kv mode: merge the coordinator-backed global "
                             "prefix index into routing, so remote holders "
                             "compete with local cache hits")
    parser.add_argument("--kv-block-bytes", type=int, default=0,
                        help="estimated KV bytes per block for pricing "
                             "remote-prefix transfers (0 disables the "
                             "net-cost credit; set to the workers' "
                             "per-block KV footprint)")
    parser.add_argument("--kv-net-cost-weight", type=float, default=25.0,
                        help="weight of the estimated transfer-seconds term "
                             "when pricing a remote prefix hit against "
                             "local recompute")
    # request-lifecycle robustness knobs; defaults layer through
    # RuntimeConfig (dataclass defaults -> TOML -> DYN_RUNTIME_* env)
    try:
        cfg = RuntimeConfig.load()
    except Exception:
        # a malformed config file/env must not take out --help (or hide
        # the argparse usage behind a traceback); flag values still win
        logger.warning("bad runtime config; using built-in defaults for "
                       "CLI flag defaults", exc_info=True)
        cfg = RuntimeConfig()
    parser.add_argument("--request-timeout-s", type=float,
                        default=cfg.request_timeout_s,
                        help="default end-to-end request deadline in seconds "
                             "(0 disables; per-request nvext.timeout_s or "
                             "X-Request-Timeout override)")
    parser.add_argument("--max-inflight", type=int,
                        default=cfg.http_max_inflight,
                        help="shed (503 + Retry-After) past this many "
                             "concurrent requests (0 = unlimited)")
    parser.add_argument("--max-model-inflight", type=int,
                        default=cfg.http_max_model_inflight,
                        help="per-model concurrent-request high-water mark "
                             "(0 = unlimited)")
    parser.add_argument("--shed-retry-after-s", type=float,
                        default=cfg.http_shed_retry_after_s,
                        help="Retry-After hint on shed responses")
    # SLO targets for goodput accounting (docs/observability.md "Step
    # timeline & goodput"): dynamo_frontend_slo_total judgments per
    # request plus dynamo_frontend_goodput_tokens_total for tokens from
    # requests inside every enabled target
    parser.add_argument("--slo-ttft-s", type=float, default=0.0,
                        help="TTFT SLO target in seconds (0 disables)")
    parser.add_argument("--slo-itl-s", type=float, default=0.0,
                        help="inter-token-latency SLO target in seconds, "
                             "judged against each request's worst "
                             "per-token gap (0 disables)")
    # failure-aware routing knobs (cost + kv modes; see docs/deployment.md
    # "Failure-aware routing")
    parser.add_argument("--breaker-failures", type=int,
                        default=cfg.router_breaker_failures,
                        help="consecutive failures that open an instance's "
                             "circuit breaker")
    parser.add_argument("--breaker-cooldown-s", type=float,
                        default=cfg.router_breaker_cooldown_s,
                        help="breaker open -> half-open probe dwell "
                             "(doubles per re-open)")
    parser.add_argument("--breaker-slow-ttft-s", type=float,
                        default=cfg.router_breaker_slow_ttft_s,
                        help="TTFT at or above this counts as a breaker "
                             "failure (0 disables slow-call accounting)")
    parser.add_argument("--retry-budget", type=float,
                        default=cfg.router_retry_budget,
                        help="retry-budget tokens earned per request (~max "
                             "fraction of requests that may retry/hedge)")
    parser.add_argument("--hedge", action="store_true",
                        default=cfg.router_hedge,
                        help="hedge slow first tokens on the next-best "
                             "instance (first winner cancels the loser)")
    parser.add_argument("--hedge-delay-s", type=float,
                        default=cfg.router_hedge_delay_s,
                        help="fixed hedge delay (0 = observed p95 TTFT)")
    parser.add_argument("--router-stats-interval-s", type=float,
                        default=cfg.router_stats_interval_s,
                        help="worker __stats__ scrape period for the cost "
                             "score")
    return parser


async def amain(args: argparse.Namespace) -> None:
    drt = await DistributedRuntime.create(
        coordinator=args.coordinator, standalone=args.standalone)
    manager = ModelManager()
    policy_config = RouterPolicyConfig(
        breaker_failures=args.breaker_failures,
        breaker_cooldown_s=args.breaker_cooldown_s,
        breaker_slow_ttft_s=args.breaker_slow_ttft_s,
        retry_budget_ratio=args.retry_budget,
        hedge=args.hedge,
        hedge_delay_s=args.hedge_delay_s,
        stats_interval_s=args.router_stats_interval_s,
        net_weight=args.kv_net_cost_weight)
    watcher = ModelWatcher(
        drt, manager,
        router_mode=RouterMode(args.router_mode),
        kv_router_config={
            "overlap_score_weight": args.kv_overlap_score_weight,
            "temperature": args.router_temperature,
            "use_kv_events": not args.no_kv_events,
            "use_global_index": args.kv_global_index,
            "kv_block_bytes": args.kv_block_bytes,
            "net_weight": args.kv_net_cost_weight,
        },
        policy_config=policy_config)
    await watcher.start()
    service = HttpService(
        manager, host=args.http_host, port=args.http_port,
        request_timeout_s=args.request_timeout_s,
        max_inflight=args.max_inflight,
        max_model_inflight=args.max_model_inflight,
        shed_retry_after_s=args.shed_retry_after_s,
        slo_ttft_s=args.slo_ttft_s, slo_itl_s=args.slo_itl_s)
    # control-plane health rides the same /metrics page as request metrics
    # (dynamo_coord_connected, dynamo_coord_reconnects_total, ...) and
    # gates GET /healthz/ready (503 while disconnected, so load balancers
    # route around a control-plane outage)
    service.attach_coord(drt.coord)
    await service.start()
    if args.standalone:
        print(f"coordinator listening on {drt._embedded.address}", flush=True)
    print(f"frontend listening on {service.host}:{service.port}", flush=True)
    try:
        await drt.runtime.wait_shutdown()
    except asyncio.CancelledError:
        pass
    finally:
        await service.stop()
        await watcher.stop()
        await drt.close()


def main() -> None:
    args = build_parser().parse_args()
    configure_logging()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
