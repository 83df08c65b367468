"""Mocker worker process: serve a simulated engine behind the runtime.

Parity: reference ``components/backends/mocker/src/dynamo/mocker/main.py`` —
full distributed-stack testing (router, planner, fault tolerance) with no
accelerator: real registration, real KV events, real metrics, simulated
timing.
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.llm.register import register_llm, serve_engine
from dynamo_tpu_torch.mocker.engine import MockEngineArgs, MockerEngine
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime.runtime import DEFAULT_COORDINATOR, DistributedRuntime
from dynamo_tpu_torch.utils.logging import configure_logging
from dynamo_tpu_torch.worker.events import kv_events_subject, ordered_kv_publisher


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dynamo_tpu mocker worker")
    p.add_argument("--coordinator", default=DEFAULT_COORDINATOR)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="mocker")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--model-name", default="mock-model")
    p.add_argument("--model-path", default=None,
                   help="optional HF dir for a real tokenizer/card")
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-context", type=int, default=4096)
    p.add_argument("--speedup-ratio", type=float, default=1.0)
    p.add_argument("--no-kv-events", action="store_true")
    return p


async def amain(args: argparse.Namespace) -> None:
    drt = await DistributedRuntime.create(coordinator=args.coordinator)
    if args.model_path:
        card = ModelDeploymentCard.from_local_path(args.model_path,
                                                   name=args.model_name)
    else:
        from dynamo_tpu_torch.utils.testing import make_test_card
        card = make_test_card(name=args.model_name,
                              kv_cache_block_size=args.page_size)
    card.kv_cache_block_size = args.page_size
    try:
        # sample inside the served tokenizer's vocab so detokenization
        # produces real text downstream
        vocab = card.load_tokenizer().vocab_size
    except Exception:
        vocab = 32000
    engine = MockerEngine(MockEngineArgs(
        num_pages=args.num_pages, page_size=args.page_size,
        max_num_seqs=args.max_num_seqs, max_context=args.max_context,
        speedup_ratio=args.speedup_ratio, vocab_size=vocab))
    endpoint = (drt.namespace(args.namespace).component(args.component)
                .endpoint(args.endpoint))
    event_pump = None
    if not args.no_kv_events:
        lease = await drt.primary_lease()
        engine.kv_event_cb, event_pump = ordered_kv_publisher(
            drt, kv_events_subject(args.namespace, args.component),
            lease.lease_id)
    served = await serve_engine(endpoint, engine,
                                stats_provider=lambda:
                                engine.stats().to_dict())
    await register_llm(drt, endpoint, card)
    # same observability surface as the real worker (worker/main.py):
    # counters + stage histogram + flight recorder on the system server
    from dynamo_tpu_torch.runtime.system_server import SystemServer
    from dynamo_tpu_torch.utils.tracing import get_tracer
    from dynamo_tpu_torch.worker.metrics import get_worker_metrics
    tracer = get_tracer()
    if not tracer.service:
        tracer.service = "mocker"
    wm = get_worker_metrics()
    wm.attach_tracer(tracer)
    from functools import partial

    from dynamo_tpu_torch.worker.metrics import engine_dispatch_stats
    wm.engine.attach(partial(engine_dispatch_stats, engine))
    # step flight recorder parity with the real worker: the mocker's
    # simulated dispatches stamp the same ring via ScheduledEngineBase
    wm.steptrace.attach(engine.steptrace.aggregates)
    system = SystemServer.from_env(registry=wm.registry, tracer=tracer,
                                   steptrace=engine.steptrace)
    if system is not None:
        system.health.register("engine", ready=True)
        system.attach_coord(drt.coord)  # 503 /healthz/ready in an outage
        await system.start()
    # graceful drain parity with the real worker: the mocker cannot
    # export KV, so every frozen stream ships an empty (replay) token —
    # fleet tests exercise the announcement/refusal/failover machinery
    from dynamo_tpu_torch.worker.drain import DrainController, install_signal_drain
    drain = DrainController(engine, served=[served],
                            on_drained=drt.runtime.shutdown)
    install_signal_drain(drain)
    if system is not None:
        system.register_drain(drain)
    print(f"mocker worker serving model {card.name}", flush=True)
    try:
        await drt.runtime.wait_shutdown()
    finally:
        if system is not None:
            await system.stop()
        if event_pump is not None:
            event_pump.cancel()
        await engine.stop()
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
