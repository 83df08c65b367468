"""The port's worker: serve a Llama-tree (dense or MoE), Gemma-2 or
DeepSeek model on ``TorchEngine`` behind the runtime.

The port of ``dynamo_tpu/worker/main.py`` for the aggregated path: connect
the distributed runtime, build the model card, build the engine (config
from the checkpoint directory, weights from its safetensors or a seeded
random init, the paged cache on the card), publish KV events and load
metrics, serve the engine's ``generate`` endpoint and the aux plane
(embeddings, prompt scoring), register the model, and expose the system
server (``DYN_SYSTEM_ENABLED``) with the worker metrics, the flight
recorder and the step timeline. ``build_parser`` is the reference's, flag
for flag and default for default, plus ``--device`` (``cuda``; the tests
pass ``cpu``, where every kernel wrapper computes its plain version).

The KV data plane is the reference's wiring: ``--disagg prefill|decode``
in both ``--disagg-strategy`` values (the prefill role serves its
``kv_export`` endpoint on the RPC plane, the bulk plane ``--bulk-host``
and, on the GPU, the CUDA IPC device-direct plane), ``kv_export`` plus
``ResumeAdmission`` on every non-prefill worker, the KVBM tiers
(``--host-cache-bytes`` / ``--disk-cache-bytes``, refused with
``--disagg decode`` as the reference refuses them), and graceful drain:
SIGTERM and ``POST /drain`` freeze in-flight streams for a survivor to
resume from pulled KV. ``--quantize int8`` and
``--speculative-num-tokens`` (with its n-gram and chain-break knobs) go
into the engine's config as the reference's worker passes them, the disagg
decode role included, and ``--moe-backend`` replaces a MoE config's expert
backend, as the reference's worker does.

Flags whose paths are not ported exit non-zero naming their ROADMAP item:
parallelism over several devices or nodes (A13), GGUF files (A6b).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import logging
import os
import tempfile

import torch
from prometheus_client.core import CounterMetricFamily

from dynamo_tpu_torch.engine.torch_engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.register import register_llm, serve_aux, serve_engine
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.hf_loader import load_hf_params
from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.runtime.runtime import DEFAULT_COORDINATOR, DistributedRuntime
from dynamo_tpu_torch.utils.device import resolve_device
from dynamo_tpu_torch.utils.logging import configure_logging
from dynamo_tpu_torch.worker.events import kv_events_subject, ordered_kv_publisher

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dynamo_tpu_torch worker")
    p.add_argument("--coordinator", default=DEFAULT_COORDINATOR)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="tpu")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--model-path", required=True,
                   help="HF-style model dir (config/tokenizer[/safetensors])")
    p.add_argument("--model-name", default=None)
    p.add_argument("--random-weights", action="store_true",
                   help="skip checkpoint load; random init made on the "
                        "device from seed 0 (dev/benchmarks; not the JAX "
                        "worker's weights)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu (the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-prefill-chunk", type=int, default=1024)
    p.add_argument("--max-context", type=int, default=8192)
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="shard the model over this many local devices "
                        "(not ported: ROADMAP A13)")
    p.add_argument("--data-parallel-size", type=int, default=1,
                   help="shard the batch over this many devices (not "
                        "ported: ROADMAP A13)")
    p.add_argument("--pipeline-parallel-size", type=int, default=1,
                   help="stage the layers over this many devices (not "
                        "ported: ROADMAP A13)")
    p.add_argument("--sequence-parallel-size", type=int, default=1,
                   help="ring-attention sequence parallelism (not ported: "
                        "ROADMAP A13)")
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "pallas", "pallas_unrolled", "scan",
                            "unrolled"],
                   help="the reference's attention A/B switch; the port "
                        "serves auto only (its CUDA kernels on the GPU, "
                        "their plain versions on the CPU)")
    p.add_argument("--quantize", choices=["", "int8"], default="",
                   help="load-time weight quantization: int8 = W8A8 "
                        "dynamic (llama family and gemma-2); halves the "
                        "per-step weight stream")
    p.add_argument("--moe-backend", choices=["dense", "dispatch"],
                   default=None,
                   help="MoE expert compute: dense (every expert, every "
                        "token — decode-batch default) or dispatch "
                        "(capacity-factor token gather — wide-EP)")
    p.add_argument("--host-cache-bytes", type=int, default=0,
                   help="KVBM G2 host-RAM KV tier budget (0 disables)")
    p.add_argument("--disk-cache-bytes", type=int, default=0,
                   help="KVBM G3 disk KV tier budget (0 disables)")
    p.add_argument("--disk-cache-path", default=None,
                   help="KVBM G3 directory (default: this process's own "
                        "under the temporary directory)")
    p.add_argument("--num-top-logprobs", type=int, default=8,
                   help="alternatives computed per sampled token (serves "
                        "OpenAI top_logprobs up to this; 0 disables)")
    p.add_argument("--speculative-num-tokens", type=int, default=0,
                   help="n-gram prompt-lookup speculative decoding: "
                        "verify this many drafted tokens per step (0 "
                        "disables)")
    p.add_argument("--speculative-ngram-max", type=int, default=4,
                   help="largest context-suffix n-gram the prompt-lookup "
                        "proposer matches")
    p.add_argument("--speculative-ngram-min", type=int, default=2,
                   help="smallest n-gram worth matching (1 is aggressive)")
    p.add_argument("--speculative-chain-break", type=int, default=8,
                   help="with speculation on, break a pipelined decode "
                        "chain after this many steps so fresh context "
                        "gets a chance to draft (0 disables chaining)")
    p.add_argument("--decode-multistep", type=int, default=None,
                   help="decode steps fused into one block (one CUDA graph "
                        "replay) with on-device sampling/stop checks "
                        "(default: DYN_DECODE_MULTISTEP or 8; 1 disables "
                        "fusion)")
    p.add_argument("--penalty-window", type=int, default=32,
                   help="device ring-buffer slots per penalized/logit_bias "
                        "row — such rows ride the fused decode block while "
                        "their distinct penalizable ids fit (raise for "
                        "long penalized generations; 0 disables the "
                        "device path and such rows decode per-step)")
    p.add_argument("--guided-table-bytes", type=int, default=8 << 20,
                   help="byte cap for a guided grammar's dense device "
                        "transition table; grammars over the cap degrade "
                        "per-row to per-step decode (fallback reason "
                        "guided_table)")
    p.add_argument("--no-kv-events", action="store_true")
    p.add_argument("--num-nodes", type=int, default=1,
                   help="multi-host: total processes (not ported: ROADMAP "
                        "A13)")
    p.add_argument("--node-rank", type=int, default=0,
                   help="multi-host: this process's rank")
    p.add_argument("--jax-coordinator", default=None,
                   help="multi-host: the reference's jax.distributed "
                        "coordinator address (unused by the port)")
    p.add_argument("--local-devices", type=int, default=None,
                   help="multi-host: local device count override")
    p.add_argument("--disagg", choices=["none", "prefill", "decode"],
                   default="none",
                   help="disaggregated role: prefill workers serve KV "
                        "blocks, decode workers pull them")
    p.add_argument("--prefill-component", default="prefill",
                   help="component name of the prefill workers (decode role)")
    p.add_argument("--disagg-strategy", choices=["decode_first",
                                                 "prefill_first"],
                   default="decode_first",
                   help="disaggregation strategy (see --disagg)")
    p.add_argument("--decode-component", default="tpu",
                   help="component name of the decode workers "
                        "(prefill role, prefill_first strategy)")
    p.add_argument("--data-parallel-rank", type=int, default=None,
                   help="engine-dp rank advertised in load metrics (the "
                        "router's per-rank dp accounting)")
    p.add_argument("--bulk-host", default="127.0.0.1",
                   help="bind host for the bulk KV data plane (prefill "
                        "role; see --disagg)")
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    """Exit naming the ROADMAP item of any flag whose path the port does
    not serve yet (the reference refuses its own unsupported
    combinations the same way: ``SystemExit`` before any engine work)."""
    for flag, val in (("--tensor-parallel-size", args.tensor_parallel_size),
                      ("--data-parallel-size", args.data_parallel_size),
                      ("--pipeline-parallel-size",
                       args.pipeline_parallel_size),
                      ("--sequence-parallel-size",
                       args.sequence_parallel_size),
                      ("--num-nodes", args.num_nodes)):
        if val > 1:
            raise SystemExit(f"{flag} {val}: multi-GPU parallelism is not "
                             "ported yet (ROADMAP A13)")
    if (args.host_cache_bytes > 0 or args.disk_cache_bytes > 0) \
            and args.disagg == "decode":
        raise SystemExit(
            "KVBM tiers with --disagg decode are not supported yet: "
            "the disagg decode path pulls prefixes from prefill "
            "workers and bypasses tier onboarding")
    if args.model_path.endswith(".gguf"):
        raise SystemExit(f"{args.model_path}: GGUF models need the GGUF "
                         "reader port (ROADMAP A6b)")
    if args.attn_impl != "auto":
        raise SystemExit(f"--attn-impl {args.attn_impl}: the port serves "
                         "auto only (its CUDA kernels on the GPU, their "
                         "plain versions on the CPU)")


def arm_guided(engine, card) -> None:
    """Give the engine the tokenizer's byte vocabulary so response_format
    guided decoding works; a failure disables the feature, never the
    process. Shared by the worker and the single-process run CLI."""
    if not hasattr(engine, "enable_guided"):
        return
    try:
        engine.enable_guided(card.load_tokenizer().token_bytes(),
                             card.eos_token_ids)
    except Exception:  # noqa: BLE001 — guided off beats worker down
        logging.getLogger(__name__).exception(
            "guided decoding disabled: token_bytes extraction failed")


def build_engine(args: argparse.Namespace) -> TorchEngine:
    refuse_unported(args)
    device = resolve_device(args.device)
    cfg = ModelConfig.from_pretrained(args.model_path, dtype=args.dtype)
    if args.moe_backend is not None and cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_backend=args.moe_backend)
    engine_cfg = TorchEngineConfig(
        num_pages=args.num_pages, page_size=args.page_size,
        max_num_seqs=args.max_num_seqs,
        max_prefill_chunk=args.max_prefill_chunk,
        max_context=min(args.max_context, cfg.max_position_embeddings),
        num_top_logprobs=args.num_top_logprobs,
        quantize=args.quantize,
        spec_tokens=args.speculative_num_tokens,
        spec_ngram_max=args.speculative_ngram_max,
        spec_ngram_min=args.speculative_ngram_min,
        spec_chain_break=args.speculative_chain_break,
        decode_multistep=args.decode_multistep,
        penalty_window=args.penalty_window,
        guided_table_bytes=args.guided_table_bytes)
    if args.random_weights:
        # the port's own seeded init on the device (torch's generator):
        # not the JAX worker's weights, which come from jax.random
        gen = torch.Generator(device=device).manual_seed(0)
        params = get_family(cfg).init_params(cfg, gen, device=device)
    else:
        params = load_hf_params(cfg, args.model_path, device=device)
    return TorchEngine(cfg, params, engine_cfg, device=device)


def bulk_unix_path(lease_id: int):
    """The prefill worker's same-host bulk socket: under the temporary
    directory (``TMPDIR``) and named by process and lease, so no other
    worker's start unlinks it; None (TCP alone) where the path would
    pass the 107 bytes a unix socket's address holds."""
    path = os.path.join(tempfile.gettempdir(),
                        f"dynamo_tpu_bulk_{os.getpid()}_{lease_id:x}.sock")
    return path if len(os.fsencode(path)) <= 107 else None


class KernelLaunchCollector:
    """Scrape-time counters of the attention kernels:
    ``dynamo_worker_kernel_launches_total{kernel}``, the CUDA launches of
    each kernel wrapper (``ops.kernels.LAUNCHES``; graph replays add what
    their capture launched; zero on the CPU), and
    ``dynamo_worker_attention_calls_total{kernel}``, the engine's
    attention calls per kernel of its family on any device."""

    def __init__(self, engine: TorchEngine):
        self.engine = engine

    def collect(self):
        launches = CounterMetricFamily(
            "dynamo_worker_kernel_launches",
            "CUDA launches of each attention kernel wrapper",
            labels=["kernel"])
        for k, n in sorted(LAUNCHES.items()):
            launches.add_metric([k], float(n))
        calls = CounterMetricFamily(
            "dynamo_worker_attention_calls",
            "The engine's attention calls per kernel of its model family",
            labels=["kernel"])
        for k, n in sorted(self.engine.kernel_launches.items()):
            calls.add_metric([k], float(n))
        return [launches, calls]


async def amain(args: argparse.Namespace) -> None:
    from dynamo_tpu_torch.models.hub import resolve_model_path
    args.model_path = resolve_model_path(args.model_path)
    refuse_unported(args)

    drt = await DistributedRuntime.create(coordinator=args.coordinator)
    card = ModelDeploymentCard.from_local_path(args.model_path,
                                               name=args.model_name)
    card.kv_cache_block_size = args.page_size
    card.num_top_logprobs = args.num_top_logprobs
    endpoint = (drt.namespace(args.namespace).component(args.component)
                .endpoint(args.endpoint))
    engine = build_engine(args)
    # advertise the engine's sparse penalty/logit_bias window so the
    # frontend preprocessor rejects requests the device would truncate
    card.penalty_window = engine.cfg.penalty_window
    arm_guided(engine, card)

    # a dead engine loop takes the worker's registration down with it, so
    # routers stop sending to a zombie
    engine.on_loop_exit = drt.runtime.shutdown
    engine.scheduler.dp_rank = args.data_parallel_rank

    tiered = None
    prefix_reader = None
    if args.host_cache_bytes > 0 or args.disk_cache_bytes > 0:
        from dynamo_tpu_torch.kvbm.manager import (
            TieredEngine, TieredKvConfig, default_disk_path,
            serve_tiered_kv_export)
        from dynamo_tpu_torch.worker.disagg import KV_EXPORT_ENDPOINT
        tiered = TieredEngine(engine, TieredKvConfig(
            host_budget_bytes=max(args.host_cache_bytes, 1),
            disk_budget_bytes=args.disk_cache_bytes,
            disk_path=args.disk_cache_path or default_disk_path()))
        # G4 remote tier: serve this worker's HBM+tier blocks to peers on
        # the same component, and fetch from peers on a local tier miss.
        # The disagg-prefill branch below registers the SAME endpoint name
        # with the tier-aware handler itself.
        g4_ep = (drt.namespace(args.namespace).component(args.component)
                 .endpoint(KV_EXPORT_ENDPOINT))
        if args.disagg != "prefill":
            await g4_ep.serve(serve_tiered_kv_export(tiered))
        g4_lease = await drt.primary_lease()
        tiered.enable_peer_fetch(await g4_ep.client(),
                                 self_instance_id=g4_lease.lease_id)
        # fleet-wide KV reuse: admission onboarding pulls from the
        # best-overlap holder first
        from dynamo_tpu_torch.kv_router.global_index import (
            GlobalPrefixIndexReader)
        prefix_reader = GlobalPrefixIndexReader(drt.kv_store())
        await prefix_reader.start()
        tiered.enable_global_index(prefix_reader)

    from dynamo_tpu_torch.worker.disagg import get_kv_bandwidth_book

    def worker_stats() -> dict:
        d = engine.stats().to_dict()
        if tiered is not None:
            d["kvbm"] = tiered.kvbm_stats()
        # per-plane KV-transfer bandwidth EWMAs (bulk/rpc/direct) so the
        # frontend cost router sees transfer health without a scrape
        bw = get_kv_bandwidth_book().snapshot()
        if bw:
            d["kv_transfer"] = bw
        return d

    event_pump = None
    prefix_pub = None
    if not args.no_kv_events:
        lease = await drt.primary_lease()
        publish_kv, event_pump = ordered_kv_publisher(
            drt, kv_events_subject(args.namespace, args.component),
            lease.lease_id)
        # the same event stream feeds the fleet-wide prefix index in the
        # coordinator kv-store
        from dynamo_tpu_torch.kv_router.global_index import (
            GlobalPrefixPublisher)
        prefix_pub = GlobalPrefixPublisher(drt.kv_store(), lease.lease_id)
        await prefix_pub.start()

        def _kv_event_cb(events, _pub=publish_kv, _gp=prefix_pub):
            _pub(events)
            for ev in events:
                _gp.apply_event(ev)

        engine.kv_event_cb = _kv_event_cb

    handler = None
    prefill_first = args.disagg_strategy == "prefill_first"
    # graceful drain & live migration (worker/drain.py): workers that hold
    # decode streams serve their component's kv_export endpoint so a
    # SURVIVOR can pull a draining peer's pinned sequence KV, and admit
    # inbound resume tokens through ResumeAdmission. Tiered and
    # disagg-prefill workers already serve the endpoint.
    resume_admission = None
    served_main = None
    comp = drt.namespace(args.namespace).component(args.component)
    if args.disagg != "prefill":
        from dynamo_tpu_torch.engine.transfer import serve_kv_export
        from dynamo_tpu_torch.worker.disagg import KV_EXPORT_ENDPOINT
        from dynamo_tpu_torch.worker.drain import ResumeAdmission
        if tiered is None:
            await comp.endpoint(KV_EXPORT_ENDPOINT).serve(
                serve_kv_export(engine))
        resume_admission = ResumeAdmission(
            engine, kv_client=await comp.endpoint(KV_EXPORT_ENDPOINT)
            .client())
    if args.disagg == "decode":
        from dynamo_tpu_torch.worker.disagg import DisaggDecodeHandler
        handler = await DisaggDecodeHandler(
            engine, drt, args.namespace, args.prefill_component,
            # prefill-first decode workers never INITIATE remote prefill —
            # they receive requests with the KV handoff already attached
            use_queue=not prefill_first,
            strategy=args.disagg_strategy).start()
        from dynamo_tpu_torch.llm.register import engine_handler
        await engine.start()
        served_main = await endpoint.serve(
            engine_handler(handler, resume_admission),
            stats_provider=worker_stats)
    elif args.disagg == "prefill" and prefill_first:
        from dynamo_tpu_torch.llm.register import engine_handler
        from dynamo_tpu_torch.worker.disagg import PrefillFirstHandler
        pf_lease = await drt.primary_lease()
        handler = await PrefillFirstHandler(
            engine, drt, args.namespace, args.decode_component,
            instance_id=pf_lease.lease_id).start()
        await engine.start()
        served_main = await endpoint.serve(engine_handler(handler),
                                           stats_provider=worker_stats)
    else:
        served_main = await serve_engine(
            endpoint, tiered if tiered is not None else engine,
            stats_provider=worker_stats,
            resume_admission=resume_admission)
    # the aux plane (embeddings + prompt scoring) rides every worker that
    # serves chat traffic
    if args.disagg != "prefill" or prefill_first:
        await serve_aux(comp, engine)
    bulk_server = None
    queue_worker = None
    if args.disagg == "prefill":
        # the KV block fetch endpoint for decode workers; model_type
        # prefill so frontends don't route chat traffic here. Bulk KV
        # bytes ride the raw-socket plane (runtime/bulk.py); the RPC
        # endpoint stays as the control/fallback path.
        from dynamo_tpu_torch.engine.transfer import (
            serve_kv_export, serve_kv_export_bulk)
        from dynamo_tpu_torch.runtime.bulk import BulkServer
        from dynamo_tpu_torch.worker.disagg import KV_EXPORT_ENDPOINT
        kv_ep = comp.endpoint(KV_EXPORT_ENDPOINT)
        lease = await drt.primary_lease()
        bulk_server = BulkServer(
            host=args.bulk_host,
            unix_path=bulk_unix_path(lease.lease_id),
            ident=f"{lease.lease_id:x}").start()
        if tiered is not None:
            # tier-aware export on BOTH planes
            from dynamo_tpu_torch.kvbm.manager import (
                serve_tiered_kv_export, serve_tiered_kv_export_bulk)
            kv_handler = serve_tiered_kv_export(tiered)
            bulk_handler = serve_tiered_kv_export_bulk(
                tiered, asyncio.get_running_loop())
        else:
            kv_handler = serve_kv_export(engine)
            bulk_handler = serve_kv_export_bulk(
                engine, asyncio.get_running_loop())
        bulk_server.register(KV_EXPORT_ENDPOINT, bulk_handler)
        # device-direct plane (CUDA IPC): blocks move card to card with no
        # host bounce when the decode side shares the host; HBM-resident
        # blocks only, so the tiered export keeps the host planes
        direct_address = ""
        if tiered is None:
            from dynamo_tpu_torch.engine.transfer import (
                KV_EXPORT_DIRECT_ENDPOINT, serve_kv_export_direct)
            from dynamo_tpu_torch.worker.disagg import (
                make_device_transfer_plane)
            plane = make_device_transfer_plane(engine)
            if plane is not None:
                try:
                    plane.host = args.bulk_host
                    direct_address = plane.address
                    await comp.endpoint(KV_EXPORT_DIRECT_ENDPOINT).serve(
                        serve_kv_export_direct(engine, plane))
                except Exception:  # noqa: BLE001 — serving must not die
                    logger.exception("device-direct KV plane unavailable; "
                                     "bulk/RPC planes serve")
                    direct_address = ""
        await kv_ep.serve(kv_handler, bulk_address=bulk_server.address,
                          direct_address=direct_address)
        if prefill_first:
            # prefill-first: THIS worker is the chat entrypoint; decode
            # workers are internal. The handler forwards with our bulk
            # (and device-direct) addresses.
            handler.bulk_address = bulk_server.address
            handler.direct_address = direct_address
            await register_llm(drt, endpoint, card)
        else:
            await register_llm(drt, endpoint, card, model_type="prefill")
            # pull-based prefill queue consumer: decode workers enqueue;
            # the first free prefill worker takes a job
            from dynamo_tpu_torch.worker.disagg import PrefillQueueWorker
            queue_worker = await PrefillQueueWorker(
                tiered if tiered is not None else engine, drt,
                args.namespace, instance_id=lease.lease_id,
                bulk_address=bulk_server.address,
                direct_address=direct_address).start()
    elif args.disagg == "decode" and prefill_first:
        await register_llm(drt, endpoint, card, model_type="decode")
    else:
        await register_llm(drt, endpoint, card)

    from dynamo_tpu_torch.runtime.system_server import SystemServer
    from dynamo_tpu_torch.utils.tracing import get_tracer
    from dynamo_tpu_torch.worker.metrics import (engine_dispatch_stats,
                                                 get_worker_metrics)
    tracer = get_tracer()
    if not tracer.service:
        tracer.service = (f"worker-{args.disagg}" if args.disagg != "none"
                          else "worker")
    wm = get_worker_metrics()
    wm.attach_tracer(tracer)
    if tiered is not None:
        wm.kvbm.attach(tiered.kvbm_stats)
    wm.engine.attach(functools.partial(engine_dispatch_stats, engine))
    wm.steptrace.attach(engine.steptrace.aggregates)
    wm.registry.register(KernelLaunchCollector(engine))
    system = SystemServer.from_env(registry=wm.registry, tracer=tracer,
                                   steptrace=engine.steptrace)
    if system is not None:
        system.health.register("engine", ready=True)
        system.attach_coord(drt.coord)
        await system.start()
    # graceful drain: SIGTERM (and POST /drain on the system server) stops
    # new work via the coordinator announcement, freezes in-flight streams
    # into resume tokens survivors pull the pinned KV for, waits (bounded
    # by DYN_DRAIN_TIMEOUT_S) for the lease acks, then shuts down
    from dynamo_tpu_torch.worker.drain import (DrainController,
                                               install_signal_drain)
    drain_lease = await drt.primary_lease()
    resume_extras = {"instance_id": drain_lease.lease_id}
    if bulk_server is not None:
        resume_extras["bulk_address"] = bulk_server.address
    drain = DrainController(
        engine, served=[se for se in (served_main,) if se is not None],
        resume_extras=resume_extras, on_drained=drt.runtime.shutdown)
    install_signal_drain(drain)
    if system is not None:
        system.register_drain(drain)
    print(f"torch worker serving model {card.name} on {engine.device} "
          f"(disagg={args.disagg})", flush=True)
    try:
        await drt.runtime.wait_shutdown()
    finally:
        if queue_worker is not None:
            await queue_worker.stop()
        if bulk_server is not None:
            bulk_server.stop()
        if system is not None:
            await system.stop()
        if handler is not None:
            await handler.stop()
        if event_pump is not None:
            event_pump.cancel()
        if prefix_pub is not None:
            await prefix_pub.close()
        if prefix_reader is not None:
            await prefix_reader.close()
        await engine.stop()
        await drt.close()


def main() -> None:
    import os
    import sys

    argv = list(sys.argv[1:])
    # planner-chosen parallelism config (the k8s reconciler patches this
    # env on the Deployment); appended last so it overrides static flags
    extra = os.environ.get("DYN_PARALLEL_ARGS", "").split()
    if extra:
        argv += extra
    args = build_parser().parse_args(argv)
    configure_logging()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
