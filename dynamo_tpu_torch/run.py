"""Single-process run CLI: ``python -m dynamo_tpu_torch.run in=<input> out=<engine>``.

The port of ``dynamo_tpu/run.py``: the same inputs, with ``out=torch``
(``TorchEngine``) where the reference has ``out=jax``.

Parity: reference ``launch/dynamo-run`` (``dynamo-run in=[http|text|batch:|
stdin] out=[mocker|echo_full|...]`` — ``launch/dynamo-run/src/main.rs:28``).
One process, no coordinator: build the engine, wrap it in the local pipeline
(preprocess -> engine -> detokenize), and drive it from the chosen input.

  in=http            OpenAI server on --http-port
  in=text            interactive chat REPL
  in=stdin           one prompt per stdin line -> completion per line
  in=batch:FILE      jsonl {"prompt": ...} -> --output jsonl, concurrent
  out=echo           token-echo engine (no model needed)
  out=mocker         simulated engine (timing model, test tokenizer ok)
  out=torch          the PyTorch + CUDA engine (requires --model-path;
                     --device cpu runs the kernels' plain versions)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
import time
from typing import Optional, Tuple

from dynamo_tpu_torch.engine.base import EchoEngine, EngineBase
from dynamo_tpu_torch.llm.pipeline import LocalEnginePipeline
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest, CompletionRequest
from dynamo_tpu_torch.utils.logging import configure_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="dynamo_tpu single-process runner",
        usage="python -m dynamo_tpu_torch.run in=<http|text|stdin|batch:FILE> "
              "out=<echo|mocker|torch> [options]")
    p.add_argument("io", nargs=2, metavar="in=.../out=...",
                   help="input and engine selectors")
    p.add_argument("--model-path", default=None)
    p.add_argument("--model-name", default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (see worker.main --device)")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--output", default="-", help="batch output (jsonl)")
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-num-seqs", type=int, default=32)
    p.add_argument("--max-context", type=int, default=8192)
    p.add_argument("--max-prefill-chunk", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--tensor-parallel-size", type=int, default=1)
    p.add_argument("--speculative-num-tokens", type=int, default=0,
                   help="n-gram prompt-lookup speculative decoding "
                        "(see worker.main --speculative-num-tokens)")
    p.add_argument("--quantize", choices=["", "int8"], default="",
                   help="load-time weight quantization (see worker.main "
                        "--quantize)")
    return p


def parse_io(io) -> Tuple[str, str]:
    spec = {}
    for part in io:
        key, _, val = part.partition("=")
        if key not in ("in", "out") or not val:
            raise SystemExit(f"bad selector {part!r}; expected in=.../out=...")
        spec[key] = val
    if "in" not in spec or "out" not in spec:
        raise SystemExit("both in= and out= are required")
    return spec["in"], spec["out"]


def build_engine_and_card(out: str, args) -> Tuple[EngineBase, ModelDeploymentCard]:
    if out == "echo":
        from dynamo_tpu_torch.utils.testing import make_test_card
        card = (ModelDeploymentCard.from_local_path(args.model_path,
                                                    name=args.model_name)
                if args.model_path else make_test_card(name="echo"))
        return EchoEngine(), card
    if out == "mocker":
        from dynamo_tpu_torch.mocker import MockEngineArgs, MockerEngine
        from dynamo_tpu_torch.utils.testing import make_test_card
        card = (ModelDeploymentCard.from_local_path(args.model_path,
                                                    name=args.model_name)
                if args.model_path else make_test_card(name="mock-model"))
        return MockerEngine(MockEngineArgs(
            num_pages=args.num_pages, page_size=args.page_size,
            max_num_seqs=args.max_num_seqs,
            max_context=args.max_context)), card
    if out == "torch":
        if not args.model_path:
            raise SystemExit("out=torch requires --model-path")
        from dynamo_tpu_torch.models.hub import resolve_model_path
        from dynamo_tpu_torch.worker.main import (
            arm_guided, build_engine, build_parser)
        args.model_path = resolve_model_path(args.model_path)
        card = ModelDeploymentCard.from_local_path(args.model_path,
                                                   name=args.model_name)
        # start from the WORKER parser's own defaults so build_engine's
        # knob set can grow without silently breaking this CLI (found
        # live: a hand-built Namespace was missing every flag added since)
        ns = build_parser().parse_args(["--model-path", args.model_path])
        for k in ("dtype", "num_pages", "page_size", "max_num_seqs",
                  "max_prefill_chunk", "max_context",
                  "tensor_parallel_size", "random_weights",
                  "speculative_num_tokens", "quantize", "device"):
            setattr(ns, k, getattr(args, k))
        engine = build_engine(ns)
        arm_guided(engine, card)
        return engine, card
    raise SystemExit(f"unknown engine {out!r}; choose echo|mocker|torch")


async def run_http(pipeline: LocalEnginePipeline, args) -> None:
    from dynamo_tpu_torch.http.service import HttpService
    from dynamo_tpu_torch.llm.model_manager import ModelManager
    from dynamo_tpu_torch.utils.config import RuntimeConfig
    manager = ModelManager()
    manager.add(pipeline.card.name, pipeline)
    # the single-process server honors the same request-lifecycle knobs as
    # the distributed frontend (DYN_RUNTIME_REQUEST_TIMEOUT_S, shedding
    # high-water marks — see docs/deployment.md)
    try:
        cfg = RuntimeConfig.load()
    except Exception:
        logging.getLogger(__name__).warning(
            "bad runtime config; request-lifecycle knobs use defaults",
            exc_info=True)
        cfg = RuntimeConfig()
    service = await HttpService(manager, host=args.http_host,
                                port=args.http_port,
                                request_timeout_s=cfg.request_timeout_s,
                                max_inflight=cfg.http_max_inflight,
                                max_model_inflight=cfg.http_max_model_inflight,
                                shed_retry_after_s=cfg.http_shed_retry_after_s,
                                ).start()
    print(f"listening on {service.host}:{service.port} "
          f"(model {pipeline.card.name})", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await service.stop()


async def _complete(pipeline: LocalEnginePipeline, prompt: str,
                    max_tokens: int) -> str:
    req = CompletionRequest(model=pipeline.card.name, prompt=prompt,
                            max_tokens=max_tokens)
    parts = []
    async for out in pipeline.generate_completion(req):
        if out.text:
            parts.append(out.text)
    return "".join(parts)


async def run_text(pipeline: LocalEnginePipeline, args) -> None:
    print(f"model: {pipeline.card.name} — interactive chat, ctrl-d to exit",
          flush=True)
    loop = asyncio.get_running_loop()
    history = []
    while True:
        try:
            line = await loop.run_in_executor(None, input, "user> ")
        except (EOFError, KeyboardInterrupt):
            return
        if not line.strip():
            continue
        history.append({"role": "user", "content": line})
        req = ChatCompletionRequest(model=pipeline.card.name,
                                    messages=list(history),
                                    max_tokens=args.max_tokens)
        sys.stdout.write("assistant> ")
        parts = []
        async for chunk in pipeline.generate_chat(req):
            for choice in chunk.choices:
                delta = choice.delta.content if choice.delta else None
                if delta:
                    parts.append(delta)
                    sys.stdout.write(delta)
                    sys.stdout.flush()
        sys.stdout.write("\n")
        history.append({"role": "assistant", "content": "".join(parts)})


async def run_stdin(pipeline: LocalEnginePipeline, args) -> None:
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            return
        line = line.strip()
        if line:
            print(await _complete(pipeline, line, args.max_tokens), flush=True)


async def run_batch(pipeline: LocalEnginePipeline, path: str, args) -> None:
    """jsonl in -> jsonl out with bounded concurrency (parity:
    ``lib/llm/src/entrypoint/input/batch.rs``)."""
    with open(path) as f:
        items = [json.loads(line) for line in f if line.strip()]
    sem = asyncio.Semaphore(args.concurrency)
    out_fh = sys.stdout if args.output == "-" else open(args.output, "w")
    t0 = time.perf_counter()
    done = 0

    async def one(i: int, item: dict) -> dict:
        async with sem:
            text = await _complete(pipeline, item["prompt"],
                                   item.get("max_tokens", args.max_tokens))
            return {"index": i, "prompt": item["prompt"], "text": text}

    try:
        results = await asyncio.gather(
            *[one(i, item) for i, item in enumerate(items)])
        for r in sorted(results, key=lambda r: r["index"]):
            out_fh.write(json.dumps(r) + "\n")
            done += 1
    finally:
        if out_fh is not sys.stdout:
            out_fh.close()
    print(f"batch: {done}/{len(items)} prompts in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr, flush=True)


async def amain(args) -> None:
    inp, out = parse_io(args.io)
    engine, card = build_engine_and_card(out, args)
    await engine.start()
    pipeline = LocalEnginePipeline(card, engine)
    try:
        if inp == "http":
            await run_http(pipeline, args)
        elif inp == "text":
            await run_text(pipeline, args)
        elif inp == "stdin":
            await run_stdin(pipeline, args)
        elif inp.startswith("batch:"):
            await run_batch(pipeline, inp[len("batch:"):], args)
        else:
            raise SystemExit(f"unknown input {inp!r}")
    finally:
        await engine.stop()


def main() -> None:
    configure_logging()
    try:
        asyncio.run(amain(build_parser().parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
