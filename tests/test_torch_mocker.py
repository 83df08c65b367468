"""The port's mocker and the processes around it, against the reference, on
the CPU.

- ``MockerEngine``: the port's and the reference's, with the same args
  and the same requests, stream the same tokens and emit the same KV
  events, request by request; a concurrent batch streams the same tokens
  per request.
- The run CLI: ``out=mocker`` over ``in=batch:FILE`` writes the reference
  CLI's texts (request ids, which the mocker's tokens hash, drawn from one
  seeded sequence in both), and ``python -m dynamo_tpu_torch.run`` serves
  the batch as a process.
- Processes: ``python -m dynamo_tpu_torch.mocker.main`` and
  ``...frontend.echo_worker`` register through the port's
  ``...frontend.coordinator`` and serve chats through the port's frontend.
- Components: the port's metrics aggregator and standalone KV router each
  start against a served port mocker.
"""

import asyncio
import json
import os
import subprocess
import sys
import time
import urllib.request
import uuid

from dynamo_tpu import run as jrun
from dynamo_tpu.mocker import MockEngineArgs as JArgs
from dynamo_tpu.mocker import MockerEngine as JMocker
from dynamo_tpu.protocols import common as jcommon
from dynamo_tpu_torch import run as trun
from dynamo_tpu_torch.mocker import MockEngineArgs, MockerEngine
from dynamo_tpu_torch.protocols import common as tcommon
from tests.procutils import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(num_pages=64, page_size=4, max_num_seqs=8, max_prefill_chunk=16,
            max_context=256, speedup_ratio=1000.0)
PROMPTS = [{"prompt": f"hello world {i} " * (1 + i), "max_tokens": 4 + i}
           for i in range(5)]


def _req(common, tokens, rid, max_tokens, temperature=0.0):
    return common.PreprocessedRequest(
        token_ids=list(tokens), request_id=rid,
        stop_conditions=common.StopConditions(max_tokens=max_tokens),
        sampling_options=common.SamplingOptions(temperature=temperature))


async def _serve(engine, common):
    events = []
    engine.kv_event_cb = lambda evs: events.extend(e.to_dict() for e in evs)
    streams = {}
    try:
        # one at a time: the events' order is the requests'
        for i, n in enumerate((9, 23, 5, 40)):
            req = _req(common, range(1 + i, 1 + i + n), f"seq-{i}", 6 + i)
            streams[req.request_id] = [
                t async for f in engine.generate(req) for t in f.token_ids]
        seq_events = list(events)

        async def one(i):
            req = _req(common, range(50 + i, 70 + 3 * i), f"con-{i}", 12)
            return [t async for f in engine.generate(req)
                    for t in f.token_ids]
        for i, toks in enumerate(await asyncio.gather(
                *[one(i) for i in range(6)])):
            streams[f"con-{i}"] = toks
        stats = engine.stats().to_dict()
    finally:
        await engine.stop()
    return streams, seq_events, stats["kv_stats"]


async def test_engines_match_reference():
    got = await _serve(MockerEngine(MockEngineArgs(**ARGS)), tcommon)
    want = await _serve(JMocker(JArgs(**ARGS)), jcommon)
    assert got[0] == want[0]
    assert [len(got[0][f"seq-{i}"]) for i in range(4)] == [6, 7, 8, 9]
    assert all(len(got[0][f"con-{i}"]) == 12 for i in range(6))
    assert got[1] == want[1]
    assert any(e["stored_blocks"] for e in got[1])
    assert got[2]["kv_total_blocks"] == want[2]["kv_total_blocks"] == 63


def _batch(module, tmp_path, monkeypatch, tag):
    """Rows of ``module.amain`` over the prompts, and the token ids the
    mocker streamed per request id."""
    prompts = tmp_path / "prompts.jsonl"
    prompts.write_text("".join(json.dumps(p) + "\n" for p in PROMPTS))
    out = tmp_path / f"{tag}.jsonl"
    ids = iter(range(1, 1 << 20))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
    streams = {}
    build = module.build_engine_and_card

    def capture(out_name, args):
        engine, card = build(out_name, args)
        inner = engine.generate

        async def generate(req):
            toks = streams.setdefault(req.request_id, [])
            async for frame in inner(req):
                toks.extend(frame.token_ids or [])
                yield frame

        engine.generate = generate
        return engine, card

    monkeypatch.setattr(module, "build_engine_and_card", capture)
    args = module.build_parser().parse_args(
        [f"in=batch:{prompts}", "out=mocker", "--output", str(out)])
    asyncio.run(module.amain(args))
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    return rows, streams


def test_run_cli_batch_matches_reference(tmp_path, monkeypatch, capsys):
    got, got_streams = _batch(trun, tmp_path, monkeypatch, "port")
    want, want_streams = _batch(jrun, tmp_path, monkeypatch, "ref")
    # the texts are the reference's (empty here, as the reference's: the
    # mocker draws ids from its 32000-id vocab, past the test tokenizer's
    # 261), and so are the token ids behind them
    assert got == want
    assert [r["index"] for r in got] == list(range(len(PROMPTS)))
    assert got_streams == want_streams
    assert sorted(len(s) for s in got_streams.values()) == \
        [p["max_tokens"] for p in PROMPTS]
    assert capsys.readouterr().err.count(
        f"batch: {len(PROMPTS)}/{len(PROMPTS)} prompts") == 2
    # and as a process
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run",
         f"in=batch:{tmp_path / 'prompts.jsonl'}", "out=mocker",
         "--output", str(tmp_path / "proc.jsonl")],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"batch: {len(PROMPTS)}/{len(PROMPTS)} prompts" in proc.stderr
    rows = [json.loads(x) for x in
            (tmp_path / "proc.jsonl").read_text().splitlines()]
    assert [r["prompt"] for r in rows] == [p["prompt"] for p in PROMPTS]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def test_mocker_process_serves_chat(tmp_path):
    import chip_smoke as cs
    coord_port, http_port = free_port(), free_port()
    coord = f"127.0.0.1:{coord_port}"
    env = {"OMP_NUM_THREADS": "2"}
    procs = []
    try:
        procs.append(cs.Child("coordinator",
                              "dynamo_tpu_torch.frontend.coordinator",
                              ["--host", "127.0.0.1", "--port",
                               str(coord_port)], str(tmp_path), env))
        procs[-1].wait_for("coordinator listening", timeout=60)
        procs.append(cs.Child(
            "mocker", "dynamo_tpu_torch.mocker.main",
            ["--coordinator", coord, "--speedup-ratio", "100",
             "--page-size", "4"], str(tmp_path), env))
        procs.append(cs.Child(
            "echo", "dynamo_tpu_torch.frontend.echo_worker",
            ["--coordinator", coord, "--model-name", "echo-model"],
            str(tmp_path), env))
        procs.append(cs.Child("frontend", "dynamo_tpu_torch.frontend.main",
                              ["--coordinator", coord, "--http-host",
                               "127.0.0.1", "--http-port", str(http_port)],
                              str(tmp_path), env))
        procs[1].wait_for("mocker worker serving model mock-model", 60)
        procs[2].wait_for("echo worker serving model echo-model", 60)
        procs[3].wait_for("frontend listening", timeout=60)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.monotonic() + 30
        names = set()
        while names != {"mock-model", "echo-model"} and \
                time.monotonic() < deadline:
            with urllib.request.urlopen(f"{base}/v1/models") as r:
                names = {m["id"] for m in json.loads(r.read())["data"]}
            time.sleep(0.1)
        assert names == {"mock-model", "echo-model"}
        chat = {"max_tokens": 6, "temperature": 0,
                "messages": [{"role": "user", "content": "one two three"}]}
        mock = _post(f"{base}/v1/chat/completions",
                     dict(chat, model="mock-model"))
        assert mock["choices"][0]["finish_reason"] in ("length", "stop")
        assert 1 <= mock["usage"]["completion_tokens"] <= 6
        echo = _post(f"{base}/v1/chat/completions",
                     dict(chat, model="echo-model"))
        assert echo["choices"][0]["message"]["content"]
    except Exception:
        for p in procs:
            print(f"--- {p.name}\n{p.tail()}")
        raise
    finally:
        for p in reversed(procs):
            p.stop()


async def _with_mocker(body):
    """A coordinator and a served port mocker in this process; ``body``
    gets (coordinator address, [runtimes to close])."""
    from dynamo_tpu_torch.llm.register import serve_engine
    from dynamo_tpu_torch.runtime.coordinator import Coordinator
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    coord = await Coordinator(port=0).start()
    drts = []
    engine = MockerEngine(MockEngineArgs(num_pages=32, page_size=4,
                                         speedup_ratio=1000.0))
    try:
        wdrt = await DistributedRuntime.create(coordinator=coord.address)
        drts.append(wdrt)
        ep = wdrt.namespace("ns").component("mocker").endpoint("generate")
        await serve_engine(ep, engine,
                           stats_provider=lambda: engine.stats().to_dict())
        await body(coord.address, drts)
    finally:
        await engine.stop()
        for d in drts:
            await d.close()
        await coord.stop()


async def test_metrics_aggregator_scrapes_the_mocker():
    from prometheus_client import generate_latest

    from dynamo_tpu_torch.components.metrics import MetricsAggregator
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

    async def body(address, drts):
        mdrt = await DistributedRuntime.create(coordinator=address)
        drts.append(mdrt)
        agg = await MetricsAggregator(mdrt, "ns", "mocker",
                                      interval_s=0.1).start()
        try:
            text = ""
            for _ in range(100):
                text = generate_latest(agg.registry).decode()
                if "dynamo_worker_kv_total_blocks{" in text:
                    break
                await asyncio.sleep(0.1)
            line = [x for x in text.splitlines()
                    if x.startswith("dynamo_worker_kv_total_blocks{")]
            assert line and float(line[0].split()[-1]) == 31.0, text[-2000:]
        finally:
            await agg.stop()

    await _with_mocker(body)


async def test_router_component_routes_to_the_mocker():
    from dynamo_tpu_torch.components.router import serve_router
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

    async def body(address, drts):
        rdrt = await DistributedRuntime.create(coordinator=address)
        drts.append(rdrt)
        router = await serve_router(rdrt, "ns", "mocker", "router",
                                    block_size=4, stats_interval=0.2)
        try:
            cdrt = await DistributedRuntime.create(coordinator=address)
            drts.append(cdrt)
            client = await (cdrt.namespace("ns").component("router")
                            .endpoint("generate").client())
            await client.wait_for_instances(1, timeout=10)
            req = _req(tcommon, range(1, 10), "r1", 4)
            stream = await client.direct(req.to_dict(),
                                         client.instance_ids()[0])
            toks = [t async for f in stream for t in f.get("token_ids", [])]
            # the mocker's greedy tokens for this request id
            want = await _one(req)
            assert toks == want and len(toks) == 4
        finally:
            await router.close()

    await _with_mocker(body)


async def _one(req):
    engine = MockerEngine(MockEngineArgs(num_pages=32, page_size=4,
                                         speedup_ratio=1000.0))
    try:
        return [t async for f in engine.generate(req) for t in f.token_ids]
    finally:
        await engine.stop()
