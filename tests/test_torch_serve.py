"""The port's serving entry points against the reference, on the CPU.

- Copies: every module the port copies from the reference's JAX-free
  serving half and KV data plane equals its reference file once
  ``dynamo_tpu.`` is rewritten to ``dynamo_tpu_torch.``, but for the named
  overrides listed here, each of which raises naming its ROADMAP item, and
  the named differences of the KV data plane's copies (the engine type,
  the CUDA IPC device-direct plane, bfloat16 blocks carried as uint16).
- ``TorchEngine.embed`` / ``score`` / ``stats`` against ``JaxEngine``'s on
  the same float32 weights: embeddings within 1e-5 of the largest value,
  prompt logprobs within 2e-6 relative (PyTorch's logsumexp sums in
  another order than XLA's), the top-n ids equal; the forward's
  ``logits_window=W`` equals W forwards of window 1. DeepSeek scores
  through its latent forward within 1e-4 (the logit tolerance of
  ``tests/test_torch_deepseek.py``) and refuses embeddings, as the
  reference does.
- The decode knobs resolve from ``RuntimeConfig`` and the short-form env
  on ``TorchEngineConfig`` as on ``JaxEngineConfig``, malformed values
  included.
- The run CLI: ``python -m dynamo_tpu_torch.run in=batch:FILE out=torch
  --device cpu`` gives the reference's ``out=jax`` texts on a checkpoint
  written by transformers.
- Processes: the port's coordinator, frontend and a ``--device cpu``
  worker serve /v1/models, chat (streamed and not), completions with
  echo + logprobs and embeddings over HTTP, the greedy text equal to the
  reference CLI's; the worker's /metrics counts the attention calls. Flags
  whose paths are not ported exit non-zero naming their ROADMAP item; the
  disaggregation and KVBM flags are accepted, KVBM with ``--disagg decode``
  refused as the reference refuses it.
- Speculation, int8 and Gemma-2: the port's worker and the reference's
  build their engines from the same flags (``--speculative-num-tokens``,
  ``--quantize int8``) on a transformers-written Gemma-2 checkpoint and on
  the Llama one, and the engines stream the same greedy tokens; the run
  CLI passes both flags on.
"""

import asyncio
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import jax_engine as jeng_mod
from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.engine import torch_engine as teng_mod
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from tests.procutils import free_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- copies -------------------------------------------------------------------

# every module of the serving path's import closure that the port copies
# (worker/main.py, run.py, engine/transfer.py, kvbm/{manager,prefetch}.py
# and the package __init__ files of frontend/, worker/, protocols/ and
# kvbm/ are the port's own)
COPIES = [
    "backend.py", "model_card.py", "frontend/main.py", "http/__init__.py",
    "http/metrics.py", "http/service.py", "kv_router/__init__.py",
    "kv_router/approx.py", "kv_router/global_index.py",
    "kv_router/indexer.py", "kv_router/recorder.py", "kv_router/router.py",
    "kv_router/scheduler.py", "kvbm/tiers.py", "llm/__init__.py",
    "llm/model_manager.py", "llm/operators.py", "llm/pipeline.py",
    "llm/register.py", "models/hub.py", "preprocessor/__init__.py",
    "preprocessor/preprocessor.py", "preprocessor/sp_tokenizer.py",
    "preprocessor/template.py", "preprocessor/tokenizer.py",
    "preprocessor/tools.py", "protocols/common.py", "protocols/events.py",
    "protocols/openai.py", "protocols/sse.py", "runtime/__init__.py",
    "runtime/bulk.py", "runtime/client.py", "runtime/codec.py",
    "runtime/component.py", "runtime/coordinator.py",
    "runtime/kv_store.py", "runtime/push_router.py",
    "runtime/resilience.py", "runtime/rpc.py", "runtime/runtime.py",
    "runtime/system_server.py", "utils/aio.py", "utils/config.py",
    "utils/logging.py", "utils/tracing.py", "utils/testing.py",
    "worker/disagg.py", "worker/drain.py", "worker/events.py",
    "worker/metrics.py",
]

# module -> [(text before the hunk, text after it, ROADMAP item, why)]: the
# hunk between the two anchors raises in the port instead of reaching a
# module that is not ported
OVERRIDES = {
    "model_card.py": [(
        "        or pass ``tokenizer_path`` explicitly.\n        \"\"\"\n",
        "\n\n\n@dataclass\nclass ModelEntry",
        "A6b", "a GGUF card needs models/gguf.py, which imports jax")],
    "models/hub.py": [(
        "            f\"not an HF repo id\")\n",
        "\n\n\ndef _looks_like_repo_id",
        "A6b", "a hub download is not part of the port: it loads local "
               "checkpoints (nothing may be downloaded where it runs)")],
}

# module -> [(reference text, port text, why)]: the named differences of
# the KV data plane's copies, each substituted into the reference (every
# occurrence) before the comparison
_DDTP_REF = ("    return _kv_bw_book\n\n\n", "def disagg_conf_key(")
NAMED = {
    "runtime/bulk.py": [
        ("""        for sk in self._socks:
            try:
                sk.close()""", """        for sk in self._socks:
            # shutdown first: it wakes the accept thread blocked on sk (a
            # close alone does not), whose frame holds this server
            try:
                sk.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sk.close()""",
         "stop() wakes its accept thread, which held the server, its "
         "handlers and the engine their closures hold"),
        ("""        for c in list(self._conns):
            try:
                c.close()""", """        for c in list(self._conns):
            # likewise for a connection thread blocked in recv on c (a
            # client pools its connection)
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()""",
         "stop() wakes its connection threads, blocked in recv on a "
         "client's pooled connection"),
    ],
    "worker/disagg.py": [
        ("from dynamo_tpu_torch.engine.jax_engine import JaxEngine",
         "from dynamo_tpu_torch.engine.torch_engine import TorchEngine",
         "the port's engine"),
        ("JaxEngine", "TorchEngine", "the port's engine in type hints"),
        (_DDTP_REF, None,
         "the device-direct plane is CUDA IPC on a CUDA cache, None on the "
         "CPU (the reference: jax.experimental.transfer, None without it)"),
    ],
    "kvbm/tiers.py": [
        ("from dynamo_tpu_torch.engine.transfer import BlockPayload\n",
         "from dynamo_tpu_torch.engine.transfer import BlockPayload, "
         "host_dtype\n", "bfloat16 blocks ride as uint16 on the host"),
        ("str(block.data.dtype)", "block.dtype",
         "the block's wire dtype name, not its host carrier's"),
        ("np.frombuffer(raw, dtype=np.dtype(dtype))",
         "np.frombuffer(raw, dtype=host_dtype(dtype))",
         "a bfloat16 file reads into uint16"),
        ("parent_hash=parent, data=arr.reshape(shape))",
         "parent_hash=parent, data=arr.reshape(shape),\n"
         "                            dtype=dtype)",
         "the read block keeps its dtype name"),
    ],
}

# module -> lines of comments or docstrings reworded in the copy: the
# reference's comments there cite its own review rounds and pull requests,
# or the JAX transfer API the port replaces (the code on those lines is
# unchanged: the test compares syntax trees too)
REWORDED = {"http/service.py": 2, "kv_router/approx.py": 1,
            "llm/operators.py": 1, "preprocessor/preprocessor.py": 1,
            "preprocessor/sp_tokenizer.py": 2, "runtime/codec.py": 1,
            "runtime/coordinator.py": 4, "runtime/resilience.py": 1,
            "worker/disagg.py": 3, "worker/drain.py": 1,
            "worker/metrics.py": 1}


def _prose_lines(text: str) -> set:
    """Line numbers (0-based) inside comments and string literals."""
    import io
    import tokenize
    out = set()
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type in (tokenize.COMMENT, tokenize.STRING):
            out.update(range(tok.start[0] - 1, tok.end[0]))
    return out


def _code(text: str) -> str:
    """The syntax tree without docstrings."""
    import ast
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(getattr(body[0], "value", None), ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:]
    return ast.dump(tree)


def _rewrite(text: str) -> str:
    import re
    return re.sub(r"\bdynamo_tpu\.", "dynamo_tpu_torch.", text)


def _cut(text: str, before: str, after: str):
    a = text.index(before) + len(before)
    b = text.index(after, a)
    return text[:a] + text[b:], text[a:b]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference(rel):
    with open(os.path.join(REPO, "dynamo_tpu", rel)) as f:
        ref = _rewrite(f.read())
    with open(os.path.join(REPO, "dynamo_tpu_torch", rel)) as f:
        port = f.read()
    for before, after, item, _why in OVERRIDES.get(rel, []):
        ref, _ = _cut(ref, before, after)
        port, hunk = _cut(port, before, after)
        assert "raise " in hunk and f"ROADMAP {item}" in hunk, hunk
    for old, new, _why in NAMED.get(rel, []):
        if new is None:  # a whole function: cut the same span from both
            ref, _ = _cut(ref, *old)
            port, _ = _cut(port, *old)
            continue
        assert old in ref and new in port, (old, new)
        ref = ref.replace(old, new)
    ref_lines, port_lines = ref.splitlines(), port.splitlines()
    assert len(port_lines) == len(ref_lines)
    differ = [i for i, (a, b) in enumerate(zip(ref_lines, port_lines))
              if a != b]
    assert len(differ) == REWORDED.get(rel, 0), differ
    if differ:
        # reworded prose only: the code is the reference's
        assert set(differ) <= _prose_lines(ref) & _prose_lines(port), differ
        assert _code(port) == _code(ref)


def test_copies_cover_the_serving_closure():
    """Every ``dynamo_tpu_torch`` import inside a copy, function-level
    ones included, resolves to a module of the port: the copies' import
    closure is complete (the overrides removed the only others)."""
    import ast
    import importlib.util
    for rel in COPIES:
        with open(os.path.join(REPO, "dynamo_tpu_torch", rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("dynamo_tpu_torch"):
                assert importlib.util.find_spec(node.module), \
                    f"{rel}:{node.lineno} imports {node.module}"


# -- embed, score, stats --------------------------------------------------------

SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=64, min_prefill_bucket=4)


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = JModelConfig.tiny(), ModelConfig.tiny()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     params)
    jeng = JaxEngine(jcfg, params, JaxEngineConfig(attn_impl="scan",
                                                   **SIZES))
    teng = TorchEngine(cfg, tllama.params_from_jax(np_tree, cfg,
                                                   device="cpu"),
                       TorchEngineConfig(**SIZES), device="cpu")
    return jeng, teng


def _token_lists():
    rng = np.random.default_rng(5)
    return [list(map(int, rng.integers(1, 256, size=n)))
            for n in (13, 1, 40, 64)]


def test_embed_matches_jax_engine(engines):
    jeng, teng = engines
    toks = _token_lists()
    want = asyncio.run(jeng.embed(toks))
    got = asyncio.run(teng.embed(toks))
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_score_matches_jax_engine(engines):
    jeng, teng = engines
    toks = _token_lists()
    before = teng.kernel_launches["paged_prefill"]
    want = asyncio.run(jeng.score(toks))
    got = asyncio.run(teng.score(toks))
    # one chunk of 256 per forward, every layer through the prefill
    # kernel's wrapper
    assert teng.kernel_launches["paged_prefill"] - before == \
        teng.model_cfg.num_layers
    assert len(got) == len(want)
    for (lps, tids, tlps), (jl, jt, jtl), t in zip(got, want, toks):
        assert lps.shape == (len(t),) and tids.shape == (len(t), 8)
        assert lps[0] == 0.0 and np.all(tids[0] == 0)
        np.testing.assert_allclose(lps, jl, rtol=2e-6, atol=0)
        np.testing.assert_array_equal(tids, jt)
        np.testing.assert_allclose(tlps, jtl, rtol=2e-6, atol=0)


def test_score_refuses_past_its_cap(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="raise max_context"):
        asyncio.run(teng.score([[1] * 65]))


def test_stats_match_jax_engine(engines):
    jeng, teng = engines
    t, j = teng.stats(), jeng.stats()
    assert t.worker_stats.moe_dropped_tokens == 0
    assert t.to_dict().keys() == j.to_dict().keys()
    assert t.to_dict()["worker_stats"] == j.to_dict()["worker_stats"]


@pytest.mark.parametrize("W", [2, 5])
def test_logits_window_equals_single_windows(W):
    cfg = ModelConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    B, S, ps = 2, 8, 4
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, 256, (B, S)).astype(np.int32))
    positions = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    new = torch.tensor([S, S - 2], dtype=torch.int32)

    def run(n, window):
        pages = tllama.make_pages(cfg, 5, ps)
        return tllama.forward(params, cfg, tokens, positions, pages, table,
                              n, n, logits_window=window)[0]

    win = run(new, W)
    assert win.shape == (B, W, cfg.vocab_size)
    for j in range(W):
        one = run(new - W + 1 + j, 1)
        assert torch.equal(win[:, j], one), j


# -- decode knobs -------------------------------------------------------------

KNOB_ENVS = [
    {},
    {"DYN_DECODE_MULTISTEP": "4"},
    {"DYN_DECODE_MULTISTEP": "0"},
    {"DYN_DECODE_MULTISTEP": "four"},
    {"DYN_RUNTIME_DECODE_MULTISTEP": "3"},
    {"DYN_RUNTIME_DECODE_MULTISTEP": "3", "DYN_DECODE_MULTISTEP": "5"},
    {"DYN_RUNTIME_DECODE_MULTISTEP": "three"},
    {"DYN_MIXED_BATCH": "0"},
    {"DYN_MIXED_BATCH": "off"},
    {"DYN_RUNTIME_MIXED_BATCH": "false"},
    {"DYN_RUNTIME_MIXED_BATCH": "false", "DYN_MIXED_BATCH": "yes"},
    {"DYN_DECODE_PROGRESS": "3"},
    {"DYN_DECODE_PROGRESS": "-1"},
    {"DYN_DECODE_PROGRESS": "x"},
    {"DYN_RUNTIME_DECODE_PROGRESS_EVERY": "5"},
]


@pytest.mark.parametrize("env", KNOB_ENVS,
                         ids=[",".join(f"{k}={v}" for k, v in e.items())
                              or "defaults" for e in KNOB_ENVS])
def test_decode_knobs_resolve_as_reference(monkeypatch, env):
    for k in list(os.environ):
        if k.startswith("DYN_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fn in ("decode_multistep_default", "mixed_batch_default",
               "decode_progress_default"):
        assert getattr(teng_mod, fn)() == getattr(jeng_mod, fn)(), fn
    jcfg, cfg = JModelConfig.tiny(), ModelConfig.tiny()
    jeng = JaxEngine(jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(0)),
                     JaxEngineConfig(attn_impl="scan", **SIZES))
    teng = TorchEngine.random_init(cfg, TorchEngineConfig(**SIZES),
                                   device="cpu")
    for knob in ("decode_multistep", "mixed_batch", "decode_progress_every"):
        assert getattr(teng.scheduler.cfg, knob) == \
            getattr(jeng.scheduler.cfg, knob), knob
    # an explicit value wins over the env, as in the reference
    pinned = TorchEngine.random_init(
        cfg, TorchEngineConfig(decode_multistep=2, mixed_batch=True,
                               decode_progress_every=4, **SIZES),
        device="cpu")
    assert (pinned.multistep, pinned.scheduler.cfg.mixed_batch,
            pinned.scheduler.cfg.decode_progress_every) == (2, True, 4)


# -- the run CLI and the processes --------------------------------------------

PROMPTS = [{"prompt": "one two three one two three", "max_tokens": 8},
           {"prompt": "hello world", "max_tokens": 6},
           {"prompt": "the quick brown fox", "max_tokens": 5}]
ENGINE_FLAGS = ["--dtype", "float32", "--num-pages", "64", "--page-size",
                "4", "--max-num-seqs", "4", "--max-prefill-chunk", "16",
                "--max-context", "128"]


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env["OMP_NUM_THREADS"] = "2"
    return env


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The reference's test tokenizer and chat template beside a random
    tiny Llama checkpoint written by transformers."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from dynamo_tpu_torch.utils.testing import make_test_model_dir
    path = str(tmp_path_factory.mktemp("model") / "m")
    make_test_model_dir(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    hf = LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, eos_token_id=cfg["eos_token_id"],
        bos_token_id=None)
    torch.manual_seed(0)
    LlamaForCausalLM(hf).eval().save_pretrained(path, safe_serialization=True)
    return path


def _run_batch(module, out, model_dir, tmp_path, extra):
    prompts = tmp_path / "prompts.jsonl"
    prompts.write_text("".join(json.dumps(p) + "\n" for p in PROMPTS))
    dest = tmp_path / f"{module}.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", module, f"in=batch:{prompts}", f"out={out}",
         "--model-path", model_dir, "--output", str(dest)]
        + ENGINE_FLAGS + extra,
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"batch: {len(PROMPTS)}/{len(PROMPTS)} prompts" in proc.stderr
    return [json.loads(line) for line in dest.read_text().splitlines()]


@pytest.fixture(scope="module")
def reference_texts(model_dir, tmp_path_factory):
    rows = _run_batch("dynamo_tpu.run", "jax", model_dir,
                      tmp_path_factory.mktemp("ref"), [])
    return [r["text"] for r in rows]


def test_run_cli_matches_reference(model_dir, reference_texts, tmp_path):
    rows = _run_batch("dynamo_tpu_torch.run", "torch", model_dir, tmp_path,
                      ["--device", "cpu"])
    assert [r["index"] for r in rows] == list(range(len(PROMPTS)))
    assert [r["prompt"] for r in rows] == [p["prompt"] for p in PROMPTS]
    assert [r["text"] for r in rows] == reference_texts
    assert all(reference_texts)


def test_run_cli_refuses_mocker(model_dir):
    from dynamo_tpu_torch import run
    args = run.build_parser().parse_args(["in=text", "out=mocker"])
    with pytest.raises(SystemExit, match="ROADMAP A14"):
        run.build_engine_and_card("mocker", args)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read().decode()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def test_processes_serve_over_http(model_dir, reference_texts, tmp_path):
    import chip_smoke as cs
    coord_port, http_port, sys_port = free_port(), free_port(), free_port()
    coord = f"127.0.0.1:{coord_port}"
    env = _env()
    procs = []
    try:
        procs.append(cs.Child("coordinator",
                              "dynamo_tpu_torch.runtime.coordinator",
                              ["--host", "127.0.0.1", "--port",
                               str(coord_port)], str(tmp_path), env))
        procs[-1].wait_for("coordinator listening", timeout=120)
        procs.append(cs.Child(
            "worker", "dynamo_tpu_torch.worker.main",
            ["--coordinator", coord, "--model-path", model_dir,
             "--device", "cpu"] + ENGINE_FLAGS, str(tmp_path),
            dict(env, DYN_SYSTEM_ENABLED="1", DYN_SYSTEM_PORT=str(sys_port))))
        procs.append(cs.Child("frontend", "dynamo_tpu_torch.frontend.main",
                              ["--coordinator", coord, "--http-host",
                               "127.0.0.1", "--http-port", str(http_port)],
                              str(tmp_path), env))
        procs[1].wait_for("torch worker serving model", timeout=120)
        procs[2].wait_for("frontend listening", timeout=120)
        base = f"http://127.0.0.1:{http_port}"
        name = None
        deadline = time.monotonic() + 60
        while name is None and time.monotonic() < deadline:
            models = json.loads(_get(f"{base}/v1/models"))["data"]
            name = models[0]["id"] if models else time.sleep(0.2)
        assert name == "m"

        p = PROMPTS[0]
        comp = json.loads(_post(f"{base}/v1/completions", {
            "model": name, "prompt": p["prompt"],
            "max_tokens": p["max_tokens"], "temperature": 0}))
        assert comp["choices"][0]["text"] == reference_texts[0]
        assert comp["usage"]["completion_tokens"] <= p["max_tokens"]

        chat = {"model": name, "max_tokens": 6, "temperature": 0,
                "messages": [{"role": "user", "content": "one two three"}]}
        full = json.loads(_post(f"{base}/v1/chat/completions", chat))
        streamed, finish = [], None
        for line in _post(f"{base}/v1/chat/completions",
                          dict(chat, stream=True)).splitlines():
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            for choice in json.loads(line[6:])["choices"]:
                streamed.append((choice.get("delta") or {}).get("content")
                                or "")
                finish = choice.get("finish_reason") or finish
        msg = full["choices"][0]
        assert "".join(streamed) == msg["message"]["content"]
        assert finish == msg["finish_reason"] in ("length", "stop")

        echo = json.loads(_post(f"{base}/v1/completions", {
            "model": name, "prompt": "hello", "max_tokens": 1, "echo": True,
            "logprobs": 2, "temperature": 0}))
        lp = echo["choices"][0]["logprobs"]
        assert lp["token_logprobs"][0] is None
        assert all(np.isfinite(x) for x in lp["token_logprobs"][1:])
        assert len(lp["top_logprobs"][1]) == 2

        emb = json.loads(_post(f"{base}/v1/embeddings",
                               {"model": name, "input": ["hello", "fox"]}))
        vecs = [d["embedding"] for d in emb["data"]]
        assert len(vecs) == 2 and all(len(v) == 64 for v in vecs)

        metrics = _get(f"http://127.0.0.1:{sys_port}/metrics")
        calls = {k: float(line.split()[-1]) for line in metrics.splitlines()
                 for k in ("paged_decode", "paged_prefill")
                 if line.startswith("dynamo_worker_attention_calls_total")
                 and f'kernel="{k}"' in line}
        assert calls["paged_decode"] > 0 and calls["paged_prefill"] > 0
    except BaseException:
        for proc in procs:
            print(f"--- {proc.name}\n{proc.tail()}")
        raise
    finally:
        for proc in reversed(procs):
            proc.stop()


@pytest.mark.parametrize("flags,item", [
    (["--tensor-parallel-size", "2"], "A13"),
    (["--data-parallel-size", "2"], "A13"),
    (["--sequence-parallel-size", "2"], "A13"),
])
def test_worker_refuses_unported_flags(model_dir, flags, item):
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.worker.main",
         "--model-path", model_dir, "--device", "cpu",
         "--coordinator", f"127.0.0.1:{free_port()}"] + flags,
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode != 0
    assert f"ROADMAP {item}" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("flags", [
    ["--disagg", "prefill"],
    ["--disagg", "prefill", "--disagg-strategy", "prefill_first"],
    ["--disagg", "decode"],
    ["--disagg", "decode", "--disagg-strategy", "prefill_first"],
    ["--host-cache-bytes", "1048576", "--disk-cache-bytes", "1048576"],
    ["--disagg", "decode", "--speculative-num-tokens", "3"],
    ["--quantize", "int8", "--speculative-num-tokens", "2"],
    ["--moe-backend", "dispatch"],
])
def test_worker_accepts_kv_data_plane_flags(flags):
    """The disaggregated roles in both strategies and the KVBM tiers pass
    the worker's refusal check; KVBM with ``--disagg decode`` is refused
    as the reference refuses it."""
    from dynamo_tpu_torch.worker.main import build_parser, refuse_unported
    args = build_parser().parse_args(["--model-path", "m"] + flags)
    refuse_unported(args)
    bad = build_parser().parse_args(
        ["--model-path", "m", "--disagg", "decode", "--host-cache-bytes",
         "1"])
    with pytest.raises(SystemExit, match="--disagg decode"):
        refuse_unported(bad)


def test_deepseek_scores_and_refuses_embeddings():
    """DeepSeek (latent attention + MoE) scores through its latent
    prefill forward's logits window, as the reference's engine does; it
    has no ``encode`` in the reference, so embeddings are refused in
    both."""
    from tests.test_torch_deepseek import _both
    jcfg, jparams, cfg, params = _both()
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(attn_impl="scan",
                                                    **SIZES))
    teng = TorchEngine(cfg, params, TorchEngineConfig(**SIZES), device="cpu")
    toks = _token_lists()[:3]
    for eng in (jeng, teng):
        with pytest.raises(NotImplementedError, match="no embedding path"):
            asyncio.run(eng.embed(toks))
    want = asyncio.run(jeng.score(toks))
    got = asyncio.run(teng.score(toks))
    assert teng.kernel_launches["mla_prefill"] == cfg.num_layers
    for (lps, tids, _), (jl, jt, _) in zip(got, want):
        np.testing.assert_allclose(lps, jl, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tids[:, 0], jt[:, 0])


@pytest.fixture(scope="module")
def gemma_dir(tmp_path_factory):
    """A random tiny Gemma-2 checkpoint written by transformers."""
    from transformers import Gemma2Config, Gemma2ForCausalLM
    path = str(tmp_path_factory.mktemp("gemma") / "g")
    hf = Gemma2Config(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, rms_norm_eps=1e-6,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        query_pre_attn_scalar=24, sliding_window=8)
    torch.manual_seed(1)
    Gemma2ForCausalLM(hf).eval().save_pretrained(path,
                                                 safe_serialization=True)
    return path


@pytest.mark.async_timeout(180)
@pytest.mark.parametrize("which", ["gemma", "llama"])
async def test_worker_engines_speculate_and_quantize_as_reference(
        which, gemma_dir, model_dir):
    """``build_engine`` of both workers on the same flags: a speculating
    int8 engine over the checkpoint, fed the same prompts, streams the
    same greedy tokens in both packages."""
    from dynamo_tpu.protocols.common import (
        PreprocessedRequest as JRequest, SamplingOptions as JSampling,
        StopConditions as JStop)
    from dynamo_tpu.worker import main as jworker
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest as TRequest, SamplingOptions as TSampling,
        StopConditions as TStop)
    from dynamo_tpu_torch.worker import main as tworker
    path = gemma_dir if which == "gemma" else model_dir
    flags = ["--model-path", path, "--quantize", "int8",
             "--speculative-num-tokens", "3", "--speculative-ngram-min",
             "1"] + ENGINE_FLAGS
    teng = tworker.build_engine(
        tworker.build_parser().parse_args(flags + ["--device", "cpu"]))
    jeng = jworker.build_engine(jworker.build_parser().parse_args(flags))
    assert teng.spec_K == jeng.spec_K == 3
    assert teng.params["layers"]["wq_q"].dtype == torch.int8
    assert teng.model_cfg.model_type == (
        "gemma2" if which == "gemma" else "llama")
    prompts = [[5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7], [9, 3, 1, 4, 2]]

    async def serve(eng, Req, Samp, Stop):
        async def one(i):
            req = Req(token_ids=prompts[i], request_id=f"q{i}",
                      stop_conditions=Stop(max_tokens=8),
                      sampling_options=Samp(temperature=0.0),
                      eos_token_ids=[])
            return [t async for f in eng.generate(req) for t in f.token_ids]
        try:
            return await asyncio.gather(*(one(i) for i in range(2)))
        finally:
            await eng.stop()

    want = await serve(jeng, JRequest, JSampling, JStop)
    got = await serve(teng, TRequest, TSampling, TStop)
    assert got == want and all(len(t) == 8 for t in got)


def test_run_cli_passes_spec_and_quantize(model_dir, monkeypatch):
    """``run.py``'s ``--speculative-num-tokens`` and ``--quantize`` reach
    the worker's engine builder."""
    from dynamo_tpu_torch import run
    from dynamo_tpu_torch.worker import main as tworker
    seen = {}

    def fake_build(ns):
        seen.update(vars(ns))
        raise SystemExit("stop here")
    monkeypatch.setattr(tworker, "build_engine", fake_build)
    args = run.build_parser().parse_args(
        ["in=text", "out=torch", "--model-path", model_dir, "--device",
         "cpu", "--quantize", "int8", "--speculative-num-tokens", "2"])
    with pytest.raises(SystemExit, match="stop here"):
        run.build_engine_and_card("torch", args)
    assert seen["quantize"] == "int8" and seen["speculative_num_tokens"] == 2
