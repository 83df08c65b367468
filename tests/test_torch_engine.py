"""``TorchEngine`` against ``JaxEngine`` end to end on the CPU, and the
port's package rules.

- Engine parity: the same weights and the same greedy requests through
  ``JaxEngine(attn_impl="scan", decode_multistep=1, pipeline_decode=False)``
  and ``TorchEngine(device="cpu")``, configured per step the same way
  (``tests/test_torch_multistep.py`` holds the fused path), must stream
  identical token ids and finish reasons. The requests cross
  ``max_prefill_chunk``, one arrives after decoding has begun (mixed
  prefill + decode steps), and a later one shares an earlier prompt's
  prefix (a prefix-cache hit).
- Sampled parity: unseeded (the batch-wide draw), seeded, penalized,
  biased, min-p and guided requests must stream the same tokens in both
  engines (the port draws JAX's threefry noise with the reference's key
  schedule), and a seeded request the same alone as in a batch.
- Admission: the port refuses only what ``JaxEngine`` refuses.
- Import hygiene: every module of ``dynamo_tpu_torch`` imports with JAX
  made unimportable, and loads nothing of ``dynamo_tpu``; no import
  statement of the port or of ``chip_smoke.py`` names either.
- Device rule: without a GPU, an entry point not told ``device="cpu"``
  raises.
"""

import asyncio
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.engine.guided import (compile_guided, initial_state,
                                            step)
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)
from tests.test_torch_guided import EOS, SCHEMA, byte_vocab

# small CPU shapes: keep torch off the cores other test workers time on
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=64, min_prefill_bucket=4, mixed_batch=True,
             decode_progress_every=2)


def _engines():
    jcfg, cfg = JModelConfig.tiny(), ModelConfig.tiny()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     params)
    jeng = JaxEngine(jcfg, params, JaxEngineConfig(
        attn_impl="scan", decode_multistep=1, pipeline_decode=False,
        **SIZES))
    teng = TorchEngine(cfg, tllama.params_from_jax(np_tree, cfg,
                                                   device="cpu"),
                       TorchEngineConfig(decode_multistep=1,
                                         pipeline_decode=False, **SIZES),
                       device="cpu")
    return jeng, teng


def _prompts():
    rng = np.random.default_rng(11)
    p = {f"r{i}": list(map(int, rng.integers(1, 256, size=n)))
         for i, n in enumerate([40, 10, 7, 0, 20])}
    # r3 shares r0's first 24 tokens: six full pages of 4
    p["r3"] = p["r0"][:24] + list(map(int, rng.integers(1, 256, size=6)))
    return p


MAX_TOKENS = {"r0": 12, "r1": 8, "r2": 6, "r3": 8, "r4": 5}


async def _workload(engine, Req, Samp, Stop):
    prompts = _prompts()
    out = {}
    started = asyncio.Event()

    async def run(rid, wait=False):
        if wait:
            await started.wait()
        req = Req(token_ids=list(prompts[rid]), request_id=rid,
                  stop_conditions=Stop(max_tokens=MAX_TOKENS[rid]),
                  sampling_options=Samp(temperature=0.0))
        toks, last = [], None
        async for frame in engine.generate(req):
            toks += frame.token_ids
            last = frame
            if rid == "r0" and len(toks) >= 2:
                started.set()
        started.set()
        out[rid] = (toks, last.finish_reason.value, last.cached_tokens)

    try:
        await asyncio.gather(run("r0"), run("r1"), run("r2", wait=True))
        await asyncio.gather(run("r3"), run("r4"))
    finally:
        await engine.stop()
    return out


@pytest.mark.async_timeout(180)
async def test_engine_greedy_streams_match_jax_engine():
    jeng, teng = _engines()
    ref = await _workload(jeng, JRequest, JSampling, JStop)
    got = await _workload(teng, TRequest, TSampling, TStop)
    for rid in MAX_TOKENS:
        assert got[rid][:2] == ref[rid][:2], rid
        assert len(got[rid][0]) == MAX_TOKENS[rid]
    # the prefix-cache hit happened in both engines, equally, and the
    # load metrics a router scrapes agree
    assert got["r3"][2] == ref["r3"][2] > 0
    assert teng.stats().to_dict() == jeng.stats().to_dict()
    # every step shape ran: prefill-only, mixed (ragged) and decode
    assert teng.mixed_steps > 0
    assert all(n > 0 for n in teng.kernel_launches.values()), \
        teng.kernel_launches


# the sampled workload: phase 1 has no per-row extras (the batch-wide
# draw), phase 2 mixes every option, phase 3 replays s0 alone
SAMPLED = {
    "u0": dict(temperature=1.0, top_p=0.9),
    "u1": dict(temperature=1.0, top_p=0.9),
    "s0": dict(temperature=0.8, seed=1234),
    "s1": dict(temperature=0.8, seed=0),
    "fp": dict(temperature=0.9, frequency_penalty=0.8, presence_penalty=0.6,
               logit_bias={5: 2.5}),
    "rp": dict(temperature=0.0, repetition_penalty=1.3),
    "lb": dict(temperature=1.0, logit_bias={17: 100.0}),
    "mp": dict(temperature=1.2, min_p=0.1),
    "g": dict(temperature=0.7, guided=SCHEMA),
    "s0-alone": dict(temperature=0.8, seed=1234),
}
PHASES = (("u0", "u1"), ("s0", "s1", "fp", "rp", "lb", "mp", "g"),
          ("s0-alone",))


def _sampled_prompts():
    rng = np.random.default_rng(23)
    p = {rid: list(map(int, rng.integers(1, 256, size=n)))
         for rid, n in zip(SAMPLED, [9, 14, 20, 6, 11, 17, 8, 12, 5])}
    p["s0-alone"] = p["s0"]
    return p


async def _sampled(engine, Req, Samp, Stop):
    prompts, out = _sampled_prompts(), {}

    async def run(rid):
        req = Req(token_ids=prompts[rid], request_id=rid,
                  stop_conditions=Stop(max_tokens=24 if rid == "g" else 10),
                  sampling_options=Samp(**SAMPLED[rid]),
                  eos_token_ids=[EOS] if rid == "g" else [])
        toks, last = [], None
        async for frame in engine.generate(req):
            toks += frame.token_ids
            last = frame
        out[rid] = (toks, last.finish_reason.value)

    try:
        for phase in PHASES:
            await asyncio.gather(*(run(rid) for rid in phase))
    finally:
        await engine.stop()
    return out


@pytest.fixture(scope="module")
def sampled_streams():
    jeng, teng = _engines()
    toks = byte_vocab(ModelConfig.tiny().vocab_size)
    for eng in (jeng, teng):
        eng.enable_guided(toks, [EOS])
    ref = asyncio.run(_sampled(jeng, JRequest, JSampling, JStop))
    got = asyncio.run(_sampled(teng, TRequest, TSampling, TStop))
    return ref, got, toks


@pytest.mark.parametrize("rid", list(SAMPLED))
def test_sampled_streams_match_jax_engine(sampled_streams, rid):
    ref, got, _toks = sampled_streams
    assert got[rid] == ref[rid]
    assert got[rid][1] != "error", got[rid]


def test_sampled_streams_do_what_was_asked(sampled_streams):
    _ref, got, toks = sampled_streams
    assert got["lb"][0] == [17] * 10             # +100 bias forces the id
    assert got["s0"][0] != got["s1"][0]          # other seed, other stream
    # the guided stream is legal JSON of the schema, or a legal prefix
    ids = [t for t in got["g"][0] if t != EOS]
    text = b"".join(toks[t] for t in ids).decode()
    g = compile_guided(SCHEMA)
    st = initial_state(g)
    for b in text.encode():
        st = step(g, st, b)
        assert st is not None, text
    if got["g"][1] == "eos":
        doc = json.loads(text)
        assert isinstance(doc["ok"], bool) and isinstance(doc["n"], int)


def test_seeded_stream_is_batch_invariant(sampled_streams):
    """A seeded request samples the same tokens alone as batched with
    other traffic (its keys fold seed and position, never the batch row
    or the step)."""
    _ref, got, _toks = sampled_streams
    assert got["s0-alone"] == got["s0"]


async def test_engine_refuses_unported_sampling_options():
    """Seeds, penalties and logit bias are served; guided decoding is
    refused exactly where ``JaxEngine`` refuses it: without a registered
    byte vocabulary, or with a schema that does not compile."""
    jeng, teng = _engines()
    served = [dict(seed=7), dict(frequency_penalty=0.5),
              dict(presence_penalty=0.5), dict(repetition_penalty=1.2),
              dict(logit_bias={3: -100.0}), dict(min_p=0.2)]
    for i, kw in enumerate(served):
        req = TRequest(token_ids=[1, 2, 3], request_id=f"s{i}",
                       stop_conditions=TStop(max_tokens=2),
                       sampling_options=TSampling(temperature=1.0, **kw))
        assert teng.validate_request(req) is None
        frames = [f async for f in teng.generate(req)]
        assert frames[-1].finish_reason.value == "length", kw
    bad = {"mode": "json_schema", "schema": {"type": "object",
                                             "patternProperties": {}}}

    def guided(spec):
        return tuple(Req(token_ids=[1, 2, 3], request_id="g",
                         stop_conditions=Stop(max_tokens=2),
                         sampling_options=Samp(guided=spec))
                     for Req, Samp, Stop in ((TRequest, TSampling, TStop),
                                             (JRequest, JSampling, JStop)))

    treq, jreq = guided(SCHEMA)
    err = teng.validate_request(treq)
    assert err and err == jeng.validate_request(jreq)
    frames = [f async for f in teng.generate(treq)]
    assert frames[-1].finish_reason.value == "error"
    toks = byte_vocab(ModelConfig.tiny().vocab_size)
    for eng in (jeng, teng):
        eng.enable_guided(toks, [EOS])
    assert teng.validate_request(treq) is None
    treq, jreq = guided(bad)
    err = teng.validate_request(treq)
    assert err and err.startswith("response_format rejected")
    assert err == jeng.validate_request(jreq)
    await teng.stop()


def test_port_imports_without_jax_or_reference():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import dynamo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__,
                                              "dynamo_tpu_torch.")]
assert {"dynamo_tpu_torch.ops.prng", "dynamo_tpu_torch.ops.sampling",
        "dynamo_tpu_torch.engine.guided", "dynamo_tpu_torch.worker.main",
        "dynamo_tpu_torch.frontend.main", "dynamo_tpu_torch.run",
        "dynamo_tpu_torch.runtime.coordinator",
        "dynamo_tpu_torch.models.hf_loader",
        "dynamo_tpu_torch.http.service"} <= set(mods), mods
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k == "dynamo_tpu" or k.startswith("dynamo_tpu."))
assert not bad, bad
assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
print(len(mods))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 80


def test_port_sources_never_import_jax_or_reference():
    """No import statement anywhere in the port's sources or in
    ``chip_smoke.py`` (function-level imports included, which importing
    the modules does not run) names ``jax`` or ``dynamo_tpu``."""
    import ast
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "dynamo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 80
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "dynamo_tpu"), \
                    f"{path}:{node.lineno} imports {name}"


def test_entry_points_raise_without_gpu(monkeypatch):
    from dynamo_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine.random_init(cfg)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(cfg, params)
    assert resolve_device("cpu") == torch.device("cpu")
