"""``TorchEngine`` against ``JaxEngine`` end to end on the CPU, and the
port's package rules.

- Engine parity: the same weights and the same greedy requests through
  ``JaxEngine(attn_impl="scan", decode_multistep=1, pipeline_decode=False)``
  and ``TorchEngine(device="cpu")`` must stream identical token ids and
  finish reasons. The requests cross ``max_prefill_chunk``, one arrives
  after decoding has begun (mixed prefill + decode steps), and a later one
  shares an earlier prompt's prefix (a prefix-cache hit).
- Import hygiene: every module of ``dynamo_tpu_torch`` imports with JAX
  made unimportable, and loads nothing of ``dynamo_tpu``.
- Device rule: without a GPU, an entry point not told ``device="cpu"``
  raises.
"""

import asyncio
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
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TRequest,
    SamplingOptions as TSampling,
    StopConditions as TStop,
)

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
                       TorchEngineConfig(**SIZES), device="cpu")
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


async def test_engine_refuses_unported_sampling_options():
    _jeng, teng = _engines()
    req = TRequest(token_ids=[1, 2, 3], request_id="s",
                   stop_conditions=TStop(max_tokens=2),
                   sampling_options=TSampling(temperature=1.0, seed=7))
    frames = [f async for f in teng.generate(req)]
    await teng.stop()
    assert frames[-1].finish_reason.value == "error"
    assert "seed" in frames[-1].error


def test_port_imports_without_jax_or_reference():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import dynamo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__,
                                              "dynamo_tpu_torch.")]
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
    assert int(res.stdout.strip()) >= 20


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
