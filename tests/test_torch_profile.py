"""The port's profiler (``dynamo_tpu_torch/planner/profile.py``) against the
reference's, on the CPU.

- ``profile_engine`` on ``TorchEngine(device="cpu")`` and the reference's
  on ``JaxEngine`` with the same float32 weights: the rows have the same
  keys and the same ``isl`` / ``concurrency`` values, and every request the
  sweep sends (the warm-up, each prefill row, each decode row's streams)
  streams the same greedy tokens in both engines, exactly. The times are
  the host's and are not compared.
- ``calibrate_mock_args`` on one fixed profile equals the reference's,
  float for float.
- ``--engine torch`` builds ``TorchEngine`` with the reference's sizes
  arithmetic (``_build_jax``'s) from a transformers-written checkpoint, on
  the GPU unless ``--device cpu`` is given (it raises here without one);
  the CLI writes JSON that the port's ``MultiPerfInterpolator`` loads.
- ``--sweep``: (1, 1) runs, a config past the CPU's cores (its ranks'
  devices, tp x sp) is skipped with the reference's message, and a (1, 2)
  config profiles a rank group on ``MeshSpec(sp=2)`` and writes the rows
  the reference's sweep writes (tp = 2 runs in
  ``tests/test_torch_parallel_worker.py``).
- ``--engine mocker`` writes what the reference's mocker profile writes:
  the same rows (keys and x values) and the same meta.
"""

import asyncio
import json
import math
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
from dynamo_tpu.planner import profile as jprofile
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.planner import profile as tprofile
from dynamo_tpu_torch.planner.perf_interpolation import MultiPerfInterpolator

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(num_pages=64, page_size=4, max_num_seqs=4, max_prefill_chunk=16,
             max_context=64)
ISLS, CONCS, OSL = (8, 24), (1, 3), 6
SMALL = ["--isl", "8,16", "--concurrency", "1,2", "--osl", "4",
         "--num-pages", "64", "--page-size", "4", "--max-prefill-chunk",
         "16"]


def _capture(engine) -> dict:
    """Wrap ``engine.generate``: request id -> the token ids it streamed."""
    streams = {}
    inner = engine.generate

    async def generate(req):
        toks = streams.setdefault(req.request_id, [])
        async for out in inner(req):
            toks.extend(out.token_ids or [])
            yield out

    engine.generate = generate
    return streams


async def _profile(module, engine, vocab):
    try:
        return await module.profile_engine(
            engine, isls=ISLS, concurrencies=CONCS, osl=OSL, vocab=vocab,
            meta={"engine": "x"})
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def profiles():
    jcfg, cfg = JModelConfig.tiny(), ModelConfig.tiny()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     params)
    jeng = JaxEngine(jcfg, params, JaxEngineConfig(attn_impl="scan",
                                                   **SIZES))
    teng = TorchEngine(cfg, tllama.params_from_jax(np_tree, cfg,
                                                   device="cpu"),
                       TorchEngineConfig(**SIZES), device="cpu")
    jstreams, tstreams = _capture(jeng), _capture(teng)
    want = asyncio.run(_profile(jprofile, jeng, jcfg.vocab_size))
    got = asyncio.run(_profile(tprofile, teng, cfg.vocab_size))
    return want, got, jstreams, tstreams, teng


def test_profile_rows_match_reference(profiles):
    want, got, _, _, teng = profiles
    assert got["meta"] == want["meta"] == {"osl": OSL, "time_scale": 1.0,
                                           "engine": "x"}
    for kind, x in (("prefill", "isl"), ("decode", "concurrency")):
        assert [sorted(r) for r in got[kind]] == \
            [sorted(r) for r in want[kind]]
        assert [r[x] for r in got[kind]] == [r[x] for r in want[kind]]
    assert [r["isl"] for r in got["prefill"]] == list(ISLS)
    assert [r["concurrency"] for r in got["decode"]] == list(CONCS)
    for r in got["prefill"]:
        assert r["ttft_s"] > 0 and r["tokens_per_s"] > 0
    for r in got["decode"]:
        assert math.isfinite(r["itl_s"]) and r["itl_s"] >= 0
        assert r["tokens_per_s"] > 0
    # the sweep went through the engine's prefill and decode kernels'
    # wrappers (their plain versions on the CPU)
    assert teng.kernel_launches["paged_prefill"] > 0
    assert teng.kernel_launches["paged_decode"] > 0


def test_profile_streams_match_reference(profiles):
    _, _, jstreams, tstreams, _ = profiles
    # warm-up + 2 repeats per isl + one stream per concurrent decode row
    assert len(tstreams) == 1 + 2 * len(ISLS) + sum(CONCS)
    assert tstreams == jstreams
    for rid, toks in tstreams.items():
        want = 2 if rid == "profile-warmup" else \
            1 if rid.startswith("profile-pre") else OSL
        assert len(toks) == want, rid


def test_calibration_equals_reference():
    profile = {
        "prefill": [{"isl": n, "ttft_s": 0.003 + n * 2.1e-5
                     + n * n * 1.7e-9 + 1e-4 * (n % 3), "tokens_per_s": 0}
                    for n in (128, 512, 1024, 2048)],
        "decode": [{"concurrency": c, "itl_s": 0.0051 + c * 9e-5
                    + 2e-4 * (c % 2), "tokens_per_s": 0}
                   for c in (1, 2, 4, 8, 16, 32)],
    }
    got = tprofile.calibrate_mock_args(profile)
    assert got == jprofile.calibrate_mock_args(profile)
    assert sorted(got) == ["decode_base_s", "decode_per_seq_s",
                           "prefill_attn_quadratic_s", "prefill_base_s",
                           "prefill_per_token_s"]
    with pytest.raises(ValueError):
        tprofile.calibrate_mock_args({"prefill": profile["prefill"][:2],
                                      "decode": profile["decode"]})


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny Llama checkpoint: transformers writes its config.json, and
    seeded weights go beside it under the HF names (``LlamaForCausalLM``
    itself takes ~15 s to import here)."""
    from safetensors.torch import save_file
    from transformers import LlamaConfig
    path = str(tmp_path_factory.mktemp("profile") / "llama")
    hf = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=512,
                     rms_norm_eps=1e-5, rope_theta=10000.0,
                     tie_word_embeddings=False)
    hf.save_pretrained(path)
    gen = torch.Generator().manual_seed(0)
    shapes = {"model.embed_tokens.weight": (256, 64),
              "model.norm.weight": (64,), "lm_head.weight": (256, 64)}
    for i in range(2):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "self_attn.q_proj.weight": (64, 64),
            pre + "self_attn.k_proj.weight": (32, 64),
            pre + "self_attn.v_proj.weight": (32, 64),
            pre + "self_attn.o_proj.weight": (64, 64),
            pre + "mlp.gate_proj.weight": (128, 64),
            pre + "mlp.up_proj.weight": (128, 64),
            pre + "mlp.down_proj.weight": (64, 128),
            pre + "input_layernorm.weight": (64,),
            pre + "post_attention_layernorm.weight": (64,)})
    save_file({k: torch.randn(s, generator=gen) * 0.05
               for k, s in shapes.items()},
              os.path.join(path, "model.safetensors"))
    return path


def test_build_torch_sizes_equal_build_jax(model_dir, monkeypatch):
    from dynamo_tpu_torch.models.hf_loader import load_hf_params
    argv = ["--engine", "torch", "--model-path", model_dir, "--dtype",
            "float32"] + SMALL
    targs = tprofile.build_parser().parse_args(argv + ["--device", "cpu"])
    jargs = jprofile.build_parser().parse_args(
        [a if a != "torch" else "jax" for a in argv])
    teng = tprofile._build_torch(targs)
    jeng = jprofile._build_jax(jargs)
    keys = ("num_pages", "page_size", "max_num_seqs", "max_prefill_chunk",
            "max_context")
    assert {k: getattr(teng.cfg, k) for k in keys} == \
        {k: getattr(jeng.cfg, k) for k in keys}
    assert teng.cfg.max_context == 512   # min(max(2 * 16, 4096), 512)
    # the checkpoint's weights, not random ones
    want = load_hf_params(teng.model_cfg, model_dir, device="cpu")
    assert torch.equal(teng.params["embed"], want["embed"])
    # without --device the engine is asked of the GPU, absent here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(tprofile.amain(tprofile.build_parser().parse_args(argv)))


def test_cli_profiles_torch_engine(model_dir, tmp_path):
    out = tmp_path / "profile.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.planner.profile",
         "--engine", "torch", "--device", "cpu", "--random-weights",
         "--model-path", model_dir, "--dtype", "float32",
         "--output", str(out), "--calibrate", "--isl", "8,16,24",
         "--concurrency", "1,2", "--osl", "4", "--num-pages", "64",
         "--page-size", "4", "--max-prefill-chunk", "16"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "3 prefill rows, 2 decode rows" in r.stdout
    assert "calibrated mocker constants" in r.stdout
    profile = json.loads(out.read_text())
    assert profile["meta"]["engine"] == "torch"
    multi = MultiPerfInterpolator.from_file(str(out))
    assert not multi.is_multi
    assert multi.options[0]["interp"].ttft(8) > 0


def test_sweep_skips_configs_past_the_devices(tmp_path, capsys,
                                              monkeypatch):
    # the CPU's devices are its cores (a rank per process): a config past
    # them is skipped (tests/test_torch_parallel_worker.py runs tp=2)
    have = os.cpu_count()
    out = tmp_path / "sweep.json"
    args = tprofile.build_parser().parse_args(
        ["--sweep", f"1,1;{2 * have},1", "--device", "cpu", "--dtype",
         "float32", "--output", str(out)] + SMALL)
    profile = asyncio.run(tprofile.amain(args))
    text = capsys.readouterr().out
    assert (f"profile: skipping tp={2 * have} sp=1 (needs {2 * have} "
            f"devices, have {have})") in text
    assert "profile: tp=1 sp=1 done (2+2 rows)" in text
    assert [(c["tp"], c["sp"], c["chips"]) for c in profile["configs"]] == \
        [(1, 1, 1)]
    assert profile["meta"] == {"engine": "torch", "model": None, "osl": 4}
    assert MultiPerfInterpolator.from_file(str(out)).options[0]["chips"] == 1
    # every config skipped: the reference's refusal; a config's devices
    # are tp x sp
    for sweep in ([(2 * have, 1)], [(1, 2 * have)]):
        args.sweep = sweep
        with pytest.raises(SystemExit, match="produced NO configs"):
            asyncio.run(tprofile.amain(args))


def test_sweep_profiles_an_sp_group_with_the_references_rows(tmp_path):
    """A (1, 2) config profiles a world of two ranks on ``MeshSpec(sp=2)``
    (its 40-token prompt past the chunk budget of 16 prefills in one ring
    step) and writes the rows the reference's sweep writes for the same
    config on the conftest's virtual devices: the same config keys, tp,
    sp and chips, row keys and x values. No time is compared."""
    flags = ["--sweep", "1,2", "--isl", "8,40", "--concurrency", "1,2",
             "--osl", "4", "--num-pages", "64", "--page-size", "4",
             "--max-prefill-chunk", "16", "--dtype", "float32"]
    out = tmp_path / "sweep.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.planner.profile", *flags,
         "--device", "cpu", "--output", str(out)],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "profile: tp=1 sp=2 done (2+2 rows)" in proc.stdout
    got = json.loads(out.read_text())
    want = asyncio.run(jprofile.profile_parallelism_sweep(
        jprofile.build_parser().parse_args(flags)))
    assert got["meta"] == dict(want["meta"], engine="torch")
    (g,), (w,) = got["configs"], want["configs"]
    assert set(g) == set(w)
    assert (g["tp"], g["sp"], g["chips"]) == (w["tp"], w["sp"],
                                              w["chips"]) == (1, 2, 2)
    for kind, x in (("prefill", "isl"), ("decode", "concurrency")):
        assert [set(r) for r in g[kind]] == [set(r) for r in w[kind]]
        assert [r[x] for r in g[kind]] == [r[x] for r in w[kind]]
        assert all(r["tokens_per_s"] > 0 for r in g[kind])
    assert MultiPerfInterpolator.from_file(str(out)).options[0][
        "chips"] == 2


def test_mocker_profile_matches_reference(tmp_path):
    argv = ["--engine", "mocker", "--isl", "64,256", "--concurrency", "1,4",
            "--osl", "8", "--speedup-ratio", "50"]
    got = asyncio.run(tprofile.amain(tprofile.build_parser().parse_args(
        argv + ["--output", str(tmp_path / "t.json")])))
    want = asyncio.run(jprofile.amain(jprofile.build_parser().parse_args(
        argv + ["--output", str(tmp_path / "j.json")])))
    assert got["meta"] == want["meta"] == {
        "osl": 8, "time_scale": 50.0, "engine": "mocker", "model": None}
    for kind, x in (("prefill", "isl"), ("decode", "concurrency")):
        assert [sorted(r) for r in got[kind]] == \
            [sorted(r) for r in want[kind]]
        assert [r[x] for r in got[kind]] == [r[x] for r in want[kind]]
        assert all(r["tokens_per_s"] > 0 for r in got[kind])
    assert json.loads((tmp_path / "t.json").read_text()) == got
