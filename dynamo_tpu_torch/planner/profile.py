"""Pre-deployment engine profiling: the ``profile_sla`` analog.

Parity: reference ``benchmarks/profiler/profile_sla.py`` sweeps deployment
configs with genai-perf against live k8s deployments and interpolates the
results for SLA planning. Here the sweep drives an ENGINE directly (the
in-process mocker for topology/planner work at zero hardware cost, or the
real ``TorchEngine`` on the GPU for true numbers) and writes exactly the
interpolator JSON the planner consumes
(``planner/perf_interpolation.py:12-14``):

  {"prefill": [{"isl": ..., "ttft_s": ..., "tokens_per_s": ...}, ...],
   "decode":  [{"concurrency": ..., "itl_s": ..., "tokens_per_s": ...}, ...],
   "meta": {...}}

Method:
- prefill row per input sequence length: a fresh-prompt request with
  ``max_tokens=1``; TTFT = time to the first output frame; prefill
  throughput = isl / ttft. Best-of-``repeats`` to shed warmup/compile noise
  (prompts are unique random tokens, so the prefix cache never hits).
- decode row per concurrency level: that many concurrent short-prompt
  streams generating ``osl`` tokens each; ITL = median inter-token gap
  after the first token (steady-state), throughput = total generated
  tokens / wall time.

CLI:
  python -m dynamo_tpu_torch.planner.profile --engine mocker --output profile.json
  python -m dynamo_tpu_torch.planner.profile --engine torch --model-path ... \\
      --isl 512,2048,8192 --concurrency 1,8,32,64
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

DEFAULT_ISLS = (128, 512, 1024, 2048)
DEFAULT_CONCURRENCIES = (1, 2, 4, 8, 16, 32)


def _request(tokens: List[int], rid: str, max_tokens: int,
             vocab: int) -> PreprocessedRequest:
    return PreprocessedRequest(
        token_ids=tokens, request_id=rid,
        stop_conditions=StopConditions(max_tokens=max_tokens,
                                       ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
        eos_token_ids=[])


def _fresh_prompt(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    return rng.integers(1, max(2, vocab - 1), size=n).astype(int).tolist()


async def _time_stream(engine, req: PreprocessedRequest) -> List[float]:
    """Run one request; returns monotonic arrival times of token frames."""
    arrivals: List[float] = []
    async for out in engine.generate(req):
        if out.error:
            raise RuntimeError(f"engine error during profiling: {out.error}")
        if out.token_ids:
            arrivals.extend([time.monotonic()] * len(out.token_ids))
    return arrivals


async def profile_prefill(engine, isls: Sequence[int], vocab: int,
                          repeats: int = 2,
                          time_scale: float = 1.0) -> List[Dict]:
    rng = np.random.default_rng(1234)
    rows = []
    for isl in isls:
        best = float("inf")
        for r in range(repeats):
            req = _request(_fresh_prompt(rng, isl, vocab),
                           f"profile-pre-{isl}-{r}", 1, vocab)
            t0 = time.monotonic()
            arrivals = await _time_stream(engine, req)
            if arrivals:
                best = min(best, arrivals[0] - t0)
        ttft = best * time_scale
        rows.append({"isl": int(isl), "ttft_s": ttft,
                     "tokens_per_s": isl / ttft if ttft > 0 else 0.0})
    return rows


async def profile_decode(engine, concurrencies: Sequence[int], vocab: int,
                         osl: int = 32, isl: int = 32,
                         time_scale: float = 1.0) -> List[Dict]:
    rng = np.random.default_rng(5678)
    rows = []
    for conc in concurrencies:
        reqs = [_request(_fresh_prompt(rng, isl, vocab),
                         f"profile-dec-{conc}-{i}", osl, vocab)
                for i in range(conc)]
        t0 = time.monotonic()
        all_arrivals = await asyncio.gather(
            *[_time_stream(engine, r) for r in reqs])
        wall = (time.monotonic() - t0) * time_scale
        gaps = [b - a for arr in all_arrivals
                for a, b in zip(arr[1:], arr[2:])]  # steady-state only
        total = sum(len(a) for a in all_arrivals)
        rows.append({
            "concurrency": int(conc),
            "itl_s": float(np.median(gaps)) * time_scale if gaps else 0.0,
            "tokens_per_s": total / wall if wall > 0 else 0.0,
        })
    return rows


async def profile_engine(engine, *, isls: Sequence[int] = DEFAULT_ISLS,
                         concurrencies: Sequence[int] = DEFAULT_CONCURRENCIES,
                         osl: int = 32, vocab: int = 32000,
                         time_scale: float = 1.0,
                         meta: Optional[Dict] = None) -> Dict:
    """Full sweep against a started engine; returns the interpolator dict.

    ``time_scale`` maps measured wall time back to modeled real time: the
    mocker compresses its simulated step costs by ``speedup_ratio``, so its
    profile passes ``time_scale=speedup_ratio`` (scheduling overhead is NOT
    compressed, so keep mocker speedups moderate or the overhead inflates).
    """
    # warmup (compile the step shapes once so TTFT rows aren't compile time)
    warm = _request(_fresh_prompt(np.random.default_rng(9), 8, vocab),
                    "profile-warmup", 2, vocab)
    await _time_stream(engine, warm)
    prefill = await profile_prefill(engine, isls, vocab,
                                    time_scale=time_scale)
    decode = await profile_decode(engine, concurrencies, vocab, osl=osl,
                                  time_scale=time_scale)
    return {"prefill": prefill, "decode": decode,
            "meta": {"osl": osl, "time_scale": time_scale, **(meta or {})}}


# ---------------------------------------------------------------- calibrate

def calibrate_mock_args(profile: Dict) -> Dict[str, float]:
    """Fit mocker timing constants to a measured (real-engine) profile.

    The mocker's default constants are invented; once a real profile of
    the card exists, this maps it back onto the mocker's cost model so
    planner/topology simulations train on measured physics:

      ttft(isl)  ≈ prefill_base + isl·per_token + isl²/2·attn_quadratic
        (chunked prefill: the quadratic term integrates attention against
         the linearly growing context)
      itl(conc)  ≈ decode_base + conc·per_seq

    Returns kwargs for ``MockEngineArgs``. Needs ≥3 prefill rows and ≥2
    decode rows (polyfit orders 2 and 1)."""
    pre = sorted(profile["prefill"], key=lambda r: r["isl"])
    dec = sorted(profile["decode"], key=lambda r: r["concurrency"])
    if len(pre) < 3 or len(dec) < 2:
        raise ValueError("calibration needs >=3 prefill and >=2 decode rows")
    isl = np.array([r["isl"] for r in pre], float)
    ttft = np.array([r["ttft_s"] for r in pre], float)
    # fit ttft = c0 + c1*isl + c2*(isl^2/2)
    A = np.stack([np.ones_like(isl), isl, isl * isl / 2.0], axis=1)
    c, *_ = np.linalg.lstsq(A, ttft, rcond=None)
    conc = np.array([r["concurrency"] for r in dec], float)
    itl = np.array([r["itl_s"] for r in dec], float)
    d1, d0 = np.polyfit(conc, itl, 1)
    return {
        "prefill_base_s": max(float(c[0]), 0.0),
        "prefill_per_token_s": max(float(c[1]), 0.0),
        "prefill_attn_quadratic_s": max(float(c[2]), 0.0),
        "decode_base_s": max(float(d0), 0.0),
        "decode_per_seq_s": max(float(d1), 0.0),
    }


# ---------------------------------------------------------------- engines

def _build_mocker(args) -> object:
    from dynamo_tpu_torch.mocker.engine import MockEngineArgs, MockerEngine
    max_isl = max(args.isl)
    return MockerEngine(MockEngineArgs(
        num_pages=args.num_pages,
        page_size=args.page_size,
        max_num_seqs=max(args.concurrency),
        max_prefill_chunk=args.max_prefill_chunk,
        max_context=max(2 * max_isl, 4096),
        speedup_ratio=args.speedup_ratio))


def _build_torch(args) -> object:
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.hub import resolve_model_path
    from dynamo_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    args.model_path = resolve_model_path(args.model_path)
    cfg = ModelConfig.from_pretrained(args.model_path, dtype=args.dtype)
    ecfg = TorchEngineConfig(
        num_pages=args.num_pages, page_size=args.page_size,
        max_num_seqs=max(args.concurrency),
        max_prefill_chunk=args.max_prefill_chunk,
        max_context=min(max(2 * max(args.isl), 4096),
                        cfg.max_position_embeddings))
    if args.random_weights:
        return TorchEngine.random_init(cfg, ecfg, device=dev)
    from dynamo_tpu_torch.models.hf_loader import load_hf_params
    return TorchEngine(cfg, load_hf_params(cfg, args.model_path, device=dev),
                       ecfg, device=dev)


async def profile_parallelism_sweep(args) -> Dict:
    """Sweep (tp, sp) engine configs, one full profile each — the reference
    ``profile_sla.py`` behavior of sweeping TP sizes for prefill/decode so
    the planner can pick a CONFIG, not just a count.

    A (tp, sp) config runs on a rank group of tp x sp processes over
    ``--device`` (None: the GPU; a rank per card, as the worker places
    them) on the reference's ``MeshSpec(tp=tp, sp=sp)``: this process is
    rank 0 and profiles the engine, the other ranks follow its steps
    (``parallel/multihost.py``); under sp a prompt past the chunk budget
    prefills in one ring step. A config that needs more devices than
    there are is skipped. Output schema:

      {"configs": [{"tp": T, "sp": S, "chips": T*S,
                    "prefill": [...], "decode": [...]}, ...],
       "meta": {...}}
    """
    import os

    import torch

    from dynamo_tpu_torch.engine.torch_engine import TorchEngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    # CPU ranks are processes: as many as there are cores
    have = (torch.cuda.device_count() if dev.type == "cuda"
            else os.cpu_count() or 1)
    if args.model_path:
        from dynamo_tpu_torch.models.hub import resolve_model_path
        args.model_path = resolve_model_path(args.model_path)
        cfg = ModelConfig.from_pretrained(args.model_path, dtype=args.dtype)
    else:
        cfg = ModelConfig.tiny(dtype="float32")
    configs = []
    for tp, sp in args.sweep:
        n = tp * sp
        if n > have:
            print(f"profile: skipping tp={tp} sp={sp} "
                  f"(needs {n} devices, have {have})")
            continue
        ecfg = TorchEngineConfig(
            num_pages=args.num_pages, page_size=args.page_size,
            max_num_seqs=max(args.concurrency),
            max_prefill_chunk=args.max_prefill_chunk,
            max_context=min(max(2 * max(args.isl), 4096),
                            cfg.max_position_embeddings))
        group = _RankGroup(cfg, ecfg, tp, sp, dev)
        try:
            prof = await profile_engine(
                group.engine, isls=args.isl, concurrencies=args.concurrency,
                osl=args.osl, vocab=cfg.vocab_size,
                meta={"tp": tp, "sp": sp})
        finally:
            await group.close()
        configs.append({"tp": tp, "sp": sp, "chips": n,
                        "prefill": prof["prefill"],
                        "decode": prof["decode"]})
        print(f"profile: tp={tp} sp={sp} done "
              f"({len(prof['prefill'])}+{len(prof['decode'])} rows)")
    if not configs:
        raise SystemExit(
            "parallelism sweep produced NO configs: every (tp, sp) needs "
            f"more than the {have} available devices — "
            "writing an empty profile would crash the planner at startup")
    return {"configs": configs,
            "meta": {"engine": "torch", "model": args.model_path,
                     "osl": args.osl}}


class _RankGroup:
    """A tp x sp engine for the sweep: at one rank one engine in this
    process; above, this process as rank 0 of a world of tp x sp ranks on
    ``MeshSpec(tp=tp, sp=sp)``, whose followers are bare engine processes
    built from the same spec and seed."""

    def __init__(self, cfg, ecfg, tp: int, sp: int, dev):
        import os
        import sys
        import tempfile

        from dynamo_tpu_torch.engine.torch_engine import TorchEngine
        from dynamo_tpu_torch.parallel import multihost as mh
        from dynamo_tpu_torch.parallel.mesh import MeshSpec
        self.world, self.procs, self.fanout = None, [], None
        self.spec_path = None
        n = tp * sp
        if n == 1:
            self.engine = TorchEngine.random_init(cfg, ecfg, device=dev)
            return
        mesh = MeshSpec(tp=tp, sp=sp)
        address = mh.free_address()
        fd, self.spec_path = tempfile.mkstemp(suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(mh.engine_spec(cfg, ecfg, address, n, None,
                                     dev.type, mesh), f)
        self.procs = mh.start_local_ranks(
            [sys.executable, "-m", "dynamo_tpu_torch.parallel.multihost",
             "--engine-spec", self.spec_path], n)
        self.world = mh.initialize_distributed(address, 1, 0, n,
                                               device=dev.type)
        self.engine = mh.build_rank_engine(cfg, ecfg, self.world, mesh)
        self.fanout = mh.StepFanout(self.world.fanout)
        self.fanout.install(self.engine)

    async def close(self) -> None:
        import os

        from dynamo_tpu_torch.parallel import multihost as mh
        await self.engine.stop()
        if self.fanout is not None:
            await self.engine.run_on_step_thread(self.fanout.close)
        if self.world is not None:
            mh.stop_local_ranks(self.procs)
            mh.shutdown_distributed()
        if self.spec_path is not None:
            os.unlink(self.spec_path)

def _parse_sweep(s: str) -> List:
    """'1,1;2,1;4,1' -> [(1,1), (2,1), (4,1)] as (tp, sp)."""
    out = []
    for part in s.split(";"):
        tp, sp = part.split(",")
        out.append((int(tp), int(sp)))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="pre-deployment engine profiler (profile_sla analog)")
    p.add_argument("--engine", choices=["mocker", "torch"], default="mocker")
    p.add_argument("--output", default="profile.json")
    p.add_argument("--isl", type=lambda s: [int(x) for x in s.split(",")],
                   default=list(DEFAULT_ISLS))
    p.add_argument("--concurrency",
                   type=lambda s: [int(x) for x in s.split(",")],
                   default=list(DEFAULT_CONCURRENCIES))
    p.add_argument("--osl", type=int, default=32)
    p.add_argument("--num-pages", type=int, default=4096)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-prefill-chunk", type=int, default=1024)
    p.add_argument("--speedup-ratio", type=float, default=10.0,
                   help="mocker: simulated-time speedup (sweeps run fast)")
    p.add_argument("--model-path", default=None, help="torch engine only")
    p.add_argument("--device", default=None,
                   help="torch engine: cuda (the default; fails without a "
                        "GPU) or cpu (the kernels' plain PyTorch versions)")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--sweep", type=_parse_sweep, default=None,
                   metavar="TP,SP;TP,SP;...",
                   help="sweep parallelism configs (torch engine; random "
                        "weights): one profile per (tp, sp), planner picks "
                        "the config")
    return p


async def amain(args) -> Dict:
    if getattr(args, "sweep", None):
        profile = await profile_parallelism_sweep(args)
        with open(args.output, "w") as f:
            json.dump(profile, f, indent=1)
        return profile
    if args.engine == "torch":
        if args.model_path is None:
            raise SystemExit("--model-path required for --engine torch")
        engine = _build_torch(args)
        vocab = engine.model_cfg.vocab_size
    else:
        engine = _build_mocker(args)
        vocab = engine.args.vocab_size
    scale = args.speedup_ratio if args.engine == "mocker" else 1.0
    try:
        profile = await profile_engine(
            engine, isls=args.isl, concurrencies=args.concurrency,
            osl=args.osl, vocab=vocab, time_scale=scale,
            meta={"engine": args.engine, "model": args.model_path})
    finally:
        await engine.stop()
    with open(args.output, "w") as f:
        json.dump(profile, f, indent=1)
    return profile


def main() -> None:
    parser = build_parser()
    parser.add_argument("--calibrate", action="store_true",
                        help="also print fitted MockEngineArgs timing "
                             "constants for this profile")
    args = parser.parse_args()
    profile = asyncio.run(amain(args))
    if "configs" in profile:
        print(f"profile written to {args.output}: "
              f"{len(profile['configs'])} parallelism configs")
        return
    print(f"profile written to {args.output}: "
          f"{len(profile['prefill'])} prefill rows, "
          f"{len(profile['decode'])} decode rows")
    if args.calibrate:
        print("calibrated mocker constants: "
              + json.dumps(calibrate_mock_args(profile), indent=1))


if __name__ == "__main__":
    main()


__all__ = ["profile_engine", "profile_prefill", "profile_decode",
           "profile_parallelism_sweep", "calibrate_mock_args"]
