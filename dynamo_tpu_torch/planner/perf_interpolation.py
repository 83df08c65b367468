"""Perf interpolators: profiled engine behavior -> capacity estimates.

Parity: reference ``planner/utils/perf_interpolation.py:20-146`` — the
planner never guesses engine throughput; it interpolates pre-deployment
profiling data (the ``profile_sla``-style sweep in
``dynamo_tpu_torch.planner.profile``). Two surfaces:

- prefill: isl -> ttft_s and prefill throughput (tokens/s per replica)
- decode: (concurrency, context) -> itl_s and decode throughput

Profiles are plain dicts (JSON-serializable):
  {"prefill": [{"isl": 512, "ttft_s": 0.08, "tokens_per_s": 60000}, ...],
   "decode":  [{"concurrency": 8, "itl_s": 0.012, "tokens_per_s": 4000}, ...]}
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np


def _interp(x: float, xs: List[float], ys: List[float]) -> float:
    """Piecewise-linear with flat extrapolation (np.interp semantics)."""
    return float(np.interp(x, xs, ys))


class PerfInterpolator:
    def __init__(self, profile: Dict[str, Any]):
        pre = sorted(profile.get("prefill", []), key=lambda r: r["isl"])
        dec = sorted(profile.get("decode", []),
                     key=lambda r: r["concurrency"])
        if not pre or not dec:
            raise ValueError("profile needs non-empty 'prefill' and 'decode'")
        self._pre_isl = [r["isl"] for r in pre]
        self._pre_ttft = [r["ttft_s"] for r in pre]
        self._pre_tps = [r["tokens_per_s"] for r in pre]
        self._dec_conc = [r["concurrency"] for r in dec]
        self._dec_itl = [r["itl_s"] for r in dec]
        self._dec_tps = [r["tokens_per_s"] for r in dec]

    @classmethod
    def from_file(cls, path: str) -> "PerfInterpolator":
        with open(path) as f:
            profile = json.load(f)
        if "configs" in profile:
            # multi-config (parallelism sweep) profile: callers that only
            # want one surface get the first config; the planner loads the
            # full set via MultiPerfInterpolator
            profile = profile["configs"][0]
        return cls(profile)

    # -- prefill -----------------------------------------------------------

    def ttft(self, isl: float) -> float:
        return _interp(isl, self._pre_isl, self._pre_ttft)

    def prefill_tokens_per_s(self, isl: float) -> float:
        return _interp(isl, self._pre_isl, self._pre_tps)

    # -- decode ------------------------------------------------------------

    def itl(self, concurrency: float) -> float:
        return _interp(concurrency, self._dec_conc, self._dec_itl)

    def decode_tokens_per_s(self, concurrency: float) -> float:
        return _interp(concurrency, self._dec_conc, self._dec_tps)

    def max_concurrency_for_itl(self, itl_target_s: float) -> float:
        """Highest profiled concurrency whose itl stays within target."""
        best = self._dec_conc[0]
        for c, itl in zip(self._dec_conc, self._dec_itl):
            if itl <= itl_target_s:
                best = c
        return float(best)


class MultiPerfInterpolator:
    """Per-parallelism-config interpolators (``profile_parallelism_sweep``
    output). The planner evaluates every option and picks the config whose
    CHIP cost (replicas x chips-per-replica) is lowest for the predicted
    load — the reference ``profile_sla`` TP-sweep consumption pattern.
    """

    def __init__(self, profile: Dict[str, Any]):
        configs = profile.get("configs")
        if configs == []:
            raise ValueError(
                "profile has an empty 'configs' list — the parallelism "
                "sweep skipped every config (not enough devices?); "
                "re-profile with feasible (tp, sp) sizes")
        if not configs:
            if "prefill" not in profile or "decode" not in profile:
                raise ValueError(
                    "profile has neither 'configs' nor flat "
                    "'prefill'/'decode' surfaces")
            # flat single-config profile: one option, 1 chip
            configs = [{"tp": 1, "sp": 1, "chips": 1,
                        "prefill": profile["prefill"],
                        "decode": profile["decode"]}]
        self.options: List[Dict[str, Any]] = []
        for c in configs:
            self.options.append({
                "tp": int(c.get("tp", 1)), "sp": int(c.get("sp", 1)),
                "chips": int(c.get("chips",
                                   c.get("tp", 1) * c.get("sp", 1))),
                "interp": PerfInterpolator(c),
            })

    @classmethod
    def from_file(cls, path: str) -> "MultiPerfInterpolator":
        with open(path) as f:
            return cls(json.load(f))

    @property
    def is_multi(self) -> bool:
        return len(self.options) > 1


__all__ = ["PerfInterpolator", "MultiPerfInterpolator"]
