"""Synthetic request-trace generator with controllable prefix sharing.

Parity: reference ``benchmarks/data_generator`` (synthesizes mooncake-style
traces whose prefix-overlap statistics drive KV-router and prefix-cache
benchmarks). A trace is JSONL, one request per line:

    {"timestamp": ms, "input_length": n, "output_length": m,
     "hash_ids": [...block hash ids...]}

``hash_ids`` are BLOCK-level ids: requests in the same "group" share their
first ``shared_blocks`` ids (the common system prompt / few-shot header),
then diverge into unique tail blocks — exactly the structure the KV router's
prefix matcher exploits. Groups are drawn Zipf-style so a few prompts are
hot, arrivals are Poisson.

Two fleet-scale extensions (both OFF by default — the base schema above is
unchanged):

- **Cohorts** (``cohorts=[CohortSpec, ...]`` / ``--cohorts``): each request
  is drawn from a weighted mix of workload cohorts (short-chat /
  long-context / guided), each with its own prefix structure, length
  distributions, and **sampling params** (temperature, penalties, guided
  ``response_format``) — so one trace exercises the full decode surface,
  including the fused penalties/guided path. Cohort traces carry two extra
  JSONL fields: ``"cohort"`` (name) and ``"sampling"`` (request params).
- **Phases** (``phases=[(rate, dur_s), ...]`` /
  ``--phases "8rps:30s,40rps:60s,8rps:30s"``): a piecewise-constant
  arrival-rate schedule — the bursty ramp an autoscaler must ride — in
  place of the single flat rate.

CLI:
    python -m dynamo_tpu_torch.trace_gen --requests 1000 --rps 8 \\
        --groups 20 --shared-blocks 16 --out trace.jsonl
    python -m dynamo_tpu_torch.trace_gen --cohorts \\
        --phases "8rps:30s,40rps:60s,8rps:30s" --out ramp.jsonl

The mocker/router e2e, the planner's fleet bench leg, and the profiler
consume these to reproduce the reference's benchmarks without real user
logs.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class CohortSpec:
    """One workload cohort: prefix/length shape + request sampling params."""

    name: str
    weight: float                     # relative draw probability
    shared_blocks: int                # blocks of shared prefix per group
    unique_blocks_mean: float         # geometric tail after the prefix
    output_len_mean: float            # geometric decode lengths
    num_groups: int = 0               # 0 -> inherit TraceConfig.num_groups
    sampling: Optional[dict] = None   # temperature/penalties/guided/...


def default_cohorts() -> List[CohortSpec]:
    """The million-user mix: mostly short chat on a hot shared prompt, a
    long-context tail, and a guided-decoding slice whose penalties and
    ``response_format`` drive the fused constrained path."""
    return [
        CohortSpec("short_chat", weight=0.55, shared_blocks=16,
                   unique_blocks_mean=4.0, output_len_mean=96.0,
                   sampling={"temperature": 0.7, "presence_penalty": 0.4}),
        CohortSpec("long_context", weight=0.25, shared_blocks=64,
                   unique_blocks_mean=96.0, output_len_mean=256.0,
                   sampling={"temperature": 0.2}),
        CohortSpec("guided", weight=0.20, shared_blocks=8,
                   unique_blocks_mean=8.0, output_len_mean=64.0,
                   sampling={"temperature": 0.0, "frequency_penalty": 0.2,
                             "response_format": {"type": "json_object"}}),
    ]


def parse_phases(spec: str) -> List[Tuple[float, float]]:
    """``"8rps:30s,40rps:60s"`` -> ``[(8.0, 30.0), (40.0, 60.0)]``."""
    phases: List[Tuple[float, float]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            rate_s, dur_s = part.split(":")
            rate_s = rate_s.strip()
            dur_s = dur_s.strip()
            if rate_s.endswith("rps"):
                rate_s = rate_s[:-3]
            if dur_s.endswith("s"):
                dur_s = dur_s[:-1]
            rate, dur = float(rate_s), float(dur_s)
        except ValueError as e:
            raise ValueError(
                f"bad phase {part!r} (want e.g. '8rps:30s'): {e}") from e
        if rate < 0 or dur <= 0:
            raise ValueError(f"bad phase {part!r}: rate must be >= 0, "
                             "duration > 0")
        phases.append((rate, dur))
    if not phases:
        raise ValueError(f"no phases in {spec!r}")
    return phases


@dataclass
class TraceConfig:
    num_requests: int = 1000
    requests_per_s: float = 8.0       # Poisson arrival rate
    num_groups: int = 20              # distinct shared prefixes
    zipf_a: float = 1.2               # group popularity skew (>1)
    shared_blocks: int = 16           # blocks of shared prefix per group
    unique_blocks_mean: float = 8.0   # geometric tail after the prefix
    output_len_mean: float = 128.0    # geometric decode lengths
    block_size: int = 16              # tokens per block (for input_length)
    seed: int = 0
    # fleet-scale extensions (None keeps the original flat-rate single-mix
    # trace and the original JSONL schema, byte-for-byte)
    phases: Optional[List[Tuple[float, float]]] = None
    cohorts: Optional[List[CohortSpec]] = None


def _arrivals(cfg: TraceConfig, rng) -> Iterator[float]:
    """Arrival timestamps in ms: flat-rate Poisson, or the piecewise-
    constant phase schedule. With phases, the schedule bounds the trace
    (``num_requests`` still acts as a hard cap)."""
    if not cfg.phases:
        t_ms = 0.0
        for _ in range(cfg.num_requests):
            t_ms += rng.exponential(1000.0 / cfg.requests_per_s)
            yield t_ms
        return
    emitted = 0
    phase_start = 0.0
    for rate, dur_s in cfg.phases:
        phase_end = phase_start + dur_s * 1000.0
        t_ms = phase_start
        while rate > 0:
            t_ms += rng.exponential(1000.0 / rate)
            if t_ms >= phase_end or emitted >= cfg.num_requests:
                break
            emitted += 1
            yield t_ms
        phase_start = phase_end
        if emitted >= cfg.num_requests:
            return


def generate(cfg: TraceConfig) -> Iterator[dict]:
    rng = np.random.default_rng(cfg.seed)
    cohorts = cfg.cohorts
    if cohorts:
        weights = np.array([max(0.0, c.weight) for c in cohorts])
        weights = weights / weights.sum()
        # each cohort owns a disjoint group/prefix id space so a group's
        # shared prefix has ONE well-defined length
        group_counts = [c.num_groups or cfg.num_groups for c in cohorts]
        prefix_bases: List[int] = []
        base = 0
        for c, n_groups in zip(cohorts, group_counts):
            prefix_bases.append(base)
            base += n_groups * c.shared_blocks
        next_unique = base
    else:
        # globally unique id spaces: group prefixes then per-request tails
        next_unique = cfg.num_groups * cfg.shared_blocks
    for t_ms in _arrivals(cfg, rng):
        if cohorts:
            ci = int(rng.choice(len(cohorts), p=weights))
            c = cohorts[ci]
            n_groups = group_counts[ci]
            shared = c.shared_blocks
            tail_mean = c.unique_blocks_mean
            out_mean = c.output_len_mean
            g_base = prefix_bases[ci]
        else:
            c = None
            n_groups = cfg.num_groups
            shared = cfg.shared_blocks
            tail_mean = cfg.unique_blocks_mean
            out_mean = cfg.output_len_mean
            g_base = 0
        g = min(int(rng.zipf(cfg.zipf_a)) - 1, n_groups - 1)
        prefix = list(range(g_base + g * shared,
                            g_base + g * shared + shared))
        n_tail = 1 + int(rng.geometric(1.0 / tail_mean))
        tail = list(range(next_unique, next_unique + n_tail))
        next_unique += n_tail
        hash_ids = prefix + tail
        req = {
            "timestamp": round(t_ms, 3),
            "input_length": len(hash_ids) * cfg.block_size,
            "output_length": 1 + int(rng.geometric(1.0 / out_mean)),
            "hash_ids": hash_ids,
        }
        if c is not None:
            req["cohort"] = c.name
            if c.sampling:
                req["sampling"] = dict(c.sampling)
        yield req


def prefix_share_ratio(trace: List[dict]) -> float:
    """Fraction of all blocks that a warm prefix cache would have already
    seen (the trace's theoretical maximum cache-hit rate)."""
    seen = set()
    total = hits = 0
    for req in trace:
        for h in req["hash_ids"]:
            total += 1
            if h in seen:
                hits += 1
            seen.add(h)
    return hits / total if total else 0.0


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="prefix-sharing request trace generator")
    p.add_argument("--requests", type=int, default=1000)
    p.add_argument("--rps", type=float, default=8.0)
    p.add_argument("--groups", type=int, default=20)
    p.add_argument("--zipf", type=float, default=1.2)
    p.add_argument("--shared-blocks", type=int, default=16)
    p.add_argument("--unique-blocks-mean", type=float, default=8.0)
    p.add_argument("--output-len-mean", type=float, default=128.0)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phases", default=None,
                   help='piecewise arrival schedule, e.g. '
                        '"8rps:30s,40rps:60s,8rps:30s" (overrides --rps)')
    p.add_argument("--cohorts", action="store_true",
                   help="draw each request from the default workload "
                        "cohort mix (short_chat/long_context/guided); "
                        "adds cohort+sampling JSONL fields")
    p.add_argument("--out", default="-")
    args = p.parse_args(argv)
    cfg = TraceConfig(
        num_requests=args.requests, requests_per_s=args.rps,
        num_groups=args.groups, zipf_a=args.zipf,
        shared_blocks=args.shared_blocks,
        unique_blocks_mean=args.unique_blocks_mean,
        output_len_mean=args.output_len_mean,
        block_size=args.block_size, seed=args.seed,
        phases=parse_phases(args.phases) if args.phases else None,
        cohorts=default_cohorts() if args.cohorts else None)
    trace = list(generate(cfg))
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for req in trace:
        out.write(json.dumps(req) + "\n")
    if out is not sys.stdout:
        out.close()
    summary = (f"trace: {len(trace)} requests, prefix-share ratio "
               f"{prefix_share_ratio(trace):.2f}")
    if args.cohorts:
        mix = {}
        for req in trace:
            mix[req["cohort"]] = mix.get(req["cohort"], 0) + 1
        summary += ", cohorts " + json.dumps(mix, sort_keys=True)
    print(summary, file=sys.stderr)


if __name__ == "__main__":
    main()


__all__ = ["TraceConfig", "CohortSpec", "default_cohorts", "parse_phases",
           "generate", "prefix_share_ratio"]
