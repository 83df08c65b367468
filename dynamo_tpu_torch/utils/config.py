"""Layered runtime configuration: defaults -> TOML file -> DYN_* env.

Parity: reference figment-based config (``lib/runtime/src/config.rs:147-196``
— defaults, then TOML, then ``DYN_RUNTIME_*`` env) without the framework:
plain dataclass + ``tomllib`` + env overrides. Precedence (last wins):

1. dataclass defaults
2. TOML file (``DYN_CONFIG_PATH`` or explicit path), table ``[runtime]``
3. environment: ``DYN_RUNTIME_<FIELD>`` (upper-case field name)
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

try:
    import tomllib  # py311+
except ModuleNotFoundError:  # pragma: no cover — py310 images ship tomli
    import tomli as tomllib

ENV_PREFIX = "DYN_RUNTIME_"
CONFIG_PATH_ENV = "DYN_CONFIG_PATH"


@dataclass
class RuntimeConfig:
    coordinator: str = "127.0.0.1:6650"
    rpc_host: str = "127.0.0.1"
    rpc_port: int = 0
    lease_ttl: float = 5.0
    log_level: str = "INFO"
    system_enabled: bool = False
    system_port: int = 0
    # -- request-lifecycle robustness ----------------------------------
    # default end-to-end request deadline applied by the HTTP frontend
    # (seconds; 0 disables — per-request nvext.timeout_s / X-Request-Timeout
    # override either way)
    request_timeout_s: float = 0.0
    # RPC keepalive health probing: ping a quiet connection every
    # ``keepalive_interval_s``; after ``keepalive_miss_budget`` intervals of
    # total silence the connection is torn down and the instance marked
    # down (0 interval disables probing)
    keepalive_interval_s: float = 5.0
    keepalive_miss_budget: int = 3
    # HTTP overload shedding high-water marks (0 = unlimited): total
    # concurrent requests, and concurrent requests per model; shed requests
    # get 503 + Retry-After ``http_shed_retry_after_s``
    http_max_inflight: int = 0
    http_max_model_inflight: int = 0
    http_shed_retry_after_s: float = 1.0
    # -- disagg KV-transfer tuning --------------------------------------
    # blocks per wire frame on the batched KV export path (short-form env
    # DYN_KV_FRAME_BLOCKS wins; see engine/transfer.py): big enough that
    # per-frame overhead is noise, small enough to pipeline recv/inject
    kv_frame_blocks: int = 16
    # max blocks committed per exclusive-window donated scatter on the
    # inject side (short-form env DYN_KV_SCATTER_BLOCKS wins): larger
    # windows amortize jit dispatch, smaller windows bound how long a
    # decode step can stall behind one KV commit
    kv_scatter_blocks: int = 64
    # KVBM packing-prefetch lookahead depth in BYTES (short-form env
    # DYN_KV_PREFETCH_DEPTH wins): how far ahead of a request's chunked-
    # prefill cursor the tier promotion scheduler stages cold KV blocks.
    # 0 disables lookahead (tier onboarding falls back to the bounded
    # synchronous path)
    kv_prefetch_depth: int = 64 * 1024 * 1024
    # -- fused decode ----------------------------------------------------
    # max decode steps fused into one jitted dispatch with on-device
    # sampling and stop checks (short-form env DYN_DECODE_MULTISTEP wins;
    # see engine/jax_engine.py). The scheduler narrows the width per batch
    # (token budgets, stop-string lookback, page pressure); 1 disables the
    # fused path entirely (per-step pipelined decode still applies)
    decode_multistep: int = 8

    # -- mixed prefill+decode dispatch -----------------------------------
    # pack decode rows into prefill steps as length-1 ragged chunks (one
    # token-budgeted [B, S] dispatch) and lift the fused-multistep
    # "no waiters/prefills" gate so blocks keep running while arrivals
    # onboard (short-form env DYN_MIXED_BATCH wins; see
    # engine/jax_engine.py). False restores the strict prefill-XOR-decode
    # alternation and the old fuse gate.
    mixed_batch: bool = True
    # decode-progress guarantee on the legacy alternation path: at most
    # K-1 consecutive prefill-only steps while decode rows exist
    # (short-form env DYN_DECODE_PROGRESS wins); 0 disables
    decode_progress_every: int = 2

    # -- failure-aware routing (runtime/resilience.py; cost + kv modes) ---
    # consecutive failures (connect errors, stream drops, timeouts, slow
    # TTFT) that open an instance's circuit breaker
    router_breaker_failures: int = 3
    # open -> half-open probe dwell (doubles per re-open, capped in code)
    router_breaker_cooldown_s: float = 1.0
    # TTFT at or above this counts as a breaker failure — routes around a
    # slow-but-alive worker before keepalive declares it dead (0 disables)
    router_breaker_slow_ttft_s: float = 0.0
    # retry-budget tokens earned per first attempt (~ the max fraction of
    # requests that may retry or hedge; brownouts can't amplify)
    router_retry_budget: float = 0.1
    # hedged dispatch: fire a second attempt on the next-best instance when
    # the first token is slower than the hedge delay (first winner cancels
    # the loser; hedges spend the retry budget)
    router_hedge: bool = False
    # fixed hedge delay in seconds; 0 derives it from the observed fleet
    # p95 TTFT
    router_hedge_delay_s: float = 0.0
    # __stats__ scrape period feeding queue depth into the cost score
    router_stats_interval_s: float = 1.0

    @classmethod
    def load(cls, path: Optional[str] = None,
             env: Optional[Dict[str, str]] = None) -> "RuntimeConfig":
        env = os.environ if env is None else env
        values: Dict[str, Any] = {}
        path = path or env.get(CONFIG_PATH_ENV)
        if path:
            with open(path, "rb") as f:
                doc = tomllib.load(f)
            values.update(doc.get("runtime", {}))
        for f in dataclasses.fields(cls):
            raw = env.get(f"{ENV_PREFIX}{f.name.upper()}")
            if raw is not None:
                values[f.name] = raw
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(values) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        # coerce by declared field type so env strings AND quoted TOML
        # values ("256") land as the right type at load time — a malformed
        # value fails here, not as a TypeError deep in a request path
        for f in dataclasses.fields(cls):
            if f.name not in values:
                continue
            v = values[f.name]
            try:
                if f.type in ("int", int):
                    values[f.name] = int(v)
                elif f.type in ("float", float):
                    values[f.name] = float(v)
                elif f.type in ("bool", bool):
                    values[f.name] = (v if isinstance(v, bool)
                                      else str(v).lower() in ("1", "true", "yes"))
            except (TypeError, ValueError):
                raise ValueError(
                    f"config key {f.name!r}: cannot coerce {v!r} "
                    f"to {f.type}") from None
        return cls(**values)


__all__ = ["RuntimeConfig"]
