"""Logging configuration.

Parity: reference ``lib/runtime/src/logging.rs:53-122`` (``logging::init``)
and the Python mirror ``configure_dynamo_logging``
(``bindings/python/src/dynamo/runtime/logging.py``):

- **env filter** via ``DYN_LOG``: tracing-EnvFilter-style directives —
  a default level plus per-target overrides, e.g.
  ``DYN_LOG=info,dynamo_tpu_torch.engine=debug,dynamo_tpu_torch.kv_router=warning``.
- **JSONL sink** via ``DYN_LOGGING_JSONL``: a file path appends one JSON
  object per record there (stderr keeps the human format); the values
  ``1``/``true`` switch the stderr handler itself to JSONL.
- **TOML config** via ``DYN_LOGGING_CONFIG_PATH``: a ``[logging]`` table
  overriding the same knobs (env still wins, matching figment layering).
- **local timezone** opt-in (``DYN_LOGGING_LOCAL_TZ``): timestamps in
  local time instead of UTC.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional, Tuple


class TraceContextFilter(logging.Filter):
    """Stamp ``trace_id``/``request_id`` from the ambient trace span onto
    every log record, so any line emitted while serving a request carries
    the ids needed to pull its trace from ``/v1/traces/{trace_id}`` — the
    link that makes a 504/migration/outage incident reconstructible from
    logs alone."""

    def filter(self, record: logging.LogRecord) -> bool:
        if getattr(record, "trace_id", None) is None:
            try:
                from dynamo_tpu_torch.utils.tracing import get_tracer
                span = get_tracer().current_span()
            except Exception:  # logging must never fail on tracing
                span = None
            if span is not None:
                record.trace_id = span.trace_id
                rid = span.attrs.get("request_id")
                if rid:
                    record.request_id = rid
        return True


class JsonlFormatter(logging.Formatter):
    def __init__(self, local_tz: bool = False):
        super().__init__()
        self._tz = time.localtime if local_tz else time.gmtime

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S",
                                  self._tz(record.created)),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        for key in ("trace_id", "request_id"):
            value = getattr(record, key, None)
            if value:
                out[key] = value
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


class HumanFormatter(logging.Formatter):
    """Stderr format, with a ``[rid=... trace=...]`` suffix when the record
    was emitted inside a traced request."""

    def __init__(self):
        super().__init__("%(asctime)s %(levelname)s %(name)s: %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        rid = getattr(record, "request_id", None)
        trace = getattr(record, "trace_id", None)
        if rid or trace:
            parts = []
            if rid:
                parts.append(f"rid={rid}")
            if trace:
                parts.append(f"trace={trace}")
            line += f" [{' '.join(parts)}]"
        return line


def parse_env_filter(spec: str) -> Tuple[int, Dict[str, int]]:
    """``"info,pkg.mod=debug"`` -> (default level, per-target levels).

    Unknown level names fall back to INFO (never crash process startup
    over a typo in an env var — matches the reference's lenient parse)."""
    default = logging.INFO
    targets: Dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, lvl = part.partition("=")
            targets[name.strip()] = getattr(logging, lvl.strip().upper(),
                                            logging.INFO)
        else:
            default = getattr(logging, part.upper(), logging.INFO)
    return default, targets


def _load_toml_config(path: str) -> dict:
    # one py310 tomli shim for the whole package, kept in utils.config
    from dynamo_tpu_torch.utils.config import tomllib

    with open(path, "rb") as f:
        data = tomllib.load(f)
    return data.get("logging", data)


def configure_logging(level: Optional[str] = None) -> None:
    """Install handlers per the layered config: defaults <- TOML <- env.

    Reference semantics (``logging.rs``): one stderr sink (human or JSONL)
    plus an optional JSONL file sink; per-target level directives."""
    conf: dict = {}
    toml_path = os.environ.get("DYN_LOGGING_CONFIG_PATH")
    if toml_path:
        try:
            conf = _load_toml_config(toml_path)
        except Exception:  # noqa: BLE001 — bad config must not kill startup
            logging.getLogger(__name__).warning(
                "could not read DYN_LOGGING_CONFIG_PATH=%s", toml_path)

    spec = (level or os.environ.get("DYN_LOG")
            or conf.get("level") or "info")
    default_level, target_levels = parse_env_filter(str(spec))
    # TOML [logging.targets] table merges under env directives
    for name, lvl in (conf.get("targets") or {}).items():
        target_levels.setdefault(
            name, getattr(logging, str(lvl).upper(), logging.INFO))

    jsonl = os.environ.get("DYN_LOGGING_JSONL", conf.get("jsonl", ""))
    local_tz = bool(os.environ.get("DYN_LOGGING_LOCAL_TZ",
                                   conf.get("local_tz", "")))

    stderr_handler = logging.StreamHandler(sys.stderr)
    if str(jsonl).lower() in ("1", "true"):
        stderr_handler.setFormatter(JsonlFormatter(local_tz))
    else:
        stderr_handler.setFormatter(HumanFormatter())
    handlers = [stderr_handler]
    if jsonl and str(jsonl).lower() not in ("1", "true"):
        # a path: append JSONL records there alongside stderr
        file_handler = logging.FileHandler(str(jsonl))
        file_handler.setFormatter(JsonlFormatter(local_tz))
        handlers.append(file_handler)

    trace_filter = TraceContextFilter()
    root = logging.getLogger()
    root.handlers.clear()
    for h in handlers:
        h.addFilter(trace_filter)
        root.addHandler(h)
    root.setLevel(default_level)
    for name, lvl in target_levels.items():
        logging.getLogger(name).setLevel(lvl)


__all__ = ["configure_logging", "JsonlFormatter", "HumanFormatter",
           "TraceContextFilter", "parse_env_filter"]
