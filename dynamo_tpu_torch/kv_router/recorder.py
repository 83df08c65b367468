"""KV-event recording and replay.

Parity: reference ``lib/llm/src/kv_router/recorder.rs`` (``KvRecorder``) and
the generic JSONL ``Recorder`` (``lib/llm/src/recorder.rs``): capture the
router-event stream to a JSONL file for later replay into an indexer —
offline analysis of routing behavior and deterministic router tests from
production traces.
"""

from __future__ import annotations

import json
import time
from typing import Iterator, Optional, TextIO

from dynamo_tpu_torch.protocols.events import RouterEvent


class KvRecorder:
    """Append router events to JSONL: {"ts": epoch_s, "event": RouterEvent}."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[TextIO] = open(path, "a", encoding="utf-8")
        self.count = 0

    def record(self, event: RouterEvent) -> None:
        if self._fh is None:
            raise RuntimeError("recorder closed")
        self._fh.write(json.dumps({"ts": time.time(),
                                   "event": event.to_dict()}) + "\n")
        self._fh.flush()
        self.count += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "KvRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_recorded(path: str) -> Iterator[RouterEvent]:
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield RouterEvent.from_dict(json.loads(line)["event"])


def replay(path: str, indexer) -> int:
    """Apply a recorded stream to an indexer; returns events applied."""
    n = 0
    for ev in iter_recorded(path):
        indexer.apply_event(ev)
        n += 1
    return n


__all__ = ["KvRecorder", "iter_recorded", "replay"]
