"""Server-Sent Events codec for OpenAI-style streaming responses.

Parity: reference ``lib/llm/src/protocols/codec.rs`` (755 LoC SSE codec).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional

DONE_SENTINEL = "[DONE]"


@dataclass
class SseEvent:
    data: Optional[str] = None
    event: Optional[str] = None
    id: Optional[str] = None
    comments: Optional[List[str]] = None

    @property
    def is_done(self) -> bool:
        return self.data is not None and self.data.strip() == DONE_SENTINEL

    def encode(self) -> bytes:
        lines: List[str] = []
        for c in self.comments or []:
            lines.append(f": {c}")
        if self.event:
            lines.append(f"event: {self.event}")
        if self.id:
            lines.append(f"id: {self.id}")
        if self.data is not None:
            for dline in self.data.split("\n"):
                lines.append(f"data: {dline}")
        return ("\n".join(lines) + "\n\n").encode()

    def json(self) -> Any:
        if self.data is None or self.is_done:
            return None
        return json.loads(self.data)


def encode_data(obj: Any) -> bytes:
    """Encode a JSON-serializable object as one SSE data event."""
    return SseEvent(data=json.dumps(obj, separators=(",", ":"))).encode()


def encode_done() -> bytes:
    return SseEvent(data=DONE_SENTINEL).encode()


class SseDecoder:
    """Incremental SSE parser: feed bytes, iterate complete events."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, chunk: bytes) -> Iterator[SseEvent]:
        self._buf += chunk
        # normalize CRLF once per feed; events are separated by a blank line
        while True:
            norm = self._buf.replace(b"\r\n", b"\n")
            sep = norm.find(b"\n\n")
            if sep < 0:
                self._buf = norm
                return
            raw, self._buf = norm[:sep], norm[sep + 2 :]
            ev = self._parse(raw.decode("utf-8", errors="replace"))
            if ev is not None:
                yield ev

    @staticmethod
    def _parse(raw: str) -> Optional[SseEvent]:
        data_lines: List[str] = []
        comments: List[str] = []
        event = None
        eid = None
        for line in raw.split("\n"):
            if not line:
                continue
            if line.startswith(":"):
                comments.append(line[1:].lstrip())
                continue
            key, _, value = line.partition(":")
            value = value[1:] if value.startswith(" ") else value
            if key == "data":
                data_lines.append(value)
            elif key == "event":
                event = value
            elif key == "id":
                eid = value
        if not data_lines and event is None and eid is None and not comments:
            return None
        return SseEvent(
            data="\n".join(data_lines) if data_lines else None,
            event=event,
            id=eid,
            comments=comments or None,
        )


__all__ = ["SseEvent", "SseDecoder", "encode_data", "encode_done", "DONE_SENTINEL"]
