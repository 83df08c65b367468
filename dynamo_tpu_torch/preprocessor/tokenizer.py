"""Tokenizer wrapper: HF `tokenizers` fast tokenizer + incremental decoding.

Parity: reference ``lib/llm/src/tokenizers.rs`` (encode/decode wrappers,
lifetime-safe ``DecodeStream``).  The incremental decoder uses the
prefix-window technique (decode a sliding window, emit only once the new
suffix no longer ends in an incomplete UTF-8/byte-fallback sequence), which is
the standard approach for streaming detokenization with byte-level BPE.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from tokenizers import Tokenizer

# replacement char appears while a multi-byte sequence is still incomplete
_REPLACEMENT = "�"

_BYTE_DECODER: Optional[dict] = None


def _gpt2_byte_decoder() -> dict:
    """char -> byte unmapping of the standard byte-level BPE alphabet
    (the gpt2 ``bytes_to_unicode`` table, inverted)."""
    global _BYTE_DECODER
    if _BYTE_DECODER is None:
        bs = (list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD))
              + list(range(0xAE, 0x100)))
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        _BYTE_DECODER = {chr(c): b for b, c in zip(bs, cs)}
    return _BYTE_DECODER


class HfTokenizer:
    """Thin wrapper over a `tokenizers.Tokenizer` (thread-safe encode/decode)."""

    def __init__(self, tokenizer: Tokenizer):
        self._tk = tokenizer
        self._lock = threading.Lock()

    @classmethod
    def from_file(cls, path: str) -> "HfTokenizer":
        return cls(Tokenizer.from_file(path))

    @classmethod
    def from_json(cls, json_str: str) -> "HfTokenizer":
        return cls(Tokenizer.from_str(json_str))

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        with self._lock:
            return self._tk.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        with self._lock:
            return self._tk.decode(ids, skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        with self._lock:
            return self._tk.token_to_id(token)

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size()

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)

    def token_bytes(self) -> List[Optional[bytes]]:
        """The byte string each token id appends to the output (None for
        special/added tokens) — the vocabulary view guided decoding walks
        (``engine/guided.py``). Handles byte-level BPE (gpt2 char->byte
        unmapping), sentencepiece-style pieces (metaspace + <0xNN> byte
        fallback), and plain vocabularies."""
        with self._lock:
            size = self._tk.get_vocab_size()
            vocab = self._tk.get_vocab(with_added_tokens=True)
            byte_level = '"ByteLevel"' in (self._tk.to_str() or "")
            specials = set()
            try:
                for tid, at in self._tk.get_added_tokens_decoder().items():
                    if getattr(at, "special", True):
                        specials.add(int(tid))
            except AttributeError:
                # older tokenizers builds: anything present only in the
                # with-added vocab is an added token — treat ALL of them
                # as special (a literal b"<s>" walking a grammar while
                # the detokenizer drops it would desync text from walk)
                base = self._tk.get_vocab(with_added_tokens=False)
                specials = {tid for tok, tid in vocab.items()
                            if tok not in base}
        out: List[Optional[bytes]] = [None] * size
        dec = _gpt2_byte_decoder()
        for tok, tid in vocab.items():
            if not 0 <= tid < size or tid in specials:
                continue
            if byte_level and all(c in dec for c in tok):
                out[tid] = bytes(dec[c] for c in tok)
            elif (len(tok) == 6 and tok.startswith("<0x")
                  and tok.endswith(">")):
                out[tid] = bytes([int(tok[3:5], 16)])     # SP byte fallback
            else:
                out[tid] = tok.replace("▁", " ").encode("utf-8")
        return out


class DecodeStream:
    """Incremental detokenizer: feed token ids one at a time, get text deltas.

    Keeps ``prefix_offset``/``read_offset`` into the accumulated id list; each
    step decodes ``ids[prefix:]`` and emits the part beyond the previously read
    text, holding back output while it ends in an incomplete byte sequence.
    """

    def __init__(self, tokenizer: HfTokenizer, skip_special_tokens: bool = True):
        self._tk = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: List[int] = []
        self._prefix_offset = 0
        self._read_offset = 0

    def step(self, token_id: int) -> str:
        self._ids.append(token_id)
        prefix_text = self._tk.decode(
            self._ids[self._prefix_offset:self._read_offset],
            skip_special_tokens=self._skip_special)
        new_text = self._tk.decode(
            self._ids[self._prefix_offset:],
            skip_special_tokens=self._skip_special)
        if new_text.endswith(_REPLACEMENT):
            # mid-multibyte: hold output until the sequence completes
            return ""
        delta = new_text[len(prefix_text):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta

    def extend(self, token_ids: List[int]) -> str:
        return "".join(self.step(t) for t in token_ids)


__all__ = ["HfTokenizer", "DecodeStream"]
