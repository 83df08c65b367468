"""Native SentencePiece tokenizer (``tokenizer.model`` files).

Parity: reference ``lib/llm/src/tokenizers/sp.rs`` (SentencePiece behind the
same tokenizer surface, selected by model-card file type,
``tokenizers.rs:586``). The ``sentencepiece`` wheel is not part of this
image, so the format is implemented natively:

- ``ModelProto`` is protobuf; the minimal wire-format reader below extracts
  the piece list (piece/score/type) and the trainer's model_type — nothing
  else is needed for inference-side encode/decode.
- **Unigram** encode is the standard Viterbi pass: best-scoring
  segmentation of the normalized text under per-piece log probabilities.
- **BPE** encode greedily merges the adjacent symbol pair whose
  concatenation is the best-scoring piece (SP stores merge priority as the
  score), which reproduces SP's order-of-merges semantics.
- Unknown characters byte-fallback to ``<0xNN>`` pieces when the model has
  them (llama-style), else the UNK id.

Normalization honors the model's ``NormalizerSpec`` flags
(add_dummy_prefix / escape_whitespaces / remove_extra_whitespaces) — the
full behavior of the identity normalizer the llama/mistral/gemma family
ships. A ``.model`` whose spec demands a precompiled charsmap or TSV rule
set (nmt_nfkc etc.) is REJECTED at load with a clear error instead of
silently mis-tokenizing.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

_SPACE = "▁"  # ▁

# SentencePiece piece types (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6

_UNIGRAM, _BPE = 1, 2


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over one protobuf message.
    Length-delimited values yield the raw bytes; varints the int; 32-bit
    the 4 raw bytes."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


class SpTokenizer:
    """SentencePiece model with the ``HfTokenizer`` call surface."""

    def __init__(self, pieces: List[Tuple[str, float, int]],
                 model_type: int = _UNIGRAM,
                 add_dummy_prefix: bool = True,
                 escape_whitespaces: bool = True,
                 remove_extra_whitespaces: bool = True):
        self._pieces = pieces
        self._model_type = model_type
        self._add_dummy_prefix = add_dummy_prefix
        self._escape_whitespaces = escape_whitespaces
        self._remove_extra_whitespaces = remove_extra_whitespaces
        # _id_of: full piece -> id map (token_to_id lookups, any type).
        # _match: pieces segmentation may produce from USER TEXT — control
        # and byte pieces excluded, or a prompt containing the literal
        # string "<s>"/"<0x41>" would encode to the special-token id
        # (prompt-boundary injection; real SentencePiece never matches
        # non-normal pieces from input).
        self._id_of: Dict[str, int] = {}
        self._match: Dict[str, int] = {}
        self._byte_id: Dict[int, int] = {}
        self.unk_id = 0
        for i, (piece, _score, ptype) in enumerate(pieces):
            if piece not in self._id_of:
                self._id_of[piece] = i
            if (ptype in (_NORMAL, _USER_DEFINED)
                    and piece not in self._match):
                self._match[piece] = i
            if ptype == _UNKNOWN:
                self.unk_id = i
            elif ptype == _BYTE and len(piece) == 6:  # "<0xNN>"
                self._byte_id[int(piece[3:5], 16)] = i
        self._max_piece_len = max((len(p) for p, _s, _t in pieces),
                                  default=1)
        # unknown-char fallback edge: scored below any real segmentation
        self._unk_penalty = min((s for _p, s, _t in pieces),
                                default=0.0) - 10.0

    # -- loading -----------------------------------------------------------

    @classmethod
    def from_file(cls, path: str) -> "SpTokenizer":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, blob: bytes) -> "SpTokenizer":
        pieces: List[Tuple[str, float, int]] = []
        model_type = _UNIGRAM
        norm_name = ""
        charsmap = b""
        rule_tsv = b""
        # proto2 defaults from sentencepiece_model.proto: all three flags
        # [default = true] (llama-family models explicitly serialize
        # remove_extra_whitespaces = false)
        add_dummy_prefix = True
        escape_whitespaces = True
        remove_extra_whitespaces = True
        for field, _wt, v in _fields(blob):
            if field == 1:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, _NORMAL
                for f2, wt2, v2 in _fields(v):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and wt2 == 5:
                        (score,) = struct.unpack("<f", v2)
                    elif f2 == 3 and wt2 == 0:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2:  # TrainerSpec
                for f2, wt2, v2 in _fields(v):
                    if f2 == 3 and wt2 == 0:  # model_type
                        model_type = v2
            elif field == 3:  # NormalizerSpec
                for f2, wt2, v2 in _fields(v):
                    if f2 == 1 and wt2 == 2:
                        norm_name = v2.decode("utf-8", errors="replace")
                    elif f2 == 2 and wt2 == 2:
                        charsmap = v2
                    elif f2 == 3 and wt2 == 0:
                        add_dummy_prefix = bool(v2)
                    elif f2 == 4 and wt2 == 0:
                        remove_extra_whitespaces = bool(v2)
                    elif f2 == 5 and wt2 == 0:
                        escape_whitespaces = bool(v2)
                    elif f2 == 6 and wt2 == 2:
                        rule_tsv = v2
        if not pieces:
            raise ValueError("no pieces in SentencePiece model")
        # fail LOUDLY on normalizers this implementation cannot reproduce:
        # a precompiled charsmap (nmt_nfkc etc.) or a custom TSV rule set
        # rewrites input text before segmentation, so ignoring it would
        # silently mis-tokenize. The llama/mistral/
        # gemma family ships name="identity" with no charsmap.
        if charsmap or rule_tsv or "nfkc" in norm_name.lower():
            raise ValueError(
                f"SentencePiece model requires the {norm_name or 'unknown'!r}"
                f" normalizer (precompiled charsmap: {len(charsmap)} bytes,"
                f" rule tsv: {len(rule_tsv)} bytes), which this native"
                f" backend does not implement — only identity-normalizer"
                f" models (llama/mistral/gemma family) are supported")
        return cls(pieces, model_type, add_dummy_prefix=add_dummy_prefix,
                   escape_whitespaces=escape_whitespaces,
                   remove_extra_whitespaces=remove_extra_whitespaces)

    # -- encode ------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        # identity-normalizer semantics driven by the model's
        # NormalizerSpec flags (charsmap models were rejected at load):
        # escape_whitespaces turns U+0020 into ▁ (tabs/newlines/unicode
        # spaces intentionally stay — real SP byte-fallbacks them under
        # the identity normalizer, and so do we); remove_extra_whitespaces
        # strips leading/trailing spaces and collapses runs.
        if self._remove_extra_whitespaces:
            import re
            text = re.sub(" +", " ", text.strip(" "))
        if self._escape_whitespaces:
            text = text.replace(" ", _SPACE)
        if self._add_dummy_prefix and not text.startswith(_SPACE):
            text = _SPACE + text
        return text

    def _symbol_ids(self, sym: str) -> List[int]:
        """Map one unsegmentable symbol to ids (byte fallback / UNK)."""
        sid = self._match.get(sym)
        if sid is not None:
            return [sid]
        if self._byte_id:
            ids = []
            for b in sym.encode("utf-8"):
                ids.append(self._byte_id.get(b, self.unk_id))
            return ids
        return [self.unk_id]

    def _encode_unigram(self, text: str) -> List[int]:
        """Viterbi best segmentation under piece log-probs."""
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = self._unk_penalty
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            hi = min(n, i + self._max_piece_len)
            for j in range(i + 1, hi + 1):
                pid = self._match.get(text[i:j])
                if pid is None:
                    continue
                s = best[i] + self._pieces[pid][1]
                if s > best[j]:
                    best[j] = s
                    back[j] = (i, pid)
            # unknown-char fallback edge
            j = i + 1
            s = best[i] + unk_penalty
            if s > best[j]:
                best[j] = s
                back[j] = (i, None)
        out: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]  # type: ignore[misc]
            if pid is None:
                out[:0] = self._symbol_ids(text[i:j])
            else:
                out.insert(0, pid)
            j = i
        return out

    def _encode_bpe(self, text: str) -> List[int]:
        """Greedy best-scoring adjacent merges (SP BPE semantics)."""
        syms = list(text)
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                pid = self._match.get(syms[i] + syms[i + 1])
                if pid is None:
                    continue
                s = self._pieces[pid][1]
                if best_score is None or s > best_score:
                    best_score, best_i = s, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        out: List[int] = []
        for sym in syms:
            out.extend(self._symbol_ids(sym))
        return out

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> List[int]:
        # BOS/EOS handling lives in the chat template; encode/decode read
        # only immutable state, so no lock (unlike the HF-object wrapper)
        del add_special_tokens
        norm = self._normalize(text)
        if self._model_type == _BPE:
            return self._encode_bpe(norm)
        return self._encode_unigram(norm)

    # -- decode ------------------------------------------------------------

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        chunks: List[bytes] = []
        for i in ids:
            if not 0 <= i < len(self._pieces):
                continue
            piece, _score, ptype = self._pieces[i]
            if ptype == _BYTE:
                chunks.append(bytes([int(piece[3:5], 16)]))
                continue
            if ptype in (_CONTROL, _UNKNOWN) and skip_special_tokens:
                continue
            chunks.append(piece.encode("utf-8"))
        text = b"".join(chunks).decode("utf-8", errors="replace")
        text = text.replace(_SPACE, " ")
        return text[1:] if text.startswith(" ") else text

    def token_to_id(self, token: str) -> Optional[int]:
        return self._id_of.get(token)

    @property
    def vocab_size(self) -> int:
        return len(self._pieces)

    def decode_stream(self, skip_special_tokens: bool = True):
        from dynamo_tpu_torch.preprocessor.tokenizer import DecodeStream
        return DecodeStream(self, skip_special_tokens)

    def token_bytes(self) -> List[Optional[bytes]]:
        """Byte string per token id for guided decoding (None for
        control/unknown pieces) — the ``HfTokenizer.token_bytes``
        counterpart: metaspace becomes a space, ``<0xNN>`` byte-fallback
        pieces become their byte."""
        out: List[Optional[bytes]] = [None] * len(self._pieces)
        for i, (piece, _score, ptype) in enumerate(self._pieces):
            if ptype == _BYTE and len(piece) == 6:
                out[i] = bytes([int(piece[3:5], 16)])
            elif ptype in (_NORMAL, _USER_DEFINED):
                out[i] = piece.replace(_SPACE, " ").encode("utf-8")
        return out


__all__ = ["SpTokenizer"]
