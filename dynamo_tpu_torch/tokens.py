"""Token block sequences with incremental content hashing.

The KV-aware router identifies reusable KV-cache prefixes by hashing fixed-size
blocks of prompt tokens; workers publish the hashes of blocks they hold and the
router radix-tree matches new prompts against them.  This module provides the
canonical block/sequence hashing used across the framework.

Capability parity: reference ``lib/llm/src/tokens.rs:56-851`` (``Tokens``,
``TokenBlock``, ``TokenBlockSequence``) and
``lib/llm/src/kv_router/indexer.rs:122-134`` (``compute_block_hash_for_seq``,
xxh3-64 seeded hashing).  The design here is fresh: a flat numpy-friendly token
representation, chained block hashes, and O(1) amortized append with unwind
support for speculative-decode rollback.

This is the port's own copy of ``dynamo_tpu/tokens.py``: the hashes are the
same, computed by the plain-Python XXH3 in ``dynamo_tpu_torch/xxh3.py`` (the
GPU host has no ``xxhash`` package), without the native C hook.

Hash scheme
-----------
``block_hash[i] = xxh3_64(le_bytes(parent_hash[i-1]) || le_bytes(tokens[i*B:(i+1)*B]), seed=SEED)``

where ``parent_hash[-1]`` is the 8-byte little-endian salt hash.  Chaining makes
a block hash identify the *entire prefix*, which is what prefix-cache matching
needs.  Equivalent chaining exists in the reference (sequence hashes); we use a
single chained hash per block instead of separate local/sequence hashes, and a
separate unchained "local" hash is provided for event granularity.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence

from dynamo_tpu_torch.xxh3 import xxh3_64_intdigest

HASH_SEED = 1337


def _hash_bytes(data: bytes, seed: int = HASH_SEED) -> int:
    return xxh3_64_intdigest(data, seed=seed)


def _tokens_to_bytes(tokens: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *[t & 0xFFFFFFFF for t in tokens])


def compute_hash(data: bytes, seed: int = HASH_SEED) -> int:
    """Hash raw bytes (exposed for salts and external callers)."""
    return _hash_bytes(data, seed)


def compute_local_block_hash(tokens: Sequence[int]) -> int:
    """Unchained hash of one block's tokens (event-plane granularity)."""
    return _hash_bytes(_tokens_to_bytes(tokens))


def compute_block_hash_for_seq(
    tokens: Sequence[int], block_size: int, salt_hash: int = 0
) -> List[int]:
    """Chained block hashes for every *complete* block of ``tokens``.

    This is the router-side entry point: given a tokenized prompt, produce the
    hashes to match against worker-published KV blocks.  Parity:
    reference ``lib/llm/src/kv_router/indexer.rs:122-134``.
    """
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    out: List[int] = []
    parent = salt_hash
    for start in range(0, len(tokens) - block_size + 1, block_size):
        chunk = tokens[start : start + block_size]
        parent = _hash_bytes(struct.pack("<Q", parent) + _tokens_to_bytes(chunk))
        out.append(parent)
    return out


@dataclass(frozen=True)
class TokenBlock:
    """One complete, immutable block of ``block_size`` tokens."""

    tokens: tuple
    block_hash: int  # chained (prefix-identifying) hash
    local_hash: int  # unchained hash of just this block
    parent_hash: int  # chained hash of the previous block (or salt)
    position: int  # block index within the sequence

    @property
    def block_size(self) -> int:
        return len(self.tokens)


class TokenBlockSequence:
    """A token sequence chunked into hash-chained fixed-size blocks.

    Supports O(1) amortized ``append``/``extend``, ``truncate``/``unwind`` (for
    request migration and speculative rollback), and exposes complete blocks
    plus the in-progress partial tail.

    Parity: reference ``lib/llm/src/tokens.rs:56-851``.
    """

    __slots__ = ("block_size", "salt_hash", "_blocks", "_partial", "_parent")

    def __init__(
        self,
        tokens: Optional[Iterable[int]] = None,
        block_size: int = 16,
        salt_hash: int = 0,
    ):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.salt_hash = salt_hash
        self._blocks: List[TokenBlock] = []
        self._partial: List[int] = []
        self._parent = salt_hash
        if tokens is not None:
            self.extend(tokens)

    # -- observers ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._blocks) * self.block_size + len(self._partial)

    @property
    def blocks(self) -> List[TokenBlock]:
        return list(self._blocks)

    @property
    def num_complete_blocks(self) -> int:
        return len(self._blocks)

    @property
    def partial_tokens(self) -> List[int]:
        return list(self._partial)

    def block_hashes(self) -> List[int]:
        return [b.block_hash for b in self._blocks]

    def tokens(self) -> List[int]:
        out: List[int] = []
        for b in self._blocks:
            out.extend(b.tokens)
        out.extend(self._partial)
        return out

    def last_token(self) -> int:
        """O(1) accessor for the newest token — the decode hot path feeds
        it every step; ``tokens()[-1]`` would rebuild the whole context
        list per call."""
        if self._partial:
            return self._partial[-1]
        if self._blocks:
            return self._blocks[-1].tokens[-1]
        raise IndexError("empty token sequence")

    # -- mutators ----------------------------------------------------------

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the newly completed block, if any."""
        self._partial.append(token)
        if len(self._partial) == self.block_size:
            return self._seal()
        return None

    def extend(self, tokens: Iterable[int]) -> List[TokenBlock]:
        """Append many tokens; returns all newly completed blocks."""
        new_blocks: List[TokenBlock] = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                new_blocks.append(b)
        return new_blocks

    def _seal(self) -> TokenBlock:
        chunk = tuple(self._partial)
        payload = struct.pack("<Q", self._parent) + _tokens_to_bytes(chunk)
        block = TokenBlock(
            tokens=chunk,
            block_hash=_hash_bytes(payload),
            local_hash=compute_local_block_hash(chunk),
            parent_hash=self._parent,
            position=len(self._blocks),
        )
        self._blocks.append(block)
        self._partial.clear()
        self._parent = block.block_hash
        return block

    def truncate(self, length: int) -> None:
        """Truncate the sequence to ``length`` tokens."""
        if length < 0 or length > len(self):
            raise ValueError(f"cannot truncate length-{len(self)} seq to {length}")
        keep_blocks, rem = divmod(length, self.block_size)
        if keep_blocks < len(self._blocks):
            tail: List[int] = []
            for b in self._blocks[keep_blocks:]:
                tail.extend(b.tokens)
            tail.extend(self._partial)
            del self._blocks[keep_blocks:]
            self._parent = (
                self._blocks[-1].block_hash if self._blocks else self.salt_hash
            )
            self._partial = tail[:rem]
        else:
            del self._partial[rem:]

    def unwind(self, n: int) -> None:
        """Remove the last ``n`` tokens (speculative-decode rollback)."""
        self.truncate(len(self) - n)


__all__ = [
    "HASH_SEED",
    "TokenBlock",
    "TokenBlockSequence",
    "compute_block_hash_for_seq",
    "compute_local_block_hash",
    "compute_hash",
]
