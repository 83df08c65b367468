"""KV-cache event plane and worker load-metric types.

Workers publish ``KvCacheEvent``s (blocks stored / removed) on the event bus;
the KV router applies them to its radix tree.  Workers also publish
``ForwardPassMetrics`` snapshots that the router's scheduler uses for load-aware
placement.

Parity: reference ``lib/llm/src/kv_router/protocols.rs`` (``KvCacheEvent``,
``RouterEvent``, ``ForwardPassMetrics{WorkerStats, KvStats, SpecDecodeStats}``)
and ``lib/llm/src/kv_router/publisher.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class KvCacheStoredBlock:
    block_hash: int
    tokens_hash: int  # unchained local hash (diagnostics)

    def to_dict(self) -> Dict[str, Any]:
        return {"block_hash": self.block_hash, "tokens_hash": self.tokens_hash}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvCacheStoredBlock":
        return cls(block_hash=d["block_hash"], tokens_hash=d.get("tokens_hash", 0))


@dataclass
class KvCacheEvent:
    """One cache mutation on a worker.

    ``stored`` events carry the chained block hashes (with the parent hash so
    the indexer can attach them at the right radix-tree position); ``removed``
    events carry evicted block hashes.  ``event_id`` is a per-worker
    monotonically increasing sequence number used to detect gaps.
    """

    event_id: int = 0
    stored_blocks: List[KvCacheStoredBlock] = field(default_factory=list)
    stored_parent_hash: Optional[int] = None
    removed_block_hashes: List[int] = field(default_factory=list)
    # "all_blocks_cleared" resets the worker's subtree (e.g. /clear_kv_blocks)
    all_blocks_cleared: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "event_id": self.event_id,
            "stored_blocks": [b.to_dict() for b in self.stored_blocks],
            "stored_parent_hash": self.stored_parent_hash,
            "removed_block_hashes": list(self.removed_block_hashes),
            "all_blocks_cleared": self.all_blocks_cleared,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvCacheEvent":
        return cls(
            event_id=d.get("event_id", 0),
            stored_blocks=[KvCacheStoredBlock.from_dict(b) for b in d.get("stored_blocks", [])],
            stored_parent_hash=d.get("stored_parent_hash"),
            removed_block_hashes=list(d.get("removed_block_hashes", [])),
            all_blocks_cleared=bool(d.get("all_blocks_cleared", False)),
        )


@dataclass
class RouterEvent:
    """A ``KvCacheEvent`` attributed to a worker instance."""

    worker_id: int
    event: KvCacheEvent

    def to_dict(self) -> Dict[str, Any]:
        return {"worker_id": self.worker_id, "event": self.event.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RouterEvent":
        return cls(worker_id=d["worker_id"], event=KvCacheEvent.from_dict(d["event"]))


@dataclass
class WorkerStats:
    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0
    data_parallel_rank: Optional[int] = None
    # cumulative MoE dispatch overflow (token-expert assignments dropped
    # past expert capacity) — 0 on dense models/backends; a growing value
    # tells an operator that output perturbation is dispatch overflow, not
    # model behavior (extension over the reference's protocols.rs fields)
    moe_dropped_tokens: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "request_active_slots": self.request_active_slots,
            "request_total_slots": self.request_total_slots,
            "num_requests_waiting": self.num_requests_waiting,
            "data_parallel_rank": self.data_parallel_rank,
            "moe_dropped_tokens": self.moe_dropped_tokens,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkerStats":
        return cls(
            request_active_slots=d.get("request_active_slots", 0),
            request_total_slots=d.get("request_total_slots", 0),
            num_requests_waiting=d.get("num_requests_waiting", 0),
            data_parallel_rank=d.get("data_parallel_rank"),
            moe_dropped_tokens=d.get("moe_dropped_tokens", 0),
        )


@dataclass
class KvStats:
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0  # name kept engine-agnostic in semantics
    gpu_prefix_cache_hit_rate: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kv_active_blocks": self.kv_active_blocks,
            "kv_total_blocks": self.kv_total_blocks,
            "gpu_cache_usage_perc": self.gpu_cache_usage_perc,
            "gpu_prefix_cache_hit_rate": self.gpu_prefix_cache_hit_rate,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvStats":
        return cls(
            kv_active_blocks=d.get("kv_active_blocks", 0),
            kv_total_blocks=d.get("kv_total_blocks", 0),
            gpu_cache_usage_perc=d.get("gpu_cache_usage_perc", 0.0),
            gpu_prefix_cache_hit_rate=d.get("gpu_prefix_cache_hit_rate", 0.0),
        )


@dataclass
class SpecDecodeStats:
    num_spec_tokens: int = 0
    num_drafts: int = 0
    num_draft_tokens: int = 0
    num_accepted_tokens: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "num_spec_tokens": self.num_spec_tokens,
            "num_drafts": self.num_drafts,
            "num_draft_tokens": self.num_draft_tokens,
            "num_accepted_tokens": self.num_accepted_tokens,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpecDecodeStats":
        return cls(**{k: d.get(k, 0) for k in (
            "num_spec_tokens", "num_drafts", "num_draft_tokens", "num_accepted_tokens")})


@dataclass
class ForwardPassMetrics:
    """A worker's load snapshot, published periodically and scraped on demand.

    Parity: reference ``kv_router/protocols.rs:42-100``.
    """

    worker_stats: WorkerStats = field(default_factory=WorkerStats)
    kv_stats: KvStats = field(default_factory=KvStats)
    spec_decode_stats: Optional[SpecDecodeStats] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "worker_stats": self.worker_stats.to_dict(),
            "kv_stats": self.kv_stats.to_dict(),
        }
        if self.spec_decode_stats is not None:
            d["spec_decode_stats"] = self.spec_decode_stats.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ForwardPassMetrics":
        sd = d.get("spec_decode_stats")
        return cls(
            worker_stats=WorkerStats.from_dict(d.get("worker_stats") or {}),
            kv_stats=KvStats.from_dict(d.get("kv_stats") or {}),
            spec_decode_stats=SpecDecodeStats.from_dict(sd) if sd else None,
        )


@dataclass
class KVHitRateEvent:
    """Emitted by the router scheduler on each routing decision."""

    worker_id: int
    isl_blocks: int
    overlap_blocks: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "isl_blocks": self.isl_blocks,
            "overlap_blocks": self.overlap_blocks,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KVHitRateEvent":
        return cls(d["worker_id"], d["isl_blocks"], d["overlap_blocks"])


__all__ = [
    "KvCacheStoredBlock",
    "KvCacheEvent",
    "RouterEvent",
    "WorkerStats",
    "KvStats",
    "SpecDecodeStats",
    "ForwardPassMetrics",
    "KVHitRateEvent",
]
