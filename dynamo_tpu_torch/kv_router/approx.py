"""Predictive (event-free) prefix index.

Parity: reference ``lib/llm/src/kv_router/approx.rs`` (``ApproxKvIndexer``) —
for engines that publish no KV events, predict cache contents purely from this
router's own decisions: when a request is routed to a worker, assume its
prompt blocks are cached there for ``ttl`` seconds.

Same ``find_matches`` interface as ``KvIndexer`` so the scheduler/router are
agnostic. Storage is per-worker hash maps, so the router hot path costs
O(workers x prompt blocks) dict probes — NOT O(total tracked entries) per
request (the reference budgets this path explicitly).
Expiry is lazy (pruned on lookup) plus a bounded sweep to stop unbounded
growth under skewed traffic.
"""

from __future__ import annotations

import time
from typing import Dict, List

DEFAULT_TTL_S = 120.0

# total tracked entries above which a lookup triggers a full sweep
SWEEP_THRESHOLD = 65536


class ApproxKvIndexer:
    def __init__(self, block_size: int, ttl: float = DEFAULT_TTL_S):
        self.block_size = block_size
        self.ttl = ttl
        # worker -> {block_hash -> expiry monotonic time}
        self._by_worker: Dict[int, Dict[int, float]] = {}
        self._total = 0

    def record_routing(self, worker: int, block_hashes: List[int]) -> None:
        exp = time.monotonic() + self.ttl
        m = self._by_worker.setdefault(worker, {})
        before = len(m)
        for h in block_hashes:
            m[h] = exp
        self._total += len(m) - before

    def remove_worker(self, worker: int) -> None:
        m = self._by_worker.pop(worker, None)
        if m:
            self._total -= len(m)

    def _sweep(self, now: float) -> None:
        if self._total < SWEEP_THRESHOLD:
            return
        for w in list(self._by_worker):
            m = self._by_worker[w]
            dead = [h for h, t in m.items() if t <= now]
            for h in dead:
                del m[h]
            self._total -= len(dead)
            if not m:
                del self._by_worker[w]

    def find_matches(self, block_hashes: List[int]) -> Dict[int, int]:
        now = time.monotonic()
        self._sweep(now)
        overlaps: Dict[int, int] = {}
        for w, m in self._by_worker.items():
            n = 0
            for h in block_hashes:
                t = m.get(h)
                if t is None or t <= now:
                    break
                n += 1
            if n:
                overlaps[w] = n
        return overlaps


__all__ = ["ApproxKvIndexer", "DEFAULT_TTL_S", "SWEEP_THRESHOLD"]
