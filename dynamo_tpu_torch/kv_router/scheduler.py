"""Worker selection: cost model over prefix overlap and predicted load.

Parity: reference ``lib/llm/src/kv_router/{scheduler,scoring,sequence}.rs`` —
``DefaultWorkerSelector`` cost ``logit = overlap_weight *
potential_prefill_blocks + potential_decode_blocks`` with softmax-temperature
sampling, fed by (a) scraped ``ForwardPassMetrics`` and (b) the scheduler's
own per-worker prediction of active decode blocks (``ActiveSequences``). Here
both live in one object; the per-worker sharded threads of the reference are
unnecessary (this runs in the frontend's event loop).
"""

from __future__ import annotations

import logging
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch.protocols.events import ForwardPassMetrics

logger = logging.getLogger(__name__)

# A selector maps (candidate ids, overlaps, isl_blocks, scheduler) to a
# worker id — pluggable like the reference's WorkerSelector trait
# (kv_router.rs:55-62).
WorkerSelector = Callable[[List[int], Dict[int, int], int, "KvScheduler"], int]


@dataclass
class _ActiveSeq:
    worker: int
    blocks: int          # predicted blocks attributable to this request
    partial_tokens: int  # decode tokens since the last block boundary


@dataclass
class _WorkerState:
    active_blocks: int = 0
    metrics: Optional[ForwardPassMetrics] = None


class KvScheduler:
    """Predicts per-worker load and picks the cheapest worker."""

    def __init__(self, block_size: int, overlap_score_weight: float = 1.0,
                 temperature: float = 0.0,
                 selector: Optional[WorkerSelector] = None,
                 policy=None,
                 block_bytes: int = 0,
                 net_weight: float = 25.0):
        self.block_size = block_size
        self.overlap_score_weight = overlap_score_weight
        self.temperature = temperature
        self.selector = selector
        # optional RouterPolicy (runtime/resilience.py): adds the failure-
        # aware terms — EWMA-TTFT penalty + router-side in-flight — to the
        # block cost, and filters breaker-open workers out of selection
        self.policy = policy
        # NetKV-style pricing of fleet-held prefixes: when the global index
        # says some worker holds ``fleet_best`` leading blocks, every
        # candidate can ONBOARD the blocks it lacks from that peer instead
        # of recomputing — worth overlap_weight * blocks, costing
        # net_weight * (bytes / measured plane bandwidth). block_bytes=0
        # disables the credit (no way to size the move).
        self.block_bytes = block_bytes
        self.net_weight = net_weight
        self._workers: Dict[int, _WorkerState] = {}
        self._seqs: Dict[str, _ActiveSeq] = {}

    # -- load inputs -------------------------------------------------------

    def update_metrics(self, metrics: Dict[int, ForwardPassMetrics]) -> None:
        for wid, m in metrics.items():
            self._workers.setdefault(wid, _WorkerState()).metrics = m
        for wid in [w for w in self._workers if w not in metrics]:
            # keep predicted state; scraped metrics just went stale
            self._workers[wid].metrics = None

    def remove_worker(self, worker: int) -> None:
        self._workers.pop(worker, None)
        for rid in [r for r, s in self._seqs.items() if s.worker == worker]:
            del self._seqs[rid]

    # -- active-sequence prediction ---------------------------------------

    def begin(self, request_id: str, worker: int, isl_blocks: int,
              overlap_blocks: int) -> None:
        """Record a routing decision: the worker will hold the prompt's
        blocks (new prefill allocations + revived prefix)."""
        st = self._workers.setdefault(worker, _WorkerState())
        st.active_blocks += isl_blocks
        self._seqs[request_id] = _ActiveSeq(worker=worker, blocks=isl_blocks,
                                            partial_tokens=0)

    def push(self, request_id: str, n_tokens: int) -> None:
        """Account decoded tokens; every block_size tokens adds a block."""
        seq = self._seqs.get(request_id)
        if seq is None:
            return
        seq.partial_tokens += n_tokens
        new_blocks, seq.partial_tokens = divmod(seq.partial_tokens,
                                                self.block_size)
        if new_blocks:
            seq.blocks += new_blocks
            st = self._workers.get(seq.worker)
            if st is not None:
                st.active_blocks += new_blocks

    def free(self, request_id: str) -> None:
        seq = self._seqs.pop(request_id, None)
        if seq is None:
            return
        st = self._workers.get(seq.worker)
        if st is not None:
            st.active_blocks = max(0, st.active_blocks - seq.blocks)

    # -- selection ---------------------------------------------------------

    def net_credit(self, worker: int, overlap_blocks: int, isl_blocks: int,
                   fleet_best: int) -> Tuple[float, float, int]:
        """(credit, net_cost_s, onboardable) for pulling the blocks this
        worker lacks (up to the fleet's best-held prefix) from a peer.
        The credit is the recompute cost avoided minus the network price;
        it never goes negative — a slow plane simply earns nothing and
        local recompute wins on the undiscounted score."""
        onboardable = max(0, min(fleet_best, isl_blocks) - overlap_blocks)
        if (onboardable <= 0 or self.block_bytes <= 0
                or self.policy is None):
            return 0.0, 0.0, onboardable
        net_cost_s = self.policy.net_cost_s(
            worker, onboardable * self.block_bytes)
        if net_cost_s == float("inf"):
            return 0.0, net_cost_s, onboardable
        saved = self.overlap_score_weight * onboardable
        credit = max(0.0, saved - self.net_weight * net_cost_s)
        return credit, net_cost_s, onboardable

    def cost(self, worker: int, overlap_blocks: int, isl_blocks: int,
             fleet_best: int = 0) -> float:
        st = self._workers.setdefault(worker, _WorkerState())
        potential_prefill = max(0, isl_blocks - overlap_blocks)
        potential_decode = st.active_blocks
        if st.metrics is not None:
            # blend in the worker's own view: waiting requests mean queued
            # prefill work this prediction can't see
            potential_decode += st.metrics.worker_stats.num_requests_waiting
        bias = 0.0
        if self.policy is not None:
            # queue depth is already priced above via num_requests_waiting;
            # cost_bias adds only the terms this model lacks (in-flight,
            # observed-latency penalty)
            bias = self.policy.cost_bias(worker)
        credit, _, _ = self.net_credit(worker, overlap_blocks, isl_blocks,
                                       fleet_best)
        return (self.overlap_score_weight * potential_prefill
                + potential_decode + bias - credit)

    def select(self, candidates: List[int], overlaps: Dict[int, int],
               isl_blocks: int,
               explain: Optional[Dict[int, Dict]] = None,
               fleet_best: int = 0) -> Tuple[int, int]:
        """Pick a worker; returns (worker_id, its overlap blocks).  When
        ``explain`` is passed, it is filled with each candidate's score
        inputs (for the routing-decision trace attrs).  ``fleet_best`` is
        the global index's best-held leading-block count, enabling the
        net-priced onboarding credit."""
        if not candidates:
            raise ConnectionError("no workers available for KV routing")
        if self.policy is not None:
            allowed = [w for w in candidates if self.policy.breakers.allow(w)]
            # all breakers open: degrade to the full set rather than refuse
            candidates = allowed or candidates
        if self.selector is not None:
            chosen = self.selector(candidates, overlaps, isl_blocks, self)
            return chosen, overlaps.get(chosen, 0)
        costs = [self.cost(w, overlaps.get(w, 0), isl_blocks,
                           fleet_best=fleet_best)
                 for w in candidates]
        if explain is not None:
            for w, c in zip(candidates, costs):
                credit, net_cost_s, onboardable = self.net_credit(
                    w, overlaps.get(w, 0), isl_blocks, fleet_best)
                explain[w] = {"cost": round(c, 4),
                              "overlap_blocks": overlaps.get(w, 0),
                              "active_blocks":
                                  self._workers[w].active_blocks
                                  if w in self._workers else 0,
                              "net_cost": (round(net_cost_s, 6)
                                           if net_cost_s != float("inf")
                                           else -1.0),
                              "net_credit": round(credit, 4),
                              "onboardable_blocks": onboardable}
        if self.temperature <= 0.0:
            best = min(costs)
            chosen = random.choice(
                [w for w, c in zip(candidates, costs) if c == best])
        else:
            # softmax over negative cost (cheaper => likelier)
            lo = min(costs)
            weights = [math.exp(-(c - lo) / self.temperature) for c in costs]
            chosen = random.choices(candidates, weights=weights, k=1)[0]
        if self.policy is not None and fleet_best > 0:
            credit, net_cost_s, onboardable = self.net_credit(
                chosen, overlaps.get(chosen, 0), isl_blocks, fleet_best)
            if onboardable > 0:
                if net_cost_s == float("inf"):
                    self.policy.stats.note_net_priced("no_path", 0.0)
                elif credit > 0:
                    self.policy.stats.note_net_priced("credit", net_cost_s)
                else:
                    self.policy.stats.note_net_priced("no_credit", net_cost_s)
        return chosen, overlaps.get(chosen, 0)


__all__ = ["KvScheduler", "WorkerSelector"]
