"""The mock engine: production scheduling + a calibrated timing model.

Cost model (defaults approximate one v5e chip serving an 8B model, scaled by
``speedup_ratio`` like the reference's ``MockEngineArgs.speedup_ratio``):

- prefill chunk of ``n`` tokens against ``c`` cached tokens:
  ``base + n * per_prefill_token + n * c * attn_quadratic`` — the quadratic
  term models attention against the growing context, which is what makes
  chunked prefill of long prompts progressively slower (the reference's
  prefill-cost model serves the same purpose, ``mocker/scheduler.rs``).
- decode step over a batch of ``b`` sequences: ``base + b * per_decode_token``.

Tokens are sampled deterministically from the request id (stable across
migrations/retries) unless the request carries nonzero temperature, in which
case they are pseudo-random.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from dynamo_tpu_torch.engine.loop import ScheduledEngineBase
from dynamo_tpu_torch.engine.scheduler import (
    MixedStepBatch,
    PrefillBatch,
    StepPlan,
)


@dataclass
class MockEngineArgs:
    """Parity: reference ``mocker/protocols.rs:80-142`` ``MockEngineArgs``."""

    num_pages: int = 512           # reference: num_gpu_blocks
    page_size: int = 16            # reference: block_size
    max_num_seqs: int = 64
    max_prefill_chunk: int = 512
    max_prefill_seqs: int = 8
    max_context: int = 4096
    speedup_ratio: float = 1.0     # >1 = faster than real time
    vocab_size: int = 32000
    # timing model (seconds)
    prefill_base_s: float = 0.004
    prefill_per_token_s: float = 25e-6
    prefill_attn_quadratic_s: float = 3e-9
    decode_base_s: float = 0.006
    decode_per_seq_s: float = 120e-6
    dp_size: int = 1               # metadata only (reported in stats)
    # fused decode: the mocker honors the same dispatch_multistep /
    # fetch_packed_block hook pair as the real engine, so pipeline tests
    # exercise the block path end to end. One block pays ONE decode_base_s
    # for ``width`` tokens — exactly the amortization the fused dispatch
    # models. 1 disables.
    decode_multistep: int = 8
    # mixed prefill+decode dispatch: the mocker executes MixedStepBatch
    # plans (prefill chunks + decode rows in ONE step paying one shared
    # base cost) so pipeline/disagg tests exercise the mixed path without
    # a TPU, matching the real engine's scheduling
    mixed_batch: bool = True
    decode_progress_every: int = 2


class MockerEngine(ScheduledEngineBase):
    def __init__(self, args: MockEngineArgs = None):
        self.args = args or MockEngineArgs()
        a = self.args
        super().__init__(num_pages=a.num_pages, page_size=a.page_size,
                         max_num_seqs=a.max_num_seqs,
                         max_prefill_chunk=a.max_prefill_chunk,
                         max_context=a.max_context,
                         max_prefill_seqs=a.max_prefill_seqs,
                         decode_multistep=a.decode_multistep,
                         mixed_batch=a.mixed_batch,
                         decode_progress_every=a.decode_progress_every)
        self._rng = np.random.default_rng(0)
        self.decode_dispatches = 0
        self.multistep_blocks = 0
        self.mixed_steps = 0

    def _simulate(self, seconds: float) -> None:
        if self.args.speedup_ratio > 0:
            time.sleep(seconds / self.args.speedup_ratio)

    def _token_for(self, request_id: str, position: int,
                   temperature: float) -> int:
        if temperature and temperature > 0:
            return int(self._rng.integers(1, self.args.vocab_size))
        digest = hashlib.blake2b(f"{request_id}:{position}".encode(),
                                 digest_size=4).digest()
        return int.from_bytes(digest, "little") % self.args.vocab_size

    def _execute_plan(self, plan: StepPlan) -> Tuple[np.ndarray, np.ndarray]:
        a = self.args
        if isinstance(plan, (PrefillBatch, MixedStepBatch)):
            # one shared step base + per-chunk token/attention costs: chunks
            # batched into one step amortize the launch overhead, which is
            # exactly the benefit batched prefill exists to model. A mixed
            # plan's decode rows ride the SAME base (that amortization is
            # what the mixed dispatch exists to model) and pay only their
            # per-sequence decode cost.
            decode_seqs = list(getattr(plan, "decode_seqs", ()))
            cost = a.prefill_base_s + len(decode_seqs) * a.decode_per_seq_s
            n = len(plan.chunks) + len(decode_seqs)
            toks = np.empty(n, np.int64)
            for i, c in enumerate(plan.chunks):
                cost += (c.length * a.prefill_per_token_s
                         + c.length * c.start * a.prefill_attn_quadratic_s)
                seq = c.seq
                so = seq.request.sampling_options
                toks[i] = self._token_for(seq.request.request_id, len(seq),
                                          so.temperature or 0.0)
            for j, seq in enumerate(decode_seqs, start=len(plan.chunks)):
                so = seq.request.sampling_options
                toks[j] = self._token_for(seq.request.request_id, len(seq),
                                          so.temperature or 0.0)
            self._simulate(cost)
            if decode_seqs:
                self.decode_dispatches += 1
                self.mixed_steps += 1
            return toks, np.full(n, -1.0, np.float32), None
        b = len(plan.seqs)
        self._simulate(a.decode_base_s + b * a.decode_per_seq_s)
        self.decode_dispatches += 1
        toks = np.empty(b, np.int64)
        for i, seq in enumerate(plan.seqs):
            so = seq.request.sampling_options
            toks[i] = self._token_for(seq.request.request_id, len(seq),
                                      so.temperature or 0.0)
        return toks, np.full(b, -1.0, np.float32), None

    # -- fused decode hooks (loop.py) --------------------------------------
    # The mocker's "device" is the host, so the block's tokens are computed
    # at dispatch time and the handle just carries them; the SINGLE
    # decode_base_s per block (vs per step) is the amortization the fused
    # dispatch exists to model. Token values match the per-step path:
    # _token_for keys on (request_id, position) and a block's row j sits at
    # position start_lens[i] + j — start_lens already carries the chained
    # offset, so chained blocks stay position-exact while host appends lag.

    @property
    def supports_multistep(self) -> bool:
        return self.args.decode_multistep > 1

    def dispatch_multistep(self, plan, prev_handle=None):
        a = self.args
        b, w = len(plan.seqs), plan.width
        self._simulate(a.decode_base_s + w * b * a.decode_per_seq_s)
        self.decode_dispatches += 1
        self.multistep_blocks += 1
        toks = np.empty((b, w), np.int64)
        for i, seq in enumerate(plan.seqs):
            so = seq.request.sampling_options
            for j in range(w):
                toks[i, j] = self._token_for(seq.request.request_id,
                                             plan.start_lens[i] + j,
                                             so.temperature or 0.0)
        return (toks, np.full((b, w), -1.0, np.float32))

    def fetch_packed_block(self, handle):
        toks, lps = handle
        return toks, lps, None


__all__ = ["MockerEngine", "MockEngineArgs"]
