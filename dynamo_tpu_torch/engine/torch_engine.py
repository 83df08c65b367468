"""The serving engine on PyTorch + CUDA: continuous batching over a paged
KV cache, one model step per scheduler plan.

The port of ``dynamo_tpu/engine/jax_engine.py`` ``JaxEngine`` on its per-step
main path: ``TorchEngine`` plugs into the same loop (``engine/loop.py``
``ScheduledEngineBase``) and overrides only ``_execute_plan``. For each
plan it builds the same padded host arrays as the reference (power-of-two
buckets on batch and chunk length, page table ``max_context // page_size``
wide, pad rows with one garbage-page token), runs the model family's forward
(``models.get_family``) with the attention kernel chosen by the step's
shape — the reference's choice on its Pallas path. The Llama tree:

- ``DecodeBatch`` (and any step with S == 1): the paged decode kernel;
- ``PrefillBatch``: the chunked-prefill kernel;
- ``MixedStepBatch`` (prefill chunks + decode rows as length-1 chunks,
  mixed batching on by default): the ragged mixed kernel.

DeepSeek (MLA, ``models/deepseek.py``): S == 1 steps run the latent decode
kernel, every S > 1 step (prefill and mixed alike) the latent prefill
kernel, which skips a decode row's pad query tiles itself. On the GPU a
geometry the latent kernels do not take is refused at construction.

Each step then samples on the device and packs everything the host needs
into one ``[B, 2 + 2K]`` int32 buffer (token, logprob bits, K alternative
ids, K alternative logprob bits): one device-to-host copy per step.

Not on this slice, and refused rather than approximated: pipelined decode
and the fused multi-step block (ROADMAP A5), speculative decoding (A8),
per-request seeds, penalties, logit bias and guided decoding (A4/A8),
sequence-parallel ring prefill (A13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.loop import ScheduledEngineBase
from dynamo_tpu_torch.engine.scheduler import (DecodeBatch, MixedStepBatch,
                                               PrefillBatch, PrefillChunk,
                                               StepPlan)
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.kernels._wrap import mla_geometry_error
from dynamo_tpu_torch.ops.kernels.decode import paged_decode_attention_stacked
from dynamo_tpu_torch.ops.kernels.mla_decode import mla_paged_decode_stacked
from dynamo_tpu_torch.ops.kernels.mla_prefill import mla_paged_prefill_stacked
from dynamo_tpu_torch.ops.kernels.prefill import (
    paged_prefill_attention_stacked)
from dynamo_tpu_torch.ops.kernels.ragged import ragged_mixed_attention_stacked
from dynamo_tpu_torch.ops.sampling import (TOPK_MAX, gumbel_noise,
                                           log_softmax_at, sample_tokens,
                                           top_k_stable)
from dynamo_tpu_torch.utils.device import resolve_device

ATTENTION = {
    "paged_decode": paged_decode_attention_stacked,
    "paged_prefill": paged_prefill_attention_stacked,
    "ragged_mixed": ragged_mixed_attention_stacked,
}


def _mla_decode(q_lat, q_pe, pages, layer, page_table, positions, total_lens,
                sm_scale):
    """The decode wrapper behind the MLA forward's hook signature (the
    decode kernel reads no positions)."""
    return mla_paged_decode_stacked(q_lat, q_pe, pages, layer, page_table,
                                    total_lens, sm_scale)


MLA_ATTENTION = {
    "mla_decode": _mla_decode,
    "mla_prefill": mla_paged_prefill_stacked,
}

# batch rows pad to the next power of two from this (decode and chunk steps)
MIN_BATCH_BUCKET = 1


@dataclass
class TorchEngineConfig:
    """Engine sizing knobs (``JaxEngineConfig``'s, for the ported path)."""

    num_pages: int = 512          # physical KV pages (page 0 reserved)
    page_size: int = 16           # tokens per page == router block size
    max_num_seqs: int = 8         # max concurrent sequences
    max_prefill_chunk: int = 512  # prompt-token budget per prefill step
    max_prefill_seqs: int = 8     # sequences sharing one prefill step
    max_context: int = 2048       # max prompt+generation length
    min_prefill_bucket: int = 16
    # alternatives returned per sampled token (OpenAI top_logprobs)
    num_top_logprobs: int = 8
    seed: int = 0
    # mixed prefill+decode dispatch (decode rows ride prefill steps as
    # length-1 ragged chunks); False restores the strict alternation
    mixed_batch: bool = True
    # with mixed batching off: at most K-1 prefill-only steps in a row
    # while decode rows wait
    decode_progress_every: int = 2


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


class TorchEngine(ScheduledEngineBase):
    """Continuous-batching paged-KV engine over a PyTorch Llama-tree or
    DeepSeek (MLA) model."""

    def __init__(self, model_cfg: ModelConfig, params,
                 config: Optional[TorchEngineConfig] = None, device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = config or TorchEngineConfig()
        self.family = get_family(model_cfg)
        self.mla = bool(model_cfg.kv_lora_rank)
        if self.mla and self.device.type == "cuda":
            bad = mla_geometry_error(model_cfg.num_heads,
                                     model_cfg.kv_lora_rank,
                                     model_cfg.qk_rope_head_dim,
                                     self.cfg.page_size)
            if bad is None and model_cfg.dtype != "bfloat16":
                bad = f"dtype {model_cfg.dtype}, not bfloat16"
            if bad:
                raise ValueError(f"{model_cfg.model_type}: the latent "
                                 f"attention kernels do not take this "
                                 f"geometry: {bad}")
        self.attention = MLA_ATTENTION if self.mla else ATTENTION
        super().__init__(
            num_pages=self.cfg.num_pages, page_size=self.cfg.page_size,
            max_num_seqs=self.cfg.max_num_seqs,
            max_prefill_chunk=self.cfg.max_prefill_chunk,
            max_context=self.cfg.max_context,
            max_prefill_seqs=self.cfg.max_prefill_seqs,
            decode_multistep=1, mixed_batch=bool(self.cfg.mixed_batch),
            decode_progress_every=int(self.cfg.decode_progress_every))
        self.params = _params_to(params, self.device)
        # the paged cache, updated in place by every step
        self.pages = self.family.make_pages(model_cfg, self.cfg.num_pages,
                                            self.cfg.page_size,
                                            device=self.device)
        self.table_width = self.cfg.max_context // self.cfg.page_size
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.cfg.seed)
        self._step_counter = 0
        self.decode_dispatches = 0
        self.mixed_steps = 0
        # attention calls routed to each of the family's kernels (per
        # layer, both devices)
        self.kernel_launches: Dict[str, int] = {k: 0
                                                for k in self.attention}

    # -- admission ---------------------------------------------------------

    def validate_request(self, request) -> Optional[str]:
        so = request.sampling_options
        missing = [name for name, on in (
            ("seed", so.seed is not None),
            ("frequency_penalty", bool(so.frequency_penalty)),
            ("presence_penalty", bool(so.presence_penalty)),
            ("repetition_penalty", so.repetition_penalty not in (None, 1.0)),
            ("logit_bias", bool(so.logit_bias)),
            ("guided", bool(so.guided))) if on]
        if missing:
            return (f"{', '.join(missing)}: not yet served by the torch "
                    "engine (ROADMAP A4/A8)")
        return None

    # -- one step ----------------------------------------------------------

    def _row_sampling(self, i: int, seq, arrays: dict) -> None:
        so = seq.request.sampling_options
        if so.temperature is not None:
            arrays["temp"][i] = so.temperature
        arrays["top_k"][i] = so.top_k or 0
        if so.top_p is not None:
            arrays["top_p"][i] = so.top_p
        if so.min_p:
            arrays["min_p"][i] = so.min_p

    def _empty_arrays(self, B: int, S: int) -> dict:
        return dict(toks=np.zeros((B, S), np.int32),
                    pos=np.zeros((B, S), np.int32),
                    table=np.zeros((B, self.table_width), np.int32),
                    total=np.ones(B, np.int32),  # pad rows: 1 garbage token
                    new=np.zeros(B, np.int32),   # pad rows: write nothing
                    temp=np.zeros(B, np.float32),
                    top_k=np.zeros(B, np.int32),
                    top_p=np.ones(B, np.float32),
                    min_p=np.zeros(B, np.float32))

    def _chunk_arrays(self, chunks) -> dict:
        B = _bucket(len(chunks), MIN_BATCH_BUCKET, self.cfg.max_num_seqs)
        S = _bucket(max(c.length for c in chunks),
                    self.cfg.min_prefill_bucket, self.cfg.max_prefill_chunk)
        a = self._empty_arrays(B, S)
        for i, c in enumerate(chunks):
            seq = c.seq
            if c.length == 1 and c.start == len(seq) - 1:
                a["toks"][i, 0] = seq.tokens.last_token()
            else:
                a["toks"][i, :c.length] = \
                    seq.tokens.tokens()[c.start:c.start + c.length]
            a["pos"][i, :c.length] = np.arange(c.start, c.start + c.length)
            a["table"][i, :len(seq.page_ids)] = seq.page_ids
            a["total"][i] = c.start + c.length
            a["new"][i] = c.length
            self._row_sampling(i, seq, a)
        return a

    def _decode_arrays(self, seqs) -> dict:
        B = _bucket(len(seqs), MIN_BATCH_BUCKET, self.cfg.max_num_seqs)
        a = self._empty_arrays(B, 1)
        for i, seq in enumerate(seqs):
            a["toks"][i, 0] = seq.tokens.last_token()
            a["pos"][i, 0] = len(seq) - 1
            a["table"][i, :len(seq.page_ids)] = seq.page_ids
            a["total"][i] = len(seq)
            a["new"][i] = 1
            self._row_sampling(i, seq, a)
        return a

    def _execute_plan(self, plan: StepPlan):
        """Build the padded arrays, run one step, fetch the sampled tokens."""
        if isinstance(plan, (PrefillBatch, MixedStepBatch)):
            mixed = isinstance(plan, MixedStepBatch)
            if not mixed and plan.ring:
                raise NotImplementedError(
                    "sequence-parallel ring prefill (ROADMAP A13)")
            chunks = list(plan.chunks)
            if mixed:
                # decode rows ARE ragged chunks of length 1
                chunks += [PrefillChunk(seq=s, start=len(s) - 1, length=1,
                                        is_last=True)
                           for s in plan.decode_seqs]
            a = self._chunk_arrays(chunks)
            if self.mla:
                kernel = ("mla_decode" if a["toks"].shape[1] == 1
                          else "mla_prefill")
            elif a["toks"].shape[1] == 1:
                kernel = "paged_decode"
            else:
                kernel = "ragged_mixed" if mixed else "paged_prefill"
            if mixed:
                self.decode_dispatches += 1
                self.mixed_steps += 1
            fetch = any(c.is_last for c in chunks)
        elif isinstance(plan, DecodeBatch):
            a = self._decode_arrays(plan.seqs)
            kernel = "mla_decode" if self.mla else "paged_decode"
            self.decode_dispatches += 1
            fetch = True
        else:
            raise NotImplementedError(
                f"{type(plan).__name__}: speculative decoding is ROADMAP A8 "
                "and the fused multi-step block ROADMAP A5")
        plan._step_id = self._step_counter
        packed = self._step(a, kernel)
        self._step_counter += 1
        self.last_padded = a["toks"].shape
        if not fetch:
            # no row samples this step (intermediate prompt chunks): skip
            # the device-to-host copy; nobody reads these values
            B = a["toks"].shape[0]
            return np.zeros(B, np.int64), np.zeros(B, np.float32), None
        return self.fetch_packed(packed)

    @torch.no_grad()
    def _step(self, a: dict, kernel: str) -> torch.Tensor:
        """Upload one step's arrays, run the forward with ``kernel`` as the
        attention, sample, and return the packed ``[B, 2 + 2K]`` int32
        result (still on the device)."""
        dev = self.device
        t = {k: torch.from_numpy(v).to(dev, non_blocking=True)
             for k, v in a.items()}
        impl = self.attention[kernel]

        def attn(*args, **kw):
            self.kernel_launches[kernel] += 1
            return impl(*args, **kw)

        logits, self.pages = self.family.forward(
            self.params, self.model_cfg, t["toks"], t["pos"], self.pages,
            t["table"], t["total"], t["new"], attn_impl=attn)
        return self._sample_tail(logits, t, use_min_p=bool(a["min_p"].any()))

    def _sample_tail(self, logits: torch.Tensor, t: dict,
                     use_min_p: bool) -> torch.Tensor:
        B, V = logits.shape
        gumbel = gumbel_noise((B, min(TOPK_MAX, V)), self._gen, self.device)
        min_p = t["min_p"] if use_min_p else None
        tokens, logprobs = sample_tokens(logits, gumbel, t["temp"],
                                         t["top_k"], t["top_p"], min_p=min_p)
        cols = [tokens[:, None], logprobs.view(torch.int32)[:, None]]
        kt = min(self.cfg.num_top_logprobs, V)
        if kt > 0:
            vals, ids = top_k_stable(logits, kt)
            cols += [ids.to(torch.int32),
                     log_softmax_at(logits, vals).view(torch.int32)]
        return torch.cat(cols, dim=1)

    def fetch_packed(self, packed: torch.Tensor):
        """One device-to-host copy of the packed step result, unpacked into
        (sampled, logprobs, extras) as ``JaxEngine.fetch_packed`` does."""
        host = packed.cpu().numpy()
        hostf = host.view(np.float32)
        extras = None
        if host.shape[1] > 2:
            K = (host.shape[1] - 2) // 2
            extras = {"top_ids": host[:, 2:2 + K],
                      "top_lps": hostf[:, 2 + K:]}
        return host[:, 0], hostf[:, 1], extras

    @classmethod
    def random_init(cls, model_cfg: ModelConfig,
                    config: Optional[TorchEngineConfig] = None,
                    seed: int = 0, device=None) -> "TorchEngine":
        """Engine with random weights made on the device from ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = get_family(model_cfg).init_params(model_cfg, gen,
                                                   device=dev)
        return cls(model_cfg, params, config, device=dev)


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


__all__ = ["TorchEngine", "TorchEngineConfig"]
