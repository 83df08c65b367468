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

Each step then samples on the device with every option the reference
serves: penalties and logit bias over a per-row window, the guided-decoding
allow-mask (``engine/guided.py``), per-request seeds, and the reference's
key schedule through ``ops/prng.py`` (JAX's threefry, bit for bit), so
sampled streams match ``JaxEngine``'s token for token. It packs everything
the host needs into one ``[B, 2 + 2K]`` int32 buffer (token, logprob bits,
K alternative ids, K alternative logprob bits): one device-to-host copy
per step.

Not on this slice, and refused rather than approximated: pipelined decode
and the fused multi-step block (ROADMAP A5), speculative decoding (A8),
sequence-parallel ring prefill (A13).
"""

from __future__ import annotations

import json
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.guided import (GuidedRequest, GuidedVocab,
                                            compile_guided)
from dynamo_tpu_torch.engine.loop import ScheduledEngineBase
from dynamo_tpu_torch.engine.scheduler import (DecodeBatch, MixedStepBatch,
                                               PrefillBatch, PrefillChunk,
                                               StepPlan)
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import prng
from dynamo_tpu_torch.ops.kernels._wrap import mla_geometry_error
from dynamo_tpu_torch.ops.kernels.decode import paged_decode_attention_stacked
from dynamo_tpu_torch.ops.kernels.mla_decode import mla_paged_decode_stacked
from dynamo_tpu_torch.ops.kernels.mla_prefill import mla_paged_prefill_stacked
from dynamo_tpu_torch.ops.kernels.prefill import (
    paged_prefill_attention_stacked)
from dynamo_tpu_torch.ops.kernels.ragged import ragged_mixed_attention_stacked
from dynamo_tpu_torch.ops.sampling import (TOPK_MAX, apply_penalties,
                                           apply_vocab_mask, log_softmax_at,
                                           sample_tokens, sampling_noise,
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
    # penalty/bias window slots per row (frequency/presence/repetition
    # penalties and logit_bias ride a sparse window of this many ids)
    penalty_window: int = 32
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
        self.scheduler.cfg.penalty_window = self.cfg.penalty_window
        self.table_width = self.cfg.max_context // self.cfg.page_size
        # JAX's PRNGKey(seed): step keys are fold_in(_rng, step)
        self._rng = prng.PRNGKey(self.cfg.seed, device=self.device)
        self._step_counter = 0
        self.decode_dispatches = 0
        self.mixed_steps = 0
        # attention calls routed to each of the family's kernels (per
        # layer, both devices)
        self.kernel_launches: Dict[str, int] = {k: 0
                                                for k in self.attention}
        # guided decoding (engine/guided.py): set by enable_guided once the
        # worker knows the tokenizer's byte vocabulary
        self._guided_vocab = None
        self._guided_bytes = None
        self._guided_reqs: dict = {}     # step thread's automata
        self._grammar_cache: dict = {}
        self._grammar_lock = threading.Lock()
        # finished/cancelled request ids, recorded on the event-loop thread
        # and dropped from _guided_reqs by the step thread
        self._released: set = set()
        self._released_lock = threading.Lock()

    # -- guided decoding ---------------------------------------------------

    def enable_guided(self, token_bytes, eos_ids) -> None:
        """Arm response_format support: ``token_bytes[id]`` is the byte
        string token id appends to the output (None for special tokens),
        ``eos_ids`` the ids allowed once the document completes."""
        self._guided_bytes = list(token_bytes)
        if len(self._guided_bytes) < self.model_cfg.vocab_size:
            # a padded model vocab: the mask must cover every logit column
            self._guided_bytes += [None] * (
                self.model_cfg.vocab_size - len(self._guided_bytes))
        for e in eos_ids:
            # an EOS that is a regular vocab entry ENDS the document; it is
            # never walked as literal text
            if 0 <= e < len(self._guided_bytes):
                self._guided_bytes[e] = None
        self._guided_vocab = GuidedVocab(self._guided_bytes, list(eos_ids))

    def validate_request(self, request) -> Optional[str]:
        """Refuse what ``JaxEngine`` refuses: a guided request without a
        registered byte vocabulary, or with a grammar that does not
        compile."""
        spec = request.sampling_options.guided
        if not spec:
            return None
        if self._guided_vocab is None:
            return ("guided decoding (response_format) is not available: "
                    "the worker did not register a token-byte vocabulary")
        try:
            self._grammar_for(spec)
        except Exception as e:  # noqa: BLE001 — surface compile errors
            return f"response_format rejected: {e}"
        return None

    def _grammar_for(self, spec: dict):
        """Compile-or-cache a guided grammar; called from both the
        event-loop thread (validate_request) and the step thread."""
        key = json.dumps(spec, sort_keys=True)
        with self._grammar_lock:
            g = self._grammar_cache.get(key)
        if g is None:
            g = compile_guided(spec)
            with self._grammar_lock:
                if len(self._grammar_cache) >= 64:
                    self._grammar_cache.pop(
                        next(iter(self._grammar_cache)), None)
                g = self._grammar_cache.setdefault(key, g)
        return g

    def release_request(self, rid) -> None:
        """A request left the scheduler: its automaton is dropped by the
        step thread at the next step (the threads never share one)."""
        with self._released_lock:
            self._released.add(rid)

    def _guided_req_for(self, seq, spec: dict):
        """Get-or-(re)build the request's automaton and sync it to the
        sequence's generated tokens (``n_seen`` beyond ``generated`` means
        a preemption rewound the sequence: rebuild and re-walk)."""
        rid = seq.request.request_id
        gr = self._guided_reqs.get(rid)
        if gr is None or gr.n_seen > len(seq.generated):
            gr = GuidedRequest(self._grammar_for(spec), self._guided_vocab,
                               self._guided_bytes)
            self._guided_reqs[rid] = gr
        gr.catch_up(seq.generated)
        gr.last_step = self._step_counter
        return gr

    def _guided_masks(self, rows, B: int) -> Optional[np.ndarray]:
        """Per-row packed allow-masks ``[B, ceil(V/32)]`` uint32 for this
        step, or None when no row is constrained (unconstrained rows of a
        constrained batch are all-ones, the no-op)."""
        gv = self._guided_vocab
        if gv is None:
            return None
        masks = None
        for i, seq in enumerate(rows):
            spec = seq.request.sampling_options.guided
            if not spec:
                continue
            m = self._guided_req_for(seq, spec).mask()
            if m is not None:
                if masks is None:
                    masks = np.full((B, gv.words), 0xFFFFFFFF, np.uint32)
                masks[i] = m
        if len(self._guided_reqs) > 4 * self.cfg.max_num_seqs:
            # size cap, evicting by last touch
            stale = sorted(self._guided_reqs.items(),
                           key=lambda kv: kv[1].last_step)
            for rid, _ in stale[:len(stale) // 2]:
                del self._guided_reqs[rid]
        return masks

    def _drop_released(self) -> None:
        with self._released_lock:
            released, self._released = self._released, set()
        for rid in released:
            self._guided_reqs.pop(rid, None)

    # -- penalties, bias, seeds ---------------------------------------------

    def _penalty_row(self, seq, W: int):
        """One row's penalty/bias window material (``JaxEngine._penalty_row``),
        or None for a row without penalties or bias.

        ``entries``: (token, generated count, in context): logit_bias ids
        first, then every distinct generated token by frequency (not yet
        cut to W). ``prestatic``: the prompt's distinct tokens, most recent
        first, at most 2W (the repetition-penalty backfill). A migrated
        stream's trailing ``resumed_tokens`` of the prompt were generated
        by its earlier legs and keep counting as generated."""
        so = seq.request.sampling_options
        f = so.frequency_penalty or 0.0
        p = so.presence_penalty or 0.0
        r = so.repetition_penalty
        rep_on = r is not None and r > 0 and r != 1.0
        lb = so.logit_bias or {}
        if W <= 0 or not (f or p or rep_on or lb):
            return None
        counts = Counter(seq.generated)
        n_prompt = seq.num_prompt - min(
            seq.request.resumed_tokens or 0, seq.num_prompt)
        if n_prompt < seq.num_prompt:
            counts.update(seq.tokens.tokens()[n_prompt:seq.num_prompt])
        prompt_set = (set(seq.tokens.tokens()[:n_prompt])
                      if rep_on else set())
        entries = [(t, counts.get(t, 0), t in counts or t in prompt_set)
                   for t in list(lb)[:W]]
        have = {t for t, _c, _x in entries}
        for t, c in counts.most_common(W):
            if t not in have:
                entries.append((t, c, True))
                have.add(t)
        prestatic: list = []
        if rep_on:
            seen: set = set()
            for t in reversed(seq.tokens.tokens()[:seq.num_prompt]):
                if t not in seen:
                    seen.add(t)
                    prestatic.append(t)
                    if len(prestatic) >= 2 * W:
                        break
        return dict(entries=entries, prestatic=prestatic, lb=lb, fp=f,
                    pp=p, rp=(r if rep_on else 1.0), rep_on=rep_on)

    def _sampling_extras(self, rows, B: int) -> dict:
        """Per-row penalty/bias windows, seeds, min-p and guided masks
        (``JaxEngine._sampling_extras``), merged into the step's host
        arrays; ``{}`` when no row uses any of them, so the common step
        ships nothing more and takes the batch-wide draw."""
        W = self.cfg.penalty_window
        seeds = np.zeros(B, np.int32)
        ids = np.zeros((B, W), np.int32)
        cnt = np.zeros((B, W), np.float32)
        ctx = np.zeros((B, W), np.float32)
        bias = np.zeros((B, W), np.float32)
        fp = np.zeros(B, np.float32)
        pp = np.zeros(B, np.float32)
        rp = np.ones(B, np.float32)
        min_p = np.zeros(B, np.float32)
        any_active = False
        for i, seq in enumerate(rows):
            so = seq.request.sampling_options
            if so.seed is not None:
                # any integer seed (0 included) maps into [1, 2^31-1];
                # 0 is the unseeded sentinel
                seeds[i] = (int(so.seed) % 0x7FFFFFFF) + 1
                any_active = True
            if so.min_p:
                min_p[i] = so.min_p
                any_active = True
            row = self._penalty_row(seq, W)
            if row is None:
                continue
            any_active = True
            fp[i], pp[i], rp[i] = row["fp"], row["pp"], row["rp"]
            # bias + generated entries, then for repetition the prompt
            # backfill, to capacity
            entries = list(row["entries"])
            have = {t for t, _c, _x in entries}
            if row["rep_on"] and len(entries) < W:
                for t in row["prestatic"]:
                    if t not in have:
                        entries.append((t, 0, True))
                        have.add(t)
                        if len(entries) >= W:
                            break
            for j, (t, c, x) in enumerate(entries[:W]):
                ids[i, j] = t
                cnt[i, j] = c
                ctx[i, j] = 1.0 if x else 0.0
                bias[i, j] = row["lb"].get(t, 0.0)
        masks = self._guided_masks(rows, B)
        if not any_active and masks is None:
            return {}
        out = dict(seeds=seeds, pen_ids=ids, pen_cnt=cnt, pen_ctx=ctx,
                   pen_bias=bias, pen_fp=fp, pen_pp=pp, pen_rp=rp,
                   pen_min_p=min_p)
        if masks is not None:
            out["mask_words"] = masks
        return out

    # -- one step ----------------------------------------------------------

    def _row_sampling(self, i: int, seq, arrays: dict) -> None:
        so = seq.request.sampling_options
        if so.temperature is not None:
            arrays["temp"][i] = so.temperature
        arrays["top_k"][i] = so.top_k or 0
        if so.top_p is not None:
            arrays["top_p"][i] = so.top_p

    def _empty_arrays(self, B: int, S: int) -> dict:
        return dict(toks=np.zeros((B, S), np.int32),
                    pos=np.zeros((B, S), np.int32),
                    table=np.zeros((B, self.table_width), np.int32),
                    total=np.ones(B, np.int32),  # pad rows: 1 garbage token
                    new=np.zeros(B, np.int32),   # pad rows: write nothing
                    temp=np.zeros(B, np.float32),
                    top_k=np.zeros(B, np.int32),
                    top_p=np.ones(B, np.float32))

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
        a.update(self._sampling_extras([c.seq for c in chunks], B))
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
        a.update(self._sampling_extras(seqs, B))
        return a

    def _execute_plan(self, plan: StepPlan):
        """Build the padded arrays, run one step, fetch the sampled tokens."""
        self._drop_released()
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
        a["step"] = np.array(self._step_counter, np.int64)
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
        # uint32 mask words travel as their int32 bit patterns
        t = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                 else v).to(dev, non_blocking=True)
             for k, v in a.items()}
        impl = self.attention[kernel]

        def attn(*args, **kw):
            self.kernel_launches[kernel] += 1
            return impl(*args, **kw)

        logits, self.pages = self.family.forward(
            self.params, self.model_cfg, t["toks"], t["pos"], self.pages,
            t["table"], t["total"], t["new"], attn_impl=attn)
        return self._sample_tail(logits, t, draw=bool(a["temp"].max() > 0))

    def _sample_tail(self, logits: torch.Tensor, t: dict,
                     draw: bool = True) -> torch.Tensor:
        """The reference's sampling epilogue (``JaxEngine._sample_tail``):
        penalties, then bias, then the guided mask on the logits (so the
        top-K alternatives and logprobs are of the distribution sampled
        from), the Gumbel draw from ``fold_in(engine key, step)`` (seeded
        rows from their seed and position), and the packed result. With
        ``draw`` False (every row greedy, as the host arrays say) the noise
        is zeros: a greedy row takes candidate 0 whatever the noise, and
        the draw is some 600 small launches on the card."""
        logits = logits.float()
        B, V = logits.shape
        seeds = min_p = None
        if "seeds" in t:
            logits = apply_penalties(logits, t["pen_ids"], t["pen_cnt"],
                                     t["pen_ctx"], t["pen_fp"], t["pen_pp"],
                                     t["pen_rp"], pen_bias=t["pen_bias"])
            if "mask_words" in t:
                # the mask LAST: a penalty or bias reweights inside the
                # grammar but never resurrects an illegal token
                logits = apply_vocab_mask(logits, t["mask_words"])
            seeds, min_p = t["seeds"], t["pen_min_p"]
        k = min(TOPK_MAX, V)
        if draw:
            gumbel = sampling_noise(prng.fold_in(self._rng, t["step"]), B, k,
                                    seeds=seeds, seed_rng=self._rng,
                                    seed_pos=t["total"])
        else:
            gumbel = torch.zeros((B, k), device=logits.device)
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
