"""The serving engine on PyTorch + CUDA: continuous batching over a paged
KV cache, with the reference's pipelined and fused decode.

The port of ``dynamo_tpu/engine/jax_engine.py`` ``JaxEngine``: ``TorchEngine``
plugs into the same loop (``engine/loop.py`` ``ScheduledEngineBase``) and
implements its per-step, pipelined and fused hooks. For each plan it builds
the same padded host arrays as the reference (power-of-two buckets on batch
and chunk length, page table ``max_context // page_size`` wide, pad rows
with one garbage-page token), runs the model family's forward
(``models.get_family``) with the attention kernel chosen by the step's
shape — the reference's choice on its Pallas path. The Llama tree:

- decode steps and fused blocks (S == 1): the paged decode kernel;
- ``PrefillBatch``: the chunked-prefill kernel;
- ``MixedStepBatch`` (prefill chunks + decode rows as length-1 chunks,
  mixed batching on by default): the ragged mixed kernel.

Gemma-2 (``models/gemma.py``) takes the same three kernels, each layer
with its sliding window and the attention softcap, as do the MoE variants
of the Llama tree (mixtral, qwen3-MoE: ``models/moe.py``). DeepSeek (MLA,
``models/deepseek.py``): S == 1 steps run the latent decode kernel, every
S > 1 step (prefill and mixed alike) the latent prefill kernel, which
skips a decode row's pad query tiles itself. On the GPU a geometry the
kernels do not take is refused at construction.

Speculative decoding (``spec_tokens = K``): the scheduler upgrades a decode
step whose rows have n-gram drafts to a verify step (``SpecDecodeBatch``):
one ``[B, K+1]`` forward through the chunked-prefill kernel (the latent one
for DeepSeek) with a logits window of ``K+1``, the guided masks applied
once, then ``ops/sampling.spec_verify`` under the step's key, packed as the
reference packs it. Verify steps run eagerly one at a time, as the
reference's do; fusion is off under speculation (reason ``"spec"``), while
plain decode steps between verify steps still chain.

``quantize="int8"`` serves the Llama tree and Gemma-2 with int8 W8A8
weights (``ops/quant.py``), quantized on the device at construction.

Each step samples on the device with every option the reference serves:
penalties and logit bias over a per-row window, the guided-decoding
allow-mask (``engine/guided.py``), per-request seeds, and the reference's
key schedule through ``ops/prng.py`` (JAX's threefry, bit for bit), so
sampled streams match ``JaxEngine``'s token for token. It packs everything
the host needs into one ``[B, 2 + 2K]`` int32 buffer (token, logprob bits,
K alternative ids, K alternative logprob bits).

Decode, with the reference's defaults (``pipeline_decode``,
``decode_multistep=8``):

- a steady decode batch runs as FUSED blocks of up to 8 steps
  (``dispatch_multistep``, the reference's ``_multistep_impl``): forward,
  penalties over the device-resident window, the guided table's mask,
  sampling and the stop rule (EOS / stop ids gated by ``min_tokens``,
  the token budget) for every step on the device, dead rows writing no
  KV; chained blocks take their first token, positions, liveness, budgets
  and penalty/automaton state from the previous block's device carry. On
  the GPU each block is one CUDA graph replay (``engine/graphs.py``), one
  graph per (padded batch, width, draw, input shapes); on the CPU the same
  body runs uncaptured;
- batches the scheduler does not fuse run per step, pipelined: step N+1
  is dispatched before step N is fetched, taking step N's tokens on the
  device (``dispatch_chained``);
- every dispatch copies its packed output into a pinned host buffer and
  records an event; ``fetch_packed`` waits on that event only, so a fetch
  of step N never waits for step N+1.

Beside the scheduler, as the reference's worker serves them on its aux
plane: ``embed`` (the family's dense ``encode``, mean-pooled) and
``score`` (prompt logprobs and top-n alternatives through the paged
chunked-prefill forward against scratch pages, its logits window covering
each full chunk; on the GPU its attention is the prefill kernel). On the
GPU both run on the loop's exclusive lane, between dispatches.
``stats`` adds the MoE drop count: with ``moe_backend="dispatch"`` every
forward returns its dropped assignments as a device scalar (a fused block
sums its steps' into an output of its CUDA graph), queued and fetched only
when the stats are read, as the reference's ``_drain_moe_drops`` does.
The decode knobs left ``None`` in ``TorchEngineConfig`` resolve at build
from ``RuntimeConfig`` and the short-form env (``DYN_DECODE_MULTISTEP``,
``DYN_MIXED_BATCH``, ``DYN_DECODE_PROGRESS``), as the reference's do.

Refused rather than approximated: sequence-parallel ring prefill (ROADMAP
A13).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import logging
import os
import threading
import time
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.graphs import BlockGraphs
from dynamo_tpu_torch.engine.guided import (GuidedRequest, GuidedVocab,
                                            build_guided_table,
                                            compile_guided, eos_ok)
from dynamo_tpu_torch.engine.guided import step as guided_step
from dynamo_tpu_torch.engine.loop import ScheduledEngineBase
from dynamo_tpu_torch.engine.scheduler import (DecodeBatch, MixedStepBatch,
                                               MultiStepBatch, PrefillBatch,
                                               PrefillChunk, SpecDecodeBatch,
                                               StepPlan)
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import prng
from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels._wrap import (gqa_geometry_error,
                                                mla_geometry_error)
from dynamo_tpu_torch.ops.kernels.decode import paged_decode_attention_stacked
from dynamo_tpu_torch.ops.kernels.mla_decode import mla_paged_decode_stacked
from dynamo_tpu_torch.ops.kernels.mla_prefill import mla_paged_prefill_stacked
from dynamo_tpu_torch.ops.kernels.prefill import (
    paged_prefill_attention_stacked)
from dynamo_tpu_torch.ops.kernels.ragged import ragged_mixed_attention_stacked
from dynamo_tpu_torch.ops.sampling import (TOPK_MAX, apply_penalties,
                                           apply_vocab_mask, log_softmax_at,
                                           penalty_window_entries,
                                           sample_tokens, sampling_noise,
                                           spec_verify, top_k_stable,
                                           update_penalty_window)
from dynamo_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

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

# batch rows of prefill and mixed steps pad to the next power of two from
# this (decode batches from ``min_decode_bucket``)
MIN_BATCH_BUCKET = 1

# default fused-decode width (decode steps per block), the reference's
# DECODE_MULTISTEP
DECODE_MULTISTEP = 8

# the device carry of a fused block: the per-row state chained blocks take
# from the previous one, then the penalty window and the automaton state
CARRY = ("tok", "pos", "total", "alive", "budget", "min_gate")
PEN_CARRY = ("pids", "pcnt", "pctx", "pbias", "pn", "gstate")


@dataclass
class TorchEngineConfig:
    """Engine sizing knobs (``JaxEngineConfig``'s, for the ported paths;
    the defaults are the reference's)."""

    num_pages: int = 512          # physical KV pages (page 0 reserved)
    page_size: int = 16           # tokens per page == router block size
    max_num_seqs: int = 8         # max concurrent sequences
    max_prefill_chunk: int = 512  # prompt-token budget per prefill step
    max_prefill_seqs: int = 8     # sequences sharing one prefill step
    max_context: int = 2048       # max prompt+generation length
    min_prefill_bucket: int = 16
    # floor for the padded decode batch: raising it to max_num_seqs gives
    # one decode shape (one graph per width); 1 pads each power of two
    min_decode_bucket: int = 1
    # alternatives returned per sampled token (OpenAI top_logprobs)
    num_top_logprobs: int = 8
    # penalty/bias window slots per row (frequency/presence/repetition
    # penalties and logit_bias ride a sparse window of this many ids)
    penalty_window: int = 32
    # guided decoding in the fused block: a grammar whose dense token-level
    # transition table (engine/guided.build_guided_table) fits under this
    # many bytes runs inside the block; a larger one decodes per step with
    # fallback reason "guided_table"
    guided_table_bytes: int = 8 << 20
    seed: int = 0
    # pipelined decode: step N+1 takes step N's sampled tokens on the
    # device and the host fetches N while N+1 runs; False is strict
    # step-at-a-time decode (and turns fusion off too)
    pipeline_decode: bool = True
    # fused decode: at most this many decode steps per block (the
    # scheduler narrows the width per batch); 1 turns fusion off. None
    # resolves DYN_DECODE_MULTISTEP / RuntimeConfig.decode_multistep
    # (default 8) when the engine is built
    decode_multistep: Optional[int] = None
    # mixed prefill+decode dispatch (decode rows ride prefill steps as
    # length-1 ragged chunks); False restores the strict alternation.
    # None resolves RuntimeConfig.mixed_batch, then DYN_MIXED_BATCH
    mixed_batch: Optional[bool] = None
    # with mixed batching off: at most K-1 prefill-only steps in a row
    # while decode rows wait. None resolves
    # RuntimeConfig.decode_progress_every, then DYN_DECODE_PROGRESS
    decode_progress_every: Optional[int] = None
    # prompt scoring (completions echo + logprobs) length cap; 0 = use
    # max_context. Scoring runs the paged chunked-prefill forward against
    # a scratch cache allocated beside the serving pool, so the default
    # stays bounded
    score_max_tokens: int = 4096
    # load-time weight quantization: "" (the checkpoint dtype) or "int8"
    # (W8A8 dynamic, ops/quant.py; the Llama tree and Gemma-2)
    quantize: str = ""
    # speculative decoding: n-gram prompt-lookup drafts verified K at a
    # time in one [B, K+1] step (0 = off). Verify steps do not chain (the
    # drafts need the sampled tokens on the host); plain decode steps
    # between them do, the chain broken every spec_chain_break steps so
    # fresh context gets to draft
    spec_tokens: int = 0
    spec_ngram_max: int = 4
    spec_ngram_min: int = 2
    spec_chain_break: int = 8


# prompt-scoring chunk: each full chunk of the prompt is one forward whose
# logits window covers the whole chunk (the reference's _SCORE_CHUNK)
_SCORE_CHUNK = 256

# defaults for the mixed-dispatch knobs (see TorchEngineConfig)
MIXED_BATCH = True
DECODE_PROGRESS_EVERY = 2


def _runtime_default(attr: str, fallback):
    """RuntimeConfig field (dataclass -> TOML -> ``DYN_RUNTIME_*`` env)
    with the shared error discipline: a bad TOML/env must not break an
    engine build. Resolved at engine build, not at import, so
    monkeypatched env changes take effect."""
    try:
        from dynamo_tpu_torch.utils.config import RuntimeConfig
        return getattr(RuntimeConfig.load(), attr)
    except Exception:  # noqa: BLE001
        logger.warning("bad runtime config; %s falls back to %r",
                       attr, fallback, exc_info=True)
        return fallback


def _env_int_default(env: str, val: int) -> int:
    """Short-form env override for an int knob; malformed values keep
    the resolved default instead of breaking the engine build."""
    raw = os.environ.get(env)
    try:
        return int(raw) if raw is not None else val
    except (TypeError, ValueError):
        logger.warning("malformed %s %r; using %d", env, raw, val)
        return val


def mixed_batch_default() -> bool:
    """Defaults layer for the mixed-dispatch enable flag:
    ``RuntimeConfig.mixed_batch``, then the short-form ``DYN_MIXED_BATCH``
    env wins."""
    val = bool(_runtime_default("mixed_batch", MIXED_BATCH))
    raw = os.environ.get("DYN_MIXED_BATCH")
    if raw is not None:
        val = raw.strip().lower() not in ("0", "false", "no", "off", "")
    return val


def decode_progress_default() -> int:
    """Defaults layer for the decode-progress guarantee K
    (``RuntimeConfig.decode_progress_every``, then the short-form
    ``DYN_DECODE_PROGRESS`` env wins)."""
    val = _runtime_default("decode_progress_every", DECODE_PROGRESS_EVERY)
    return max(0, _env_int_default("DYN_DECODE_PROGRESS", int(val)))


def decode_multistep_default() -> int:
    """Defaults layer for the fused-decode width
    (``RuntimeConfig.decode_multistep``, then the short-form
    ``DYN_DECODE_MULTISTEP`` env wins)."""
    val = _runtime_default("decode_multistep", DECODE_MULTISTEP)
    return max(1, _env_int_default("DYN_DECODE_MULTISTEP", int(val)))


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def _upload(v: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev`` (uint32 mask words travel as their int32 bit
    patterns). Asynchronous: a pageable source is staged before the call
    returns, and the stream is not waited on."""
    if v.dtype == np.uint32:
        v = v.view(np.int32)
    return torch.from_numpy(v).to(dev, non_blocking=True)


class _Staged:
    """A dispatched step or block: its packed device output, a block's
    device carry, and on the GPU the pinned host buffer its output is
    copied into and the event recorded after that copy."""

    __slots__ = ("dev", "carry", "slot", "event", "__weakref__")

    def __init__(self, dev: torch.Tensor, carry=None):
        self.dev = dev
        self.carry = carry
        self.slot = None
        self.event = None


class _PinnedSlot:
    """One pinned host buffer of the fetch ring and the handle whose copy
    it holds (a weak reference: a handle dropped unfetched frees it)."""

    __slots__ = ("buf", "owner")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.owner = None

    def free(self) -> bool:
        return self.owner is None or self.owner() is None


class TorchEngine(ScheduledEngineBase):
    """Continuous-batching paged-KV engine over a PyTorch Llama-tree (dense
    or MoE), Gemma-2 or DeepSeek (MLA) model."""

    def __init__(self, model_cfg: ModelConfig, params,
                 config: Optional[TorchEngineConfig] = None, device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = config or TorchEngineConfig()
        self.family = get_family(model_cfg)
        self.mla = bool(model_cfg.kv_lora_rank)
        if self.device.type == "cuda":
            if self.mla:
                what = "latent attention kernels"
                bad = mla_geometry_error(model_cfg.num_heads,
                                         model_cfg.kv_lora_rank,
                                         model_cfg.qk_rope_head_dim,
                                         self.cfg.page_size)
            else:
                what = "attention kernels"
                bad = gqa_geometry_error(model_cfg.num_heads,
                                         model_cfg.num_kv_heads,
                                         model_cfg.head_dim,
                                         self.cfg.page_size)
            if bad is None and model_cfg.dtype != "bfloat16":
                bad = f"dtype {model_cfg.dtype}, not bfloat16"
            if bad:
                raise ValueError(f"{model_cfg.model_type}: the {what} do "
                                 f"not take this geometry: {bad}")
        if self.cfg.quantize:
            if self.cfg.quantize != "int8":
                raise ValueError(
                    f"quantize={self.cfg.quantize!r}: only 'int8' "
                    "(W8A8 dynamic) is implemented")
            if self.family.__name__.rsplit(".", 1)[-1] not in ("llama",
                                                               "gemma"):
                # the MoE/MLA families' expert/latent matmul sites do not
                # dispatch through quant.mm
                raise ValueError(
                    f"quantize='int8' currently covers the llama family "
                    f"tree (llama/mistral/qwen dense) and gemma-2; "
                    f"model_type {model_cfg.model_type!r} is served bf16")
        self.spec_K = int(self.cfg.spec_tokens or 0)
        if self.device.type == "cuda" and self.device.index is None:
            # a definite index: dispatches run on the loop's pool threads,
            # each of which sets it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.attention = MLA_ATTENTION if self.mla else ATTENTION
        self.decode_kernel = "mla_decode" if self.mla else "paged_decode"
        self.multistep = (max(1, int(self.cfg.decode_multistep))
                          if self.cfg.decode_multistep is not None
                          else decode_multistep_default())
        self.mixed_batch = (bool(self.cfg.mixed_batch)
                            if self.cfg.mixed_batch is not None
                            else mixed_batch_default())
        super().__init__(
            num_pages=self.cfg.num_pages, page_size=self.cfg.page_size,
            max_num_seqs=self.cfg.max_num_seqs,
            max_prefill_chunk=self.cfg.max_prefill_chunk,
            max_context=self.cfg.max_context,
            max_prefill_seqs=self.cfg.max_prefill_seqs,
            spec_tokens=self.spec_K,
            spec_ngram_max=self.cfg.spec_ngram_max,
            spec_ngram_min=self.cfg.spec_ngram_min,
            spec_chain_break=self.cfg.spec_chain_break,
            decode_multistep=self.multistep,
            mixed_batch=self.mixed_batch,
            decode_progress_every=(
                int(self.cfg.decode_progress_every)
                if self.cfg.decode_progress_every is not None
                else decode_progress_default()))
        # fused-path gates for penalized/guided rows: the scheduler narrows
        # block widths by the penalty window's remaining capacity and asks
        # whether a row's grammar lowered to a device table
        self.scheduler.cfg.penalty_window = self.cfg.penalty_window
        self.scheduler.cfg.guided_fuse_check = self._guided_fuse_check
        self.params = _params_to(params, self.device)
        if self.cfg.quantize:
            from dynamo_tpu_torch.ops.quant import quantize_params
            self.params = quantize_params(self.params)
        # the paged cache, written in place by every step and block (a
        # captured graph holds its address: never rebound)
        self.pages = self.family.make_pages(model_cfg, self.cfg.num_pages,
                                            self.cfg.page_size,
                                            device=self.device)
        self.table_width = self.cfg.max_context // self.cfg.page_size
        # JAX's PRNGKey(seed): step keys are fold_in(_rng, step)
        self._rng = prng.PRNGKey(self.cfg.seed, device=self.device)
        self._step_counter = 0
        self.decode_dispatches = 0   # decode-family dispatches
        self.chained_steps = 0       # of which pipelined (chained) steps
        self.multistep_blocks = 0    # of which fused blocks
        self.mixed_steps = 0         # mixed prefill+decode steps
        # cache writes of the KV inject paths (engine/transfer.py, kvbm/):
        # one per scatter, as the reference counts its jitted scatters
        self.page_scatter_dispatches = 0
        # attention calls routed to each of the family's kernels (per
        # layer, both devices; a graph replay adds what its capture ran)
        self.kernel_launches: Dict[str, int] = {k: 0
                                                for k in self.attention}
        self._attn = {k: self._counted(k) for k in self.attention}
        # composition-keyed device sampling arrays and page table of the
        # decode family: (key, arrays) / (key, versions, host, device)
        self._samp_cache = None
        self._table_cache = None
        # the fetch ring: (packed shape, dtype) -> pinned slots
        self._pinned: Dict[tuple, list] = {}
        # one CUDA graph per fused block shape (none on the CPU, where the
        # block body runs as it is)
        self.graphs = (BlockGraphs(self.device, [LAUNCHES,
                                                 self.kernel_launches])
                       if self.device.type == "cuda" else None)
        # graph captures, drained by the loop as the reference's jit
        # compiles are (engine/steptrace.py)
        self._pending_compiles: list = []
        self._compile_lock = threading.Lock()
        # guided decoding (engine/guided.py): set by enable_guided once the
        # worker knows the tokenizer's byte vocabulary
        self._guided_vocab = None
        self._guided_bytes = None
        self._guided_reqs: dict = {}     # step thread's automata
        self._grammar_cache: dict = {}
        self._grammar_lock = threading.Lock()
        # lowered device tables per grammar (None = not tableable), keyed
        # like _grammar_cache and guarded by the same lock
        self._guided_tables: dict = {}
        # event-loop thread's automata for the post-block parity check
        self._guided_mirrors: dict = {}
        self.guided_parity_mismatches = 0
        # finished/cancelled request ids, recorded on the event-loop thread
        # and dropped from the step thread's state at its next dispatch
        self._released: set = set()
        self._released_lock = threading.Lock()
        # MoE dispatch overflow accounting: each step's (each block's)
        # device scalar queues here and stats() drains them into the total.
        # Only the dispatch backend can drop. Appends happen on the step
        # thread, drains there (the 512 cap) or on the event-loop thread
        self._pending_moe_drops: list = []
        self._moe_dropped_total = 0
        self._moe_drops_lock = threading.Lock()
        self._moe_dispatch_active = (
            getattr(model_cfg, "moe_backend", "") == "dispatch")

    def _counted(self, kernel: str):
        impl = self.attention[kernel]

        def attn(*args, **kw):
            self.kernel_launches[kernel] += 1
            return impl(*args, **kw)
        return attn

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
        try:
            # lower the fused path's table here (event-loop thread, cached
            # per grammar) so the step thread never pays the search; a
            # grammar with no table decodes per step ("guided_table")
            self._guided_table_for(spec)
        except Exception:  # noqa: BLE001 — table lowering is best-effort
            logger.warning("guided table lowering failed; request %s "
                           "decodes per-step", request.request_id,
                           exc_info=True)
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

    def _guided_table_for(self, spec: dict):
        """The grammar's lowered device transition table, or None when it
        is not tableable (over ``guided_table_bytes``, or a reachable state
        with an empty mask). Cached beside the grammar cache under its
        lock; normally warmed by ``validate_request``."""
        key = json.dumps(spec, sort_keys=True)
        with self._grammar_lock:
            if key in self._guided_tables:
                return self._guided_tables[key]
        table = build_guided_table(self._grammar_for(spec),
                                   self._guided_vocab,
                                   self.cfg.guided_table_bytes)
        with self._grammar_lock:
            if len(self._guided_tables) >= 64:
                self._guided_tables.pop(
                    next(iter(self._guided_tables)), None)
            return self._guided_tables.setdefault(key, table)

    def _guided_fuse_check(self, seq) -> bool:
        """Scheduler hook: may this guided row ride a fused block? True iff
        its grammar lowered to a device table."""
        spec = seq.request.sampling_options.guided
        if not spec or self._guided_vocab is None:
            return False
        try:
            return self._guided_table_for(spec) is not None
        except Exception:  # noqa: BLE001 — a lowering bug must not
            return False   # break planning; the row decodes per-step

    def release_request(self, rid) -> None:
        """A request left the scheduler: its event-loop mirror goes now,
        its step-thread automaton and any composition cache holding it at
        the next dispatch (the threads never share one)."""
        self._guided_mirrors.pop(rid, None)
        with self._released_lock:
            self._released.add(rid)

    def multistep_guided_check(self, seq) -> None:
        """Post-block guided parity check (event-loop thread): re-walk the
        row's committed tokens on a host mirror of its automaton and count
        a grammar-illegal one (EOS: ``eos_ok``) on
        ``guided_parity_mismatches``; a mirror that diverged wedges, so one
        divergence is reported once."""
        spec = seq.request.sampling_options.guided
        if not spec or self._guided_vocab is None:
            return
        rid = seq.request.request_id
        gen = seq.generated
        gr = self._guided_mirrors.get(rid)
        if gr is None or gr.n_seen > len(gen):
            try:
                gr = GuidedRequest(self._grammar_for(spec),
                                   self._guided_vocab, self._guided_bytes)
            except Exception:  # noqa: BLE001 — the mirror is best-effort
                return
            self._guided_mirrors[rid] = gr
        new = gen[gr.n_seen:]
        gr.n_seen = len(gen)
        ok = True
        for t in new:
            if gr.wedged:
                return
            t = int(t)
            if t in self._guided_vocab.eos_ids:
                if not eos_ok(gr.grammar, gr.state):
                    ok = False
                    break
                continue          # the host advance no-ops EOS
            gr.advance(t)
            if gr.wedged:
                ok = False
                break
        if not ok:
            self.guided_parity_mismatches += 1
            gr.wedged = True
            logger.warning(
                "fused guided block committed a grammar-illegal token for "
                "%s: device table and host automaton diverged", rid)
        if len(self._guided_mirrors) > 4 * self.cfg.max_num_seqs:
            stale = sorted(self._guided_mirrors)
            for k in stale[:len(stale) // 2]:
                self._guided_mirrors.pop(k, None)

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
        """Drop finished/cancelled rows' automata, and the composition
        cache if it still holds one of them (a dead row's window and table
        slots must not linger even if an identical batch never re-forms)."""
        with self._released_lock:
            released, self._released = self._released, set()
        if not released:
            return
        for rid in released:
            self._guided_reqs.pop(rid, None)
        cached = self._samp_cache
        if cached is not None and any(rid in released
                                      for rid, _s in cached[0][1]):
            self._samp_cache = None

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

    # -- plan -> host arrays -------------------------------------------------

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
        a["table"] = np.zeros((B, self.table_width), np.int32)
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

    def _decode_arrays(self, seqs, chained: bool) -> dict:
        """Padded host arrays for one decode step. A plain step feeds each
        row's last token at position ``len - 1``; a chained one (step N's
        token still on the device, not yet appended on the host) feeds
        position ``len``, and the device takes the token from step N's
        packed output."""
        B = _bucket(len(seqs), self.cfg.min_decode_bucket,
                    self.cfg.max_num_seqs)
        a = self._empty_arrays(B, 1)
        a["table"] = self._table_arrays(seqs, B)[0]
        for i, seq in enumerate(seqs):
            if chained:
                a["pos"][i, 0] = len(seq)
                a["total"][i] = len(seq) + 1
            else:
                a["toks"][i, 0] = seq.tokens.last_token()
                a["pos"][i, 0] = len(seq) - 1
                a["total"][i] = len(seq)
            a["new"][i] = 1
            self._row_sampling(i, seq, a)
        a.update(self._sampling_extras(seqs, B))
        return a

    def _table_arrays(self, seqs, B: int):
        """The padded page table (host, device) of a decode-family batch,
        keyed by batch composition and rebuilt per row only when that row's
        pages changed (``Sequence.table_version``), re-uploaded only when
        any did. The host array is never written after its upload (a stale
        hit copies first)."""
        key = (B, tuple((s.request.request_id, id(s)) for s in seqs))
        cached = self._table_cache
        if cached is not None and cached[0] == key:
            _k, versions, table, dev = cached
            stale = [i for i, s in enumerate(seqs)
                     if versions[i] != s.table_version]
            if not stale:
                return table, dev
            table = table.copy()
            for i in stale:
                s = seqs[i]
                table[i, :] = 0
                table[i, :len(s.page_ids)] = s.page_ids
                versions[i] = s.table_version
        else:
            table = np.zeros((B, self.table_width), np.int32)
            versions = [s.table_version for s in seqs]
            for i, s in enumerate(seqs):
                table[i, :len(s.page_ids)] = s.page_ids
        dev = _upload(table, self.device)
        self._table_cache = (key, versions, table, dev)
        return table, dev

    def _device_sampling(self, seqs, B: int) -> dict:
        """Device-resident per-row sampling and stop arrays of a decode
        batch (``JaxEngine._device_sampling``), rebuilt only when the batch
        composition changes: temperature / top-k / top-p, the padded EOS +
        stop-id set (-1 pads never match) and, when a row uses them,
        ``pen``: seeds and min-p, the penalty knobs with the 2W
        prompt-reproduction arrays (``pw_*``) and the batched guided
        transition table and masks (``gt_*``). ``draw`` says whether any
        row samples (an all-greedy block skips the draw). The per-token
        pieces (the window, the automaton state) ride the block carry."""
        key = (B, tuple((s.request.request_id, id(s)) for s in seqs))
        cached = self._samp_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        temp = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int32)
        top_p = np.ones(B, np.float32)
        seeds = np.zeros(B, np.int32)
        min_p = np.zeros(B, np.float32)
        pen_active = False
        stop_lists = []
        W = self.cfg.penalty_window
        pfp = np.zeros(B, np.float32)
        ppp = np.zeros(B, np.float32)
        prp = np.ones(B, np.float32)
        pact = np.zeros(B, bool)
        prompt_ids = np.zeros((B, 2 * max(W, 1)), np.int32)
        prompt_valid = np.zeros((B, 2 * max(W, 1)), bool)
        pw_active = False
        guided_specs: dict = {}
        knobs = dict(temp=temp, top_k=top_k, top_p=top_p)
        for i, seq in enumerate(seqs):
            so = seq.request.sampling_options
            self._row_sampling(i, seq, knobs)
            if so.seed is not None:
                # the _sampling_extras seed mapping: [1, 2^31-1], 0 = off
                seeds[i] = (int(so.seed) % 0x7FFFFFFF) + 1
                pen_active = True
            if so.min_p:
                min_p[i] = so.min_p
                pen_active = True
            f = so.frequency_penalty or 0.0
            p = so.presence_penalty or 0.0
            r = so.repetition_penalty
            rep_on = r is not None and r > 0 and r != 1.0
            if W > 0 and (f or p or rep_on or so.logit_bias):
                pw_active = pen_active = True
                pact[i] = True
                pfp[i], ppp[i] = f, p
                if rep_on:
                    prp[i] = r
                    ps = self._penalty_row(seq, W)["prestatic"]
                    prompt_ids[i, :len(ps)] = ps
                    prompt_valid[i, :len(ps)] = True
            spec = so.guided
            if spec and self._guided_vocab is not None:
                table = self._guided_table_for(spec)
                gr = self._guided_req_for(seq, spec)
                if table is not None and not gr.wedged:
                    guided_specs[i] = (spec, table)
            sc = seq.request.stop_conditions
            ids = list(sc.stop_token_ids or [])
            if not sc.ignore_eos:
                ids += list(seq.request.eos_token_ids or [])
            stop_lists.append(ids)
        E = max([len(x) for x in stop_lists] + [1])
        E = 1 << (E - 1).bit_length()   # pow2 pad: a bounded graph count
        stop_ids = np.full((B, E), -1, np.int32)
        for i, ids in enumerate(stop_lists):
            stop_ids[i, :len(ids)] = ids
        dev = self.device
        pen: Dict[str, torch.Tensor] = {}
        gt_host = None
        if pen_active or guided_specs:
            pen = {"seeds": _upload(seeds, dev), "min_p": _upload(min_p, dev)}
            if pw_active:
                pen.update(pw_fp=_upload(pfp, dev), pw_pp=_upload(ppp, dev),
                           pw_rp=_upload(prp, dev),
                           pw_active=_upload(pact, dev),
                           pw_prompt_ids=_upload(prompt_ids, dev),
                           pw_prompt_valid=_upload(prompt_valid, dev))
            if guided_specs:
                # the distinct tables batched behind sentinel state 0 (an
                # all-ones mask, a self-loop): unguided and wedged rows sit
                # at state 0 and ride the same gather
                V = self.model_cfg.vocab_size
                by_key: dict = {}
                offsets: dict = {}
                S = 1
                for i, (spec, table) in guided_specs.items():
                    k = json.dumps(spec, sort_keys=True)
                    if k not in by_key:
                        by_key[k] = table
                        offsets[k] = S
                        S += table.num_states
                    offsets[i] = offsets[k]
                S_pad = 1 << (S - 1).bit_length()
                trans = np.zeros((S_pad, V), np.int32)
                masks = np.full((S_pad, self._guided_vocab.words),
                                0xFFFFFFFF, np.uint32)
                for k, table in by_key.items():
                    o = offsets[k]
                    n = table.num_states
                    trans[o:o + n] = table.trans + o
                    masks[o:o + n] = table.masks
                # pad states: unreachable, all-ones masks and self-loops
                for s in range(S, S_pad):
                    trans[s] = s
                pen.update(gt_trans=_upload(trans, dev),
                           gt_masks=_upload(masks, dev))
                gt_host = {"trans": trans,
                           "offsets": {i: offsets[i] for i in guided_specs}}
        out = {"temp": _upload(temp, dev), "top_k": _upload(top_k, dev),
               "top_p": _upload(top_p, dev),
               "stop_ids": _upload(stop_ids, dev), "pen": pen,
               "needs_pcarry": pw_active or bool(guided_specs),
               "gt_host": gt_host, "draw": bool(temp.max() > 0)}
        self._samp_cache = (key, out)
        return out

    def _fresh_pcarry(self, seqs, B: int, samp: dict) -> dict:
        """The penalty and automaton carry of a FRESH constrained block:
        each penalized or biased row's window (bias ids and every distinct
        generated token, from ``_penalty_row`` as the per-step path builds
        it; the scheduler's width gate guarantees it fits W), and each
        guided row's state id (its generated tokens walked through the
        batched table from its grammar's offset)."""
        W = self.cfg.penalty_window
        pids = np.zeros((B, W), np.int32)
        pcnt = np.zeros((B, W), np.float32)
        pctx = np.zeros((B, W), np.float32)
        pbias = np.zeros((B, W), np.float32)
        pn = np.zeros(B, np.int32)
        gstate = np.zeros(B, np.int32)
        gt_host = samp["gt_host"]
        for i, seq in enumerate(seqs):
            row = self._penalty_row(seq, W)
            if row is not None:
                entries = row["entries"][:W]
                for j, (t, c, x) in enumerate(entries):
                    pids[i, j] = t
                    pcnt[i, j] = c
                    pctx[i, j] = 1.0 if x else 0.0
                    pbias[i, j] = row["lb"].get(t, 0.0)
                pn[i] = len(entries)
            if gt_host is not None and i in gt_host["offsets"]:
                s = gt_host["offsets"][i]
                for t in seq.generated:
                    s = int(gt_host["trans"][s, int(t)])
                gstate[i] = s
        dev = self.device
        return {k: _upload(v, dev) for k, v in
                zip(PEN_CARRY, (pids, pcnt, pctx, pbias, pn, gstate))}

    # -- per-step dispatch ---------------------------------------------------

    def _execute_plan(self, plan: StepPlan):
        """Run one plan and fetch its results: prefill and mixed steps here,
        a decode step or a fused block through their dispatch hooks."""
        if isinstance(plan, MultiStepBatch):
            return self.fetch_packed_block(self.dispatch_multistep(plan))
        if isinstance(plan, DecodeBatch):
            return self.fetch_packed(self.dispatch_decode(plan))
        self._use_device()
        self._drop_released()
        if isinstance(plan, SpecDecodeBatch):
            return self._execute_spec(plan)
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
        plan._step_id = self._step_counter
        a["step"] = np.array(self._step_counter, np.int64)
        packed = self._step(a, kernel)
        self._step_counter += 1
        self.last_padded = a["toks"].shape
        if not any(c.is_last for c in chunks):
            # no row samples this step (intermediate prompt chunks): skip
            # the device-to-host copy; nobody reads these values
            B = a["toks"].shape[0]
            return np.zeros(B, np.int64), np.zeros(B, np.float32), None
        return self.fetch_packed(self._stage(packed))

    # -- speculative verify ---------------------------------------------------

    def _execute_spec(self, plan: SpecDecodeBatch):
        """One verify step (the reference's ``SpecDecodeBatch`` branch of
        ``_execute_plan``): run it, fetch it, and unpack its packed row
        ``[final_tok, final_lp bits, n_acc, K draft lp bits, S*kt top ids,
        S*kt top lp bits]`` into (sampled, logprobs, extras)."""
        a = self._spec_arrays(plan.seqs, plan.drafts)
        plan._step_id = self._step_counter
        a["step"] = np.array(self._step_counter, np.int64)
        packed = self._spec_step(a)
        self._step_counter += 1
        self.decode_dispatches += 1
        self.last_padded = a["toks"].shape
        host = self._host(self._stage(packed))
        hostf = host.view(np.float32)
        B = host.shape[0]
        K, S = self.spec_K, self.spec_K + 1
        # the clamp _topk_cols packs with (a vocab narrower than K_top)
        kt = min(self.cfg.num_top_logprobs, self.model_cfg.vocab_size)
        extras = {"spec_acc": host[:, 2], "spec_lps": hostf[:, 3:3 + K]}
        if kt > 0:
            base = 3 + K
            extras["spec_top_ids"] = host[
                :, base:base + S * kt].reshape(B, S, kt)
            extras["spec_top_lps"] = hostf[
                :, base + S * kt:base + 2 * S * kt].reshape(B, S, kt)
        return host[:, 0], hostf[:, 1], extras

    def _spec_arrays(self, seqs, drafts: np.ndarray) -> dict:
        """Padded host arrays of one verify step ``[B, K+1]``
        (``JaxEngine._spec_arrays``): row i feeds its last token at
        position ``len - 1`` (slot 0, the token a plain decode step would
        write) and its K drafts at ``len .. len + K - 1``; ``total`` covers
        every fed position, so each draft attends to its prefix; pad rows
        write nothing. ``gmask`` ``[B, K+1, words]``: the guided rows'
        per-slot masks, when a row is guided."""
        K = self.spec_K
        B = _bucket(len(seqs), self.cfg.min_decode_bucket,
                    self.cfg.max_num_seqs)
        S = K + 1
        a = self._empty_arrays(B, S)
        a["table"] = np.zeros((B, self.table_width), np.int32)
        gmask = None
        for i, seq in enumerate(seqs):
            a["toks"][i, 0] = seq.tokens.last_token()
            a["toks"][i, 1:] = drafts[i]
            a["pos"][i] = np.arange(len(seq) - 1, len(seq) + K)
            a["table"][i, :len(seq.page_ids)] = seq.page_ids
            a["total"][i] = len(seq) + K
            a["new"][i] = S
            self._row_sampling(i, seq, a)
            row_masks = self._guided_spec_masks(seq, drafts[i], S)
            if row_masks is not None:
                if gmask is None:
                    gmask = np.full((B, S, self._guided_vocab.words),
                                    0xFFFFFFFF, np.uint32)
                gmask[i] = row_masks
        if gmask is not None:
            a["gmask"] = gmask
        return a

    def _guided_spec_masks(self, seq, row_drafts, S: int):
        """Per-slot allow-masks ``[S, words]`` of one guided row of a
        verify step (``JaxEngine._guided_spec_masks``): slot j's mask is
        the automaton's after walking drafts 1..j. A draft the grammar
        refuses ends the walk: its own slot's mask rejects it, and no later
        slot is consulted. A drafted EOS leaves the state as it is (as an
        appended EOS does). None for an unguided or wedged row."""
        spec = seq.request.sampling_options.guided
        gv = self._guided_vocab
        if not spec or gv is None:
            return None
        gr = self._guided_req_for(seq, spec)
        m0 = gr.mask()
        if m0 is None:
            return None           # wedged: served unconstrained
        out = np.full((S, gv.words), 0xFFFFFFFF, np.uint32)
        out[0] = m0
        st = gr.state
        for j, tid in enumerate(row_drafts[:S - 1], start=1):
            if int(tid) in gv.eos_ids:
                out[j] = out[j - 1]
                continue
            bs = (self._guided_bytes[int(tid)]
                  if int(tid) < len(self._guided_bytes) else None)
            if bs is None:
                break             # a special or illegal draft ends the walk
            ok = True
            for b in bs:
                st2 = guided_step(gr.grammar, st, b)
                if st2 is None:
                    ok = False
                    break
                st = st2
            if not ok:
                break
            m = gv.mask(gr.grammar, st)
            if not m.any():
                # a state with no continuation would NaN the slot's
                # softmax: left unconstrained (the wedge behaviour)
                break
            out[j] = m
        return out

    def _topk_cols(self, lf: torch.Tensor):
        """Top-K alternative (ids, logprob bits) of float32 ``lf [R, V]``
        (the reference's ``_topk_cols``: K clamped to the vocab), the
        columns both the plain tail and the verify step pack."""
        kt = min(self.cfg.num_top_logprobs, lf.shape[-1])
        vals, ids = top_k_stable(lf, kt)
        return (ids.to(torch.int32),
                log_softmax_at(lf, vals).view(torch.int32))

    @torch.no_grad()
    def _spec_step(self, a: dict) -> torch.Tensor:
        """The reference's ``_spec_step_impl``: the ``[B, K+1]`` forward
        through the chunked-prefill kernel (DeepSeek: the latent one) with a
        logits window of ``K+1``, the guided masks applied once (so the
        packed alternatives are of the distribution verified against),
        ``spec_verify`` under ``fold_in(rng, step)``, and the packed row."""
        t = {k: _upload(v, self.device) for k, v in a.items()}
        S = a["toks"].shape[1]
        kernel = "mla_prefill" if self.mla else "paged_prefill"
        logits, aux = self._forward(t["toks"], t["pos"], t["table"],
                                    t["total"], t["new"], kernel,
                                    logits_window=S)
        # a MoE family's verify step reports dispatch drops like any step
        self._queue_drops(aux.get("moe_dropped_assignments"))
        logits = logits.float()
        B, _S, V = logits.shape
        if "gmask" in t:
            logits = apply_vocab_mask(
                logits.reshape(B * S, V),
                t["gmask"].reshape(B * S, -1)).reshape(B, S, V)
        n_acc, final_tok, final_lp, draft_lps = spec_verify(
            logits, t["toks"], prng.fold_in(self._rng, t["step"]),
            t["temp"], t["top_k"], t["top_p"])
        cols = [final_tok[:, None], final_lp.view(torch.int32)[:, None],
                n_acc[:, None], draft_lps.view(torch.int32)]
        if self.cfg.num_top_logprobs > 0:
            # per-slot alternatives: [B, S*kt] ids, then their lp bits
            ids, lp_bits = self._topk_cols(logits.reshape(B * S, V))
            cols += [ids.reshape(B, -1), lp_bits.reshape(B, -1)]
        return torch.cat(cols, dim=1)

    @property
    def supports_pipelining(self) -> bool:
        # speculation and chaining compose: verify steps do not chain, the
        # plain decode steps between them do (the scheduler breaks a chain
        # every spec_chain_break steps so fresh context can draft)
        return self.cfg.pipeline_decode

    def dispatch_decode(self, plan):
        """Dispatch one decode step without waiting for it; returns its
        handle (``fetch_packed`` reads it)."""
        return self._dispatch_step(plan, None)

    def dispatch_chained(self, plan, prev_handle):
        """Dispatch decode step N+1 over step N's rows, taking step N's
        sampled tokens from its packed output on the device."""
        self.chained_steps += 1
        return self._dispatch_step(plan, prev_handle)

    def _dispatch_step(self, plan, prev_handle):
        self._use_device()
        self._drop_released()
        seqs = plan.seqs
        a = self._decode_arrays(seqs, chained=prev_handle is not None)
        B = a["pos"].shape[0]
        samp = self._device_sampling(seqs, B)
        dev_arrays = {"table": self._table_arrays(seqs, B)[1],
                      "temp": samp["temp"], "top_k": samp["top_k"],
                      "top_p": samp["top_p"]}
        if prev_handle is not None:
            dev_arrays["toks"] = _device_of(prev_handle)[:, :1]
        plan._step_id = self._step_counter
        a["step"] = np.array(self._step_counter, np.int64)
        packed = self._step(a, self.decode_kernel, dev_arrays)
        self._step_counter += 1
        self.decode_dispatches += 1
        self.last_padded = (B, 1)
        return self._stage(packed)

    @torch.no_grad()
    def _step(self, a: dict, kernel: str,
              dev_arrays: Optional[dict] = None) -> torch.Tensor:
        """Upload one step's arrays (but those ``dev_arrays`` already holds
        on the device), run the forward with ``kernel`` as the attention,
        sample, and return the packed ``[B, 2 + 2K]`` int32 result (still
        on the device)."""
        dev_arrays = dev_arrays or {}
        t = {k: _upload(v, self.device) for k, v in a.items()
             if k not in dev_arrays}
        t.update(dev_arrays)
        logits, aux = self._forward(t["toks"], t["pos"], t["table"],
                                    t["total"], t["new"], kernel)
        self._queue_drops(aux.get("moe_dropped_assignments"))
        return self._sample_tail(logits, t, draw=bool(a["temp"].max() > 0))

    def _forward(self, toks, pos, table, total, new, kernel: str,
                 logits_window: int = 1):
        """The family's forward on the serving cache with ``kernel`` as the
        attention; returns (logits, aux). MoE families return a third
        ``aux`` dict (dispatch drop counts), the others the plain
        ``(logits, pages)`` pair (aux ``{}``)."""
        out = self.family.forward(
            self.params, self.model_cfg, toks, pos, self.pages, table, total,
            new, attn_impl=self._attn[kernel], logits_window=logits_window)
        return out[0], (out[2] if len(out) > 2 else {})

    def _queue_drops(self, drops: Optional[torch.Tensor]) -> None:
        """Queue one dispatch's dropped-assignment count (a device scalar)
        for the next stats read; no host sync. Past 512 pending, all but
        the freshest 8 are drained (those may still be in flight)."""
        if drops is None or not self._moe_dispatch_active:
            return
        with self._moe_drops_lock:
            self._pending_moe_drops.append(drops)
            overflow = len(self._pending_moe_drops) > 512
        if overflow:
            self._drain_moe_drops(keep_last=8)

    def _sample_tail(self, logits: torch.Tensor, t: dict,
                     draw: bool = True) -> torch.Tensor:
        """The reference's sampling epilogue (``JaxEngine._sample_tail``):
        penalties, then bias, then the guided mask on the logits (so the
        top-K alternatives and logprobs are of the distribution sampled
        from), then ``_sample_pack``."""
        logits = logits.float()
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
        return self._sample_pack(logits, t["step"], t["temp"], t["top_k"],
                                 t["top_p"], seeds, min_p, t["total"],
                                 draw)[0]

    def _sample_pack(self, logits, step, temp, top_k, top_p, seeds, min_p,
                     seed_pos, draw: bool):
        """Sample from float32 ``logits`` and pack ``[B, 2 + 2K]``; returns
        (packed, tokens). The Gumbel draw comes from ``fold_in(engine key,
        step)`` (seeded rows from their seed and ``seed_pos``). With
        ``draw`` False (every row greedy) the noise is zeros: a greedy row
        takes candidate 0 whatever the noise, and the draw is some 600
        small launches on the card."""
        B, V = logits.shape
        k = min(TOPK_MAX, V)
        if draw:
            gumbel = sampling_noise(prng.fold_in(self._rng, step), B, k,
                                    seeds=seeds, seed_rng=self._rng,
                                    seed_pos=seed_pos)
        else:
            gumbel = torch.zeros((B, k), device=logits.device)
        tokens, logprobs = sample_tokens(logits, gumbel, temp, top_k, top_p,
                                         min_p=min_p)
        cols = [tokens[:, None], logprobs.view(torch.int32)[:, None]]
        if min(self.cfg.num_top_logprobs, V) > 0:
            cols += list(self._topk_cols(logits))
        return torch.cat(cols, dim=1), tokens

    # -- the asynchronous fetch ----------------------------------------------

    def _stage(self, dev: torch.Tensor, carry=None):
        """The handle of a dispatch. On the GPU the packed output is copied
        into a free pinned buffer of the ring behind the dispatch's work and
        an event recorded after the copy, so a fetch waits for this
        dispatch alone. On the CPU a step's handle is the tensor itself."""
        if dev.device.type != "cuda":
            return dev if carry is None else _Staged(dev, carry)
        h = _Staged(dev, carry)
        # a buffer is reused only once its handle was fetched or dropped;
        # the loop holds two unfetched (step N+1 runs while N is fetched),
        # so a ring settles at two buffers per shape
        ring = self._pinned.setdefault((tuple(dev.shape), dev.dtype), [])
        slot = next((s for s in ring if s.free()), None)
        if slot is None:
            slot = _PinnedSlot(torch.empty(dev.shape, dtype=dev.dtype,
                                           pin_memory=True))
            ring.append(slot)
        slot.owner = weakref.ref(h)
        slot.buf.copy_(dev, non_blocking=True)
        h.slot = slot
        h.event = torch.cuda.Event()
        h.event.record()
        return h

    def _host(self, handle) -> np.ndarray:
        """The packed output of ``handle`` on the host: on the GPU, after
        waiting for the handle's own event (not the stream)."""
        if isinstance(handle, torch.Tensor):
            return handle.numpy()
        if handle.slot is None:
            return handle.dev.numpy()
        handle.event.synchronize()
        out = handle.slot.buf.numpy().copy()
        handle.slot.owner = None
        return out

    def fetch_packed(self, handle):
        """Unpack one step's results into (sampled, logprobs, extras), as
        ``JaxEngine.fetch_packed`` does."""
        host = self._host(handle)
        hostf = host.view(np.float32)
        extras = None
        if host.shape[1] > 2:
            K = (host.shape[1] - 2) // 2
            extras = {"top_ids": host[:, 2:2 + K],
                      "top_lps": hostf[:, 2 + K:]}
        return host[:, 0], hostf[:, 1], extras

    def fetch_packed_block(self, handle):
        """Unpack one fused block's ``[B, w, 2 + 2K]`` results into
        (sampled [B, w], logprobs [B, w], extras)."""
        host = self._host(handle)
        hostf = host.view(np.float32)
        extras = None
        if host.shape[2] > 2:
            K = (host.shape[2] - 2) // 2
            extras = {"top_ids": host[:, :, 2:2 + K],
                      "top_lps": hostf[:, :, 2 + K:]}
        return host[:, :, 0], hostf[:, :, 1], extras

    # -- the fused block -------------------------------------------------------

    @property
    def supports_multistep(self) -> bool:
        # fusion composes with pipelined decode (the per-step chain serves
        # the batches the planner does not fuse), not with speculation (its
        # own [B, K+1] verify path, as in the reference); pipeline_decode
        # False is strict step-at-a-time decode, fusion off too
        return (self.multistep > 1 and self.cfg.pipeline_decode
                and not self.spec_K)

    @property
    def multistep_unsupported_reason(self) -> Optional[str]:
        """Why fusion is off on an engine whose config asked for it: the
        reference's reasons are speculative decoding and multi-host
        lockstep, which the port does not serve (ROADMAP A13)."""
        if self.multistep <= 1 or not self.cfg.pipeline_decode:
            return None
        if self.spec_K:
            return "spec"
        return None

    def dispatch_multistep(self, plan, prev_handle=None):
        """Dispatch one fused block of ``plan.width`` decode steps without
        waiting for it; returns its handle (packed block and device carry).
        A chained block takes its first token, positions, liveness, budgets
        and penalty/automaton state from the previous block's carry; only
        the page table (pages may have grown) comes from the host."""
        self._use_device()
        self._drop_released()
        seqs, w = plan.seqs, plan.width
        B = _bucket(len(seqs), self.cfg.min_decode_bucket,
                    self.cfg.max_num_seqs)
        samp = self._device_sampling(seqs, B)
        x = {"table": self._table_arrays(seqs, B)[1], "temp": samp["temp"],
             "top_k": samp["top_k"], "top_p": samp["top_p"],
             "stop_ids": samp["stop_ids"], **samp["pen"]}
        if prev_handle is not None:
            c = prev_handle.carry
            x.update((k, c[k]) for k in CARRY)
            if samp["needs_pcarry"]:
                x.update((k, c[k]) for k in PEN_CARRY)
        else:
            tok = np.zeros((B, 1), np.int32)
            pos = np.zeros((B, 1), np.int32)
            total = np.ones(B, np.int32)    # pad rows: 1 garbage-page token
            alive = np.zeros(B, bool)       # pad rows: never write
            budget = np.zeros(B, np.int32)
            min_gate = np.zeros(B, np.int32)
            for i, (seq, sl) in enumerate(zip(seqs, plan.start_lens)):
                tok[i, 0] = seq.tokens.last_token()
                pos[i, 0] = sl - 1
                total[i] = sl
                alive[i] = True
                budget[i] = plan.budgets[i]
                min_gate[i] = plan.min_gates[i]
            x.update((k, _upload(v, self.device)) for k, v in
                     zip(CARRY, (tok, pos, total, alive, budget, min_gate)))
            if samp["needs_pcarry"]:
                x.update(self._fresh_pcarry(seqs, B, samp))
        x["step0"] = _upload(np.array(self._step_counter, np.int64),
                             self.device)
        plan._step_id = self._step_counter
        out = self._run_block(x, w, samp["draw"])
        if self._moe_dispatch_active:
            # the graph's static output is overwritten by its next replay:
            # the queue keeps a device copy (no host sync)
            self._queue_drops(out["drops"].clone())
        # one rng-fold key per fused step: the counter advances by the
        # width, so fused and per-step runs draw the same keys
        self._step_counter += w
        self.decode_dispatches += 1
        self.multistep_blocks += 1
        self.last_padded = (B, w)
        return self._stage(out["packed"], carry=out)

    def _run_block(self, x: dict, w: int, draw: bool,
                   report: bool = True) -> dict:
        """The block on ``x``: on the GPU one replay of its shape's graph
        (captured first when the shape is new, warmed up on the same inputs
        with every row dead, which writes only the garbage page), on the
        CPU the body itself."""
        if self.graphs is None:
            return self._block(x, w, draw)
        warm = dict(x, alive=torch.zeros_like(x["alive"]))
        t0 = time.perf_counter()
        out, fresh = self.graphs.run(
            (w, draw), lambda s: self._block(s, w, draw), x, warm)
        if fresh and report:
            self._mark_compile("multistep", x["tok"].shape[0], w,
                               time.perf_counter() - t0)
        return out

    @torch.no_grad()
    def _block(self, x: dict, w: int, draw: bool) -> dict:
        """``w`` decode steps over the tensors of ``x`` (the reference's
        ``_multistep_impl``, its ``lax.scan`` written out). Per step: the
        forward with ``new = alive`` (dead rows write no KV, their position
        and total freeze), penalties and bias over the window and the
        prompt entries, the guided mask last, the draw from
        ``fold_in(rng, step0 + j)``, the packed row, then the stop rule
        ``(hit & j+1 >= min_gate) | j+1 >= budget``, the window update over
        live penalized rows and the automaton step of live rows. Returns
        the packed ``[B, w, 2 + 2K]`` block, the carry for the next, and
        ``drops``: the MoE dispatch's dropped assignments summed over the
        steps (on the GPU an output of the block's graph)."""
        tok, pos, total, alive = x["tok"], x["pos"], x["total"], x["alive"]
        table, stop_ids = x["table"], x["stop_ids"]
        budget, min_gate = x["budget"], x["min_gate"]
        pw = "pw_fp" in x
        gt = "gt_trans" in x
        B = tok.shape[0]
        dev = tok.device
        if "pids" in x:
            pids, pcnt, pctx, pbias, pn, gstate = (x[k] for k in PEN_CARRY)
        else:
            # an unconstrained block: a zero window and state, so every
            # block's carry has the same keys
            W = self.cfg.penalty_window
            pids = torch.zeros((B, W), dtype=torch.int32, device=dev)
            pcnt = torch.zeros((B, W), dtype=torch.float32, device=dev)
            pctx = torch.zeros((B, W), dtype=torch.float32, device=dev)
            pbias = torch.zeros((B, W), dtype=torch.float32, device=dev)
            pn = torch.zeros(B, dtype=torch.int32, device=dev)
            gstate = torch.zeros(B, dtype=torch.int32, device=dev)
        steps = []
        drops = torch.zeros((), dtype=torch.int32, device=dev)
        for j in range(w):
            new = alive.to(torch.int32)
            logits, aux = self._forward(tok, pos, table, total, new,
                                        self.decode_kernel)
            if self._moe_dispatch_active:
                drops = drops + aux["moe_dropped_assignments"]
            logits = logits.float()
            if pw:
                # the window and the prompt entries in one scatter-add
                # (excluded and pad entries carry a zero delta)
                prompt = x["pw_prompt_ids"]
                inc = penalty_window_entries(prompt, x["pw_prompt_valid"],
                                             pids, pn)
                zs = torch.zeros(inc.shape, dtype=torch.float32, device=dev)
                logits = apply_penalties(
                    logits, torch.cat([pids, prompt], dim=1),
                    torch.cat([pcnt, zs], dim=1),
                    torch.cat([pctx, inc.float()], dim=1),
                    x["pw_fp"], x["pw_pp"], x["pw_rp"],
                    pen_bias=torch.cat([pbias, zs], dim=1))
            if gt:
                logits = apply_vocab_mask(logits,
                                          x["gt_masks"][gstate.long()])
            packed, sampled = self._sample_pack(
                logits, x["step0"] + j, x["temp"], x["top_k"], x["top_p"],
                x.get("seeds"), x.get("min_p"), total, draw)
            steps.append(packed)
            hit = (stop_ids == sampled[:, None]).any(dim=1)
            stopped = (hit & (j + 1 >= min_gate)) | (j + 1 >= budget)
            tok = torch.where(alive[:, None], sampled[:, None], tok)
            pos = pos + new[:, None]
            total = total + new
            if pw:
                # the sampled token joins the row's penalized set for the
                # next step, as the per-step path recounts it
                pids, pcnt, pctx, pn = update_penalty_window(
                    pids, pcnt, pctx, pn, sampled, alive & x["pw_active"])
            if gt:
                # EOS rows self-loop in the table; dead rows freeze
                gstate = torch.where(
                    alive, x["gt_trans"][gstate.long(), sampled.long()],
                    gstate)
            alive = alive & ~stopped
        return {"packed": torch.stack(steps, dim=1), "tok": tok, "pos": pos,
                "total": total, "alive": alive, "budget": budget - w,
                "min_gate": min_gate - w, "pids": pids, "pcnt": pcnt,
                "pctx": pctx, "pbias": pbias, "pn": pn, "gstate": gstate,
                "drops": drops}

    def prime_multistep(self, B: int, widths=None):
        """Capture the fused block's graphs for padded batch ``B`` before
        serving (on the CPU: run the body), with every row dead so nothing
        but the garbage page is written. Defaults to the pow2 ladder the
        scheduler narrows to (cap, cap/2, .., 2). Returns the last packed
        block."""
        if widths is None:
            widths, w = [], 1 << (self.multistep.bit_length() - 1)
            while w >= 2:
                widths.append(w)
                w //= 2
        self._use_device()
        dev, P = self.device, self.table_width

        def z(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        out = None
        for w in widths:
            x = {"table": z((B, P)), "temp": z(B, torch.float32),
                 "top_k": z(B), "top_p": torch.ones(B, device=dev),
                 "stop_ids": torch.full((B, 1), -1, dtype=torch.int32,
                                        device=dev),
                 "tok": z((B, 1)), "pos": z((B, 1)),
                 "total": torch.ones(B, dtype=torch.int32, device=dev),
                 "alive": z(B, torch.bool), "budget": z(B),
                 "min_gate": z(B), "step0": z((), torch.int64)}
            # priming IS the capture: serving's first block of this shape
            # replays and reports no capture
            out = self._run_block(x, w, False, report=False)["packed"]
        return out

    def _mark_compile(self, kind: str, batch: int, width: int,
                      seconds: float) -> None:
        """Record one graph capture (the port's counterpart of a jit
        compile) for the step flight recorder; the loop drains these after
        the dispatch."""
        with self._compile_lock:
            self._pending_compiles.append(
                {"kind": kind, "batch": batch, "width": width,
                 "seconds": seconds})
            if len(self._pending_compiles) > 256:
                # bounded when nothing drains (no loop running)
                del self._pending_compiles[:-64]

    def drain_compile_events(self) -> list:
        with self._compile_lock:
            ev, self._pending_compiles = self._pending_compiles, []
        return ev

    def stats(self):
        """The scheduler's metrics with the MoE drop count, as
        ``JaxEngine.stats``."""
        m = super().stats()
        m.worker_stats.moe_dropped_tokens = self.moe_dropped_total()
        return m

    def _drain_moe_drops(self, keep_last: int = 0) -> None:
        """Fold all but the ``keep_last`` freshest pending drop counts into
        the total: the list is swapped out under the lock, and the device
        values come over in ONE transfer outside it, so a slow fetch never
        blocks the step thread."""
        with self._moe_drops_lock:
            if len(self._pending_moe_drops) <= keep_last:
                return
            split = len(self._pending_moe_drops) - keep_last
            done = self._pending_moe_drops[:split]
            self._pending_moe_drops = self._pending_moe_drops[split:]
        total = int(torch.stack([d.reshape(()).to(torch.int64)
                                 for d in done]).sum())
        with self._moe_drops_lock:
            self._moe_dropped_total += total

    def moe_dropped_total(self) -> int:
        """Cumulative MoE dispatch overflow count (token-expert assignments
        whose combine weight was zeroed; 0 on the dense backend). Drains
        every pending device scalar: called from the stats scrape, where
        waiting for at most the dispatch in flight is acceptable."""
        self._drain_moe_drops(keep_last=0)
        with self._moe_drops_lock:
            return self._moe_dropped_total

    # -- page IO: KV block export and inject ---------------------------------
    #
    # The reference's gather/scatter jits (``jax_engine.py`` page IO) as
    # PyTorch indexing. Every cache write is in place (``index_copy_``):
    # the fused blocks' CUDA graphs hold ``self.pages``'s address. Callers
    # run these on the loop's exclusive lane, whose thread issues them on
    # the same stream as the steps, so a gather reads what every step
    # before it wrote and a scatter lands before the next step reads.

    @staticmethod
    def _pad_page_ids(page_ids) -> np.ndarray:
        """Pad to the next power of two with page 0 (the garbage page), as
        the reference pads its jitted gathers."""
        n = 1
        while n < len(page_ids):
            n *= 2
        return np.asarray(list(page_ids) + [0] * (n - len(page_ids)),
                          np.int64)

    def _page_index(self, ids) -> torch.Tensor:
        self._use_device()
        return _upload(np.asarray(ids, np.int64), self.device)

    def dispatch_gather_pages(self, page_ids,
                              replicate: bool = True) -> torch.Tensor:
        """Gather cache pages -> ``[L, n_pad, 2, Hkv, ps, Dh]`` on the
        cache's device, not waited on. ``replicate`` is the reference's
        mesh flag; one device has nothing to replicate."""
        return self.pages.index_select(
            1, self._page_index(self._pad_page_ids(page_ids)))

    def fetch_host(self, dev: torch.Tensor) -> np.ndarray:
        """``dev`` on the host as a numpy array (bfloat16 as its uint16
        bits). On the GPU the copy lands in pinned memory behind the work
        already queued on this thread's stream, and only its own event is
        waited on."""
        from dynamo_tpu_torch.engine.transfer import host_array
        if dev.device.type != "cuda":
            return host_array(dev)
        buf = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        buf.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host_array(buf)

    def gather_pages_host(self, page_ids) -> np.ndarray:
        """Gather + host fetch, trimmed to the real page count."""
        out = self.dispatch_gather_pages(page_ids)
        return self.fetch_host(out[:, :len(page_ids)])

    def scatter_pages_device(self, page_ids, vals_dev) -> None:
        """Write ``vals_dev`` ``[L, n, 2, Hkv, ps, Dh]`` (a tensor, on any
        device) into cache pages ``page_ids``, in place."""
        n = len(page_ids)
        vals = vals_dev[:, :n]
        if vals.device != self.device:
            vals = vals.to(self.device, non_blocking=True)
        elif vals.is_cuda:
            # made on another stream (an inject upload, a direct pull):
            # its memory must outlive this stream's read of it
            vals.record_stream(torch.cuda.current_stream(self.device))
        self.page_scatter_dispatches += 1
        self.pages.index_copy_(1, self._page_index(page_ids),
                               vals.to(self.pages.dtype))

    def scatter_pages_host(self, page_ids, vals) -> None:
        """Scatter host values ``[L, n, 2, Hkv, ps, Dh]`` (numpy; bfloat16
        as uint16 bits) into cache pages, in place."""
        from dynamo_tpu_torch.engine.transfer import host_tensor
        vals = host_tensor(np.asarray(vals)[:, :len(page_ids)],
                           self.pages.dtype)
        self.scatter_pages_device(page_ids, vals)

    def scatter_pages_chunked(self, page_ids, vals,
                              max_blocks: Optional[int] = None) -> None:
        """Host-values scatter split into windows of at most ``max_blocks``
        pages (default: the static ``SCATTER_WINDOW_BLOCKS``; hot paths
        resolve the configured knob outside the exclusive window and pass
        it in). Callers hold the exclusive window across all chunks."""
        if max_blocks is None:
            from dynamo_tpu_torch.engine.transfer import SCATTER_WINDOW_BLOCKS
            max_blocks = SCATTER_WINDOW_BLOCKS
        vals = np.asarray(vals)
        for i in range(0, len(page_ids), max_blocks):
            self.scatter_pages_host(page_ids[i:i + max_blocks],
                                    vals[:, i:i + max_blocks])

    # -- one-shot surfaces: embeddings and prompt scoring ------------------

    async def _beside_loop(self, fn, *args):
        """Run ``fn`` off the scheduler. On the GPU it runs on the loop's
        exclusive lane (``run_exclusive``: between dispatches, on the step
        threads' card): a fused block's graph capture on the step thread
        fails if another thread launches work meanwhile (PyTorch's default
        stream is the legacy stream, which joins every capture), and its
        one-stream order keeps a replay's writes and this work's apart. On
        the CPU it runs in a thread beside the loop, as the reference's
        ``asyncio.to_thread``."""
        if self.device.type == "cuda":
            return await self.run_exclusive(fn, *args)
        return await asyncio.to_thread(fn, *args)

    def _padded_tokens(self, token_lists, S: int):
        B = len(token_lists)
        toks = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), bool)
        for i, ids in enumerate(token_lists):
            n = min(len(ids), S)
            toks[i, :n] = ids[:n]
            mask[i, :n] = True
        return toks, mask

    @torch.no_grad()
    def _embed_batch(self, token_lists) -> np.ndarray:
        """Mean-pooled hidden-state embeddings ``[B, H]`` float32 (the
        reference's ``_embed_batch``: the family's dense ``encode`` at the
        prefill bucket of the longest prompt; no KV cache)."""
        encode = getattr(self.family, "encode", None)
        if encode is None:
            raise NotImplementedError(
                f"{self.model_cfg.model_type} has no embedding path")
        S = _bucket(max(len(t) for t in token_lists),
                    self.cfg.min_prefill_bucket, self.cfg.max_prefill_chunk)
        toks, mask = self._padded_tokens(token_lists, S)
        self._use_device()
        out = encode(self.params, self.model_cfg,
                     _upload(toks, self.device), _upload(mask, self.device))
        return out.cpu().numpy()

    async def embed(self, token_lists) -> np.ndarray:
        return await self._beside_loop(self._embed_batch, token_lists)

    def _score_batch(self, token_lists):
        """Per-token prompt logprobs (the OpenAI ``echo`` + logprobs
        surface): a list of (lps, top_ids [n, top_n], top_lps [n, top_n])
        per input; index 0 has no context (lp 0). The reference's
        ``_score_batch``: the family's paged chunked-prefill forward
        against scratch pages, ``logits_window`` covering each full chunk,
        so its attention is the prefill kernel's."""
        if not token_lists:
            return []
        cap = (self.cfg.score_max_tokens or self.cfg.max_context)
        cap = min(cap, self.cfg.max_context)
        longest = max(len(t) for t in token_lists)
        if longest > cap:
            # name the knob(s) that bind, as the reference does
            smt = self.cfg.score_max_tokens
            if not smt or smt > self.cfg.max_context:
                knob = "max_context"
            elif smt < self.cfg.max_context:
                knob = "score_max_tokens"
            else:
                knob = "score_max_tokens AND max_context"
            raise ValueError(
                f"prompt of {longest} tokens exceeds the scoring cap "
                f"{cap} (score_max_tokens="
                f"{self.cfg.score_max_tokens or 'max_context'}, "
                f"max_context {self.cfg.max_context}) — raise {knob} "
                "to score longer prompts")
        if "logits_window" not in inspect.signature(
                self.family.forward).parameters:
            raise NotImplementedError(
                f"{self.model_cfg.model_type} has no prompt-scoring "
                "path (forward lacks logits_window)")
        chunk = _SCORE_CHUNK
        S = max(chunk, -(-longest // chunk) * chunk)
        toks, _ = self._padded_tokens(token_lists, S)
        lps, tids, tlps = self._score_impl(toks)
        return [(lps[i, :len(t)], tids[i, :len(t)], tlps[i, :len(t)])
                for i, t in enumerate(token_lists)]

    @torch.no_grad()
    def _score_impl(self, tokens_np: np.ndarray):
        """The reference's ``_score_impl`` with its ``lax.scan`` over
        chunks written out. Every chunk is full (S is a multiple of the
        chunk), so ``new_lens`` is uniform and the window is the whole
        chunk; pad positions write KV into the row's own scratch pages past
        its real length, where no real position attends."""
        cfg = self.model_cfg
        dev = self.device
        self._use_device()
        B, S = tokens_np.shape
        chunk = _SCORE_CHUNK
        ps = self.cfg.page_size
        per_row = -(-S // ps)
        pages = self.family.make_pages(cfg, B * per_row + 1, ps, device=dev)
        table = (1 + torch.arange(B * per_row, dtype=torch.int32,
                                  device=dev)).reshape(B, per_row)
        tokens = _upload(tokens_np, dev)
        # position p's logits predict tokens[p + 1]: shifted once, so the
        # last slot of a chunk reaches across the chunk boundary
        tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
        top_n = max(1, min(self.cfg.num_top_logprobs or 1, cfg.vocab_size))
        attn = self._attn["mla_prefill" if self.mla else "paged_prefill"]
        new = torch.full((B,), chunk, dtype=torch.int32, device=dev)
        t_lp, top_id, top_lp = [], [], []
        for ci in range(S // chunk):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            pos = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                               device=dev)[None].expand(B, chunk)
            total = torch.full((B,), sl.stop, dtype=torch.int32, device=dev)
            logits = self.family.forward(
                self.params, cfg, tokens[:, sl].contiguous(),
                pos.contiguous(), pages, table, total, new, attn_impl=attn,
                logits_window=chunk)[0]
            lsm = torch.log_softmax(logits.float(), dim=-1)  # [B, c, V]
            t_lp.append(torch.gather(lsm, -1, tgt[:, sl, None])[..., 0])
            vals, ids = top_k_stable(lsm.reshape(B * chunk, -1), top_n)
            top_lp.append(vals.reshape(B, chunk, top_n))
            top_id.append(ids.to(torch.int32).reshape(B, chunk, top_n))
        # position j - 1 predicts token j; index 0 has no context, and the
        # wrapped last target drops out with the same shift
        t_lp, top_id, top_lp = (torch.cat(x, dim=1).cpu().numpy()
                                for x in (t_lp, top_id, top_lp))
        target_lps = np.concatenate(
            [np.zeros((B, 1), np.float32), t_lp[:, :-1]], axis=1)
        top_ids = np.concatenate(
            [np.zeros((B, 1, top_n), np.int32), top_id[:, :-1]], axis=1)
        top_lps = np.concatenate(
            [np.zeros((B, 1, top_n), np.float32), top_lp[:, :-1]], axis=1)
        return target_lps, top_ids, top_lps

    async def score(self, token_lists):
        return await self._beside_loop(self._score_batch, token_lists)

    def _use_device(self) -> None:
        """Dispatches run on the loop's pool threads: make this engine's
        card the thread's current device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

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


def _device_of(handle) -> torch.Tensor:
    """The packed device output behind a dispatch handle."""
    return handle if isinstance(handle, torch.Tensor) else handle.dev


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


__all__ = ["TorchEngine", "TorchEngineConfig", "decode_multistep_default",
           "mixed_batch_default", "decode_progress_default",
           "DECODE_MULTISTEP", "MIXED_BATCH", "DECODE_PROGRESS_EVERY"]
