"""Llama-family decoder (llama 2/3, mistral, qwen2/qwen3) in PyTorch.

The port of ``dynamo_tpu/models/llama.py``'s serving forward: the same
parameter tree (a dict: ``embed``, stacked ``layers`` with ``[L, in, out]``
matrices, ``final_norm``, optional ``lm_head``) and the same paged cache
``[L, N, 2, Hkv, ps, Dh]``. The reference's ``lax.scan`` over stacked layers
becomes one Python loop; ``pages[l]`` is a free view here, so there is a
single forward with an ``attn_impl`` hook (the engine passes the CUDA
kernels' wrappers). The cache is updated IN PLACE by ``write_kv`` — the
JAX package donated it to the jitted step for the same effect.

Plain matrix products stay ``torch.matmul`` (the reference leaves them to
XLA, outside any Pallas kernel). Only the last real token's logits are
computed, ``[B, V]`` in float32, from model-dtype operands — or the last
``logits_window`` tokens' for prompt scoring. ``encode`` is the dense
(non-paged) forward of the embeddings surface.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.ops.attention import paged_attention, write_kv_rows
from dynamo_tpu_torch.ops.rope import apply_rope

Params = Dict[str, object]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis (also qwen3's per-head q/k norm, where x
    is [B, S, H, Dh] and w is [Dh])."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def make_pages(cfg: ModelConfig, num_pages: int, page_size: int,
               dtype: Optional[torch.dtype] = None,
               device=None) -> torch.Tensor:
    """Stacked paged KV cache ``[L, N, 2, Hkv, page_size, Dh]``, zeroed.
    Page 0 is the garbage page for pad writes: allocators hand out pages
    from 1."""
    dtype = dtype or torch_dtype(cfg.dtype)
    return torch.zeros((cfg.num_layers, num_pages, 2, cfg.num_kv_heads,
                        page_size, cfg.head_dim), dtype=dtype, device=device)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                scale: float = 0.02, device=None) -> Params:
    """Random-normal init (tests / benchmarks), built on ``device`` from the
    seeded ``generator`` (which must live on that device)."""
    dtype = torch_dtype(cfg.dtype)

    def norm(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def randn(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    layers = {
        "attn_norm": norm((L, H)),
        "wq": randn((L, H, cfg.q_size)),
        "wk": randn((L, H, cfg.kv_size)),
        "wv": randn((L, H, cfg.kv_size)),
        "wo": randn((L, cfg.q_size, H)),
        "mlp_norm": norm((L, H)),
        "w_gate": randn((L, H, I)),
        "w_up": randn((L, H, I)),
        "w_down": randn((L, I, H)),
    }
    if cfg.attention_bias:
        for name, n in (("bq", cfg.q_size), ("bk", cfg.kv_size),
                        ("bv", cfg.kv_size)):
            layers[name] = torch.zeros((L, n), dtype=dtype, device=device)
    if cfg.qk_norm:
        layers["q_norm"] = norm((L, cfg.head_dim))
        layers["k_norm"] = norm((L, cfg.head_dim))
    params: Params = {"embed": randn((cfg.vocab_size, H)), "layers": layers,
                      "final_norm": norm((H,))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = randn((H, cfg.vocab_size))
    return params


def params_from_jax(params_np: dict, cfg: ModelConfig,
                    device=None) -> Params:
    """The reference's parameter tree, given as numpy arrays (``embed``,
    ``layers`` with stacked ``[L, in, out]`` matrices, ``final_norm``,
    optional ``lm_head``), as this module's parameters in ``cfg.dtype`` —
    same layout, so both packages compute the same function. A quantized
    tree's ``*_q`` leaves come across as int8 and its ``*_scale`` leaves as
    float32 (``ops/quant.py``)."""
    dtype = torch_dtype(cfg.dtype)

    def conv(name, a):
        # ml_dtypes bfloat16 arrays have no torch counterpart: go via f32
        arr = np.asarray(a)
        if arr.dtype not in (np.float32, np.float64, np.float16):
            arr = arr.astype(np.float32)
        to = (torch.int8 if name.endswith("_q") else
              torch.float32 if name.endswith("_scale") else dtype)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=to)

    out: Params = {k: conv(k, v) for k, v in params_np.items()
                   if k != "layers" and v is not None}
    out["layers"] = {k: conv(k, v) for k, v in params_np["layers"].items()}
    return out


def _project_qkv(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 h: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-layer pre-attention math: norm, qkv, qk-norm, rope."""
    B, S, _ = h.shape
    eps = cfg.rms_norm_eps
    x = _rms_norm(h, lp["attn_norm"], eps)
    q = quant.mm(lp, "wq", x)
    k = quant.mm(lp, "wk", x)
    v = quant.mm(lp, "wv", x)
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = _rms_norm(q, lp["q_norm"], eps)
        k = _rms_norm(k, lp["k_norm"], eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _finish_layer(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                  h: torch.Tensor, attn: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """Out-projection residual + gated MLP residual (under tp, ``wo`` and
    ``w_down`` are the row-parallel products, each summed over ``tp``)."""
    B, S, _ = h.shape
    h = h + quant.row_mm(lp, "wo", attn.reshape(B, S, cfg.q_size), mesh)
    x = _rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    act = F.silu(quant.mm(lp, "w_gate", x)) * quant.mm(lp, "w_up", x)
    return h + quant.row_mm(lp, "w_down", act, mesh)


def select_rows(h: torch.Tensor, new_lens: torch.Tensor,
                window: int) -> torch.Tensor:
    """Hidden states ``[B, S, H]`` at each row's last ``window`` real new
    positions: ``[B, H]`` for a window of 1, else ``[B, W, H]`` (positions
    before a row's first new token clamp to slot 0, as the reference's
    do)."""
    rows = torch.arange(h.shape[0], device=h.device)
    if window == 1:
        last = torch.clamp(new_lens.long() - 1, min=0)
        return h[rows, last]
    offs = torch.arange(window, device=h.device)[None, :]
    idx = torch.clamp(new_lens.long()[:, None] - window + offs, min=0)
    return h[rows[:, None], idx]


def head_logits(params: Params, h_sel: torch.Tensor, mesh=None,
                vocab: int = 0) -> torch.Tensor:
    """float32 logits of ``h_sel [..., H]``: the int8 head when the tree
    was quantized, else model-dtype operands with a float32 result. A
    vocab-split head (an untied ``lm_head`` narrower than ``vocab``)
    gathers every rank's columns, so each rank holds the full logits."""
    lm8 = params.get("lm_head_q")
    if lm8 is not None:
        out = quant.qdot(h_sel, lm8, params["lm_head_scale"],
                         out_dtype=torch.float32)
    else:
        lm_head = params.get("lm_head")
        if lm_head is None:
            lm_head = params["embed"].t()
        out = quant.mm_f32(h_sel, lm_head)
    if mesh is not None and vocab and out.shape[-1] != vocab:
        out = mesh.all_gather(out, "tp", dim=-1)
    return out


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor,
            new_lens: torch.Tensor, window: int = 1,
            mesh=None) -> torch.Tensor:
    """float32 logits at each row's last ``window`` real new positions:
    ``[B, V]`` for ``window == 1`` (every serving step), ``[B, W, V]``
    for ``window = W > 1`` (prompt scoring and the speculative verify
    step)."""
    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return head_logits(params, select_rows(h, new_lens, window), mesh,
                       cfg.vocab_size)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, pages: torch.Tensor,
            page_table: torch.Tensor, total_lens: torch.Tensor,
            new_lens: torch.Tensor, attn_impl: Optional[Callable] = None,
            logits_window: int = 1, mesh=None, dp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward over the stacked paged cache.

    tokens/positions: [B, S] (pads masked via new_lens); pages: the cache,
    written in place; page_table: [B, P]; total_lens: [B] context including
    the new tokens; new_lens: [B] real new tokens per row. ``attn_impl``
    takes ``paged_attention``'s signature. Returns (logits float32 at each
    row's last ``logits_window`` real new tokens — ``[B, V]`` for a window
    of 1, else ``[B, W, V]`` — and pages).

    Under tensor parallelism ``mesh`` is the rank's mesh, ``cfg`` the
    rank's local config (``parallel/sharding.local_config``: its heads and
    FFN width) and ``params`` / ``pages`` its shards; the collectives are
    one sum after ``wo`` and one after ``w_down`` per layer, and the
    gather of vocab-split logits. None issues none. Under data parallelism
    ``dp`` (``parallel/mesh.DpRows``) names this rank's rows of a batch
    split over ``dp``: the inputs are those rows, and each layer's new K/V
    rows are gathered over ``dp`` before the cache write, so every
    replica's cache holds every row (``ops.attention.write_kv_rows``).
    """
    sm_scale = cfg.head_dim ** -0.5
    attn_impl = attn_impl or paged_attention
    h = params["embed"][tokens.long()]
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in layers.items()}
        q, k, v = _project_qkv(cfg, lp, h, positions)
        write_kv_rows(pages, l, k, v, page_table, positions, new_lens, dp)
        attn = attn_impl(q, pages, l, page_table, positions, total_lens,
                         sm_scale)
        h = _finish_layer(cfg, lp, h, attn, mesh)
    return (_logits(cfg, params, h, new_lens, window=logits_window,
                    mesh=mesh), pages)


def _dense_layers(params: Params, cfg: ModelConfig, h: torch.Tensor,
                  mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """The ``cfg.num_layers`` layers of ``params`` over hidden states
    ``h [B, S, H]``, with causal dense (non-paged) attention over the
    prompt itself in plain PyTorch: float32 scores ``[B, H, S, S]`` per
    layer (the reference computes it outside any Pallas kernel too), so
    callers bound S. A pipeline stage runs its own layers with it."""
    B, S, _ = h.shape
    dev = h.device
    sm_scale = cfg.head_dim ** -0.5
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=dev))
    attn_mask = causal[None, None] & mask[:, None, None, :]      # [B,1,S,S]
    rep = cfg.num_heads // cfg.num_kv_heads
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in layers.items()}
        q, k, v = _project_qkv(cfg, lp, h, positions)
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * sm_scale
        scores = torch.where(attn_mask, scores,
                             torch.tensor(-1e30, device=dev))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
        h = _finish_layer(cfg, lp, h, attn.to(h.dtype), mesh)
    return h


def _dense_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """The causal dense forward of the one-shot embeddings surface
    (``_dense_layers`` from the embedding); returns the final-norm hidden
    states ``[B, S, H]``."""
    h = _dense_layers(params, cfg, params["embed"][tokens.long()], mask,
                      mesh)
    return _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)


def mean_pool(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32 mean of ``h [B, S, H]`` over each row's real tokens."""
    m = mask.float()[..., None]
    return (h.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def encode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Embeddings: the mean-pooled final hidden state over each row's real
    tokens, float32 ``[B, H]`` (tokens / mask ``[B, S]``; ``mesh`` as in
    ``forward``)."""
    return mean_pool(_dense_hidden(params, cfg, tokens, mask, mesh), mask)


__all__ = ["init_params", "params_from_jax", "forward", "encode",
           "make_pages", "torch_dtype"]
