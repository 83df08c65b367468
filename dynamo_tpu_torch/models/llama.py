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
computed, ``[B, V]`` in float32, from model-dtype operands.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import paged_attention, write_kv
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
    same layout, so both packages compute the same function."""
    dtype = torch_dtype(cfg.dtype)

    def conv(a):
        # ml_dtypes bfloat16 arrays have no torch counterpart: go via f32
        arr = np.asarray(a)
        if arr.dtype not in (np.float32, np.float64, np.float16):
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=dtype)

    out: Params = {"embed": conv(params_np["embed"]),
                   "layers": {k: conv(v)
                              for k, v in params_np["layers"].items()},
                   "final_norm": conv(params_np["final_norm"])}
    if params_np.get("lm_head") is not None:
        out["lm_head"] = conv(params_np["lm_head"])
    return out


def _project_qkv(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 h: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-layer pre-attention math: norm, qkv, qk-norm, rope."""
    B, S, _ = h.shape
    eps = cfg.rms_norm_eps
    x = _rms_norm(h, lp["attn_norm"], eps)
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
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
                  h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Out-projection residual + gated MLP residual."""
    B, S, _ = h.shape
    h = h + attn.reshape(B, S, cfg.q_size) @ lp["wo"]
    x = _rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    act = F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])
    return h + act @ lp["w_down"]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with model-dtype operands and a float32 result (the
    reference's ``preferred_element_type=f32``). On the card cuBLAS
    accumulates in f32 and writes f32; on the CPU the operands are upcast."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor,
            new_lens: torch.Tensor) -> torch.Tensor:
    """float32 logits [B, V] at each row's last real new token."""
    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    last = torch.clamp(new_lens.long() - 1, min=0)
    h_sel = h[torch.arange(h.shape[0], device=h.device), last]   # [B, H]
    lm_head = params.get("lm_head")
    if lm_head is None:
        lm_head = params["embed"].t()
    return _mm_f32(h_sel, lm_head)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, pages: torch.Tensor,
            page_table: torch.Tensor, total_lens: torch.Tensor,
            new_lens: torch.Tensor, attn_impl: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward over the stacked paged cache.

    tokens/positions: [B, S] (pads masked via new_lens); pages: the cache,
    written in place; page_table: [B, P]; total_lens: [B] context including
    the new tokens; new_lens: [B] real new tokens per row. ``attn_impl``
    takes ``paged_attention``'s signature. Returns (logits [B, V] float32,
    pages).
    """
    sm_scale = cfg.head_dim ** -0.5
    attn_impl = attn_impl or paged_attention
    h = params["embed"][tokens.long()]
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in layers.items()}
        q, k, v = _project_qkv(cfg, lp, h, positions)
        write_kv(pages, l, k, v, page_table, positions, new_lens)
        attn = attn_impl(q, pages, l, page_table, positions, total_lens,
                         sm_scale)
        h = _finish_layer(cfg, lp, h, attn)
    return _logits(cfg, params, h, new_lens), pages


__all__ = ["init_params", "params_from_jax", "forward", "make_pages",
           "torch_dtype"]
