"""Gemma-2 decoder in PyTorch over the paged KV cache.

The port of ``dynamo_tpu/models/gemma.py``'s serving forward, with the
Llama module's parameter layout and cache (``models/llama.py``) and these
differences:

- RMSNorm as ``x * (1 + w)`` in float32 (the weights are zero-initialised);
- sandwich norms: a pre- and a post-norm around the attention and around
  the MLP, four per layer;
- GeGLU MLP, ``gelu_tanh(x @ gate) * (x @ up) @ down``;
- the embedding scaled by ``sqrt(hidden_size)``, that factor first rounded
  to the model dtype (as HF and the reference do);
- attention-logit and final-logit soft-capping;
- alternating sliding-window layers, even layers sliding and odd layers
  global, as a per-layer window of the same paged attention;
- the query scale from ``query_pre_attn_scalar`` instead of ``head_dim``.

The engine passes the attention kernels' wrappers as ``attn_impl``; each
layer hands its window and the softcap to the kernel of the step's shape
(decode, prefill or ragged), which all take both. Every dense matmul goes
through ``ops/quant.mm``, so an int8 tree serves as the bf16 one does.
Gemma has no embeddings surface (no ``encode``), as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import (head_logits, make_pages,
                                           params_from_jax, select_rows,
                                           torch_dtype)
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.ops.attention import paged_attention, write_kv
from dynamo_tpu_torch.ops.rope import apply_rope

Params = Dict[str, object]

# rows of a stacked weight made per random draw by ``init_params``: the
# float32 draw of a whole Gemma-2-27B stack would not fit beside the rest
_INIT_ROWS = 1 << 26


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma's RMSNorm: float32 throughout, ``x * (1 + w)``."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + w.to(torch.float32))).to(x.dtype)


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window: even layers slide, odd layers are
    global (0)."""
    if not cfg.sliding_window:
        return [0] * cfg.num_layers
    return [cfg.sliding_window if i % 2 == 0 else 0
            for i in range(cfg.num_layers)]


def _sm_scale(cfg: ModelConfig) -> float:
    base = cfg.query_pre_attn_scalar or cfg.head_dim
    return base ** -0.5


def init_params(cfg: ModelConfig, generator: torch.Generator,
                scale: float = 0.02, device=None) -> Params:
    """Random-normal init (tests / benchmarks) on ``device`` from the seeded
    ``generator`` (which must live there), norms zero. Each weight is made
    in the model dtype a slab at a time (a float32 draw of at most
    ``_INIT_ROWS`` elements, scaled and cast), so a full-size model never
    needs a float32 copy of a whole stack."""
    dtype = torch_dtype(cfg.dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def randn(shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        flat = out.view(shape[0], -1)
        per = max(1, _INIT_ROWS // max(1, flat.shape[1]))
        for i in range(0, shape[0], per):
            n = min(per, shape[0] - i)
            flat[i:i + n] = (torch.randn((n, flat.shape[1]),
                                         generator=generator,
                                         dtype=torch.float32,
                                         device=device) * scale).to(dtype)
        return out

    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    layers = {
        "attn_norm": zeros((L, H)),
        "post_attn_norm": zeros((L, H)),
        "pre_ffw_norm": zeros((L, H)),
        "post_ffw_norm": zeros((L, H)),
        "wq": randn((L, H, cfg.q_size)),
        "wk": randn((L, H, cfg.kv_size)),
        "wv": randn((L, H, cfg.kv_size)),
        "wo": randn((L, cfg.q_size, H)),
        "w_gate": randn((L, H, I)),
        "w_up": randn((L, H, I)),
        "w_down": randn((L, I, H)),
    }
    params: Params = {"embed": randn((cfg.vocab_size, H)), "layers": layers,
                      "final_norm": zeros((H,))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = randn((H, cfg.vocab_size))
    return params


def _project_qkv(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 h: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = h.shape
    x = _rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q = quant.mm(lp, "wq", x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = quant.mm(lp, "wk", x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = quant.mm(lp, "wv", x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _finish_layer(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                  h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The post-attention norm on the attention residual, then the
    pre-norm, GeGLU MLP and post-norm on the MLP residual."""
    B, S, _ = h.shape
    eps = cfg.rms_norm_eps
    attn_out = quant.mm(lp, "wo", attn.reshape(B, S, cfg.q_size))
    h = h + _rms_norm(attn_out, lp["post_attn_norm"], eps)
    x = _rms_norm(h, lp["pre_ffw_norm"], eps)
    act = (F.gelu(quant.mm(lp, "w_gate", x), approximate="tanh")
           * quant.mm(lp, "w_up", x))
    mlp = quant.mm(lp, "w_down", act)
    return h + _rms_norm(mlp, lp["post_ffw_norm"], eps)


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor,
            new_lens: torch.Tensor, window: int = 1) -> torch.Tensor:
    """float32 logits at each row's last ``window`` real new positions
    (``[B, V]``, or ``[B, W, V]`` for the speculative verify step and
    prompt scoring), soft-capped when the config caps them."""
    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    logits = head_logits(params, select_rows(h, new_lens, window))
    cap = cfg.final_logit_softcap
    if cap:
        logits = torch.tanh(logits / cap) * cap
    return logits


def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    h = params["embed"][tokens.long()]
    # scaled by sqrt(H) rounded to the model dtype first, as HF does; a
    # host scalar, so a captured block copies nothing to the card
    normalizer = float(torch.tensor(math.sqrt(cfg.hidden_size),
                                    dtype=h.dtype))
    return h * normalizer


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, pages: torch.Tensor,
            page_table: torch.Tensor, total_lens: torch.Tensor,
            new_lens: torch.Tensor, attn_impl: Optional[Callable] = None,
            logits_window: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward over the stacked paged cache, with ``models/llama.py``'s
    signature and returns; ``attn_impl`` takes ``paged_attention``'s
    signature with its ``window`` and ``softcap`` keywords, which every
    layer passes (window 0 on the global layers)."""
    attn_impl = attn_impl or paged_attention
    sm_scale = _sm_scale(cfg)
    softcap = cfg.attn_logit_softcap or None
    h = _embed(cfg, params, tokens)
    layers = params["layers"]
    for l, win in enumerate(layer_windows(cfg)):
        lp = {k: v[l] for k, v in layers.items()}
        q, k, v = _project_qkv(cfg, lp, h, positions)
        write_kv(pages, l, k, v, page_table, positions, new_lens)
        attn = attn_impl(q, pages, l, page_table, positions, total_lens,
                         sm_scale, window=win, softcap=softcap)
        h = _finish_layer(cfg, lp, h, attn)
    return _logits(cfg, params, h, new_lens, window=logits_window), pages


__all__ = ["init_params", "params_from_jax", "forward", "make_pages",
           "layer_windows", "torch_dtype"]
