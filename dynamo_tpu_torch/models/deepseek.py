"""DeepSeek V2/V3 family in PyTorch: absorbed multi-head latent attention
(MLA) over a latent paged cache, and shared + routed MoE.

The port of ``dynamo_tpu/models/deepseek.py``'s serving forward, with the
reference's names and parameter tree: ``embed``, ``final_norm``, optional
``lm_head``, and two layer stacks, ``dense_layers`` (the first
``first_k_dense_replace`` layers, gated MLP) and ``moe_layers`` (router,
``[M, E, in, out]`` routed experts, optional shared experts), matrices
``[in, out]``. The cache is the stacked latent cache ``[L, N, 2, 1, ps,
dkv]``: slot 0 holds the rms-normed latent ``c_kv``, slot 1 the shared
roped key ``k_pe`` zero-padded to ``dkv = kv_lora_rank``; page 0 is the
garbage page. It is written IN PLACE by ``ops.attention.write_kv``.

Attention runs in latent space: queries absorb ``W_UK`` (``q_lat``, kept
float32 as the reference computes it), scores are ``q_lat . c_kv + q_pe .
k_pe`` and the value is the latent; ``W_UV`` re-expands the result outside
the attention. ``forward`` takes an ``attn_impl`` hook with the MLA
signature ``(q_lat, q_pe, pages, layer, page_table, positions, total_lens,
sm_scale) -> [B, S, nh, dkv]`` float32; the engine passes the CUDA kernels'
wrappers (``ops/kernels/mla_decode.py`` for S == 1, ``mla_prefill.py`` for
S > 1, as the reference's Pallas path chooses). Without a hook the
JAX-style oracle serves: ``_mla_attend`` (full gather) or
``_mla_attend_blockwise`` (online softmax over page chunks, S > 1 over
more than ``PAGES_PER_CHUNK`` table pages), as in the reference.

Routed experts run on the dense backend: every expert on every token, as at
the reference's ``deepseek.py:452-460``. Plain matrix products stay
``torch.matmul``/``bmm`` (the reference leaves them to XLA). Not ported
here: the ``dispatch`` capacity backend and the expert mesh (ROADMAP A11,
A13), ``forward_unrolled`` (one forward over the stacked cache serves), and
``load_params`` (waits for a checkpoint in the repository, ROADMAP A6).
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import _logits, _rms_norm, torch_dtype
from dynamo_tpu_torch.ops.attention import NEG_INF, _pad_table, write_kv
from dynamo_tpu_torch.ops.sampling import top_k_stable

Params = Dict[str, object]

# pages per streamed chunk on the blockwise path (reference value)
PAGES_PER_CHUNK = 8


def yarn_freqs(cfg: ModelConfig) -> Tuple[np.ndarray, float]:
    """(inv_freq [dr/2] float32, attention_factor): HF's
    ``_compute_yarn_parameters`` for the rope head dim, in float64 then
    float32 as the reference; identity when the config has no yarn."""
    dr = cfg.qk_rope_head_dim
    base = cfg.rope_theta
    pos_freqs = base ** (np.arange(0, dr, 2, dtype=np.float64) / dr)
    if not cfg.rope_scaling_factor:
        return (1.0 / pos_freqs).astype(np.float32), 1.0
    factor = cfg.rope_scaling_factor
    orig = cfg.rope_orig_max_position or cfg.max_position_embeddings

    def get_mscale(scale, mscale=1.0):
        if scale <= 1:
            return 1.0
        return 0.1 * mscale * math.log(scale) + 1.0

    if cfg.rope_attention_factor:
        attention_factor = cfg.rope_attention_factor
    elif cfg.rope_mscale and cfg.rope_mscale_all_dim:
        attention_factor = (get_mscale(factor, cfg.rope_mscale)
                            / get_mscale(factor, cfg.rope_mscale_all_dim))
    else:
        attention_factor = get_mscale(factor)

    def correction_dim(num_rot):
        return (dr * math.log(orig / (num_rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), dr - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dr // 2, dtype=np.float64) - low)
                   / (high - low), 0, 1)
    extrapolation_factor = 1 - ramp
    inv_freq = ((1.0 / (factor * pos_freqs)) * (1 - extrapolation_factor)
                + (1.0 / pos_freqs) * extrapolation_factor)
    return inv_freq.astype(np.float32), float(attention_factor)


_YARN_FIELDS = ("qk_rope_head_dim", "rope_theta", "rope_scaling_factor",
                "rope_orig_max_position", "max_position_embeddings",
                "rope_attention_factor", "rope_mscale", "rope_mscale_all_dim",
                "rope_beta_fast", "rope_beta_slow")


def yarn_table(cfg: ModelConfig, device) -> Tuple[torch.Tensor, float]:
    """``yarn_freqs`` with inv_freq as a float32 tensor on ``device``, made
    once per (rope config, device): every layer of the forward reads it,
    and an upload there would wait for the device (and could not be
    captured in a CUDA graph)."""
    return _yarn_table(tuple(getattr(cfg, f) for f in _YARN_FIELDS),
                       str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _yarn_table(fields: tuple, device: str) -> Tuple[torch.Tensor, float]:
    inv, scale = yarn_freqs(SimpleNamespace(**dict(zip(_YARN_FIELDS,
                                                       fields))))
    return torch.from_numpy(inv).to(device), scale


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor, theta: float,
                     inv_freq: Union[np.ndarray, torch.Tensor, None] = None,
                     scale: float = 1.0,
                     interleaved: bool = True) -> torch.Tensor:
    """RoPE in either DeepSeek convention, scaled by the yarn
    ``attention_factor``: ``interleaved=True`` rotates consecutive pairs
    ``(x[2i], x[2i+1])`` (HF's complex-pair form), ``False`` llama's
    rotate-half over ``(x[:D/2], x[D/2:])``. x [B, S, ..., D]; positions
    [B, S]. Computed in float32, returned in x's dtype."""
    D = x.shape[-1]
    dev = x.device
    if inv_freq is None:
        inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                            device=dev) / D))
    elif isinstance(inv_freq, torch.Tensor):
        inv = inv_freq
    else:
        inv = torch.as_tensor(np.asarray(inv_freq, np.float32), device=dev)
    ang = positions.to(torch.float32)[..., None] * inv       # [B, S, D/2]
    while ang.dim() < x.dim():
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang) * scale, torch.sin(ang) * scale
    if interleaved:
        xr = x[..., 0::2].float()
        xi = x[..., 1::2].float()
        out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
        return out.reshape(x.shape).to(x.dtype)
    x1 = x[..., :D // 2].float()
    x2 = x[..., D // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------- params

def make_pages(cfg: ModelConfig, num_pages: int, page_size: int,
               dtype: Optional[torch.dtype] = None,
               device=None) -> torch.Tensor:
    """Stacked latent cache ``[L, N, 2, 1, page_size, kv_lora_rank]``,
    zeroed; page 0 is the garbage page for pad writes."""
    dtype = dtype or torch_dtype(cfg.dtype)
    return torch.zeros((cfg.num_layers, num_pages, 2, 1, page_size,
                        cfg.kv_lora_rank), dtype=dtype, device=device)


def _layer_shapes(cfg: ModelConfig, moe: bool) -> Dict[str, tuple]:
    """Per-layer leaf shapes of one stack (``_attn_leaves`` and the MLP
    leaves of the reference's ``init_params``)."""
    H = cfg.hidden_size
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    shapes = {
        "attn_norm": (H,),
        "wkv_a": (H, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "kv_a_norm": (cfg.kv_lora_rank,),
        "wkv_b": (cfg.kv_lora_rank,
                  cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "wo": (cfg.num_heads * cfg.v_head_dim, H),
        "mlp_norm": (H,),
    }
    if cfg.q_lora_rank:
        shapes["wq_a"] = (H, cfg.q_lora_rank)
        shapes["q_a_norm"] = (cfg.q_lora_rank,)
        shapes["wq_b"] = (cfg.q_lora_rank, cfg.num_heads * qk_head)
    else:
        shapes["wq"] = (H, cfg.num_heads * qk_head)
    if not moe:
        I = cfg.intermediate_size
        shapes.update(w_gate=(H, I), w_up=(H, I), w_down=(I, H))
        return shapes
    E = cfg.num_experts
    Im = cfg.moe_intermediate_size or cfg.intermediate_size
    shapes.update(w_router=(H, E), w_gate=(E, H, Im), w_up=(E, H, Im),
                  w_down=(E, Im, H))
    if cfg.topk_method == "noaux_tc":
        shapes["router_bias"] = (E,)
    if cfg.n_shared_experts:
        Is = Im * cfg.n_shared_experts
        shapes.update(ws_gate=(H, Is), ws_up=(H, Is), ws_down=(Is, H))
    return shapes


_ONES = ("attn_norm", "kv_a_norm", "mlp_norm", "q_a_norm")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                scale: float = 0.02, device=None) -> Params:
    """Random-normal init (tests / benchmarks) with the two-stack layout,
    built on ``device`` from the seeded ``generator`` (which must live on
    that device). Each stack is allocated once in the model dtype and
    filled one layer at a time, so the float32 draw is one layer's leaf at
    most (a whole-stack draw of V2-Lite's routed ``w_gate`` would be
    19 GB). Norms are ones; ``router_bias`` is float32 zeros."""
    dtype = torch_dtype(cfg.dtype)
    H = cfg.hidden_size

    def randn(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    def stack(n: int, moe: bool) -> Dict[str, torch.Tensor]:
        out = {}
        for name, shape in _layer_shapes(cfg, moe).items():
            if name in _ONES:
                out[name] = torch.ones((n,) + shape, dtype=dtype,
                                       device=device)
            elif name == "router_bias":
                out[name] = torch.zeros((n,) + shape, dtype=torch.float32,
                                        device=device)
            else:
                leaf = torch.empty((n,) + shape, dtype=dtype, device=device)
                for i in range(n):
                    leaf[i] = randn(shape)
                out[name] = leaf
        return out

    params: Params = {"embed": randn((cfg.vocab_size, H)),
                      "final_norm": torch.ones((H,), dtype=dtype,
                                               device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = randn((H, cfg.vocab_size))
    K = cfg.first_k_dense_replace
    if K:
        params["dense_layers"] = stack(K, moe=False)
    if cfg.num_layers - K:
        params["moe_layers"] = stack(cfg.num_layers - K, moe=True)
    return params


def params_from_jax(params_np: dict, cfg: ModelConfig,
                    device=None) -> Params:
    """The reference's two-stack tree, given as numpy arrays, as this
    module's parameters: every leaf in ``cfg.dtype`` except
    ``router_bias``, which stays float32 as the reference's loader keeps it
    (``deepseek.py:744-747``: rounding it flips near-tie routes)."""
    dtype = torch_dtype(cfg.dtype)

    def conv(name, a):
        # ml_dtypes bfloat16 arrays have no torch counterpart: go via f32
        arr = np.asarray(a)
        if arr.dtype not in (np.float32, np.float64, np.float16):
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device,
            dtype=torch.float32 if name == "router_bias" else dtype)

    out: Params = {}
    for key, val in params_np.items():
        if isinstance(val, dict):
            out[key] = {k: conv(k, v) for k, v in val.items()}
        elif val is not None:
            out[key] = conv(key, val)
    return out


# ---------------------------------------------------------------- attention

def _mla_qkv(cfg: ModelConfig, lp: Dict[str, torch.Tensor], h: torch.Tensor,
             positions: torch.Tensor):
    """Pre-attention MLA math: queries (latent-absorbed + rope) and the new
    tokens' cache rows. Returns (q_lat [B,S,nh,dkv] float32, q_pe
    [B,S,nh,dr], c_kv [B,S,dkv], k_pe [B,S,dr], w_uv [nh,dkv,dv])."""
    B, S, _H = h.shape
    nh = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dkv, dv = cfg.kv_lora_rank, cfg.v_head_dim
    eps = cfg.rms_norm_eps
    x = _rms_norm(h, lp["attn_norm"], eps)
    if cfg.q_lora_rank:
        q = _rms_norm(x @ lp["wq_a"], lp["q_a_norm"], eps) @ lp["wq_b"]
    else:
        q = x @ lp["wq"]
    q = q.reshape(B, S, nh, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    inv_freq, att_scale = yarn_table(cfg, h.device)
    q_pe = rope_interleaved(q_pe, positions, cfg.rope_theta,
                            inv_freq=inv_freq, scale=att_scale,
                            interleaved=cfg.rope_interleave)
    ckv = x @ lp["wkv_a"]                                  # [B,S,dkv+dr]
    c_kv = _rms_norm(ckv[..., :dkv], lp["kv_a_norm"], eps)
    k_pe = rope_interleaved(ckv[..., dkv:], positions, cfg.rope_theta,
                            inv_freq=inv_freq, scale=att_scale,
                            interleaved=cfg.rope_interleave)
    w_kb = lp["wkv_b"].reshape(dkv, nh, dn + dv)
    w_uk = w_kb[..., :dn].permute(1, 0, 2)                 # [nh, dkv, dn]
    w_uv = w_kb[..., dn:].permute(1, 0, 2)                 # [nh, dkv, dv]
    # absorb W_UK into the queries: scores run in latent space
    q_lat = torch.einsum("bsnd,nkd->bsnk", q_nope.float(), w_uk.float())
    return q_lat, q_pe, c_kv, k_pe, w_uv


def _cache_rows(cfg: ModelConfig, c_kv: torch.Tensor, k_pe: torch.Tensor):
    """(k_new, v_new) for the generic paged write: slot 0 the latent, slot
    1 the rope key zero-padded to the latent width. Both [B, S, 1, dkv]."""
    pad = cfg.kv_lora_rank - cfg.qk_rope_head_dim
    return c_kv[:, :, None, :], F.pad(k_pe, (0, pad))[:, :, None, :]


def _mla_scale(cfg: ModelConfig) -> float:
    """Softmax scale. V3 folds the yarn mscale into the score scale
    (``mscale^2`` when rope_scaling carries mscale_all_dim); V2 expresses
    it through the rope attention_factor instead (``yarn_freqs``)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if (cfg.model_type == "deepseek_v3" and cfg.rope_scaling_factor
            and cfg.rope_mscale_all_dim):
        m = (0.1 * cfg.rope_mscale_all_dim
             * math.log(cfg.rope_scaling_factor) + 1.0
             if cfg.rope_scaling_factor > 1 else 1.0)
        scale *= m * m
    return scale


def _expand_and_project(cfg: ModelConfig, lp, h: torch.Tensor,
                        lat: torch.Tensor, w_uv: torch.Tensor
                        ) -> torch.Tensor:
    """lat [B,S,nh,dkv] latent attention output -> W_UV expand -> wo
    residual."""
    B, S, _H = h.shape
    out = torch.einsum("bsnk,nkd->bsnd", lat, w_uv.float())
    out = out.reshape(B, S, cfg.num_heads * cfg.v_head_dim).to(h.dtype)
    return h + out @ lp["wo"]


def _mla_attend(cfg: ModelConfig, lp, h, q_lat, q_pe, w_uv,
                ckv_ctx: torch.Tensor, kpe_ctx: torch.Tensor,
                positions: torch.Tensor, total_lens: torch.Tensor
                ) -> torch.Tensor:
    """The oracle's direct path: latent attention over the gathered context
    ``ckv_ctx`` [B, T, dkv] / ``kpe_ctx`` [B, T, dr] in float32 (unrounded
    query, f32 weights), then the output projection residual."""
    sm_scale = _mla_scale(cfg)
    T = ckv_ctx.shape[1]
    ckv32 = ckv_ctx.float()
    scores = (torch.einsum("bsnk,btk->bnst", q_lat, ckv32)
              + torch.einsum("bsnd,btd->bnst", q_pe.float(),
                             kpe_ctx.float())) * sm_scale
    t_pos = torch.arange(T, device=h.device)[None, None, None, :]
    mask = ((t_pos <= positions.long()[:, None, :, None])
            & (t_pos < total_lens.long()[:, None, None, None]))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)                  # [B,nh,S,T]
    lat = torch.einsum("bnst,btk->bsnk", probs, ckv32)     # [B,S,nh,dkv]
    return _expand_and_project(cfg, lp, h, lat, w_uv)


def _mla_attend_blockwise(cfg: ModelConfig, lp, h, q_lat, q_pe, w_uv,
                          gather_chunk, num_table_pages: int, ps: int,
                          positions: torch.Tensor, total_lens: torch.Tensor
                          ) -> torch.Tensor:
    """The oracle's chunked path for prefill: the context streams in page
    chunks with an online softmax, so the peak intermediate is
    ``[B, nh, S, span]`` scores plus a ``[B, nh, S, dkv]`` accumulator."""
    B, S, _H = h.shape
    nh, dkv = cfg.num_heads, cfg.kv_lora_rank
    sm_scale = _mla_scale(cfg)
    span = PAGES_PER_CHUNK * ps
    n_static = -(-num_table_pages // PAGES_PER_CHUNK)
    n_chunks = min((int(total_lens.max()) + span - 1) // span, n_static)
    q_pe32 = q_pe.float()
    dev = h.device
    pos = positions.long()
    num = torch.zeros((B, nh, S, dkv), dtype=torch.float32, device=dev)
    den = torch.zeros((B, nh, S), dtype=torch.float32, device=dev)
    mx = torch.full((B, nh, S), NEG_INF, dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        ckv, kpe = gather_chunk(c)           # [B, span, dkv] / [B, span, dr]
        ckv32 = ckv.float()
        s = (torch.einsum("bsnk,btk->bnst", q_lat, ckv32)
             + torch.einsum("bsnd,btd->bnst", q_pe32, kpe.float())) * sm_scale
        t_pos = c * span + torch.arange(span, device=dev)
        mask = ((t_pos[None, None, None, :] <= pos[:, None, :, None])
                & (t_pos[None, None, None, :]
                   < total_lens.long()[:, None, None, None]))
        s = torch.where(mask, s, NEG_INF)
        mx_new = torch.maximum(mx, s.amax(dim=-1))         # [B,nh,S]
        p = torch.exp(s - mx_new[..., None])
        p = torch.where((mx_new > NEG_INF / 2)[..., None], p, 0.0)
        scale = torch.where(mx > NEG_INF / 2, torch.exp(mx - mx_new), 0.0)
        pv = torch.einsum("bnst,btk->bnsk", p, ckv32)
        num = num * scale[..., None] + pv
        den = den * scale + p.sum(dim=-1)
        mx = mx_new
    lat = (num / torch.clamp(den, min=1e-20)[..., None]).permute(0, 2, 1, 3)
    return _expand_and_project(cfg, lp, h, lat, w_uv)


def _gather_ctx(cfg: ModelConfig, gathered: torch.Tensor):
    """[B, P, 2, 1, ps, dkv] gathered pages -> latent / rope context."""
    B, P, _two, _one, ps, dkv = gathered.shape
    ckv = gathered[:, :, 0, 0].reshape(B, P * ps, dkv)
    kpe = gathered[:, :, 1, 0, :, :cfg.qk_rope_head_dim].reshape(
        B, P * ps, cfg.qk_rope_head_dim)
    return ckv, kpe


# --------------------------------------------------------------------- MoE

def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of any shape (ties: lower
    index first)."""
    vals, idx = top_k_stable(x.reshape(-1, x.shape[-1]), k)
    return (vals.reshape(x.shape[:-1] + (k,)),
            idx.reshape(x.shape[:-1] + (k,)))


def _group_mask(cfg: ModelConfig, group_scores: torch.Tensor,
                E: int) -> torch.Tensor:
    """[..., E] bool: the experts of each token's ``topk_group`` best
    groups."""
    _gv, gi = _top_k(group_scores, cfg.topk_group)
    group_mask = F.one_hot(gi, cfg.n_group).sum(dim=-2) > 0    # [..., g]
    return group_mask.repeat_interleave(E // cfg.n_group, dim=-1)


def _gate(cfg: ModelConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor):
    """The DeepSeek gate, per generation: V2 = float32 softmax scores with
    ``greedy`` / ``group_limited_greedy`` top-k (no renorm); V3
    (``noaux_tc``) = ``_gate_noaux``. Both scale by routed_scaling_factor.
    Returns (weights [..., k] float32, expert ids [..., k])."""
    if cfg.topk_method == "noaux_tc":
        return _gate_noaux(cfg, lp, x)
    scores = torch.softmax(x.float() @ lp["w_router"].float(), dim=-1)
    k = cfg.num_experts_per_tok
    if cfg.topk_method == "group_limited_greedy":
        E = scores.shape[-1]
        g = cfg.n_group
        group_scores = scores.reshape(scores.shape[:-1] + (g, E // g)) \
            .amax(dim=-1)
        masked = torch.where(_group_mask(cfg, group_scores, E), scores, 0.0)
        top_w, top_i = _top_k(masked, k)
    elif cfg.topk_method == "greedy":
        top_w, top_i = _top_k(scores, k)
    else:
        raise NotImplementedError(f"topk_method {cfg.topk_method!r}")
    return top_w * cfg.routed_scaling_factor, top_i


def _gate_noaux(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                x: torch.Tensor):
    """V3 aux-loss-free gate: sigmoid scores, bias-corrected group-limited
    selection (a group scores the sum of its top-2 corrected scores),
    weights from the UNCORRECTED scores, normalized (+1e-20) when
    norm_topk_prob, scaled."""
    scores = torch.sigmoid(x.float() @ lp["w_router"].float())
    sfc = scores + lp["router_bias"].float()
    E = scores.shape[-1]
    g, k = cfg.n_group, cfg.num_experts_per_tok
    group_scores = _top_k(sfc.reshape(sfc.shape[:-1] + (g, E // g)),
                          2)[0].sum(dim=-1)
    masked = torch.where(_group_mask(cfg, group_scores, E), sfc, 0.0)
    _w, top_i = _top_k(masked, k)
    top_w = torch.gather(scores, -1, top_i)
    if cfg.norm_topk_prob:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    return top_w * cfg.routed_scaling_factor, top_i


def _moe_mlp(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    """Routed experts (dense backend: every expert on every token, weighted
    by the gate; zero weight off the top-k) plus the shared experts. The
    tokens broadcast over the expert stack in one batched product per
    projection, so the ``[E, in, out]`` weights are read as they lie."""
    if cfg.moe_backend == "dispatch":
        raise NotImplementedError(
            "moe_backend='dispatch' (the capacity-factor expert dispatch) "
            "is not ported yet: ROADMAP A11")
    B, S, H = x.shape
    E = cfg.num_experts
    top_w, top_i = _gate(cfg, lp, x)
    weights = (F.one_hot(top_i, E).float() * top_w[..., None]).sum(dim=-2)
    xt = x.reshape(1, B * S, H).expand(E, B * S, H)
    act = F.silu(torch.bmm(xt, lp["w_gate"])) * torch.bmm(xt, lp["w_up"])
    per_expert = torch.bmm(act, lp["w_down"])              # [E, T, H]
    routed = torch.bmm(weights.reshape(B * S, 1, E).to(x.dtype),
                       per_expert.transpose(0, 1)).reshape(B, S, H)
    if cfg.n_shared_experts:
        routed = routed + _dense_mlp(lp, x, "ws_")
    return routed


def _dense_mlp(lp: Dict[str, torch.Tensor], x: torch.Tensor,
               prefix: str = "w_") -> torch.Tensor:
    return (F.silu(x @ lp[prefix + "gate"])
            * (x @ lp[prefix + "up"])) @ lp[prefix + "down"]


# ----------------------------------------------------------------- forward

def _layer_step(cfg: ModelConfig, lp, h, positions, total_lens, new_lens,
                page_table, pages, lidx: int, moe: bool,
                attn_impl: Optional[Callable]) -> torch.Tensor:
    """One decoder layer against the stacked latent cache (written in
    place)."""
    q_lat, q_pe, c_kv, k_pe, w_uv = _mla_qkv(cfg, lp, h, positions)
    k_new, v_new = _cache_rows(cfg, c_kv, k_pe)
    write_kv(pages, lidx, k_new, v_new, page_table, positions, new_lens)
    S = h.shape[1]
    P = page_table.shape[1]
    ps = pages.shape[-2]
    layer = pages[lidx]
    if attn_impl is not None:
        lat = attn_impl(q_lat, q_pe, pages, lidx, page_table, positions,
                        total_lens, _mla_scale(cfg))
        h = _expand_and_project(cfg, lp, h, lat, w_uv)
    elif S > 1 and P > PAGES_PER_CHUNK:
        table = _pad_table(page_table.long(), PAGES_PER_CHUNK)

        def gather_chunk(c):
            tbl = table[:, c * PAGES_PER_CHUNK:(c + 1) * PAGES_PER_CHUNK]
            return _gather_ctx(cfg, layer[tbl])

        h = _mla_attend_blockwise(cfg, lp, h, q_lat, q_pe, w_uv,
                                  gather_chunk, P, ps, positions,
                                  total_lens)
    else:
        ckv_ctx, kpe_ctx = _gather_ctx(cfg, layer[page_table.long()])
        h = _mla_attend(cfg, lp, h, q_lat, q_pe, w_uv, ckv_ctx, kpe_ctx,
                        positions, total_lens)
    x = _rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    return h + (_moe_mlp(cfg, lp, x) if moe else _dense_mlp(lp, x))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, pages: torch.Tensor,
            page_table: torch.Tensor, total_lens: torch.Tensor,
            new_lens: torch.Tensor, attn_impl: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward over the stacked latent cache: the dense stack, then the MoE
    stack, one shared cache.

    tokens/positions: [B, S] (pads masked via new_lens); pages: the latent
    cache, written in place; page_table: [B, P]; total_lens: [B] context
    including the new tokens; new_lens: [B] real new tokens per row.
    ``attn_impl`` takes the MLA signature (module docstring); None runs the
    oracle. Returns (logits [B, V] float32, pages)."""
    K = cfg.first_k_dense_replace
    h = params["embed"][tokens.long()]
    stacks = []
    if K and "dense_layers" in params:
        stacks.append((params["dense_layers"], 0, False))
    if "moe_layers" in params:
        stacks.append((params["moe_layers"], K, True))
    for layers, first, moe in stacks:
        n = next(iter(layers.values())).shape[0]
        for i in range(n):
            lp = {k: v[i] for k, v in layers.items()}
            h = _layer_step(cfg, lp, h, positions, total_lens, new_lens,
                            page_table, pages, first + i, moe, attn_impl)
    return _logits(cfg, params, h, new_lens), pages


__all__ = ["init_params", "params_from_jax", "forward", "make_pages",
           "yarn_freqs", "yarn_table", "rope_interleaved",
           "PAGES_PER_CHUNK"]
