"""Model architecture config, constructed from HF ``config.json``.

Capability parity: reference ``lib/llm/src/model_card/model.rs:87-230`` reads
HF config for context length / arch metadata; here the config additionally
drives the native model (the reference never builds the model itself).

This is the port's own copy of ``dynamo_tpu/models/config.py``.

Covers the Llama family tree: llama/llama-3, mistral, qwen2/qwen3 (qwen3 adds
per-head q/k RMS norm), the MoE variants (mixtral/qwen3_moe/deepseek-style
``num_experts``/``top_k`` routing) handled by ``models/moe.py``, and the
gemma-2 family (GeGLU, sandwich norms, logit softcaps, alternating
sliding-window layers) handled by ``models/gemma.py``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    qk_norm: bool = False          # qwen3-style per-head q/k RMSNorm
    attention_bias: bool = False   # qwen2-style qkv bias
    model_type: str = "llama"
    dtype: str = "bfloat16"
    # MoE (0 experts => dense MLP)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # expert compute: "dense" runs every expert on every token (static
    # shapes, fine at decode batch sizes); "dispatch" gathers each expert's
    # routed tokens into a fixed-capacity buffer first, cutting expert
    # FLOPs from E to ~k x capacity_factor per token (the wide-EP path)
    moe_backend: str = "dense"
    # dispatch capacity per expert = ceil(T * k / E * this); tokens routed
    # past capacity are dropped (their combine weight is zero) — the
    # standard GShard/Switch overflow semantics
    moe_capacity_factor: float = 2.0
    # DeepSeek V2/V3 MLA + MoE shape (models/deepseek.py). kv_lora_rank
    # > 0 selects the MLA family: the KV cache stores the compressed
    # latent (+ the shared rope key) instead of per-head K/V.
    q_lora_rank: int = 0               # 0 = direct q projection
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0     # leading dense (non-MoE) layers
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"        # greedy | group_limited_greedy
    n_group: int = 1
    topk_group: int = 1
    # YaRN rope scaling (real DeepSeek checkpoints ship
    # rope_scaling={type: yarn, ...}); factor 0 = disabled
    rope_scaling_factor: float = 0.0
    rope_orig_max_position: int = 0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.0
    rope_mscale_all_dim: float = 0.0
    rope_attention_factor: float = 0.0  # 0 = infer from factor/mscale
    # deepseek rope convention: True = complex-pair interleaved (the HF
    # default for this family), False = llama-style rotate-half halves
    rope_interleave: bool = True
    # gemma-2 family (models/gemma.py)
    sliding_window: int = 0            # 0 = all layers global attention
    attn_logit_softcap: float = 0.0    # 0 = disabled
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: float = 0.0  # 0 = use head_dim

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @classmethod
    def from_hf(cls, hf: Dict[str, Any], dtype: str = "bfloat16") -> "ModelConfig":
        heads = hf["num_attention_heads"]
        mt = hf.get("model_type", "llama")
        num_experts = hf.get("num_local_experts", hf.get("num_experts", 0)) or 0
        extra: Dict[str, Any] = {}
        if mt.startswith("deepseek"):
            num_experts = hf.get("n_routed_experts", 0) or 0
            extra = dict(
                q_lora_rank=int(hf.get("q_lora_rank") or 0),
                kv_lora_rank=int(hf.get("kv_lora_rank") or 0),
                qk_rope_head_dim=int(hf.get("qk_rope_head_dim") or 0),
                qk_nope_head_dim=int(hf.get("qk_nope_head_dim") or 0),
                v_head_dim=int(hf.get("v_head_dim") or 0),
                n_shared_experts=int(hf.get("n_shared_experts") or 0),
                first_k_dense_replace=int(
                    hf.get("first_k_dense_replace") or 0),
                routed_scaling_factor=float(
                    hf.get("routed_scaling_factor") or 1.0),
                # V3 checkpoints route with the aux-loss-free sigmoid gate;
                # HF's DeepseekV3Config does not serialize topk_method, so
                # the model type implies it
                topk_method=hf.get(
                    "topk_method",
                    "noaux_tc" if mt == "deepseek_v3" else "greedy"),
                n_group=int(hf.get("n_group") or 1),
                topk_group=int(hf.get("topk_group") or 1),
            )
            rs = hf.get("rope_scaling") or {}
            rtype = rs.get("rope_type", rs.get("type"))
            if rtype == "yarn":
                extra.update(
                    rope_scaling_factor=float(rs.get("factor") or 1.0),
                    rope_orig_max_position=int(
                        rs.get("original_max_position_embeddings") or 0),
                    rope_beta_fast=float(rs.get("beta_fast") or 32.0),
                    rope_beta_slow=float(rs.get("beta_slow") or 1.0),
                    rope_mscale=float(rs.get("mscale") or 0.0),
                    rope_mscale_all_dim=float(
                        rs.get("mscale_all_dim") or 0.0),
                    rope_attention_factor=float(
                        rs.get("attention_factor") or 0.0),
                )
            elif rtype is not None:
                raise NotImplementedError(
                    f"deepseek rope_scaling type {rtype!r} (only yarn is "
                    "implemented)")
            extra["rope_interleave"] = bool(
                hf.get("rope_interleave", True))
        mla = bool(extra.get("kv_lora_rank"))
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=heads,
            # MLA: the paged cache stores ONE shared latent per token —
            # [N, 2, 1, ps, kv_lora_rank], slot 0 = compressed kv latent,
            # slot 1 = the (padded) shared rope key — so the generic cache
            # machinery sizes from Hkv=1 x head_dim=kv_lora_rank
            num_kv_heads=1 if mla else hf.get("num_key_value_heads", heads),
            head_dim=(extra["kv_lora_rank"] if mla
                      else hf.get("head_dim") or hf["hidden_size"] // heads),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            # transformers omits fields equal to its per-arch defaults:
            # gemma ties embeddings by default and serializes nothing
            tie_word_embeddings=bool(hf.get("tie_word_embeddings",
                                            mt.startswith("gemma"))),
            qk_norm=mt in ("qwen3", "qwen3_moe"),
            attention_bias=bool(hf.get("attention_bias", mt == "qwen2")),
            model_type=mt,
            dtype=dtype,
            num_experts=num_experts,
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
            moe_intermediate_size=hf.get("moe_intermediate_size",
                                         hf.get("intermediate_size", 0)),
            norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
            sliding_window=int(hf.get("sliding_window") or 0)
            if mt.startswith("gemma") else 0,
            attn_logit_softcap=float(hf.get("attn_logit_softcapping") or 0.0),
            final_logit_softcap=float(
                hf.get("final_logit_softcapping") or 0.0),
            query_pre_attn_scalar=float(
                hf.get("query_pre_attn_scalar") or 0.0),
            **extra,
        )

    @classmethod
    def from_pretrained(cls, path: str, dtype: str = "bfloat16") -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf(json.load(f), dtype=dtype)

    @classmethod
    def llama32_3b(cls, **kw) -> "ModelConfig":
        """Llama-3.2-3B geometry — the single-GPU flagship config
        (head_dim=128, the width the CUDA attention kernels take)."""
        defaults = dict(
            vocab_size=128256, hidden_size=3072, intermediate_size=8192,
            num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
            rope_theta=500000.0, max_position_embeddings=8192,
            tie_word_embeddings=True, dtype="bfloat16")
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def deepseek_v2_lite(cls, **kw) -> "ModelConfig":
        """DeepSeek-V2-Lite, from its published ``config.json``
        (huggingface.co/deepseek-ai/DeepSeek-V2-Lite): 27 layers, hidden
        2048, 16 heads, vocab 102400; MLA with kv_lora_rank 512, rope 64,
        nope 128, v 128, no q_lora; layer 0 dense (FFN 10944), then 64
        routed experts of 1408 + 2 shared, top-6 greedy; yarn rope x40."""
        hf = dict(
            model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
            intermediate_size=10944, moe_intermediate_size=1408,
            num_hidden_layers=27, num_attention_heads=16,
            num_key_value_heads=16, n_shared_experts=2, n_routed_experts=64,
            routed_scaling_factor=1.0, kv_lora_rank=512, q_lora_rank=None,
            qk_rope_head_dim=64, v_head_dim=128, qk_nope_head_dim=128,
            topk_method="greedy", n_group=1, topk_group=1,
            num_experts_per_tok=6, first_k_dense_replace=1,
            norm_topk_prob=False, max_position_embeddings=163840,
            rms_norm_eps=1e-6, rope_theta=10000, tie_word_embeddings=False,
            rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32,
                          "beta_slow": 1, "mscale": 0.707,
                          "mscale_all_dim": 0.707,
                          "original_max_position_embeddings": 4096})
        return replace(cls.from_hf(hf), **kw)

    @classmethod
    def gemma2_27b(cls, **kw) -> "ModelConfig":
        """Gemma-2-27B, from its published ``config.json``
        (huggingface.co/google/gemma-2-27b): 46 layers, hidden 4608, FFN
        36864, 32 heads over 16 kv heads of head_dim 128, vocab 256000,
        query_pre_attn_scalar 144, sliding window 4096 on the even layers,
        softcaps 50 (attention) and 30 (final), tied embeddings."""
        hf = dict(
            model_type="gemma2", vocab_size=256000, hidden_size=4608,
            intermediate_size=36864, num_hidden_layers=46,
            num_attention_heads=32, num_key_value_heads=16, head_dim=128,
            query_pre_attn_scalar=144, sliding_window=4096,
            attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
            rms_norm_eps=1e-6, rope_theta=10000.0,
            max_position_embeddings=8192, tie_word_embeddings=True,
            hidden_activation="gelu_pytorch_tanh")
        return replace(cls.from_hf(hf), **kw)

    @classmethod
    def qwen3_30b_a3b(cls, **kw) -> "ModelConfig":
        """Qwen3-30B-A3B, from its published ``config.json``
        (huggingface.co/Qwen/Qwen3-30B-A3B): 48 layers, hidden 2048, 32
        heads over 4 kv heads of head_dim 128 with qwen3's qk-norm, every
        layer MoE (``decoder_sparse_step`` 1, no ``mlp_only_layers``): 128
        experts of 768, top-8 renormalized; vocab 151936, untied head, rope
        theta 1e6, 40960 positions."""
        hf = dict(
            model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
            intermediate_size=6144, moe_intermediate_size=768,
            num_hidden_layers=48, num_attention_heads=32,
            num_key_value_heads=4, head_dim=128, num_experts=128,
            num_experts_per_tok=8, norm_topk_prob=True,
            decoder_sparse_step=1, mlp_only_layers=[],
            rms_norm_eps=1e-6, rope_theta=1000000.0,
            max_position_embeddings=40960, tie_word_embeddings=False,
            attention_bias=False, hidden_act="silu")
        return replace(cls.from_hf(hf), **kw)

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """A toy config for tests (runs in ms on CPU)."""
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                        rope_theta=10000.0, max_position_embeddings=512,
                        dtype="float32")
        defaults.update(kw)
        return cls(**defaults)


__all__ = ["ModelConfig"]
