"""Mixture-of-Experts decoder (mixtral, qwen3-MoE) in PyTorch.

The port of ``dynamo_tpu/models/moe.py``'s serving forward: the Llama
tree's attention (``models/llama.py``: qkv, qwen3's qk-norm, rope, the
paged cache ``[L, N, 2, Hkv, ps, Dh]`` written in place) with the dense MLP
swapped for routed experts, the reference's names and parameter tree:
``w_router [L, H, E]``, ``w_gate`` / ``w_up [L, E, H, I]``, ``w_down [L, E,
I, H]``.

- the router: a float32 softmax over the expert logits, top-k in
  ``jax.lax.top_k``'s order, renormalized when ``norm_topk_prob``;
- two expert backends, chosen by ``cfg.moe_backend``: ``"dense"``
  computes every expert on every token, weighted by the router (zero off
  the top-k); ``"dispatch"`` (``expert_dispatch``) gathers each expert's
  routed tokens into a buffer of fixed capacity first and drops the
  assignments past it, counted.

``forward`` returns the reference's third value, ``{"moe_dropped_assignments":
int32 scalar}`` summed over layers (0 on the dense backend), which the
engine adds up for its stats without a host sync. The expert products stay
``torch.bmm``: the reference computes them as XLA einsums outside any
Pallas kernel. Every shape depends on the step's padded token count only,
so a fused decode block captures as a CUDA graph. ``forward_unrolled``
has no counterpart (one forward over the stacked cache serves).

Under a mesh (``mesh``, the reference's ``ep_mesh``) each rank holds the
experts of its ``ep`` coordinate, each expert's FFN width split over
``tp``: every rank routes EVERY token over all experts (the router is
replicated), runs its local experts on the tokens routed there with either
backend, and one sum over ``tp`` and ``ep`` combines the float32 partials.
The dispatch's capacity and drop rule are the global ones, so every rank
counts the same global drops (the reference's count) with no collective.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import (_logits, _project_qkv, _rms_norm,
                                           make_pages, params_from_jax,
                                           torch_dtype)
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.ops.attention import paged_attention, write_kv_rows
from dynamo_tpu_torch.ops.sampling import top_k_stable

Params = Dict[str, object]

# decode-size batches get their dispatch capacity padded to 4x the expected
# per-expert load, so drops there are vanishingly rare (the reference's)
_SMALL_BATCH_T = 64

# the dense backend's [E, tokens, H] expert outputs are computed this many
# bytes at a time (tokens in chunks): at 128 experts a 512-token chunk is
# 256 MiB of bf16, where the whole of a 8192-token mixed step would be 4 GiB
_DENSE_CHUNK_BYTES = 1 << 28


def _router_topk(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router: a float32 softmax over ``x @ w_router`` (model-dtype
    operands), top-k (ties: lower index first), optional renorm.
    x: [..., H] -> (weights [..., k] float32, expert ids [..., k] int64)."""
    probs = torch.softmax((x @ lp["w_router"]).float(), dim=-1)
    k = cfg.num_experts_per_tok
    top_w, top_i = top_k_stable(probs.reshape(-1, probs.shape[-1]), k)
    top_w = top_w.reshape(probs.shape[:-1] + (k,))
    top_i = top_i.reshape(probs.shape[:-1] + (k,))
    if cfg.norm_topk_prob:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, top_i


def expert_range(cfg: ModelConfig, mesh) -> Tuple[int, int]:
    """(first expert, expert count) of this rank's ``ep`` coordinate."""
    ep = 1 if mesh is None else mesh.axis_size("ep")
    n = cfg.num_experts // ep
    return (0 if mesh is None else mesh.coords["ep"] * n), n


def split_experts(mesh) -> bool:
    """Do this rank's experts or expert columns hold a partial of the MLP
    (``tp`` or ``ep`` > 1)? Replicas over ``dp`` alone hold the whole."""
    return mesh is not None and mesh.axis_size("tp", "ep") > 1


def combine(mesh, part: torch.Tensor, dtype) -> torch.Tensor:
    """The MoE combine: this rank's float32 partial summed over ``tp`` and
    ``ep``, in ``dtype``."""
    return mesh.all_reduce(part.float(), "tp", "ep").to(dtype)


def dense_experts(xt: torch.Tensor, top_w: torch.Tensor,
                  top_i: torch.Tensor, w_gate, w_up, w_down,
                  expert_lo: int = 0, num_experts: int = 0,
                  f32_out: bool = False) -> torch.Tensor:
    """Every expert on every token, weighted by the router: ``xt [T, H]``,
    ``top_w`` / ``top_i [T, k]`` (a float32 weight per expert, zero off the
    top-k), expert weights ``[E, H, I]`` / ``[E, I, H]``. The tokens
    broadcast over the expert stack in one batched product per projection
    (the weights are read as they lie), ``_DENSE_CHUNK_BYTES`` of expert
    outputs at a time; the weighted sum over experts is a batched product
    in the model dtype, as the reference's ``bse,bseh->bsh`` einsum.
    Returns ``[T, H]`` in x's dtype.

    Under ep the stacks hold ``E`` local experts, the ``num_experts``
    global ones' from ``expert_lo``; ``f32_out`` returns the float32
    partial (sum before rounding) for the combine."""
    T, H = xt.shape
    E = w_gate.shape[0]
    weights = (F.one_hot(top_i, num_experts or E).float()
               * top_w[..., None]).sum(dim=-2)             # [T, E]
    weights = weights[:, expert_lo:expert_lo + E]
    step = max(1, _DENSE_CHUNK_BYTES // (E * max(H, w_gate.shape[-1])
                                         * xt.element_size()))
    outs = []
    for t0 in range(0, T, step):
        x = xt[t0:t0 + step]
        n = x.shape[0]
        xe = x.unsqueeze(0).expand(E, n, H)
        act = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
        per_expert = torch.bmm(act, w_down)                # [E, n, H]
        w = weights[t0:t0 + n].reshape(n, 1, E)
        if f32_out:
            out = torch.bmm(w, per_expert.transpose(0, 1).float())
        else:
            out = torch.bmm(w.to(xt.dtype), per_expert.transpose(0, 1))
        outs.append(out.reshape(n, H))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def moe_mlp(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
            x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The dense backend. x: [B, S, H] (already normed) -> [B, S, H]."""
    B, S, H = x.shape
    top_w, top_i = _router_topk(cfg, lp, x.reshape(B * S, H))  # [T, k]
    if not split_experts(mesh):
        return dense_experts(x.reshape(B * S, H), top_w, top_i,
                             lp["w_gate"], lp["w_up"],
                             lp["w_down"]).reshape(B, S, H)
    lo, _n = expert_range(cfg, mesh)
    part = dense_experts(x.reshape(B * S, H), top_w, top_i, lp["w_gate"],
                         lp["w_up"], lp["w_down"], expert_lo=lo,
                         num_experts=cfg.num_experts, f32_out=True)
    return combine(mesh, part, x.dtype).reshape(B, S, H)


def capacity(T: int, k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert of a step of ``T`` tokens (the reference's ``C``):
    ``ceil(T * k * cf / E)`` within [1, T], raised to 4x the expected load
    when ``T <= _SMALL_BATCH_T``. A function of the padded shape only."""
    C = max(1, min(T, math.ceil(T * k * capacity_factor / num_experts)))
    if T <= _SMALL_BATCH_T:
        C = min(T, max(C, math.ceil(4 * T * k / num_experts)))
    return C


def moe_mlp_dispatch(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                     x: torch.Tensor, mesh=None, dp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity dispatch backend: each expert computes only a buffer of
    its routed tokens (``expert_dispatch``). Returns ``(out [B, S, H],
    dropped assignments int32 scalar)``."""
    B, S, H = x.shape
    xt = x.reshape(B * S, H)
    top_w, top_i = _router_topk(cfg, lp, xt)              # [T, k]
    lo, _n = expert_range(cfg, mesh)
    out, dropped = expert_dispatch(
        xt, top_w, top_i, lp["w_gate"], lp["w_up"], lp["w_down"],
        cfg.num_experts, cfg.moe_capacity_factor, expert_lo=lo, dp=dp)
    if split_experts(mesh):
        return combine(mesh, out, x.dtype).reshape(B, S, H), dropped
    return out.reshape(B, S, H).to(x.dtype), dropped


def expert_dispatch(xt: torch.Tensor, top_w: torch.Tensor,
                    top_i: torch.Tensor, w_gate, w_up, w_down,
                    num_experts: int, capacity_factor: float,
                    expert_lo: int = 0, dp=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch (routing-agnostic: DeepSeek reuses it
    with its own gate). The ``T * k`` assignments group by expert through a
    stable sort; an assignment's rank inside its expert's group is its slot,
    and ranks of ``C`` (``capacity``) or more drop: within an expert,
    earlier tokens win. Per-expert counts are a scatter-add (no
    ``bincount``, which syncs with the host on CUDA); dropped assignments
    write to one trash row past the ``[E * C, H]`` buffer and read zeros
    back, so every shape is static. The combine puts each assignment's
    weighted output back in its ``[T, k]`` slot and sums over k, a fixed
    order on either device (the reference's float32 scatter-add over
    tokens, which on CUDA would be atomics in a varying order).

    xt [T, H]; top_w / top_i [T, k]; expert weights [E, H, I] / [E, I, H].
    Returns ``(out [T, H] float32, dropped assignments int32 scalar)``.

    Under ep the weights are the ``E_local`` experts from ``expert_lo``:
    capacity, slots and drops are the global ones (all ``num_experts``),
    assignments to another rank's experts go to the trash row, and ``out``
    is this rank's partial.

    Over a batch split by ``dp`` (``parallel/mesh.DpRows``) the tokens are
    this replica's rows: capacity is the whole batch's, and the
    assignments of the replicas before this one (earlier rows) take their
    slots first, so every slot, keep and drop is the one the whole batch
    gives. ``dropped`` counts this replica's."""
    T, H = xt.shape
    E = num_experts
    E_loc = w_gate.shape[0]
    k = top_i.shape[1]
    C = capacity(T if dp is None else T * dp.mesh.shape["dp"], k, E,
                 capacity_factor)
    A = T * k
    dev = xt.device
    flat_e = top_i.reshape(A).long()
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones(A, dtype=torch.long, device=dev))
    starts = torch.cumsum(counts, 0) - counts              # [E]
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(A, device=dev) - starts[flat_e[order]]
    if dp is not None:
        every = dp.gather(counts[None])                   # [dp, E]
        rank = rank + every[:dp.mesh.coords["dp"]].sum(0)[flat_e]
    keep = rank < C
    dropped = (~keep).sum().to(torch.int32)
    if E_loc != E:
        local = (flat_e >= expert_lo) & (flat_e < expert_lo + E_loc)
        keep = keep & local
    dest = torch.where(keep, (flat_e - expert_lo) * C + rank,
                       E_loc * C)                         # token-major
    xe = torch.zeros((E_loc * C + 1, H), dtype=xt.dtype, device=dev)
    xe.index_copy_(0, dest, xt.repeat_interleave(k, dim=0))
    xe = xe[:E_loc * C].view(E_loc, C, H)
    act = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(act, w_down)                           # [E_loc, C, H]
    ye_flat = torch.cat([ye.reshape(E_loc * C, H).float(),
                         torch.zeros((1, H), dtype=torch.float32,
                                     device=dev)])        # trash row = 0
    contrib = ye_flat[dest] * top_w.reshape(A, 1).float()  # [A, H]
    return contrib.view(T, k, H).sum(dim=1), dropped


def _moe_layer_tail(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                    h: torch.Tensor, attn: torch.Tensor, mesh=None, dp=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Out-projection residual, then the routed MLP residual. Returns (h,
    dropped assignments), dropped None on the dense backend (it computes
    every expert: nothing drops)."""
    B, S, _ = h.shape
    h = h + quant.row_mm(lp, "wo", attn.reshape(B, S, cfg.q_size), mesh)
    x = _rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    if cfg.moe_backend == "dispatch":
        mlp, dropped = moe_mlp_dispatch(cfg, lp, x, mesh, dp)
        return h + mlp, dropped
    return h + moe_mlp(cfg, lp, x, mesh), None


def sum_drops(drops, device, dp=None) -> torch.Tensor:
    """The forward's drop count: the per-layer int32 scalars summed on the
    device (a zero when no layer could drop); over a batch split by ``dp``
    summed over the replicas too, so every rank holds the batch's."""
    if not drops:
        return torch.zeros((), dtype=torch.int32, device=device)
    total = torch.stack(drops).sum().to(torch.int32)
    return total if dp is None else dp.sum(total)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                scale: float = 0.02, device=None) -> Params:
    """Random-normal init (tests / benchmarks) on ``device`` from the seeded
    ``generator`` (which must live there): the Llama tree's attention and
    embeddings with the expert stack in place of the dense MLP. Each stack
    is allocated once in the model dtype and filled one layer at a time,
    so the float32 draw is one layer's leaf at most (a whole-stack draw of
    Qwen3-30B-A3B's ``w_gate`` would be 39 GB). Norms are ones."""
    dtype = torch_dtype(cfg.dtype)
    L, H, E = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    I = cfg.moe_intermediate_size or cfg.intermediate_size

    def randn(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    def stacked(shape):
        leaf = torch.empty((L,) + shape, dtype=dtype, device=device)
        for i in range(L):
            leaf[i] = randn(shape)
        return leaf

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones((L, H)),
        "wq": stacked((H, cfg.q_size)),
        "wk": stacked((H, cfg.kv_size)),
        "wv": stacked((H, cfg.kv_size)),
        "wo": stacked((cfg.q_size, H)),
        "mlp_norm": ones((L, H)),
        "w_router": stacked((H, E)),
        "w_gate": stacked((E, H, I)),
        "w_up": stacked((E, H, I)),
        "w_down": stacked((E, I, H)),
    }
    if cfg.attention_bias:
        for name, n in (("bq", cfg.q_size), ("bk", cfg.kv_size),
                        ("bv", cfg.kv_size)):
            layers[name] = torch.zeros((L, n), dtype=dtype, device=device)
    if cfg.qk_norm:
        layers["q_norm"] = ones((L, cfg.head_dim))
        layers["k_norm"] = ones((L, cfg.head_dim))
    params: Params = {"embed": randn((cfg.vocab_size, H)), "layers": layers,
                      "final_norm": ones((H,))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = randn((H, cfg.vocab_size))
    return params


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, pages: torch.Tensor,
            page_table: torch.Tensor, total_lens: torch.Tensor,
            new_lens: torch.Tensor, attn_impl: Optional[Callable] = None,
            logits_window: int = 1, mesh=None, dp=None
            ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Forward over the stacked paged cache: ``models/llama.py``'s
    signature and returns (``mesh`` and ``dp`` included) plus a third,
    ``{"moe_dropped_assignments": int32 scalar}`` summed over layers (the
    engine's drop count)."""
    sm_scale = cfg.head_dim ** -0.5
    attn_impl = attn_impl or paged_attention
    h = params["embed"][tokens.long()]
    layers = params["layers"]
    drops = []
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in layers.items()}
        q, k, v = _project_qkv(cfg, lp, h, positions)
        write_kv_rows(pages, l, k, v, page_table, positions, new_lens, dp)
        attn = attn_impl(q, pages, l, page_table, positions, total_lens,
                         sm_scale)
        h, dropped = _moe_layer_tail(cfg, lp, h, attn, mesh, dp)
        if dropped is not None:
            drops.append(dropped)
    aux = {"moe_dropped_assignments": sum_drops(drops, h.device, dp)}
    return (_logits(cfg, params, h, new_lens, window=logits_window,
                    mesh=mesh), pages, aux)


__all__ = ["init_params", "params_from_jax", "forward", "make_pages",
           "moe_mlp", "moe_mlp_dispatch", "expert_dispatch", "dense_experts",
           "capacity", "torch_dtype"]
