"""Pipeline parallelism: layer stages over the ``pp`` axis of a rank world.

The port of ``dynamo_tpu/parallel/pipeline.py``. The reference runs its
pipeline as ONE ``shard_map`` program over a device mesh; here every rank
is a process (``parallel/multihost.py``) and runs the same schedule on its
own shards, issuing the collectives itself:

- the layer-stacked parameters and the stacked paged KV cache split their
  LAYER axis over ``pp`` (``StageSharding``, ``pp_sharding_fns``): stage
  ``s`` holds layers ``[s*L/pp, (s+1)*L/pp)`` and exactly those layers'
  pages, so paged reads and writes stay on the stage;
- the batch is split into ``M`` microbatches that flow through the stages
  (at tick ``t`` stage ``s`` works microbatch ``t - s``; ``M + pp - 1``
  ticks). Stage 0 embeds its microbatch, every other stage takes the
  activation its predecessor handed on (``RankMesh.send_next``, the
  reference's ``ppermute``), which every rank issues on every tick;
- an inactive tick (fill or drain) computes nothing and writes no page:
  the ranks that share a collective (a stage's tp ranks, and the dp
  replicas at one stage and tick) are active together, so the collective
  order is the same on every rank. The reference computes such ticks on
  garbage with their writes masked to the garbage page;
- the last stage keeps each microbatch's last-token hidden state; these
  are broadcast over ``pp`` (a sum with zeros elsewhere, the reference's
  ``psum``) and every rank runs the family's tail (final norm, the
  replicated vocab projection, Gemma-2's final softcap), so every rank
  holds the same logits and samples the same tokens.

Inside a stage ``tp`` runs through the families' own row-parallel sums on
the stage's tp group (``_finish_layer(..., mesh)``: one after ``wo``, one
after ``w_down``), at the rank's local shapes (``local_config``). Over
``dp`` each replica pipelines its own rows (``mesh.DpRows``); before every
cache write the layer's new K/V, and once a tick the microbatch's table,
positions and counts, are gathered over ``dp``, so every replica writes
every row and the replicated page pool stays equal.

The attention is the caller's ``attn_impl`` (the engine's kernel wrappers,
whose plain versions serve CPU tensors), called with the LOCAL layer index
into the stage's cache slab; Gemma-2's sliding window follows the GLOBAL
layer index ``stage * L / pp + l``. Families, one stage adapter each
(``_STAGE_ADAPTERS``): the Llama tree, MoE (its dispatch drop counts are
discarded, as the reference's are) and Gemma-2. DeepSeek is refused: its
dense and MoE layers live in two stacks no uniform stage slab holds.

``pipeline_encode`` is the embeddings surface (the Llama tree's dense
``encode``) on the same stages, one microbatch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import paged_attention, write_kv_rows
from dynamo_tpu_torch.parallel.mesh import DpRows, RankMesh
from dynamo_tpu_torch.parallel.sharding import (TP_TAILS, TP_TAILS_MOE,
                                                StageSharding, ffn_width,
                                                local_config)

# ------------------------------------------------------------- stage bodies
# One adapter per supported family: the pieces of a layer that differ
# (embedding, qkv projection, per-layer attention kwargs, the
# post-attention tail with its tp sums, the final vocab projection). The
# schedule, the KV writes, the dp gathers and the handoff are shared.


class _LlamaStage:
    TP_TAILS = TP_TAILS

    def __init__(self, cfg: ModelConfig, cfg_local: ModelConfig,
                 mesh: Optional[RankMesh]):
        from dynamo_tpu_torch.models import llama
        self._m = llama
        self.cfg, self.cfg_local, self.mesh = cfg, cfg_local, mesh
        self.sm_scale = cfg.head_dim ** -0.5

    def embed(self, params, tok):
        return params["embed"][tok.long()]

    def qkv(self, lp, h, pos):
        return self._m._project_qkv(self.cfg_local, lp, h, pos)

    def attend_kwargs(self, global_lidx: int) -> dict:
        return {}

    def finish(self, lp, h, attn):
        return self._m._finish_layer(self.cfg_local, lp, h, attn, self.mesh)

    def tail(self, params, hidden):
        m = self._m
        hn = m._rms_norm(hidden, params["final_norm"], self.cfg.rms_norm_eps)
        return m.head_logits(params, hn)


class _MoeStage(_LlamaStage):
    """Mixtral / Qwen3-MoE: the Llama attention and routed experts, either
    backend. Under tp the expert FFN width is split and one sum after the
    routed combine completes it (``moe.combine``). The dispatch's capacity
    is the microbatch's and its drop count is discarded, as the
    reference's is."""

    TP_TAILS = TP_TAILS_MOE

    def finish(self, lp, h, attn):
        from dynamo_tpu_torch.models import moe
        h, _dropped = moe._moe_layer_tail(self.cfg_local, lp, h, attn,
                                          self.mesh)
        return h


class _GemmaStage:
    """Gemma-2: the (1 + w) norm sandwich around the attention and the
    GeGLU MLP, the sqrt(H)-scaled embedding, alternating sliding windows
    by the global layer index, and the attention and final softcaps."""

    TP_TAILS = TP_TAILS

    def __init__(self, cfg: ModelConfig, cfg_local: ModelConfig,
                 mesh: Optional[RankMesh]):
        from dynamo_tpu_torch.models import gemma
        self._g = gemma
        self.cfg, self.cfg_local, self.mesh = cfg, cfg_local, mesh
        self.sm_scale = gemma._sm_scale(cfg)

    def embed(self, params, tok):
        return self._g._embed(self.cfg, params, tok)

    def qkv(self, lp, h, pos):
        return self._g._project_qkv(self.cfg_local, lp, h, pos)

    def attend_kwargs(self, global_lidx: int) -> dict:
        # even GLOBAL layers slide, odd ones are global (layer_windows)
        cfg = self.cfg
        win = (cfg.sliding_window
               if cfg.sliding_window and global_lidx % 2 == 0 else 0)
        return {"window": win, "softcap": cfg.attn_logit_softcap or None}

    def finish(self, lp, h, attn):
        return self._g._finish_layer(self.cfg_local, lp, h, attn, self.mesh)

    def tail(self, params, hidden):
        g, cfg = self._g, self.cfg
        hn = g._rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
        logits = g.head_logits(params, hn)
        cap = cfg.final_logit_softcap
        if cap:
            logits = torch.tanh(logits / cap) * cap
        return logits


_STAGE_ADAPTERS = {
    "dynamo_tpu_torch.models.llama": _LlamaStage,
    "dynamo_tpu_torch.models.gemma": _GemmaStage,
    "dynamo_tpu_torch.models.moe": _MoeStage,
}


def stage_adapter_for(cfg: ModelConfig):
    """The stage adapter CLASS of this config's family, or None when the
    family cannot stage (DeepSeek MLA). The worker's flag check, the
    engine, the sharding and the forward all resolve through it."""
    from dynamo_tpu_torch.models import get_family
    return _STAGE_ADAPTERS.get(getattr(get_family(cfg), "__name__", ""))


def no_adapter_message(cfg: ModelConfig) -> str:
    return (f"pipeline_forward has no stage adapter for "
            f"{cfg.model_type!r} — running it through another family's "
            f"layers would serve silently wrong outputs; use tp/dp/sp "
            f"for this family (worker/main.py guards the flag)")


def _ring(mesh: RankMesh, M: int, shape, dtype, device,
          work: Callable[[int, torch.Tensor], torch.Tensor]) -> None:
    """The microbatch ring: at tick ``t`` this stage works microbatch
    ``t - stage`` (``work(m, received) -> activation``) when it is one of
    the ``M``; every rank hands an activation on, every tick (zeros on an
    inactive one: its successor is inactive at the next tick too)."""
    stage, n = mesh.coords["pp"], mesh.shape["pp"]
    h_in = torch.zeros(shape, dtype=dtype, device=device)
    for t in range(M + n - 1):
        m = t - stage
        if 0 <= m < M:
            send = work(m, h_in)
        else:
            send = torch.zeros(shape, dtype=dtype, device=device)
        h_in = mesh.send_next(send, "pp")


def pipeline_forward(params: Dict[str, Any], cfg: ModelConfig,
                     tokens: torch.Tensor, positions: torch.Tensor,
                     pages: torch.Tensor, page_table: torch.Tensor,
                     total_lens: torch.Tensor, new_lens: torch.Tensor,
                     mesh: RankMesh, n_microbatches: Optional[int] = None,
                     attn_impl: Optional[Callable] = None,
                     dp: Optional[DpRows] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The family's forward run as a pp pipeline on this rank: returns
    (float32 logits ``[B, V]`` at each row's last real token, pages).

    ``cfg`` is the WHOLE model's config; ``params`` and ``pages`` (``[L /
    pp, N, 2, Hkv / tp, ps, Dh]``, written in place) this rank's shards
    (``pp_sharding_fns``). ``tokens`` .. ``new_lens`` are the step's rows,
    or with ``dp`` (``mesh.DpRows``) this replica's rows of a batch split
    over ``dp``; without it a ``dp`` > 1 mesh runs the whole batch on
    every replica. ``n_microbatches`` must divide the rows; the default is
    the largest divisor of them that is <= pp (a small batch pipelines
    with bubbles rather than failing). Every rank of the world calls it
    with the same arrays (its own dp rows)."""
    n_stages = mesh.shape["pp"]
    adapter_factory = stage_adapter_for(cfg)
    if adapter_factory is None:
        raise ValueError(no_adapter_message(cfg))
    tp = mesh.shape["tp"]
    if cfg.num_layers % n_stages:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pp={n_stages}")
    if tp > 1 and (cfg.num_kv_heads % tp or ffn_width(cfg) % tp):
        raise ValueError(f"num_kv_heads={cfg.num_kv_heads}/"
                         f"ffn_width={ffn_width(cfg)} not divisible by "
                         f"tp={tp}")
    B_local = tokens.shape[0]
    M = n_microbatches or max(m for m in range(1, n_stages + 1)
                              if B_local % m == 0)
    if B_local % M:
        raise ValueError(f"per-replica batch {B_local} not divisible by "
                         f"n_microbatches={M}")
    Bm = B_local // M
    S = tokens.shape[1]
    H = cfg.hidden_size
    stage, last = mesh.coords["pp"], n_stages - 1
    layers_per_stage = cfg.num_layers // n_stages
    body = adapter_factory(cfg, local_config(cfg, mesh), mesh)
    attend = attn_impl or paged_attention
    layers = params["layers"]
    dtype, dev = params["embed"].dtype, tokens.device
    out = torch.zeros((M, Bm, H), dtype=dtype, device=dev)
    cols = page_table.shape[1]

    def work(m: int, h_in: torch.Tensor) -> torch.Tensor:
        rows = slice(m * Bm, (m + 1) * Bm)
        tok, pos, tbl, tot, new = (x[rows] for x in (
            tokens, positions, page_table, total_lens, new_lens))
        h = body.embed(params, tok) if stage == 0 else h_in
        mdp = None
        if dp is not None:
            # every replica at this (stage, tick) works microbatch m: its
            # rows' table, positions and counts, gathered once for the
            # tick's cache writes
            both = mesh.all_gather(torch.cat(
                [tbl.to(torch.int32), pos.to(torch.int32),
                 new.to(torch.int32)[:, None]], dim=1), "dp", dim=0)
            mdp = DpRows(mesh, Bm, both[:, :cols], both[:, cols:cols + S],
                         both[:, -1])
        for lidx in range(layers_per_stage):
            lp = {k: v[lidx] for k, v in layers.items()}
            q, k, v = body.qkv(lp, h, pos)
            write_kv_rows(pages, lidx, k, v, tbl, pos, new, mdp)
            attn = attend(q, pages, lidx, tbl, pos, tot, body.sm_scale,
                          **body.attend_kwargs(
                              stage * layers_per_stage + lidx))
            h = body.finish(lp, h, attn)
        if stage == last:
            # the vocab projection runs once after the ring, not per tick
            rix = torch.arange(Bm, device=dev)
            out[m] = h[rix, torch.clamp(new.long() - 1, min=0)]
        return h

    _ring(mesh, M, (Bm, S, H), dtype, dev, work)
    # only the last stage holds real hidden states: broadcast them over
    # pp, then every rank projects to the vocab
    mesh.all_reduce(out, "pp")
    return body.tail(params, out.reshape(B_local, H)), pages


def pipeline_encode(params: Dict[str, Any], cfg: ModelConfig,
                    tokens: torch.Tensor, mask: torch.Tensor,
                    mesh: RankMesh) -> torch.Tensor:
    """The embeddings surface on the stages (the Llama tree's ``encode``:
    the mean-pooled final hidden state, float32 ``[B, H]``): one
    microbatch through the ring, each stage its layers of the dense
    causal forward, the last stage's pooled rows broadcast over pp."""
    from dynamo_tpu_torch.models import llama
    B, S = tokens.shape
    H = cfg.hidden_size
    stage, last = mesh.coords["pp"], mesh.shape["pp"] - 1
    lcfg = local_config(cfg, mesh)
    dtype = params["embed"].dtype
    pooled = torch.zeros((B, H), dtype=torch.float32, device=tokens.device)

    def work(_m: int, h_in: torch.Tensor) -> torch.Tensor:
        h = params["embed"][tokens.long()] if stage == 0 else h_in
        h = llama._dense_layers(params, lcfg, h, mask, mesh)
        if stage == last:
            hn = llama._rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
            pooled.copy_(llama.mean_pool(hn, mask))
        return h

    _ring(mesh, 1, (B, S, H), dtype, tokens.device, work)
    return mesh.all_reduce(pooled, "pp")


def pp_sharding_fns(mesh: RankMesh, cfg: Optional[ModelConfig] = None,
                    device=None):
    """(shard_params_fn, shard_pages_fn) placing this rank's stage of the
    layer-stacked leaves and of the stacked page cache — what a rank's
    engine takes in ``TorchEngineConfig`` to serve with
    ``pipeline_forward``. Under ``tp`` > 1 each layer leaf also takes its
    family's tp tail (wq ``("pp", None, "tp")``, the pages ``("pp", None,
    None, "tp")``); every other leaf replicates. ``cfg`` is required
    then, for the divisibility checks."""
    tails = TP_TAILS
    if cfg is not None:
        adapter = stage_adapter_for(cfg)
        if adapter is not None:
            tails = adapter.TP_TAILS
    shard = StageSharding(cfg, mesh, tails, device=device)
    return shard.shard_params, shard.shard_pages


__all__ = ["pipeline_forward", "pipeline_encode", "pp_sharding_fns",
           "stage_adapter_for"]
