"""Tensor- and expert-parallel shardings of the parameter trees and the
paged KV cache, one rank's slice at a time.

The port of ``dynamo_tpu/parallel/sharding.py``. The reference annotates
its arrays with GSPMD shardings and lets XLA insert the collectives; here
every rank holds only its slice, and the model forwards issue the
collectives themselves (``models/llama.py``: one sum after ``wo`` and one
after ``w_down`` per layer, one gather of vocab-sharded logits). The specs
are the reference's, each a tuple with one entry per dimension (``None``:
replicated, an axis name: split over that axis), so ``param_specs`` equals
the reference's ``PartitionSpec`` tree entry for entry:

- ``wq/wk/wv`` ``[L, H, out]``  — ``out`` (heads) over ``tp``;
- ``wo``       ``[L, q, H]``    — ``q`` (heads) over ``tp``;
- ``w_gate/w_up`` ``[L, H, I]`` — ``I`` over ``tp``; ``w_down`` ``[L, I,
  H]`` — ``I`` over ``tp``;
- MoE expert stacks ``[L, E, ...]``: ``E`` over ``ep``, the expert FFN
  width over ``tp``;
- ``embed`` replicated; an untied ``lm_head`` ``[H, V]`` splits ``V`` over
  ``tp`` when ``tp`` divides the vocabulary, else replicates;
- the cache ``[L, N, 2, Hkv, page, Dh]``: ``Hkv`` over ``tp`` (MLA's latent
  cache is shared by every head: replicated);
- over ``dp`` every weight and the cache replicate: a replica runs its
  rows of the batch, and the page pool stays equal on all replicas.

Under pipeline parallelism (``StageSharding``, the reference's
``parallel/pipeline.py`` specs) every layer-stacked leaf splits its layer
axis over ``pp`` as well, every other leaf (``lm_head`` included)
replicates, and the cache splits its layers over ``pp`` and its kv heads
over ``tp``; ``local_config`` then gives a stage's ``L / pp`` layers.

``shard_layout`` and ``transport_sharding`` describe a placement by its
mesh and spec (``Sharding``), the form the sharded KV wire reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.parallel.mesh import MeshSpec, RankMesh, make_mesh

Spec = Tuple[Optional[str], ...]


def P(*entries) -> Spec:
    """A partition spec: one entry per leading dimension (the reference's
    ``PartitionSpec``, as a plain tuple)."""
    return tuple(entries)


@dataclass(frozen=True)
class Sharding:
    """A placement: a mesh and the spec an array is split by on it."""

    mesh: RankMesh
    spec: Spec


class ModelSharding:
    """Sharding specs bound to a mesh for one model configuration."""

    def __init__(self, cfg: ModelConfig, mesh: RankMesh, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = device
        tp = mesh.shape.get("tp", 1)
        ep = mesh.shape.get("ep", 1)
        if tp > 1:
            if cfg.kv_lora_rank:
                # MLA: tp splits the QUERY heads (the latent cache is
                # shared/replicated), so num_heads is the constraint
                if cfg.num_heads % tp:
                    raise ValueError(
                        f"num_heads={cfg.num_heads} not divisible by "
                        f"tp={tp}")
            elif cfg.num_kv_heads % tp:
                raise ValueError(
                    f"num_kv_heads={cfg.num_kv_heads} not divisible by tp={tp}")
            if cfg.intermediate_size % tp:
                raise ValueError(
                    f"intermediate_size={cfg.intermediate_size} not divisible "
                    f"by tp={tp}")
            if cfg.num_experts:
                # both MoE spec families shard the expert FFN width over tp
                moe_i = cfg.moe_intermediate_size or cfg.intermediate_size
                if moe_i % tp:
                    raise ValueError(
                        f"moe_intermediate_size={moe_i} not divisible "
                        f"by tp={tp}")
        if ep > 1 and cfg.num_experts % ep:
            raise ValueError(
                f"num_experts={cfg.num_experts} not divisible by ep={ep}")

    # -- specs -------------------------------------------------------------

    def param_specs(self) -> Dict[str, Any]:
        if self.cfg.kv_lora_rank:
            return self._deepseek_specs()
        layers = {
            "attn_norm": P(),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "mlp_norm": P(),
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        }
        if self.cfg.num_experts:
            # experts over ep, expert-FFN width over tp: each rank runs its
            # local experts over every token, then one combine sum
            layers.update(
                w_router=P(),
                w_gate=P(None, "ep", None, "tp"),
                w_up=P(None, "ep", None, "tp"),
                w_down=P(None, "ep", "tp", None),
            )
        if self.cfg.attention_bias:
            layers.update(bq=P(None, "tp"), bk=P(None, "tp"), bv=P(None, "tp"))
        if self.cfg.qk_norm:
            layers.update(q_norm=P(), k_norm=P())
        if self.cfg.model_type.startswith("gemma"):
            # the sandwich norms act on full hidden rows: replicated (the
            # reference's spec tree has no entry for them; its
            # shard_params cannot place a gemma tree)
            layers.update(post_attn_norm=P(), pre_ffw_norm=P(),
                          post_ffw_norm=P())
        specs: Dict[str, Any] = {
            "embed": P(),
            "layers": layers,
            "final_norm": P(),
        }
        if not self.cfg.tie_word_embeddings:
            # logits shard cleanly for real vocabs (128256, 32000, ...);
            # replicate as a fallback for odd-sized vocabs (toy models)
            tp = self.mesh.shape.get("tp", 1)
            specs["lm_head"] = (P(None, "tp")
                                if self.cfg.vocab_size % tp == 0 else P())
        return self._add_quant_specs(specs)

    def _add_quant_specs(self, specs: Dict[str, Any]) -> Dict[str, Any]:
        """Specs for int8 trees (``ops/quant.quantize_params``): the int8
        tensor splits as the original does, its per-out-channel scale keeps
        the layer and out dims (axis 1 of a stacked ``[L, K, N]`` and axis 0
        of ``lm_head`` are the contraction). Under a split contraction
        (``wo``/``w_down``) each rank's partial product is rescaled, then
        summed: the scales distribute over the sum."""
        from dynamo_tpu_torch.ops.quant import LAYER_WEIGHTS
        layers = specs["layers"]
        for name in LAYER_WEIGHTS:
            spec = layers.get(name)
            if spec is None or len(spec) != 3:
                continue  # MoE 4-d expert stacks don't quantize
            layers[name + "_q"] = spec
            layers[name + "_scale"] = P(spec[0], spec[2])
        lm = specs.get("lm_head")
        if lm is not None:
            specs["lm_head_q"] = lm
            specs["lm_head_scale"] = P(lm[1]) if len(lm) == 2 else P()
        return specs

    def _deepseek_specs(self) -> Dict[str, Any]:
        """MLA (deepseek) tree: the head-carrying projections split their
        head-packed dim over tp (wq/wq_b/wkv_b outputs, wo input), so the
        latent attention runs head-local with one sum after wo; the latent
        path (wkv_a/kv_a_norm) and the shared-per-token cache replicate.
        Routed experts split over ep, shared experts' width over tp."""
        attn = {
            "attn_norm": P(),
            "wkv_a": P(),
            "kv_a_norm": P(),
            "wkv_b": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "mlp_norm": P(),
            "wq": P(None, None, "tp"),
            "wq_a": P(),
            "q_a_norm": P(),
            "wq_b": P(None, None, "tp"),
        }
        dense = dict(attn)
        dense.update(w_gate=P(None, None, "tp"), w_up=P(None, None, "tp"),
                     w_down=P(None, "tp", None))
        moe = dict(attn)
        moe.update(
            w_router=P(),
            router_bias=P(),
            w_gate=P(None, "ep", None, "tp"),
            w_up=P(None, "ep", None, "tp"),
            w_down=P(None, "ep", "tp", None),
            ws_gate=P(None, None, "tp"),
            ws_up=P(None, None, "tp"),
            ws_down=P(None, "tp", None),
        )
        specs: Dict[str, Any] = {
            "embed": P(),
            "final_norm": P(),
            "dense_layers": dense,
            "moe_layers": moe,
        }
        if not self.cfg.tie_word_embeddings:
            tp = self.mesh.shape.get("tp", 1)
            specs["lm_head"] = (P(None, "tp")
                                if self.cfg.vocab_size % tp == 0 else P())
        return specs

    def pages_spec(self) -> Spec:
        """Stacked cache [L, N, 2, Hkv, page, Dh]: Hkv over tp (MLA: the
        latent is shared across heads — replicated); replicated over dp,
        as the reference's (every replica writes every row's KV)."""
        return cache_spec(self.cfg)

    def pages_layer_spec(self) -> Spec:
        """Per-layer cache [N, 2, Hkv, page, Dh]: Hkv over tp."""
        if self.cfg.kv_lora_rank:
            return P()
        return P(None, None, "tp", None, None)

    # -- application -------------------------------------------------------

    def local_slice(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's block of ``x`` under ``spec`` (a view)."""
        return local_slice(self.mesh, x, spec)

    def _place(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        return place(self.mesh, x, spec, self.device)

    def shard_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        specs = self.param_specs()

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            return self._place(node, spec)

        return walk(params, specs)

    def shard_pages(self, pages):
        if isinstance(pages, list):
            spec = self.pages_layer_spec()
            return [self._place(p, spec) for p in pages]
        return self._place(pages, self.pages_spec())

    def pages_sharding(self, per_layer: bool = False) -> Sharding:
        return Sharding(self.mesh, self.pages_layer_spec() if per_layer
                        else self.pages_spec())


def local_slice(mesh: RankMesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The block of ``x`` that ``mesh``'s rank holds under ``spec`` (a
    view)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for nm in names:
            size = mesh.shape.get(nm, 1)
            idx = idx * size + mesh.coords.get(nm, 0)
            n *= size
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split {n} ways ({spec})")
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def place(mesh: RankMesh, x: torch.Tensor, spec: Spec,
          device=None) -> torch.Tensor:
    """``local_slice`` with storage of its own (a view would keep the
    whole tree alive), in the leaf's layout (quant's column-major int8
    layer stacks stay column-major), on ``device``."""
    s = local_slice(mesh, x, spec)
    if s is x:
        return x if device is None else x.to(device)
    if s.dim() == 3 and s.shape[1] > 1 and s.stride(1) == 1:
        s = s.transpose(1, 2).clone(
            memory_format=torch.contiguous_format).transpose(1, 2)
    else:
        s = s.clone(memory_format=torch.contiguous_format)
    return s if device is None else s.to(device)


def cache_spec(cfg: ModelConfig, mesh: Optional[RankMesh] = None) -> Spec:
    """The spec of the stacked cache ``[L, N, 2, Hkv, page, Dh]`` and of
    its transport array ``[L, n, ...]``: Hkv over tp, replicated
    elsewhere; MLA's latent cache replicated. On a mesh with ``pp`` > 1
    the layer axis is split over the stages too (``pp_pages_spec``)."""
    if mesh is not None and mesh.shape.get("pp", 1) > 1:
        return pp_pages_spec(mesh.shape.get("tp", 1))
    if cfg.kv_lora_rank:
        return P()
    return P(None, None, None, "tp", None, None)


def local_config(cfg: ModelConfig, mesh: Optional[RankMesh]) -> ModelConfig:
    """The config one rank's forward runs with: its local query and kv
    heads and FFN widths (experts keep their global count: every rank
    routes over all of them), and on a mesh with ``pp`` > 1 its stage's
    ``L / pp`` layers. The geometry checks of the attention kernels apply
    to these local shapes."""
    import dataclasses
    tp = 1 if mesh is None else mesh.shape.get("tp", 1)
    pp = 1 if mesh is None else mesh.shape.get("pp", 1)
    kw = {}
    if pp > 1:
        kw["num_layers"] = cfg.num_layers // pp
    if tp > 1:
        kw.update(num_heads=cfg.num_heads // tp,
                  intermediate_size=cfg.intermediate_size // tp)
        if not cfg.kv_lora_rank:
            kw["num_kv_heads"] = cfg.num_kv_heads // tp
        if cfg.num_experts and cfg.moe_intermediate_size:
            kw["moe_intermediate_size"] = cfg.moe_intermediate_size // tp
    return dataclasses.replace(cfg, **kw) if kw else cfg


# -- layer staging (pipeline parallelism) -------------------------------------
# The reference's ``parallel/pipeline.py`` specs: a layer-stacked leaf splits
# its layer axis over ``pp`` and, under ``tp``, the dims after it by the
# family's tail (the plain tp path's placement: qkv / FFN-up split their
# output dim, the out / down projections their input dim); every other leaf
# is replicated, ``lm_head`` included (the vocab projection runs whole after
# the pipeline); the pages split their layers over ``pp`` and their kv heads
# over ``tp``.

TP_TAILS: Dict[str, Tuple] = {
    "attn_norm": (), "mlp_norm": (), "q_norm": (), "k_norm": (),
    "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
    "wo": ("tp", None),
    "w_gate": (None, "tp"), "w_up": (None, "tp"), "w_down": ("tp", None),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
}

# MoE expert leaves carry a leading E dim: [L, E, H, I] / [L, E, I, H]
TP_TAILS_MOE: Dict[str, Tuple] = {
    **TP_TAILS,
    "w_router": (),
    "w_gate": (None, None, "tp"), "w_up": (None, None, "tp"),
    "w_down": (None, "tp", None),
}


def pp_layer_spec(name: str, tp: int,
                  tails: Dict[str, Tuple] = TP_TAILS) -> Spec:
    """A layer-stacked leaf's spec: its layers over ``pp``, then the
    family's tp tail when ``tp`` > 1 (a leaf without a tail: the rest
    replicated)."""
    if tp == 1:
        return P("pp")
    return P("pp", *tails.get(name, ()))


def pp_param_specs(params: Dict[str, Any], tp: int,
                   tails: Dict[str, Tuple] = TP_TAILS) -> Dict[str, Any]:
    """The reference's ``_param_specs``: the layer leaves staged, every
    other leaf replicated."""
    specs: Dict[str, Any] = {k: P() for k in params if k != "layers"}
    specs["layers"] = {k: pp_layer_spec(k, tp, tails)
                       for k in params["layers"]}
    return specs


def pp_pages_spec(tp: int) -> Spec:
    """The stacked cache's spec under ``pp``: layers over the stages, kv
    heads over ``tp``."""
    return P("pp") if tp == 1 else P("pp", None, None, "tp")


def ffn_width(cfg: ModelConfig) -> int:
    """The per-layer FFN width the tp axis splits (the expert width on
    MoE)."""
    if cfg.num_experts:
        return cfg.moe_intermediate_size or cfg.intermediate_size
    return cfg.intermediate_size


class StageSharding:
    """The placement of ``pp_param_specs`` / ``pp_pages_spec`` on one
    rank: its stage's layers (and under ``tp`` its heads and FFN columns)
    of a whole tree and cache, with the reference's divisibility checks
    and messages."""

    def __init__(self, cfg: Optional[ModelConfig], mesh: RankMesh,
                 tails: Dict[str, Tuple] = TP_TAILS, device=None):
        tp = mesh.shape.get("tp", 1)
        if tp > 1:
            if cfg is None:
                raise ValueError("pp x tp sharding needs the model config")
            if cfg.num_kv_heads % tp or ffn_width(cfg) % tp:
                raise ValueError(
                    f"num_kv_heads={cfg.num_kv_heads}/ffn_width="
                    f"{ffn_width(cfg)} not divisible by tp={tp}")
        pp = mesh.shape.get("pp", 1)
        if cfg is not None and cfg.num_layers % pp:
            raise ValueError(f"num_layers={cfg.num_layers} not divisible "
                             f"by pp={pp}")
        self.cfg, self.mesh, self.tp, self.tails = cfg, mesh, tp, tails
        self.device = device

    def param_specs(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return pp_param_specs(params, self.tp, self.tails)

    def pages_spec(self) -> Spec:
        return pp_pages_spec(self.tp)

    def shard_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        specs = self.param_specs(params)
        out = {k: place(self.mesh, v, specs[k], self.device)
               for k, v in params.items() if k != "layers"}
        out["layers"] = {k: place(self.mesh, v, specs["layers"][k],
                                  self.device)
                         for k, v in params["layers"].items()}
        return out

    def shard_pages(self, pages: torch.Tensor) -> torch.Tensor:
        return place(self.mesh, pages, self.pages_spec(), self.device)


def tp_sharding(cfg: ModelConfig, tp_size: int, rank: Optional[int] = None,
                device=None) -> ModelSharding:
    """Pure tensor-parallel sharding: over the running world when ``rank``
    is None, else for that rank's coordinates alone (no process group)."""
    spec = MeshSpec(tp=tp_size)
    mesh = make_mesh(spec) if rank is None else RankMesh(spec, rank)
    return ModelSharding(cfg, mesh, device=device)


# -- transport-array sharding helpers ---------------------------------------
# The KV transfer paths move blocks as a STACKED rank-6 array
# [L, n, 2, Hkv, ps, Dh] whether the cache itself is stacked or a per-layer
# list; these helpers map the cache placement to the transport placement.


def transport_sharding(sharding: Optional[Sharding],
                       per_layer: bool = False) -> Optional[Sharding]:
    """Sharding of the stacked ``[L, n, ...]`` transport array matching the
    cache's placement: for a per-layer cache (rank-5 spec) the layer axis
    is prepended; no placement (one device) passes through."""
    if per_layer and sharding is not None:
        return Sharding(sharding.mesh, P(None, *sharding.spec))
    return sharding


def shard_layout(sharding: Optional[Sharding]) -> tuple:
    """``(shard_count, axis)`` a placement splits its array over: ``(1,
    -1)`` for unsplit or single-device placements, ``(0, -1)`` when more
    than one axis is split (the per-shard KV wire carries exactly one split
    axis — multi-axis caches fall back to merged frames)."""
    if sharding is None:
        return (1, -1)
    mesh_shape = dict(sharding.mesh.shape)
    parted = []
    for i, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for nm in names:
            n *= int(mesh_shape.get(nm, 1))
        if n > 1:
            parted.append((n, i))
    if not parted:
        return (1, -1)
    if len(parted) > 1:
        return (0, -1)
    return parted[0]


__all__ = ["ModelSharding", "StageSharding", "Sharding", "tp_sharding",
           "transport_sharding", "cache_spec", "shard_layout",
           "local_config", "local_slice", "place", "pp_param_specs",
           "pp_pages_spec", "pp_layer_spec", "ffn_width", "TP_TAILS",
           "TP_TAILS_MOE", "P"]
