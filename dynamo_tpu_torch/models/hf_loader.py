"""Load HF safetensors checkpoints into the port's stacked parameter tree.

The port of ``dynamo_tpu/models/hf_loader.py`` ``load_hf_params`` for the
Llama tree (llama 2/3, mistral, qwen2, qwen3), its MoE variants (mixtral,
qwen3-MoE) and Gemma-2: the same name map (Gemma-2's sandwich norms, the
mixtral and qwen3-MoE expert names included), torch ``Linear``'s ``[out,
in]`` transposed to ``[in, out]``, every layer stacked on a leading axis
(``models/llama.py``'s ``[L, in, out]`` tree) and every expert on a second
(``models/moe.py``'s ``[L, E, in, out]``), tied and untied heads, sharded
checkpoints (``model.safetensors.index.json``) read one file at a time. Each tensor goes to the device as it is read and
is transposed and cast to the config's dtype there, into its preallocated
stack, so the host never holds the assembled model.

The files are read without the ``safetensors`` package
(``SafetensorsFile``): 8 bytes of little-endian header length, a JSON
header (name -> dtype, shape, byte range), then the raw little-endian
tensors, BF16, F16 or F32. DeepSeek's latent tree is read by
``models/deepseek.py`` ``load_params`` over the same reader.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import torch_dtype
from dynamo_tpu_torch.utils.device import resolve_device

# safetensors dtype tag -> torch dtype (the tags a Llama-tree checkpoint
# carries)
SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                      "F32": torch.float32}


class SafetensorsFile:
    """One ``.safetensors`` file, read with no package: ``keys()`` and
    ``get_tensor(name)`` (a CPU tensor over a fresh buffer). Assumes a
    little-endian host, as the format's byte order is."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        (n,) = struct.unpack("<Q", self._fh.read(8))
        self.header: Dict[str, Any] = json.loads(self._fh.read(n))
        self.header.pop("__metadata__", None)
        self._base = 8 + n

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._fh.close()

    def keys(self) -> List[str]:
        return list(self.header)

    def get_tensor(self, name: str) -> torch.Tensor:
        meta = self.header[name]
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{meta['dtype']}, not one of "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if end == start:
            return torch.empty(shape, dtype=dtype)
        buf = bytearray(end - start)
        self._fh.seek(self._base + start)
        if self._fh.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: tensor {name!r} is truncated")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def _checkpoint_files(path: str) -> List[str]:
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(path, v) for v in weight_map.values()})
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(f"no safetensors checkpoint under {path}")


# HF tensor name -> (tree path, transpose?); "{i}" is the layer index, "{j}"
# the expert index (expert tensors stack on a second axis). The reference's
# map for the Llama tree, its MoE variants and Gemma-2.
def _name_map(cfg: ModelConfig) -> Dict[str, Any]:
    m = {
        "model.embed_tokens.weight": (("embed",), False),
        "model.norm.weight": (("final_norm",), False),
        "model.layers.{i}.input_layernorm.weight": (("layers", "attn_norm"), False),
        "model.layers.{i}.self_attn.q_proj.weight": (("layers", "wq"), True),
        "model.layers.{i}.self_attn.k_proj.weight": (("layers", "wk"), True),
        "model.layers.{i}.self_attn.v_proj.weight": (("layers", "wv"), True),
        "model.layers.{i}.self_attn.o_proj.weight": (("layers", "wo"), True),
        "model.layers.{i}.post_attention_layernorm.weight": (("layers", "mlp_norm"), False),
    }
    if cfg.num_experts and cfg.model_type == "mixtral":
        m.update({
            "model.layers.{i}.block_sparse_moe.gate.weight":
                (("layers", "w_router"), True),
            # mixtral naming: w1 = gate, w3 = up, w2 = down
            "model.layers.{i}.block_sparse_moe.experts.{j}.w1.weight":
                (("layers", "w_gate"), True),
            "model.layers.{i}.block_sparse_moe.experts.{j}.w3.weight":
                (("layers", "w_up"), True),
            "model.layers.{i}.block_sparse_moe.experts.{j}.w2.weight":
                (("layers", "w_down"), True),
        })
    elif cfg.num_experts:  # qwen3_moe naming
        m.update({
            "model.layers.{i}.mlp.gate.weight": (("layers", "w_router"), True),
            "model.layers.{i}.mlp.experts.{j}.gate_proj.weight":
                (("layers", "w_gate"), True),
            "model.layers.{i}.mlp.experts.{j}.up_proj.weight":
                (("layers", "w_up"), True),
            "model.layers.{i}.mlp.experts.{j}.down_proj.weight":
                (("layers", "w_down"), True),
        })
    else:
        m.update({
            "model.layers.{i}.mlp.gate_proj.weight": (("layers", "w_gate"), True),
            "model.layers.{i}.mlp.up_proj.weight": (("layers", "w_up"), True),
            "model.layers.{i}.mlp.down_proj.weight": (("layers", "w_down"), True),
        })
    if cfg.model_type.startswith("gemma"):
        # gemma-2 sandwich norms: post_attention_layernorm is the POST
        # norm on the attention residual (not the llama mlp_norm), plus
        # dedicated pre/post feed-forward norms
        m.update({
            "model.layers.{i}.post_attention_layernorm.weight":
                (("layers", "post_attn_norm"), False),
            "model.layers.{i}.pre_feedforward_layernorm.weight":
                (("layers", "pre_ffw_norm"), False),
            "model.layers.{i}.post_feedforward_layernorm.weight":
                (("layers", "post_ffw_norm"), False),
        })
    if not cfg.tie_word_embeddings:
        m["lm_head.weight"] = (("lm_head",), True)
    if cfg.attention_bias:
        m["model.layers.{i}.self_attn.q_proj.bias"] = (("layers", "bq"), False)
        m["model.layers.{i}.self_attn.k_proj.bias"] = (("layers", "bk"), False)
        m["model.layers.{i}.self_attn.v_proj.bias"] = (("layers", "bv"), False)
    if cfg.qk_norm:
        m["model.layers.{i}.self_attn.q_norm.weight"] = (("layers", "q_norm"), False)
        m["model.layers.{i}.self_attn.k_norm.weight"] = (("layers", "k_norm"), False)
    return m


_EXPERT_RE = re.compile(r"experts\.(\d+)\.")


def _match(name: str, patterns: Dict[str, Any]
           ) -> Tuple[Any, Optional[int], Optional[int]]:
    """Returns (spec, layer index or None, expert index or None)."""
    if name in patterns:
        return patterns[name], None, None
    if not name.startswith("model.layers."):
        return None, None, None
    idx, _, tail = name[len("model.layers."):].partition(".")
    try:
        layer = int(idx)
    except ValueError:
        return None, None, None
    key = f"model.layers.{{i}}.{tail}"
    if key in patterns:
        return patterns[key], layer, None
    m = _EXPERT_RE.search(tail)
    if m:
        tail2 = tail.replace(f"experts.{m.group(1)}.", "experts.{j}.", 1)
        spec = patterns.get(f"model.layers.{{i}}.{tail2}")
        if spec is not None:
            return spec, layer, int(m.group(1))
    return None, None, None


def load_hf_params(cfg: ModelConfig, path: str,
                   device=None) -> Dict[str, Any]:
    """The parameter tree of the HF checkpoint directory ``path``, on
    ``device`` (None: the GPU) in ``cfg.dtype``. DeepSeek's latent tree
    goes to ``models/deepseek.py`` ``load_params``, as in the reference."""
    if cfg.kv_lora_rank:
        from dynamo_tpu_torch.models.deepseek import load_params
        return load_params(cfg, path, device)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    patterns = _name_map(cfg)
    params: Dict[str, Any] = {}
    filled: Dict[tuple, set] = {}
    E = cfg.num_experts
    for f in _checkpoint_files(path):
        with SafetensorsFile(f) as sf:
            for name in sf.keys():
                spec, layer, expert = _match(name, patterns)
                if spec is None or (layer is not None
                                    and layer >= cfg.num_layers) \
                        or (expert is not None and expert >= E):
                    continue
                tree_path, transpose = spec
                t = sf.get_tensor(name).to(dev)
                if transpose:
                    t = t.t()
                node = params
                for k in tree_path[:-1]:
                    node = node.setdefault(k, {})
                leaf = tree_path[-1]
                if layer is None:
                    node[leaf] = t.to(dtype).contiguous()
                    filled[tree_path] = {None}
                    continue
                if expert is None:
                    if leaf not in node:
                        node[leaf] = torch.empty(
                            (cfg.num_layers,) + t.shape, dtype=dtype,
                            device=dev)
                    node[leaf][layer].copy_(t)
                    filled.setdefault(tree_path, set()).add(layer)
                    continue
                if leaf not in node:
                    node[leaf] = torch.empty((cfg.num_layers, E) + t.shape,
                                             dtype=dtype, device=dev)
                node[leaf][layer, expert].copy_(t)
                filled.setdefault(tree_path, set()).add((layer, expert))
    for tree_path, got in filled.items():
        if None in got:
            continue
        if isinstance(next(iter(got)), tuple):
            missing = {(i, j) for i in range(cfg.num_layers)
                       for j in range(E)} - got
            if missing:
                raise ValueError(
                    f"checkpoint missing {len(missing)} expert tensors for "
                    f"{tree_path} (e.g. {sorted(missing)[:3]})")
            continue
        missing = set(range(cfg.num_layers)) - got
        if missing:
            raise ValueError(f"checkpoint missing layers {sorted(missing)} "
                             f"for {tree_path}")
    # every expected weight family must have appeared: catches truncated
    # checkpoints and architectures whose tensor names are not mapped
    absent = {tp for tp, _ in patterns.values()} - set(filled)
    if absent:
        raise ValueError(
            f"checkpoint at {path} is missing weights for {sorted(absent)}; "
            f"unsupported architecture or incomplete download")
    return params


__all__ = ["load_hf_params", "SafetensorsFile", "SAFETENSORS_DTYPES"]
