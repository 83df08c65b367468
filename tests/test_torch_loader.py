"""The port's safetensors loader (``dynamo_tpu_torch/models/hf_loader.py``)
against the reference's and against the ``safetensors`` package.

- The reader: ``SafetensorsFile`` (no package) returns every tensor of a
  file the ``safetensors`` package wrote bit for bit as ``safe_open``
  reads it, in BF16, F16 and F32.
- The loader: a random tiny checkpoint written by transformers (Llama with
  tied and untied heads, qwen2 with attention biases, qwen3 with q/k norms;
  f32 and bf16; one file and an index of two shards) loads through the
  port and through ``dynamo_tpu.models.hf_loader.load_hf_params`` into the
  same tree, every leaf equal bit for bit as numpy arrays (an f32
  checkpoint served in bf16 rounds the same way in both).
- The MoE variants: a random tiny ``MixtralForCausalLM`` and
  ``Qwen3MoeForCausalLM`` load into the same ``[L, E, in, out]`` expert
  stacks in both packages, and a checkpoint missing one expert tensor is
  refused as the reference refuses it.
- DeepSeek's latent tree, which the port does not load yet, is refused
  naming its ROADMAP item, and a truncated checkpoint is refused as the
  reference refuses it.
"""

import json
import os

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.hf_loader import load_hf_params as jload
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.hf_loader import SafetensorsFile, load_hf_params

torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    """A leaf's raw bits: bf16 has no numpy dtype of its own in torch."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_reader_equals_safe_open(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(dtype),
               "b.weight": torch.randn(7, generator=g).to(dtype),
               "scalar": torch.tensor(1.5).to(dtype),
               "empty": torch.zeros((0, 4), dtype=dtype)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    with SafetensorsFile(path) as sf, safe_open(path, framework="pt") as ref:
        assert sorted(sf.keys()) == sorted(ref.keys())
        for name in ref.keys():
            got, want = sf.get_tensor(name), ref.get_tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(_bits(got), _bits(want)), name


FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", {}),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", {}),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", {"head_dim": 16}),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                {"num_local_experts": 4, "num_experts_per_tok": 2}),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  {"head_dim": 16, "num_experts": 4, "num_experts_per_tok": 2,
                   "moe_intermediate_size": 32, "norm_topk_prob": True}),
}


def _write_checkpoint(path, family, tied, ckpt_dtype, shards):
    import transformers
    cfg_name, model_name, extra = FAMILIES[family]
    hf_cfg = getattr(transformers, cfg_name)(
        vocab_size=96, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tied, **extra)
    torch.manual_seed(0)
    model = getattr(transformers, model_name)(hf_cfg).eval().to(ckpt_dtype)
    with torch.no_grad():
        # a norm of ones reads the same in any loader: make them random
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith(".bias"):
                p.copy_(torch.randn_like(p))
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size="40KB" if shards > 1 else "5GB")
    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    assert len(files) == shards or (shards > 1 and len(files) > 1), files
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("family,tied,ckpt,serve,shards", [
    ("llama", True, torch.float32, "float32", 1),
    ("llama", False, torch.float32, "float32", 2),
    ("llama", True, torch.bfloat16, "bfloat16", 2),
    ("llama", False, torch.bfloat16, "bfloat16", 1),
    ("llama", False, torch.float32, "bfloat16", 1),
    ("qwen2", False, torch.bfloat16, "bfloat16", 2),
    ("qwen3", True, torch.float32, "float32", 1),
    ("mixtral", False, torch.float32, "float32", 1),
    ("mixtral", False, torch.bfloat16, "bfloat16", 2),
    ("qwen3_moe", False, torch.float32, "bfloat16", 2),
    ("qwen3_moe", True, torch.float32, "float32", 1),
])
def test_loader_equals_reference_bit_for_bit(tmp_path, family, tied, ckpt,
                                             serve, shards):
    hf = _write_checkpoint(str(tmp_path), family, tied, ckpt, shards)
    cfg = ModelConfig.from_hf(hf, dtype=serve)
    jcfg = JModelConfig.from_hf(hf, dtype=serve)
    assert (cfg.attention_bias, cfg.qk_norm) == (
        family == "qwen2", family in ("qwen3", "qwen3_moe"))
    assert cfg.num_experts == (4 if family in ("mixtral", "qwen3_moe")
                               else 0)
    got = dict(_leaves(load_hf_params(cfg, str(tmp_path), device="cpu")))
    want = dict(_leaves(jload(jcfg, str(tmp_path))))
    assert sorted(got) == sorted(want)
    assert ("lm_head",) in got if not tied else ("lm_head",) not in got
    for path, w in want.items():
        g = got[path]
        assert g.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[serve], path
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.is_contiguous(), path
        assert np.array_equal(_bits(g), _bits(w)), path


def test_loader_refuses_unported_families(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        load_hf_params(ModelConfig.deepseek_v2_lite(), str(tmp_path),
                       device="cpu")


@pytest.mark.parametrize("family,name", [
    ("mixtral", "model.layers.1.block_sparse_moe.experts.2.w3.weight"),
    ("qwen3_moe", "model.layers.0.mlp.experts.3.down_proj.weight"),
])
def test_loader_refuses_missing_expert(tmp_path, family, name):
    """One expert tensor gone: both loaders refuse the checkpoint."""
    hf = _write_checkpoint(str(tmp_path), family, False, torch.float32, 1)
    path = str(tmp_path / "model.safetensors")
    with safe_open(path, framework="pt") as f:
        names = list(f.keys())
        kept = {k: f.get_tensor(k) for k in names if k != name}
    assert name in names
    save_file(kept, path, metadata={"format": "pt"})
    with pytest.raises(ValueError, match="missing 1 expert tensors"):
        load_hf_params(ModelConfig.from_hf(hf, dtype="float32"),
                       str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="missing 1 expert tensors"):
        jload(JModelConfig.from_hf(hf, dtype="float32"), str(tmp_path))


def test_loader_refuses_truncated_checkpoint(tmp_path):
    hf = _write_checkpoint(str(tmp_path), "llama", False, torch.float32, 1)
    path = str(tmp_path / "model.safetensors")
    with safe_open(path, framework="pt") as f:
        kept = {k: f.get_tensor(k) for k in f.keys()
                if k != "model.layers.1.mlp.up_proj.weight"}
    save_file(kept, path, metadata={"format": "pt"})
    cfg = ModelConfig.from_hf(hf, dtype="float32")
    with pytest.raises(ValueError, match="missing layers"):
        load_hf_params(cfg, str(tmp_path), device="cpu")
    os.remove(path)
    with pytest.raises(FileNotFoundError):
        load_hf_params(cfg, str(tmp_path), device="cpu")

