"""Model families of the port: the Llama tree (llama 2/3, mistral,
qwen2/qwen3; ``models/llama.py``) and DeepSeek V2/V3 with latent attention
and MoE (``models/deepseek.py``). ``get_family(cfg)`` maps a config to its
module and imports it only then: importing the config must stay cheap.
"""

import importlib

from dynamo_tpu_torch.models.config import ModelConfig


def get_family(cfg: ModelConfig):
    """The module implementing this config's model family (the reference's
    ``dynamo_tpu.models.get_family`` over the families ported so far)."""
    if cfg.kv_lora_rank:
        # MLA (deepseek v2/v3): latent paged cache, absorbed attention
        return importlib.import_module("dynamo_tpu_torch.models.deepseek")
    if cfg.num_experts:
        raise NotImplementedError(
            f"model_type {cfg.model_type!r}: the mixtral / qwen3-MoE family "
            "(models/moe.py) is not ported yet: ROADMAP A11")
    if cfg.model_type.startswith("gemma"):
        raise NotImplementedError(
            f"model_type {cfg.model_type!r}: gemma-2 (models/gemma.py) is "
            "not ported yet: ROADMAP A10")
    return importlib.import_module("dynamo_tpu_torch.models.llama")


__all__ = ["ModelConfig", "get_family"]
