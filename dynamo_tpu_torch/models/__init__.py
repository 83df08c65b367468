"""Model families of the port: the Llama tree (llama 2/3, mistral,
qwen2/qwen3; ``models/llama.py``), its MoE variants (mixtral, qwen3-MoE;
``models/moe.py``), Gemma-2 (``models/gemma.py``) and DeepSeek V2/V3 with
latent attention and MoE (``models/deepseek.py``). ``get_family(cfg)`` maps
a config to its module and imports it only then: importing the config must
stay cheap.
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
        return importlib.import_module("dynamo_tpu_torch.models.moe")
    if cfg.model_type == "gemma2":
        return importlib.import_module("dynamo_tpu_torch.models.gemma")
    if cfg.model_type.startswith("gemma"):
        # gemma-1 / gemma-3 differ (norm layout, qk-norm, dual rope
        # thetas) and must not silently load as gemma-2
        raise NotImplementedError(
            f"model_type {cfg.model_type!r}: only gemma2 is implemented")
    return importlib.import_module("dynamo_tpu_torch.models.llama")


__all__ = ["ModelConfig", "get_family"]
