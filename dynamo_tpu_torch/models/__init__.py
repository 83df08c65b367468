"""Model families of the port. Only the Llama tree (llama 2/3, mistral,
qwen2/qwen3) is ported so far (``models/llama.py``). ``llama`` is not
re-exported here: importing the config must stay cheap."""

from dynamo_tpu_torch.models.config import ModelConfig

__all__ = ["ModelConfig"]
