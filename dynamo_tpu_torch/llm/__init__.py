"""LLM serving layer: pipelines, model discovery, worker registration.

Parity: reference ``lib/llm/src/{discovery,entrypoint,migration}.rs`` — the
glue that turns a registered model + engine into an OpenAI-servable pipeline.
"""

from dynamo_tpu_torch.llm.pipeline import ServicePipeline, LocalEnginePipeline, RemotePipeline
from dynamo_tpu_torch.llm.model_manager import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.register import register_llm, serve_engine

__all__ = [
    "ServicePipeline",
    "LocalEnginePipeline",
    "RemotePipeline",
    "ModelManager",
    "ModelWatcher",
    "register_llm",
    "serve_engine",
]
