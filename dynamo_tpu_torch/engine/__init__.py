"""Engines of the port.

``EngineBase``/``EchoEngine`` (``base.py``), the continuous-batching loop
(``loop.py``), scheduler, page allocator, n-gram proposer and step flight
recorder are copies of the reference's JAX-free engine modules.
``TorchEngine`` (``torch_engine.py``) is the PyTorch + CUDA model step.
"""

from dynamo_tpu_torch.engine.base import EchoEngine, EngineBase

__all__ = ["EngineBase", "EchoEngine"]
