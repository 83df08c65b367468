"""dynamo_tpu_torch — the serving engine of ``dynamo_tpu`` in PyTorch + CUDA.

``dynamo_tpu`` (JAX on a TPU) stays the reference; this package serves the
same Llama-tree models and the DeepSeek V2/V3 family (latent attention +
MoE; DeepSeek-V2-Lite on one card) on an NVIDIA H100. Its main path is the
continuous-batching loop (``engine/loop.py``, ``engine/scheduler.py``,
copies of the reference's JAX-free modules) driving ``TorchEngine``
(``engine/torch_engine.py``): a PyTorch forward (``models/llama.py``,
``models/deepseek.py``) whose paged attention runs through hand-written CUDA
kernels for ``sm_90a`` (``ops/kernels/``: paged decode, chunked prefill,
ragged mixed steps, and latent MLA decode and prefill), one for each Pallas
kernel of the reference.

The package imports ``torch`` and never ``jax`` or ``dynamo_tpu``. Its entry
points run on the GPU unless the caller passes ``device="cpu"``, where every
kernel wrapper computes its plain PyTorch version instead (the CPU tests).
"""

from dynamo_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
