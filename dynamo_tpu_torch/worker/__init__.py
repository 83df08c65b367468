"""The port's worker process (``python -m dynamo_tpu_torch.worker.main``):
serves ``TorchEngine`` behind the runtime, as ``dynamo_tpu/worker/main.py``
serves ``JaxEngine``."""
