"""The port's OpenAI frontend process: ``python -m
dynamo_tpu_torch.frontend.main`` (HTTP service, model discovery and the
router; a copy of ``dynamo_tpu/frontend/main.py``)."""
