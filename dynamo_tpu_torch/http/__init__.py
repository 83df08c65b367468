"""OpenAI-compatible HTTP frontend service."""

from dynamo_tpu_torch.http.service import HttpService

__all__ = ["HttpService"]
