"""Standalone deployable components.

Parity with the reference's ``components/`` processes beyond the frontend and
workers (which live in ``dynamo_tpu_torch.frontend`` / ``dynamo_tpu_torch.worker``):

- ``metrics``: scrapes a component's worker stats + KV hit-rate events into a
  Prometheus exposition (reference ``components/metrics``, Rust).
- ``router``: hosts the KV router as its own service endpoint so external
  clients can use KV-aware placement without embedding the frontend
  (reference ``components/router``, Rust).
"""
