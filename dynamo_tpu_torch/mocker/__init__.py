"""Mocker engine: a full engine simulator with real KV/scheduling behavior.

Parity: reference rust mocker (``lib/llm/src/mocker/`` — paged ``KvManager``
with LRU eviction + block events, prefill-cost model, chunked scheduler with
watermark/preemption, ``MockEngineArgs``), the reference's key trick for
testing multi-worker routing without GPUs
(``tests/router/test_router_e2e_with_mockers.py``).

Here the mocker IS the production scheduling stack — it shares
``ScheduledEngineBase`` (admission, chunked prefill, preemption, prefix cache,
KV events, metrics) with the real ``JaxEngine`` and swaps only the compute
for a timing model. Router/planner behavior observed against the mocker is
therefore exactly what the real engine produces, token-for-token and
event-for-event.
"""

from dynamo_tpu_torch.mocker.engine import MockEngineArgs, MockerEngine

__all__ = ["MockEngineArgs", "MockerEngine"]
