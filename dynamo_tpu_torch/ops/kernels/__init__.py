"""Hand-written CUDA attention kernels for Hopper (``sm_90a``) and their
PyTorch wrappers.

- ``decode.paged_decode_attention_stacked`` (``csrc/decode.cu``, split-KV)
  replaces the TPU kernel ``dynamo_tpu/ops/pallas/decode.py``;
- ``prefill.paged_prefill_attention_stacked`` (``csrc/prefill_sm90.cu``, TMA
  + wgmma) replaces ``dynamo_tpu/ops/pallas/prefill.py``;
- ``ragged.ragged_mixed_attention_stacked`` (``csrc/prefill_sm90.cu``,
  ragged entry: split-KV for decode rows) replaces
  ``dynamo_tpu/ops/pallas/ragged.py``;
- ``mla_decode.mla_paged_decode_stacked`` (``csrc/mla_decode.cu``,
  split-KV) replaces ``dynamo_tpu/ops/pallas/mla_decode.py``;
- ``mla_prefill.mla_paged_prefill_stacked`` (``csrc/mla_prefill.cu``, TMA
  + wgmma, split-KV decode rows) replaces
  ``dynamo_tpu/ops/pallas/mla_prefill.py``.

That is every Pallas kernel of the reference; the TMA kernels share their
Hopper helpers through ``csrc/sm90.cuh``. Each wrapper keeps the JAX
function's signature: ``(q, pages, layer_idx, page_table, positions,
total_lens, sm_scale, window=None, softcap=None)`` for the three GQA
kernels of the Llama tree, ``(q_lat, q_pe, pages, layer_idx, page_table,
[positions,] total_lens, sm_scale)`` for DeepSeek's latent (MLA) pair.
On a CUDA tensor it launches its kernel (built from ``csrc/`` at first use,
see ``build.py``) or raises on what the kernel does not take; on a CPU
tensor it computes the kernel's plain PyTorch version (``plain.py``).
``LAUNCHES`` counts kernel launches per wrapper and nothing else.
"""

LAUNCHES = {"paged_decode": 0, "paged_prefill": 0, "ragged_mixed": 0,
            "mla_decode": 0, "mla_prefill": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = ["LAUNCHES", "reset_launch_counts"]
