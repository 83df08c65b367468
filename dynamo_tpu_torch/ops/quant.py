"""Int8 W8A8 dynamic quantization of the dense matmuls.

The port of ``dynamo_tpu/ops/quant.py``. A decode step streams every
weight once, so symmetric int8 weights halve the step's largest stream;
activations quantize per token inside the step (no calibration pass).

- **Weights**: symmetric per-output-channel absmax over the contraction
  axis, ``w8[k, n] = round(w[k, n] / s_w[n])`` with ``s_w = absmax_k / 127``;
  stacked ``[L, K, N] int8`` beside ``[L, N] float32``, so the layer dicts
  slice per layer as the bf16 ones do. ``quantize_params`` lays each
  ``[K, N]`` matrix out column-major (``N`` rows of ``K``): cuBLASLt's int8
  product runs 6-11x faster on it than on row-major at Llama-3.2-3B's
  shapes on an H100 (``PERF.md`` §6).
- **Activations**: ``x8 = clip(round(x / s_x), -127, 127)`` with ``s_x =
  absmax over the row / 127``, in float32.
- **Product**: int8 x int8 into int32 (``torch._int_mm``: a plain product,
  which the reference also leaves to the compiler outside any Pallas
  kernel), then ``(y * s_x) * s_w`` in float32, in the reference's order,
  so that on the CPU the result is the reference's bit for bit. Scales
  divide by 127 as a tensor: CUDA divides by a host scalar as a product
  with its reciprocal, an ulp off the division in ~4% of rows.

``round`` is half to even in both packages. Tied embeddings stay in the
model dtype (the table is also the gather of the embedding lookup), and so
do norms and biases.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, object]

# stacked [L, in, out] layer weights that quantize: the Llama tree's names,
# which Gemma-2 shares (the MoE and latent families stay in the model dtype)
LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

_EPS = 1e-30

# ``torch._int_mm`` on CUDA takes more than 16 rows (and K, N multiples of
# 8); a decode batch of up to 16 rows is padded with zero rows to this many
_INT_MM_MIN_ROWS = 17


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, EPS) / 127`` as a true division on either device."""
    return torch.clamp(amax, min=_EPS) / amax.new_full((), 127.0)


def quantize_weight(w: torch.Tensor, axis: int):
    """Symmetric per-channel int8: absmax over ``axis`` (the contraction
    dim), one float32 scale per remaining channel. Returns ``(w8, scale)``
    with ``scale`` shaped like ``w`` without ``axis``."""
    wf = w.float()
    scale = _absmax_scale(wf.abs().amax(dim=axis))
    w8 = torch.round(wf / scale.unsqueeze(axis)).to(torch.int8)
    return w8, scale


def _int_mm(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """``x8 [M, K] @ w8 [K, N]`` in int32. On the card, a batch of at most
    16 rows is padded with zero rows to the 17 ``_int_mm`` takes; rows do
    not mix in a product, so the real rows are exact and the pad is cut."""
    M = x8.shape[0]
    if x8.is_cuda and M < _INT_MM_MIN_ROWS:
        pad = torch.zeros((_INT_MM_MIN_ROWS - M, x8.shape[1]),
                          dtype=x8.dtype, device=x8.device)
        return torch._int_mm(torch.cat([x8, pad]), w8)[:M]
    return torch._int_mm(x8, w8)


def qdot(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
         out_dtype=None) -> torch.Tensor:
    """``x @ w`` with int8 weights and per-token int8 activations.

    x: ``[..., K]`` (any float dtype); w8: ``[K, N]`` int8; w_scale: ``[N]``
    float32. The result is cast to ``out_dtype`` (default ``x.dtype``); the
    logits sites pass float32."""
    xf = x.float()
    s_x = _absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
    x8 = torch.round(xf / s_x).clamp(-127, 127).to(torch.int8)
    K, N = w8.shape
    y = _int_mm(x8.reshape(-1, K), w8).reshape(*x.shape[:-1], N)
    return ((y.float() * s_x) * w_scale).to(out_dtype or x.dtype)


def quantize_params(params: Params) -> Params:
    """A Llama-tree or Gemma-2 parameter tree with int8 weights.

    Each stacked layer matrix ``name [L, K, N]`` becomes ``name + "_q"``
    ``[L, K, N]`` int8 (each layer's matrix column-major) and ``name +
    "_scale"`` ``[L, N]`` float32, and the original is dropped; an untied
    ``lm_head [K, N]`` the same way. One layer is quantized at a time, so
    the float32 copy the arithmetic needs is one layer's. Everything else
    passes through."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in LAYER_WEIGHTS:
        w = layers.pop(name, None)
        if w is None:
            continue
        w8 = torch.empty((w.shape[0], w.shape[2], w.shape[1]),
                         dtype=torch.int8, device=w.device).transpose(1, 2)
        scale = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32,
                            device=w.device)
        for l in range(w.shape[0]):
            w8[l], scale[l] = quantize_weight(w[l], axis=0)
        layers[name + "_q"] = w8
        layers[name + "_scale"] = scale
    out["layers"] = layers
    lm = out.pop("lm_head", None)
    if lm is not None:
        w8, out["lm_head_scale"] = quantize_weight(lm, axis=0)
        out["lm_head_q"] = w8.t().contiguous().t()
    return out


def mm(lp: Dict[str, torch.Tensor], name: str,
       x: torch.Tensor) -> torch.Tensor:
    """``x @ lp[name]``, through the int8 pair when the tree was
    quantized: the one call site the Llama and Gemma forwards share."""
    w8 = lp.get(name + "_q")
    if w8 is not None:
        return qdot(x, w8, lp[name + "_scale"])
    return x @ lp[name]


__all__ = ["LAYER_WEIGHTS", "mm", "qdot", "quantize_params",
           "quantize_weight"]
