"""Rotary position embeddings (HF half-split convention), as
``dynamo_tpu/ops/rope.py``: ``rope(x) = x * cos + [-x2, x1] * sin`` with
``inv_freq = theta^(-2i/d)`` tiled twice, computed in float32 from the
absolute positions."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin for absolute ``positions`` (any shape) with a trailing
    ``head_dim`` axis, in float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` ``[B, S, H, Dh]`` by per-token ``positions`` ``[B, S]``."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.to(torch.float32)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


__all__ = ["rope_cos_sin", "apply_rope"]
