"""Argument checks shared by the kernel wrappers (CUDA path only)."""

from __future__ import annotations

import torch

# query heads per kv head the kernels are instantiated for
GROUPS = (1, 2, 3, 4, 6, 8)
HEAD_DIM = 128


def check_cuda_args(name: str, q: torch.Tensor, pages: torch.Tensor,
                    layer_idx, page_table: torch.Tensor,
                    total_lens: torch.Tensor, positions=None) -> None:
    """Raise on anything the kernels do not take: they read bf16, Dh=128,
    ``ps % 8 == 0``, int32 tables, contiguous row-major buffers, one device."""
    dev = q.device
    if q.dim() != 4 or pages.dim() != 6:
        raise ValueError(f"{name}: q must be [B,S,Hq,Dh] and pages "
                         f"[L,N,2,Hkv,ps,Dh], got {tuple(q.shape)} and "
                         f"{tuple(pages.shape)}")
    B, S, Hq, Dh = q.shape
    L, _N, two, Hkv, ps, Dh2 = pages.shape
    if Dh != HEAD_DIM or Dh2 != HEAD_DIM or two != 2:
        raise ValueError(f"{name}: the kernel takes head_dim={HEAD_DIM}, "
                         f"got q {Dh} / pages {Dh2}")
    if Hq % Hkv or Hq // Hkv not in GROUPS:
        raise ValueError(f"{name}: Hq/Hkv={Hq}/{Hkv} is not one of the "
                         f"instantiated groups {GROUPS}")
    if ps % 8:
        raise ValueError(f"{name}: page_size={ps} is not a multiple of 8")
    if q.dtype != torch.bfloat16 or pages.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 q and pages, got "
                        f"{q.dtype} / {pages.dtype}")
    if not (0 <= int(layer_idx) < L):
        raise IndexError(f"{name}: layer_idx {layer_idx} out of [0, {L})")
    ints = [("page_table", page_table, 2), ("total_lens", total_lens, 1)]
    if positions is not None:
        ints.append(("positions", positions, 2))
    for what, t, nd in ints:
        if t.dtype != torch.int32 or t.dim() != nd or t.shape[0] != B:
            raise TypeError(f"{name}: {what} must be int32 with {nd} dims "
                            f"and batch {B}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if positions is not None and positions.shape[1] != S:
        raise ValueError(f"{name}: positions {tuple(positions.shape)} do not "
                         f"match q's [B, S] = [{B}, {S}]")
    for what, t in [("q", q), ("pages", pages), ("page_table", page_table),
                    ("total_lens", total_lens)] + (
                        [("positions", positions)] if positions is not None
                        else []):
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def window_arg(window) -> int:
    return 0 if window is None else int(window)


def softcap_arg(softcap) -> float:
    return float(softcap or 0.0)
