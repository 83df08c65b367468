"""Argument checks shared by the kernel wrappers (CUDA path only): GQA
(``check_cuda_args``) and latent MLA (``check_mla_args``)."""

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
    _check_rest(name, [("q", q), ("pages", pages)], L, layer_idx,
                page_table, total_lens, positions, B, S)


def _check_rest(name: str, buffers, L: int, layer_idx,
                page_table: torch.Tensor, total_lens: torch.Tensor,
                positions, B: int, S: int) -> None:
    """The checks both kernel families share: the layer index, int32
    tables of batch B (positions [B, S]), and every buffer contiguous on
    the first buffer's device."""
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
    first, dev = buffers[0][0], buffers[0][1].device
    for what, t in buffers + [(what, t) for what, t, _nd in ints]:
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, {first} on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


# MLA kernels: query heads per block, and the shared-memory budget
MLA_HEAD_GROUP = 16
SMEM_MAX = 232448


def mla_smem_bytes(rows: int, dkv: int, dr: int) -> int:
    """Dynamic shared memory of an MLA block with ``rows`` query rows
    (``layout().total`` in ``csrc/mla.cu``)."""
    ld = dkv + dr + 8
    return (rows * ld * 2 + 64 * ld * 2 + rows * 68 * 4 + rows * 72 * 2
            + rows * (dkv + 4) * 4 + 3 * rows * 4)


def mla_geometry_error(nh: int, dkv: int, dr: int, ps: int):
    """Why the MLA kernels do not take this geometry, or None."""
    if dkv % 128:
        return f"kv_lora_rank={dkv} is not a multiple of 128"
    if ps % 8:
        return f"page_size={ps} is not a multiple of 8"
    if dr > dkv or dr % 16:
        return (f"rope dim {dr} must be a multiple of 16 and at most "
                f"kv_lora_rank={dkv}")
    if nh % MLA_HEAD_GROUP:
        return f"num_heads={nh} is not a multiple of {MLA_HEAD_GROUP}"
    if mla_smem_bytes(32, dkv, dr) > SMEM_MAX:
        return (f"dkv={dkv}, dr={dr} tiles exceed the {SMEM_MAX}-byte "
                "shared-memory budget")
    return None


def check_mla_args(name: str, q_lat: torch.Tensor, q_pe: torch.Tensor,
                   pages: torch.Tensor, layer_idx, page_table: torch.Tensor,
                   total_lens: torch.Tensor, positions=None) -> None:
    """Raise on anything the MLA kernels do not take: bf16 pages
    ``[L, N, 2, 1, ps, dkv]`` with ``dkv % 128 == 0`` and ``ps % 8 == 0``
    (the reference's ``supports``, ``mla_decode.py:55``), ``dr <= dkv`` with
    ``dr % 16 == 0``, heads in groups of 16, the block's tiles within the
    shared-memory budget, int32 tables, contiguous buffers, one device."""
    if q_lat.dim() != 4 or q_pe.dim() != 4 or pages.dim() != 6:
        raise ValueError(f"{name}: q_lat/q_pe must be [B,S,nh,d] and pages "
                         f"[L,N,2,1,ps,dkv], got {tuple(q_lat.shape)}, "
                         f"{tuple(q_pe.shape)}, {tuple(pages.shape)}")
    B, S, nh, dkv = q_lat.shape
    dr = q_pe.shape[-1]
    L, _N, two, one, ps, dkv2 = pages.shape
    if q_pe.shape[:3] != q_lat.shape[:3] or two != 2 or one != 1 \
            or dkv2 != dkv:
        raise ValueError(f"{name}: q_lat {tuple(q_lat.shape)}, q_pe "
                         f"{tuple(q_pe.shape)} and pages "
                         f"{tuple(pages.shape)} do not fit together")
    bad = mla_geometry_error(nh, dkv, dr, ps)
    if bad:
        raise ValueError(f"{name}: {bad}")
    if pages.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 pages, got "
                        f"{pages.dtype}")
    if not (q_lat.is_floating_point() and q_pe.is_floating_point()):
        raise TypeError(f"{name}: q_lat/q_pe must be floating point")
    # q_lat/q_pe are stacked into a fresh buffer: only their device counts
    for what, t in (("q_lat", q_lat), ("q_pe", q_pe)):
        if t.device != pages.device:
            raise ValueError(f"{name}: {what} is on {t.device}, pages on "
                             f"{pages.device}")
    _check_rest(name, [("pages", pages)], L, layer_idx, page_table,
                total_lens, positions, B, S)


def window_arg(window) -> int:
    return 0 if window is None else int(window)


def softcap_arg(softcap) -> float:
    return float(softcap or 0.0)
