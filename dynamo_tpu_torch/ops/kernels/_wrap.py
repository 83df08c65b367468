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


# the MLA prefill kernel's ring: chunks of 32 kv positions, as many stages
# as fit beside the query up to 4 (csrc/mla_prefill.cu)
MLA_PREFILL_CHUNK = 32
MLA_PREFILL_MAX_STAGES = 4


def mla_smem_bytes(dkv: int, dr: int, stages: int) -> int:
    """Dynamic shared memory of an MLA prefill block (``layout().total`` in
    ``csrc/mla_prefill.cu``): the swizzled query ``[64, dkv + dr]`` in
    column blocks of 64 (8 KB each), a ring of ``stages`` chunks of 32
    positions in ``dkv / 64 + max(1, ceil(dr / 64))`` column blocks (the
    first k_pe block carries P between the warpgroups), the warpgroups' row
    maxima and sums, the mbarriers of the ring and of the query's staging,
    and 1 KB of alignment slack."""
    rope = -(-dr // 64)
    qblocks = dkv // 64 + rope
    cblocks = dkv // 64 + max(1, rope)
    return (qblocks * 64 * 128 + stages * cblocks * MLA_PREFILL_CHUNK * 128
            + 2 * 2 * 64 * 4 + stages * 16 + 24 + 1024)


def mla_prefill_stages(dkv: int, dr: int) -> int:
    """The prefill kernel's ring depth: the most stages, up to 4, that fit
    the shared memory beside the query; 0 when not even 2 fit."""
    fits = [n for n in range(2, MLA_PREFILL_MAX_STAGES + 1)
            if mla_smem_bytes(dkv, dr, n) <= SMEM_MAX]
    return max(fits, default=0)


# the MLA decode kernel's output columns per block: 8 warps of at most 10
# m16n8 tiles of register accumulators (csrc/mla_decode.cu)
MLA_DECODE_MAX_DKV = 640
# the prefill kernel's: each of its two consumer warpgroups holds
# [64, dkv / 2] f32 in registers, 128 a thread at dkv = 512
# (csrc/mla_prefill.cu); a wider latent would spill
MLA_PREFILL_MAX_DKV = 512


def mla_decode_smem_bytes(dkv: int, dr: int) -> int:
    """Dynamic shared memory of an MLA decode block (``layout().total`` in
    ``csrc/mla_decode.cu``): a ring of 3 stages of 32 positions, each
    ``dkv / 64 + ceil(dr / 64)`` swizzled column blocks of 4 KB, the warps'
    partial scores, the bf16 probabilities, the rows' rescale factors and
    sums, the split's page ids, the ring's mbarriers and 1 KB of alignment
    slack."""
    cblocks = dkv // 64 + -(-dr // 64)
    return (3 * cblocks * 32 * 128 + 8 * MLA_HEAD_GROUP * 36 * 4
            + MLA_HEAD_GROUP * 40 * 2 + 2 * MLA_HEAD_GROUP * 4 + 256 * 4
            + 6 * 8 + 1024)


def mla_geometry_error(nh: int, dkv: int, dr: int, ps: int, kernel=None):
    """Why the MLA kernels (``kernel`` "decode" or "prefill", or None for
    both, as the engine runs them) do not take this geometry, or None."""
    if dkv % 128:
        return f"kv_lora_rank={dkv} is not a multiple of 128"
    if ps % 8:
        return f"page_size={ps} is not a multiple of 8"
    if dr > dkv or dr % 16:
        return (f"rope dim {dr} must be a multiple of 16 and at most "
                f"kv_lora_rank={dkv}")
    if nh % MLA_HEAD_GROUP:
        return f"num_heads={nh} is not a multiple of {MLA_HEAD_GROUP}"
    if kernel != "prefill":
        if dkv > MLA_DECODE_MAX_DKV:
            return (f"kv_lora_rank={dkv} exceeds the decode kernel's "
                    f"{MLA_DECODE_MAX_DKV} register-held output columns")
        if mla_decode_smem_bytes(dkv, dr) > SMEM_MAX:
            return (f"dkv={dkv}, dr={dr} tiles exceed the decode kernel's "
                    f"{SMEM_MAX}-byte shared-memory budget")
    if kernel != "decode":
        if dkv > MLA_PREFILL_MAX_DKV:
            return (f"kv_lora_rank={dkv} exceeds the prefill kernel's "
                    f"{MLA_PREFILL_MAX_DKV} register-held output columns "
                    f"({MLA_PREFILL_MAX_DKV // 2} a consumer warpgroup)")
        if not mla_prefill_stages(dkv, dr):
            return (f"dkv={dkv}, dr={dr} tiles exceed the prefill kernel's "
                    f"{SMEM_MAX}-byte shared-memory budget")
    return None


def check_mla_args(name: str, q_lat: torch.Tensor, q_pe: torch.Tensor,
                   pages: torch.Tensor, layer_idx, page_table: torch.Tensor,
                   total_lens: torch.Tensor, positions=None) -> None:
    """Raise on anything the MLA kernel ``name`` ("mla_decode" or
    "mla_prefill") does not take: bf16 pages ``[L, N, 2, 1, ps, dkv]`` with
    ``dkv % 128 == 0`` and ``ps % 8 == 0`` (the reference's ``supports``,
    ``mla_decode.py:55``), ``dr <= dkv`` with ``dr % 16 == 0``, heads in
    groups of 16, the kernel's register and shared-memory budgets, int32
    tables, contiguous buffers, one device; the prefill kernel also reads
    f32 or bf16 query rows itself, each row contiguous and 16-byte
    aligned."""
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
    bad = mla_geometry_error(nh, dkv, dr, ps, name.removeprefix("mla_"))
    if bad:
        raise ValueError(f"{name}: {bad}")
    if pages.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 pages, got "
                        f"{pages.dtype}")
    if not (q_lat.is_floating_point() and q_pe.is_floating_point()):
        raise TypeError(f"{name}: q_lat/q_pe must be floating point")
    buffers = [("pages", pages)]
    for what, t in (("q_lat", q_lat), ("q_pe", q_pe)):
        if t.device != pages.device:
            raise ValueError(f"{name}: {what} is on {t.device}, pages on "
                             f"{pages.device}")
        if name == "mla_prefill" and t.shape[-1]:
            # the prefill kernel copies each (slot, head) row of f32 or bf16
            # itself (the decode wrapper stacks q into a fresh buffer)
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"{name}: {what} must be float32 or "
                                f"bfloat16, got {t.dtype}")
            if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                    st * t.element_size() % 16 for st in t.stride()[:3]):
                raise ValueError(f"{name}: {what}'s rows must be contiguous "
                                 f"and 16-byte aligned, got strides "
                                 f"{t.stride()}")
    _check_rest(name, buffers, L, layer_idx, page_table,
                total_lens, positions, B, S)


def window_arg(window) -> int:
    return 0 if window is None else int(window)


def softcap_arg(softcap) -> float:
    return float(softcap or 0.0)
