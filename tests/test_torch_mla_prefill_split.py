"""The MLA prefill kernel's schedule, split-KV and query arithmetic, on the
CPU.

``ops/kernels/csrc/mla_prefill.cu`` gives block (x, y) one work item: row
b and head group g of x = b * groups + g, rank y. A long row's rank r takes
query tile R - 1 - r of 4 slots (R real tiles, so its tiles go last-first;
the ranks past them write pad zeros), a decode row's
(1 <= q_len <= ``SPLIT_Q_CAP``) rank r its split r of ``mla_prefill_splits``
whole pages, whose f32 (num, den, max) partials a merge kernel finishes
with ``merge_softmax_partials`` / ``normalize_softmax_partials``. Blocks
dispatch x fastest. Here Python mirrors of that schedule and of the
block's arithmetic (chunks of 32 positions taken in
pairs that share one running max, as the two consumer warpgroups do) are
held, in float32 (no bf16 rounding of p, so only the order of the float32
sums differs: within 2e-5), against the plain version and the JAX kernel in
interpret mode:

- ``mla_prefill_splits`` cuts the table into whole pages that cover it,
  from shapes alone (its signature holds no lengths);
- the schedule is a bijection onto the items, each row's ranks in order of
  the kv positions they load, most first, and writes every (slot, head)
  output row exactly once (tiles, pad tiles, the merge of a decode row's
  splits);
- the ring is as deep as the shared memory allows beside the query, up to
  4 stages, and the geometry check refuses what fits no 2-stage ring;
- the mirror, merged, equals ``mla_prefill_plain`` and the JAX
  ``mla_paged_prefill_stacked`` on a q_len 77/1/130/5/1 mix at S = 131 with
  decode rows at ctx 1, on a split boundary and one either side of it;
- the in-kernel query arithmetic (f32 product with sm_scale, then round to
  nearest even bf16) is bit-equal to ``plain.mla_query``.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas.mla_prefill import (
    mla_paged_prefill_stacked as jmla_prefill)
from dynamo_tpu_torch.ops.attention import (merge_softmax_partials,
                                            normalize_softmax_partials)
from dynamo_tpu_torch.ops.kernels._wrap import (SMEM_MAX, mla_geometry_error,
                                                mla_prefill_stages,
                                                mla_smem_bytes)
from dynamo_tpu_torch.ops.kernels.mla_prefill import (SPLIT_Q_CAP,
                                                      TILE_SLOTS,
                                                      mla_prefill_plain,
                                                      mla_prefill_splits)
from dynamo_tpu_torch.ops.kernels.plain import NEG_INF, mla_query

torch.set_num_threads(2)

F32_TOL = 2e-5
SMS = 132
HG = 16          # heads of a block
KB = 32          # kv positions of a chunk


def t(a):
    return torch.from_numpy(np.array(a))


# -- the split function -------------------------------------------------------


@pytest.mark.parametrize("B,S,nh,P,ps", [
    (4, 512, 16, 256, 16), (8, 512, 16, 256, 16), (7, 131, 16, 256, 16),
    (32, 512, 128, 256, 16), (1, 1, 16, 256, 16), (2, 40, 32, 100, 8),
    (3, 7, 16, 3, 64), (128, 64, 16, 4096, 8), (1, 16, 16, 0, 16)])
def test_mla_prefill_splits_whole_pages_cover_the_table(B, S, nh, P, ps):
    n_work, splits, per = mla_prefill_splits(B, S, nh, P, ps, SMS)
    # every long row's tiles and every decode row's splits have a block
    assert n_work == max(-(-S // TILE_SLOTS), splits)
    assert splits >= 1 and per >= 0
    assert splits * per >= P                  # the splits cover the table
    assert (splits - 1) * per < max(P, 1)     # none starts past it
    # shapes only: the lengths are not an argument, so they cannot move it
    assert list(inspect.signature(mla_prefill_splits).parameters) == [
        "B", "S", "nh", "P", "ps", "num_sms"]


# -- a mirror of the kernel's schedule ----------------------------------------


def _row_work(ctx, q_start, S, P, ps, span, splits):
    q_len = ctx - q_start
    n_real = max(0, min(q_len, S))
    kv_end = min(ctx, P * ps)
    split = 1 <= q_len <= SPLIT_Q_CAP
    live = min(splits, -(-kv_end // span)) if split else 0
    return dict(kv_end=kv_end, q_start=q_start, n_real=n_real, split=split,
                live=live, real_tiles=-(-n_real // TILE_SLOTS))


def _load(w, rank, span):
    """The kv positions rank ``rank`` of a row loads (csrc: its kv_stop
    less its kv_lo), 0 for a rank that only writes zeros."""
    if w["split"]:
        return min(span, w["kv_end"] - rank * span) if rank < w["live"] \
            else 0
    if rank >= w["real_tiles"]:
        return 0
    tile = w["real_tiles"] - 1 - rank
    return min(w["kv_end"],
               w["q_start"] + min(TILE_SLOTS * (tile + 1), w["n_real"]))


def _block_item(L, B, groups):
    """csrc: the (row, head group, rank) of the block dispatched L-th, x
    fastest over the grid (B * groups) x n_work."""
    x, r = L % (B * groups), L // (B * groups)
    return x // groups, x % groups, r


def _rows(q_lens, ctxs, S, P, ps, nh):
    B = len(ctxs)
    n_work, splits, per = mla_prefill_splits(B, S, nh, P, ps, SMS)
    span = per * ps
    rows = [_row_work(c, c - q, S, P, ps, span, splits)
            for q, c in zip(q_lens, ctxs)]
    return rows, n_work, splits, span


@pytest.mark.parametrize("nh", [16, 32])
@pytest.mark.parametrize("S,q_lens,ctx_of", [
    (131, [77, 1, 130, 5, 1, 1, 1], "edge"),
    (512, [512, 512, 1, 1, 1, 1, 1, 1], "mixed"),
    (512, [512, 512, 512, 300], "prefix"),
    (9, [0, 9, 1, 4], "short")])
def test_schedule_is_longest_first_and_writes_every_row_once(nh, S, q_lens,
                                                            ctx_of):
    P, ps = 64, 16
    groups = nh // HG
    B = len(q_lens)
    _n, _splits, per = mla_prefill_splits(B, S, nh, P, ps, SMS)
    edge = per * ps
    ctxs = {"edge": [300, 1, 1000, 5, edge - 1, edge, edge + 1],
            "mixed": [1024, 512, 1, edge, edge + 1, 700, 1023, P * ps],
            "prefix": [512, 1024, 1023, 836],
            "short": [3, 9, 1, 4]}[ctx_of]
    rows, n_work, splits, span = _rows(q_lens, ctxs, S, P, ps, nh)
    T = B * groups * n_work
    items = [_block_item(L, B, groups) for L in range(T)]
    assert sorted(items) == [(b, g, r) for b in range(B)
                             for g in range(groups) for r in range(n_work)]
    for b in range(B):             # each row's blocks: longest first
        loads = [_load(rows[b], r, span) for bb, g, r in items
                 if bb == b and g == 0]
        assert loads == sorted(loads, reverse=True), (b, loads)
    # every (row, slot, head group) written once: a tile (real or pad)
    # writes its slots < S, a split block the pad slots of tile `rank`,
    # the merge a decode row's real slots
    n_tiles = -(-S // TILE_SLOTS)
    written = {}
    for b, g, r in items:
        w = rows[b]
        if w["split"]:
            slots = [s for s in range(r * TILE_SLOTS, (r + 1) * TILE_SLOTS)
                     if s < S and s >= w["n_real"]] if r < n_tiles else []
        elif r < n_tiles:
            tile = w["real_tiles"] - 1 - r if r < w["real_tiles"] else r
            slots = [s for s in range(tile * TILE_SLOTS,
                                      (tile + 1) * TILE_SLOTS) if s < S]
        else:
            slots = []
        for s in slots:
            written[(b, g, s)] = written.get((b, g, s), 0) + 1
    for b, w in enumerate(rows):
        if w["split"]:
            for g in range(groups):
                for s in range(w["n_real"]):
                    written[(b, g, s)] = written.get((b, g, s), 0) + 1
    assert written == {(b, g, s): 1 for b in range(B) for g in range(groups)
                       for s in range(S)}


# -- the ring's depth -----------------------------------------------------------


@pytest.mark.parametrize("dkv,dr,stages", [
    (512, 64, 4), (512, 0, 4), (128, 16, 4), (256, 128, 4), (384, 0, 4),
    (512, 128, 3), (512, 192, 3), (512, 256, 2), (512, 384, 2),
    (384, 384, 2), (512, 448, 0)])
def test_ring_depth_is_the_most_that_fits(dkv, dr, stages):
    """The prefill kernel's ring is as deep as the shared memory allows
    beside the query (V2-Lite's widths fit 4 stages of 32 positions in
    223,320 bytes), at most 4; a geometry that fits no 2-stage ring is
    refused, every narrower one taken."""
    assert mla_prefill_stages(dkv, dr) == stages
    if dkv == 512 and dr == 64:
        assert mla_smem_bytes(dkv, dr, 4) == 223320
    if stages:
        assert mla_smem_bytes(dkv, dr, stages) <= SMEM_MAX
        assert stages == 4 or mla_smem_bytes(dkv, dr, stages + 1) > SMEM_MAX
        assert mla_geometry_error(16, dkv, dr, 16, "prefill") is None
    else:
        assert mla_smem_bytes(dkv, dr, 2) > SMEM_MAX
        assert "shared-memory" in mla_geometry_error(16, dkv, dr, 16,
                                                     "prefill")


# -- the mirror's arithmetic ---------------------------------------------------

NH, DKV, DR, PS = 16, 128, 16, 8


def _mla_case(seed, q_lens, ctxs, S, P):
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    N = sum(-(-c // PS) for c in ctxs) + 1
    pages = rng.normal(size=(2, N, 2, 1, PS, DKV)).astype(np.float32)
    pages[:, :, 1, :, :, DR:] = 0.0
    table = np.zeros((B, P), np.int32)
    perm = rng.permutation(np.arange(1, N))
    off = 0
    positions = np.zeros((B, S), np.int32)
    for i, (q, c) in enumerate(zip(q_lens, ctxs)):
        n = -(-c // PS)
        table[i, :n] = perm[off:off + n]
        off += n
        positions[i, :q] = np.arange(c - q, c)
    q_lat = rng.normal(size=(B, S, NH, DKV)).astype(np.float32)
    q_pe = rng.normal(size=(B, S, NH, DR)).astype(np.float32)
    return q_lat, q_pe, pages, table, positions, np.asarray(ctxs, np.int32)


def _block_state(q, pages, layer, table_row, q_start, slots, lo, stop):
    """One block's online softmax over kv [lo, stop): chunks of KB
    positions taken in pairs, both chunks of a pair rescaled by the pair's
    max, as the two consumer warpgroups share it. q [slots, nh, k] (the
    scaled, rounded query); returns the un-normalised (num, den, max) of
    each (slot, head)."""
    n = len(slots)
    num = torch.zeros((n, NH, DKV))
    den = torch.zeros((n, NH))
    m = torch.full((n, NH), NEG_INF)
    qpos = torch.tensor([q_start + s for s in slots])[:, None, None]
    for c0 in range(lo, stop, 2 * KB):
        pos = torch.arange(c0, min(c0 + 2 * KB, stop))
        pg = table_row[pos // PS].long()
        ckv = pages[layer, pg, 0, 0, pos % PS].float()
        kpe = pages[layer, pg, 1, 0, pos % PS, :DR].float()
        sc = torch.einsum("snk,tk->snt", q, torch.cat([ckv, kpe], dim=-1))
        ok = pos[None, None, :] <= qpos
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        ml = torch.where(m_new > NEG_INF / 2, m_new, 0.0)
        p = torch.where(ok, torch.exp(sc - ml[..., None]), 0.0)
        scale = torch.exp(m - ml)
        num = num * scale[..., None] + torch.einsum(
            "snt,tk->snk", p.to(pages.dtype).float(), ckv)
        den = den * scale + p.sum(dim=-1)
        m = m_new
    return num, den, m


def _mirror(q_lat, q_pe, pages, layer, table, positions, total, sm_scale,
            P):
    """The kernel's output through the mirrored schedule: each item's
    block (a tile's slots over [0, kv_stop), or a decode row's split over
    [rank * span, + span)), the splits merged."""
    B, S = positions.shape
    q = mla_query(q_lat, q_pe, sm_scale, pages.dtype).float()
    ctxs = [int(c) for c in total]
    q_lens = [c - int(positions[b, 0]) for b, c in enumerate(ctxs)]
    rows, n_work, splits, span = _rows(q_lens, ctxs, S, P, PS, NH)
    out = torch.zeros((B, S, NH, DKV))
    parts = {}
    for L in range(B * n_work):
        b, _g, r = _block_item(L, B, 1)
        w = rows[b]
        if w["split"]:
            if r < w["live"]:
                lo = r * span
                parts.setdefault(b, []).append(_block_state(
                    q[b, :w["n_real"]], pages, layer, table[b],
                    w["q_start"], range(w["n_real"]), lo,
                    min(w["kv_end"], lo + span)))
            continue
        if r >= w["real_tiles"]:
            continue                          # pad tile: zeros
        tile = w["real_tiles"] - 1 - r
        slots = range(tile * TILE_SLOTS,
                      min((tile + 1) * TILE_SLOTS, w["n_real"]))
        stop = min(w["kv_end"], w["q_start"] + slots[-1] + 1)
        num, den, _m = _block_state(q[b, list(slots)], pages, layer,
                                    table[b], w["q_start"], slots, 0, stop)
        out[b, list(slots)] = normalize_softmax_partials(num, den)
    for b, ps_ in parts.items():
        num, den, _m = functools.reduce(merge_softmax_partials, ps_)
        out[b, :rows[b]["n_real"]] = normalize_softmax_partials(num, den)
    return out


def test_mirror_matches_plain_and_pallas():
    P, S = 128, 131
    q_lens = [77, 1, 130, 5, 1, 1, 1]
    _n, splits, per = mla_prefill_splits(len(q_lens), S, NH, P, PS, SMS)
    assert splits > 2
    edge = per * PS
    ctxs = [300, 1, 1000, 5, edge - 1, edge, edge + 1]
    case = _mla_case(7, q_lens, ctxs, S, P)
    q_lat, q_pe, pages, table, positions, total = case
    got = _mirror(*(t(a) for a in case[:2]), t(pages), 1, t(table),
                  t(positions), t(total), 0.1, P)
    plain = mla_prefill_plain(t(q_lat), t(q_pe), t(pages), 1, t(table),
                              t(positions), t(total), 0.1)
    assert float((got - plain).abs().max()) <= F32_TOL
    ref = np.asarray(jmla_prefill(
        jnp.asarray(q_lat), jnp.asarray(q_pe), jnp.asarray(pages), 1,
        jnp.asarray(table), jnp.asarray(positions), jnp.asarray(total), 0.1,
        interpret=True))
    for b, q in enumerate(q_lens):
        # real slots only: the Pallas kernel leaves finite garbage in pads
        err = float(np.max(np.abs(ref[b, :q] - got[b, :q].numpy())))
        assert err <= F32_TOL, (b, err)
        if q < S:
            assert float(got[b, q:].abs().max()) == 0.0


# -- the query arithmetic ------------------------------------------------------


def _bf16_rne_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, round to nearest even (the kernel's
    ``__floats2bfloat162_rn``) for finite values."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


@pytest.mark.parametrize("lat_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sm_scale", [0.0721688, 0.5, 1.0 / 3.0])
def test_in_kernel_query_rounding_is_bit_equal_to_mla_query(lat_dtype,
                                                            sm_scale):
    rng = np.random.default_rng(11)
    lat = rng.normal(size=(3, 5, 16, 128)).astype(np.float32) * 4.0
    # products exactly between two bf16 values: ties go to even
    ties = ((0x3F80 + np.arange(64, dtype=np.uint32)) << 16) | 0x8000
    lat[0, 0, 0, :64] = ties.view(np.float32)
    pe = rng.normal(size=(3, 5, 16, 64)).astype(np.float32)
    q_lat = torch.from_numpy(lat).to(lat_dtype)
    q_pe = torch.from_numpy(pe).to(torch.bfloat16)
    want = mla_query(q_lat, q_pe, sm_scale, torch.bfloat16)
    # the kernel: each value read as f32, times the f32 sm_scale (one
    # rounding), then to nearest even bf16
    scale = np.float32(sm_scale)
    got_lat = _bf16_rne_bits(q_lat.float().numpy() * scale)
    got_pe = _bf16_rne_bits(q_pe.float().numpy() * scale)
    bits = want.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits[..., :128], got_lat)
    assert np.array_equal(bits[..., 128:], got_pe)
