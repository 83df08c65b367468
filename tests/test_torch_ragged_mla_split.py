"""Split-KV arithmetic of the ragged mixed kernel's short rows and of the
MLA decode kernel, on the CPU.

The ragged kernel (``ops/kernels/csrc/prefill_sm90.cu``, entry
``ragged_mixed_launch``) spreads each row of at most ``SPLIT_Q_CAP`` real
queries over ``ragged_splits`` kv ranges of whole pages; the MLA decode
kernel (``csrc/mla_decode.cu``) spreads every row over
``mla_decode_splits`` ranges. Each range gives an un-normalised
online-softmax state (num, den, max), empty ranges a dead one, and a merge
pass finishes the row with ``merge_softmax_partials`` /
``normalize_softmax_partials``. Here, from numpy inputs in float32 (no
bf16 rounding of p, so only the order of the float32 sums differs: within
2e-5):

- both split functions cut the table into whole pages that cover it, from
  shapes alone (their signatures hold no lengths);
- a Python mirror of the MLA split ranges, merged, equals
  ``mla_decode_plain`` and the JAX ``mla_paged_decode_stacked`` in
  interpret mode, for contexts of 1, a split boundary and one either side
  of it, and the full table;
- a mirror of the ragged kernel's short-row split ranges (the other rows
  through the plain version) equals the Pallas ragged kernel in interpret
  mode on a q_len 7/1/5 mix with decode rows on split boundaries, with and
  without a window and softcap.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas.mla_decode import (
    mla_paged_decode_stacked as jmla_decode)
from dynamo_tpu.ops.pallas.ragged import (
    ragged_mixed_attention_stacked as pallas_ragged)
from dynamo_tpu_torch.ops.attention import (merge_softmax_partials,
                                            normalize_softmax_partials)
from dynamo_tpu_torch.ops.kernels.mla_decode import (
    SPLIT_MAX_PAGES as MLA_MAX_PAGES, mla_decode_plain, mla_decode_splits)
from dynamo_tpu_torch.ops.kernels.plain import NEG_INF, mla_query
from dynamo_tpu_torch.ops.kernels.ragged import (SPLIT_Q_CAP,
                                                 ragged_mixed_plain,
                                                 ragged_splits)

torch.set_num_threads(2)

F32_TOL = 2e-5
SMS = 132


def t(a):
    return torch.from_numpy(np.array(a))


# -- the split functions -------------------------------------------------------


@pytest.mark.parametrize("B,nh,P,ps", [
    (1, 16, 256, 16), (8, 16, 256, 16), (32, 16, 256, 16), (32, 128, 256, 16),
    (1, 16, 8192, 16), (3, 16, 3, 16), (2, 32, 100, 8), (1, 16, 1, 64),
    (128, 16, 4096, 8), (1, 16, 0, 16)])
def test_mla_decode_splits_whole_pages_cover_the_table(B, nh, P, ps):
    splits, per = mla_decode_splits(B, nh, P, ps, SMS)
    assert splits >= 1 and 0 <= per <= MLA_MAX_PAGES
    assert splits * per >= P                  # the splits cover the table
    assert (splits - 1) * per < max(P, 1)     # none starts past it
    # shapes only: the lengths are not an argument, so they cannot move it
    assert list(inspect.signature(mla_decode_splits).parameters) == [
        "B", "nh", "P", "ps", "num_sms"]


@pytest.mark.parametrize("B,S,Hkv,G,P,ps", [
    (8, 512, 8, 3, 256, 16), (32, 512, 8, 3, 256, 16), (1, 1, 8, 3, 256, 16),
    (4, 131, 4, 8, 100, 8), (2, 700, 2, 1, 64, 64), (6, 40, 4, 6, 3, 16),
    (1, 16, 1, 2, 0, 16)])
def test_ragged_splits_whole_pages_cover_the_table(B, S, Hkv, G, P, ps):
    n_work, splits, per = ragged_splits(B, S, Hkv, G, P, ps, SMS)
    n_tiles = -(-S // (128 // G))
    # every long row's tiles and every short row's splits have a block
    assert n_work == max(n_tiles, splits)
    assert splits >= 1 and per >= 0
    assert splits * per >= P and (splits - 1) * per < max(P, 1)
    # the partial scratch stays a few MB at the mixed shape's width
    scratch = B * Hkv * splits * SPLIT_Q_CAP * G * (128 + 2) * 4
    if (B, S, Hkv, G) == (32, 512, 8, 3):
        assert scratch < 4 * 2 ** 20
    assert list(inspect.signature(ragged_splits).parameters) == [
        "B", "S", "Hkv", "G", "P", "ps", "num_sms"]


# -- MLA decode ---------------------------------------------------------------

NH, DKV, DR, PS = 4, 128, 16, 8     # tests/test_deepseek.py:450's geometry


def _mla_cache(seed, ctxs, P):
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    N = sum(-(-c // PS) for c in ctxs) + 1
    pages = rng.normal(size=(2, N, 2, 1, PS, DKV)).astype(np.float32)
    pages[:, :, 1, :, :, DR:] = 0.0
    table = np.zeros((B, P), np.int32)
    perm = rng.permutation(np.arange(1, N))
    off = 0
    for i, c in enumerate(ctxs):
        n = -(-c // PS)
        table[i, :n] = perm[off:off + n]
        off += n
    q_lat = rng.normal(size=(B, 1, NH, DKV)).astype(np.float32)
    q_pe = rng.normal(size=(B, 1, NH, DR)).astype(np.float32)
    return q_lat, q_pe, pages, table, np.asarray(ctxs, np.int32)


def _mla_split_mirror(q_lat, q_pe, pages, layer, table, total, sm_scale,
                      splits, per):
    """The kernel's arithmetic: per split, positions [s * per * ps,
    + per * ps) clipped to the context; a (num, den, max) state per (row,
    head); an empty range is dead; the states merged and normalised."""
    q = mla_query(q_lat, q_pe, sm_scale, pages.dtype).float()[:, 0]
    B, P = table.shape
    span = per * PS
    parts = []
    for s in range(splits):
        num = torch.zeros((B, NH, DKV))
        den = torch.zeros((B, NH))
        mx = torch.full((B, NH), NEG_INF)
        for b in range(B):
            ctx = min(int(total[b]), P * PS)
            lo, hi = s * span, min(s * span + span, ctx)
            if lo >= hi:
                continue
            pos = torch.arange(lo, hi)
            pg = table[b][pos // PS].long()
            ckv = pages[layer, pg, 0, 0, pos % PS].float()
            kpe = pages[layer, pg, 1, 0, pos % PS, :DR].float()
            sc = q[b] @ torch.cat([ckv, kpe], dim=-1).T       # [nh, T]
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[:, None])
            num[b] = p.to(pages.dtype).float() @ ckv
            den[b], mx[b] = p.sum(dim=-1), m
        parts.append((num, den, mx))
    num, den, _ = functools.reduce(merge_softmax_partials, parts)
    return normalize_softmax_partials(num, den)[:, None]      # [B,1,nh,dkv]


def test_mla_split_mirror_matches_plain_and_pallas():
    P = 64
    B = 5
    splits, per = mla_decode_splits(B, NH, P, PS, SMS)
    assert splits > 2
    edge = per * PS
    ctxs = [1, edge - 1, edge, edge + 1, P * PS]
    q_lat, q_pe, pages, table, total = _mla_cache(0, ctxs, P)
    got = _mla_split_mirror(t(q_lat), t(q_pe), t(pages), 1, t(table),
                            t(total), 0.1, splits, per)
    plain = mla_decode_plain(t(q_lat), t(q_pe), t(pages), 1, t(table),
                             t(total), 0.1)
    assert float((got - plain).abs().max()) <= F32_TOL
    ref = jmla_decode(jnp.asarray(q_lat), jnp.asarray(q_pe),
                      jnp.asarray(pages), 1, jnp.asarray(table),
                      jnp.asarray(total), 0.1, interpret=True)
    err = float(np.max(np.abs(np.asarray(ref) - got.numpy())))
    assert err <= F32_TOL, err


# -- ragged mixed: the short rows' splits ---------------------------------------

HQ, HKV, DH, RPS = 4, 2, 128, 8


def _ragged_case(seed, q_lens, ctxs, S, P):
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    N = sum(-(-c // RPS) for c in ctxs) + 1
    pages = rng.normal(size=(2, N, 2, HKV, RPS, DH)).astype(np.float32)
    table = np.zeros((B, P), np.int32)
    perm = rng.permutation(np.arange(1, N))
    off = 0
    q = np.zeros((B, S, HQ, DH), np.float32)
    positions = np.zeros((B, S), np.int32)
    for i, (ql, c) in enumerate(zip(q_lens, ctxs)):
        n = -(-c // RPS)
        table[i, :n] = perm[off:off + n]
        off += n
        q[i, :ql] = rng.normal(size=(ql, HQ, DH))
        positions[i, :ql] = np.arange(c - ql, c)
    return q, pages, table, positions, np.asarray(ctxs, np.int32)


def _ragged_split_row(q, pages, layer, table_row, ctx, sm_scale, splits,
                      per, window, softcap):
    """One short row (q_len 1, the query at ctx - 1) over the kernel's
    split ranges: positions [s * per * ps, + per * ps) clipped to the
    context and, with a window, to ctx - window onward; -> [Hq, Dh]."""
    G = HQ // HKV
    span = per * RPS
    qs = (q * sm_scale).to(q.dtype).float().reshape(HKV, G, DH)
    first = max(ctx - window, 0) if window else 0
    parts = []
    for s in range(splits):
        num = torch.zeros((HKV, G, DH))
        den = torch.zeros((HKV, G))
        mx = torch.full((HKV, G), NEG_INF)
        lo, hi = max(first, s * span), min(ctx, s * span + span)
        if lo < hi:
            pos = torch.arange(lo, hi)
            pg = table_row[pos // RPS].long()
            k = pages[layer, pg, 0, :, pos % RPS].float()    # [T, Hkv, Dh]
            v = pages[layer, pg, 1, :, pos % RPS].float()
            sc = torch.einsum("ngd,tnd->ngt", qs, k)
            if softcap:
                sc = torch.tanh(sc / softcap) * softcap
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            num = torch.einsum("ngt,tnd->ngd", p.to(pages.dtype).float(), v)
            den, mx = p.sum(dim=-1), m
        parts.append((num, den, mx))
    num, den, _ = functools.reduce(merge_softmax_partials, parts)
    return normalize_softmax_partials(num, den).reshape(HQ, DH)


@pytest.mark.parametrize("window,softcap", [(None, None), (100, 20.0)])
def test_ragged_split_mirror_matches_pallas(window, softcap):
    P, S = 128, 16
    q_lens0 = [7, 1, 5]
    B = 6
    n_work, splits, per = ragged_splits(B, S, HKV, HQ // HKV, P, RPS, SMS)
    assert splits > 2 and n_work >= splits
    edge = per * RPS
    # the q_len 7/1/5 mix, then decode rows on a split boundary, one past
    # it and at the full table
    q_lens = q_lens0 + [1, 1, 1]
    ctxs = [300, edge + 1, 5, edge, 2 * edge + 1, P * RPS]
    q, pages, table, positions, total = _ragged_case(3, q_lens, ctxs, S, P)
    ref = np.asarray(pallas_ragged(
        jnp.asarray(q), jnp.asarray(pages), 1, jnp.asarray(table),
        jnp.asarray(positions), jnp.asarray(total), 0.09, window=window,
        softcap=softcap, interpret=True))
    got = ragged_mixed_plain(t(q), t(pages), 1, t(table), t(positions),
                             t(total), 0.09, window, softcap).clone()
    n_split = 0
    for b, ql in enumerate(q_lens):
        if 1 <= ql <= SPLIT_Q_CAP:
            got[b, 0] = _ragged_split_row(t(q[b, 0]), t(pages), 1,
                                          t(table[b]), ctxs[b], 0.09,
                                          splits, per, window, softcap)
            n_split += 1
    assert n_split == 4
    for b, ql in enumerate(q_lens):
        err = float(np.max(np.abs(ref[b, :ql] - got[b, :ql].numpy())))
        assert err <= F32_TOL, (b, err)
        # pad slots: zeros in the port (the merge writes them)
        assert float(got[b, ql:].abs().max()) == 0.0 if ql < S else True
