"""Split-KV (flash-decoding) arithmetic of the paged decode kernel, on the CPU.

The kernel (``ops/kernels/csrc/decode.cu``) splits each row's page table
into ``decode_splits`` ranges of whole pages, computes an un-normalised
online-softmax state per range and merges the states. Here, from numpy
inputs:

- the port's ``merge_softmax_partials`` / ``normalize_softmax_partials``
  equal the JAX package's (``dynamo_tpu/ops/attention.py``) on the same
  partials within 1e-6 (float32, the same elementwise operations), and the
  ``return_partials`` form of ``_attend_blockwise`` equals JAX's within
  2e-5 (its products sum in another order on XLA's CPU dot);
- ``decode_splits`` cuts the table into whole pages that cover it, from
  shapes alone;
- partials over the wrapper's split ranges, merged and normalised, equal
  ``plain_paged_attention`` in float32 within 2e-5 (only the order of the
  float32 sums differs), for contexts of 1, ps - 1, a split boundary and
  one either side of it, and the full table; with a window that starts
  inside a split too.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jattn
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops.kernels.decode import (SPLIT_MAX_PAGES,
                                                 SPLIT_MIN_POSITIONS,
                                                 decode_splits)
from dynamo_tpu_torch.ops.kernels.plain import plain_paged_attention

torch.set_num_threads(2)

MERGE_TOL = 1e-6
F32_TOL = 2e-5
PS, HQ, HKV, DH = 16, 4, 2, 128
P = 4096 // PS
SMS = 132


def _partials(rng, shape, dead):
    num = rng.normal(size=shape + (DH,)).astype(np.float32)
    den = rng.uniform(0.5, 20.0, size=shape).astype(np.float32)
    mx = rng.normal(scale=4.0, size=shape).astype(np.float32)
    num[dead], den[dead], mx[dead] = 0.0, 0.0, jattn.NEG_INF
    return num, den, mx


def test_merge_and_normalize_match_jax():
    rng = np.random.default_rng(0)
    shape = (3, 4, 5)
    a = _partials(rng, shape, rng.random(shape) < 0.3)
    b = _partials(rng, shape, rng.random(shape) < 0.3)
    b[0][0, 0, 0], b[1][0, 0, 0], b[2][0, 0, 0] = 0.0, 0.0, jattn.NEG_INF
    a[0][0, 0, 0], a[1][0, 0, 0], a[2][0, 0, 0] = 0.0, 0.0, jattn.NEG_INF
    jm = jattn.merge_softmax_partials(tuple(map(jnp.asarray, a)),
                                      tuple(map(jnp.asarray, b)))
    tm = tattn.merge_softmax_partials(tuple(map(torch.from_numpy, a)),
                                      tuple(map(torch.from_numpy, b)))
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=MERGE_TOL,
                                   atol=MERGE_TOL)
    jo = jattn.normalize_softmax_partials(jm[0], jm[1])
    to = tattn.normalize_softmax_partials(tm[0], tm[1])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=MERGE_TOL,
                               atol=MERGE_TOL)
    assert float(to[0, 0, 0].abs().max()) == 0.0   # both dead: zeros


def _cache(seed, ctxs):
    rng = np.random.default_rng(seed)
    N = sum(-(-c // PS) for c in ctxs) + 1
    pages = rng.normal(size=(1, N, 2, HKV, PS, DH)).astype(np.float32)
    table = np.zeros((len(ctxs), P), np.int32)
    perm = rng.permutation(np.arange(1, N))
    off = 0
    for i, c in enumerate(ctxs):
        n = -(-c // PS)
        table[i, :n] = perm[off:off + n]
        off += n
    q = rng.normal(size=(len(ctxs), 1, HQ, DH)).astype(np.float32)
    return q, pages, table, np.asarray(ctxs, np.int32)


def test_blockwise_partials_match_jax():
    q, pages, table, total = _cache(1, [5, 40, 100])
    B = len(total)
    chunk = 2
    positions = np.stack([total - 1 - i for i in range(3)], axis=1)
    qg = np.repeat(q, 3, axis=1).reshape(B, 3, HKV, HQ // HKV, DH)
    table = table[:, :8]

    def gather(mod, layer, tbl):
        def chunk_kv(c):
            if mod is jattn:      # c is traced inside JAX's fori_loop
                sl = jax.lax.dynamic_slice_in_dim(tbl, c * chunk, chunk, 1)
            else:
                sl = tbl[:, c * chunk:(c + 1) * chunk]
            g = layer[sl]
            return (mod._gathered_to_bhtd(g[:, :, 0]),
                    mod._gathered_to_bhtd(g[:, :, 1]))
        return chunk_kv

    jout = jattn._attend_blockwise(
        jnp.asarray(qg), gather(jattn, jnp.asarray(pages[0]),
                                jnp.asarray(table)),
        8, PS, chunk, jnp.asarray(positions), jnp.asarray(total), 0.09,
        window=30, return_partials=True)
    tout = tattn._attend_blockwise(
        torch.from_numpy(qg), gather(tattn, torch.from_numpy(pages[0]),
                                     torch.from_numpy(table).long()),
        8, PS, chunk, torch.from_numpy(positions), torch.from_numpy(total),
        0.09, window=30, return_partials=True)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("B,Hkv,P_,ps", [
    (1, 8, 256, 16), (8, 8, 256, 16), (32, 8, 256, 16), (128, 8, 256, 16),
    (1, 1, 8192, 16), (3, 4, 3, 16), (2, 8, 100, 8), (1, 2, 1, 64),
    (64, 16, 2048, 32), (1, 8, 0, 16)])
def test_decode_splits_whole_pages_cover_the_table(B, Hkv, P_, ps):
    splits, per = decode_splits(B, Hkv, P_, ps, SMS)
    assert splits >= 1 and 0 <= per <= SPLIT_MAX_PAGES
    assert splits * per >= P_                 # the splits cover the table
    assert (splits - 1) * per < max(P_, 1)    # none starts past it
    if splits > 1:
        assert per * ps >= SPLIT_MIN_POSITIONS or P_ > splits * (
            SPLIT_MAX_PAGES - 1)
    # shapes only: the lengths are not an argument, so they cannot move it
    assert list(inspect.signature(decode_splits).parameters) == [
        "B", "Hkv", "P", "ps", "num_sms"]


def _split_kv(q, pages, table, total, window=None):
    """Partials over the wrapper's split ranges, merged and normalised:
    [B, 1, Hq, Dh]."""
    B = len(total)
    splits, per = decode_splits(B, HKV, P, PS, SMS)
    span = per * PS
    tbl = torch.nn.functional.pad(torch.from_numpy(table).long(),
                                  (0, splits * per - P))
    layer = torch.from_numpy(pages[0])
    qg = torch.from_numpy(q).reshape(B, 1, HKV, HQ // HKV, DH)
    tot = torch.from_numpy(total).long()
    parts = []
    for s in range(splits):
        sl = tbl[:, s * per:(s + 1) * per]

        def chunk_kv(c, sl=sl):
            g = layer[sl]
            return (tattn._gathered_to_bhtd(g[:, :, 0]),
                    tattn._gathered_to_bhtd(g[:, :, 1]))
        # the split's positions, shifted to start at 0
        parts.append(tattn._attend_blockwise(
            qg, chunk_kv, per, PS, per, (tot - 1 - s * span)[:, None],
            tot - s * span, DH ** -0.5, window=window, return_partials=True))
    num, den, _mx = functools.reduce(tattn.merge_softmax_partials, parts)
    out = tattn.normalize_softmax_partials(num, den)     # [B, Hq, 1, Dh]
    return out.permute(0, 2, 1, 3), splits, span


@pytest.mark.parametrize("window", [None, 300, 133])
def test_split_partials_merged_equal_plain(window):
    splits, per = decode_splits(6, HKV, P, PS, SMS)
    edge = per * PS                         # the first split boundary
    assert splits > 1
    ctxs = [1, PS - 1, edge - 1, edge, edge + 1, P * PS]
    if window:
        # a window whose start lies inside a split, one boundary in
        ctxs = [1, PS - 1, edge + window // 2, 2 * edge + 7, 1000, P * PS]
    q, pages, table, total = _cache(2, ctxs)
    out, got_splits, span = _split_kv(q, pages, table, total, window)
    assert got_splits == splits and span == edge
    ref = plain_paged_attention(
        torch.from_numpy(q), torch.from_numpy(pages), 0,
        torch.from_numpy(table), torch.from_numpy(total).long() - 1,
        torch.from_numpy(total), DH ** -0.5, window=window)
    err = float((out - ref).abs().max())
    assert err <= F32_TOL, err
    if window:
        # the window really starts inside a split for these rows
        starts = [c - window for c in ctxs if c > window]
        assert any(st % edge for st in starts)
