"""The CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: they skip (with the reason) where no CUDA device is
present, as on a CPU-only test host. On the GPU host run them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -m cuda

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
does not have). ``chip_smoke.py`` checks the kernels at the Llama-3.2-3B
and DeepSeek-V2-Lite shapes; these cover the other query-group sizes the
GQA kernels are built for, the latent (MLA) kernels at 16 and 128 heads
(V2-Lite's and V2/V3's), decode at ctx 1, odd chunk lengths, a decode row
inside a mixed batch, and the wrappers' argument checks.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels.decode import (
    paged_decode_attention_stacked, paged_decode_plain)
from dynamo_tpu_torch.ops.kernels.mla_decode import (mla_decode_plain,
                                                     mla_paged_decode_layer,
                                                     mla_paged_decode_stacked)
from dynamo_tpu_torch.ops.kernels.mla_prefill import (
    mla_paged_prefill_stacked, mla_prefill_plain)
from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
from dynamo_tpu_torch.ops.kernels.prefill import (
    paged_prefill_attention_stacked, paged_prefill_plain)
from dynamo_tpu_torch.ops.kernels.ragged import (
    ragged_mixed_attention_stacked, ragged_mixed_plain)

pytestmark = pytest.mark.cuda
TOL_ULPS = 2.0   # per (query, head) row, bf16 ulps of the row's largest value


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, Hq, Hkv, q_lens, ctxs, S, ps=16, seed=0):
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    P = -(-max(ctxs) // ps) + 2
    N = sum(-(-c // ps) for c in ctxs) + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.randn((2, N, 2, Hkv, ps, 128), generator=g, device=dev
                        ).to(torch.bfloat16)
    pages[:, 0] = float("nan")
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    table = np.zeros((B, P), np.int32)
    pos = np.zeros((B, S), np.int32)
    off = 0
    for i, (ql, c) in enumerate(zip(q_lens, ctxs)):
        n = -(-c // ps)
        table[i, :n] = perm[off:off + n]
        off += n
        pos[i, :ql] = np.arange(c - ql, c)
    q = torch.randn((B, S, Hq, 128), generator=g, device=dev
                    ).to(torch.bfloat16)
    return (q, pages, 1, torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev),
            torch.tensor(ctxs, dtype=torch.int32, device=dev), 0.0883883)


def _check(fn, plain, args, q_lens, name, **kw):
    n0 = LAUNCHES[name]
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == n0 + 1
    ref = plain(*args, **kw)
    assert bool(torch.isfinite(out).all())
    for i, ql in enumerate(q_lens):
        err = float(row_ulp_error(out[i, :ql], ref[i, :ql]).max())
        assert err <= TOL_ULPS, (i, err)
        if out.shape[1] > ql:
            assert float(out[i, ql:].float().abs().max()) == 0.0


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 4), (24, 8), (16, 4),
                                    (24, 4), (32, 4)])
def test_decode_groups(dev, Hq, Hkv):
    ctxs = [1, 17, 300, 2049]
    args = _case(dev, Hq, Hkv, [1] * 4, ctxs, 1)
    _check(paged_decode_attention_stacked, paged_decode_plain, args,
           [1] * 4, "paged_decode")
    _check(paged_decode_attention_stacked, paged_decode_plain, args,
           [1] * 4, "paged_decode", window=100, softcap=20.0)


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 4), (24, 8), (32, 4)])
def test_prefill_and_ragged_groups(dev, Hq, Hkv):
    q_lens, ctxs, S = [77, 1, 130, 5], [77, 400, 1000, 5], 130
    args = _case(dev, Hq, Hkv, q_lens, ctxs, S, seed=3)
    for fn, plain, name in (
            (paged_prefill_attention_stacked, paged_prefill_plain,
             "paged_prefill"),
            (ragged_mixed_attention_stacked, ragged_mixed_plain,
             "ragged_mixed")):
        _check(fn, plain, args, q_lens, name)
        _check(fn, plain, args, q_lens, name, window=64, softcap=30.0)


def test_wrappers_reject_what_kernels_do_not_take(dev):
    args = list(_case(dev, 8, 4, [1], [40], 1))
    bad_dh = list(args)
    bad_dh[0] = torch.zeros((1, 1, 8, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention_stacked(*bad_dh)
    bad_dtype = list(args)
    bad_dtype[0] = args[0].float()
    with pytest.raises(TypeError, match="bfloat16"):
        paged_decode_attention_stacked(*bad_dtype)
    bad_table = list(args)
    bad_table[3] = args[3].long()
    with pytest.raises(TypeError, match="int32"):
        paged_prefill_attention_stacked(*bad_table)
    bad_groups = list(_case(dev, 10, 2, [1], [40], 1))
    with pytest.raises(ValueError, match="groups"):
        paged_decode_attention_stacked(*bad_groups)


def _mla_case(dev, nh, q_lens, ctxs, S, dkv=512, dr=64, ps=16, seed=0):
    """Latent cache [2, N, 2, 1, ps, dkv] bf16 (slot 1 zero past dr, page 0
    NaN), float32 q_lat and bf16 q_pe at each row's last q_len positions."""
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    P = -(-max(ctxs) // ps) + 2
    N = sum(-(-c // ps) for c in ctxs) + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.randn((2, N, 2, 1, ps, dkv), generator=g, device=dev
                        ).to(torch.bfloat16)
    pages[:, :, 1, :, :, dr:] = 0
    pages[:, 0] = float("nan")
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    table = np.zeros((B, P), np.int32)
    pos = np.zeros((B, S), np.int32)
    off = 0
    for i, (ql, c) in enumerate(zip(q_lens, ctxs)):
        n = -(-c // ps)
        table[i, :n] = perm[off:off + n]
        off += n
        pos[i, :ql] = np.arange(c - ql, c)
    q_lat = torch.randn((B, S, nh, dkv), generator=g, device=dev)
    q_pe = torch.randn((B, S, nh, dr), generator=g, device=dev
                       ).to(torch.bfloat16)
    return dict(q_lat=q_lat, q_pe=q_pe, pages=pages,
                table=torch.from_numpy(table).to(dev),
                positions=torch.from_numpy(pos).to(dev),
                total=torch.tensor(ctxs, dtype=torch.int32, device=dev))


def _decode_args(c):
    return (c["q_lat"][:, :1].contiguous(), c["q_pe"][:, :1].contiguous(),
            c["pages"], 1, c["table"], c["total"], 0.0721688)


def _prefill_args(c):
    return (c["q_lat"], c["q_pe"], c["pages"], 1, c["table"], c["positions"],
            c["total"], 0.0721688)


@pytest.mark.parametrize("nh", [16, 128])
def test_mla_decode(dev, nh):
    c = _mla_case(dev, nh, [1] * 4, [1, 17, 300, 2049], 1)
    args = _decode_args(c)
    _check(mla_paged_decode_stacked, mla_decode_plain, args, [1] * 4,
           "mla_decode")
    # the per-layer variant: the same kernel on a one-layer view
    one = mla_paged_decode_layer(args[0], args[1], c["pages"][1], *args[4:])
    assert torch.equal(one, mla_paged_decode_stacked(*args))


@pytest.mark.parametrize("nh", [16, 128])
def test_mla_prefill_odd_chunks_and_a_decode_row(dev, nh):
    """Odd chunk lengths over prefixes, a row of 5, and a decode row
    (q_len 1, its 130 pad slots skipped) in one mixed batch; S = 131 is odd,
    so the last 2-token query tile is ragged."""
    c = _mla_case(dev, nh, [77, 1, 130, 5], [77, 400, 1000, 5], 131, seed=3)
    _check(mla_paged_prefill_stacked, mla_prefill_plain, _prefill_args(c),
           [77, 1, 130, 5], "mla_prefill")


def test_mla_wrappers_reject_what_kernels_do_not_take(dev):
    good = _mla_case(dev, 16, [1], [40], 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        mla_paged_decode_stacked(*_decode_args(
            _mla_case(dev, 16, [1], [40], 1, dkv=192)))
    with pytest.raises(ValueError, match="page_size"):
        mla_paged_prefill_stacked(*_prefill_args(
            _mla_case(dev, 16, [1], [40], 1, ps=12)))
    with pytest.raises(ValueError, match="num_heads"):
        mla_paged_decode_stacked(*_decode_args(
            _mla_case(dev, 8, [1], [40], 1)))
    args = list(_decode_args(good))
    args[2] = good["pages"].float()
    with pytest.raises(TypeError, match="bfloat16"):
        mla_paged_decode_stacked(*args)
    args = list(_prefill_args(good))
    args[4] = good["table"].long()
    with pytest.raises(TypeError, match="int32"):
        mla_paged_prefill_stacked(*args)
