"""The CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: they skip (with the reason) where no CUDA device is
present, as on a CPU-only test host. On the GPU host run them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -m cuda

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
does not have). ``chip_smoke.py`` checks the kernels at the Llama-3.2-3B
shapes; these cover the other query-group sizes the kernels are built for,
odd chunk lengths, and the wrappers' argument checks.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels.decode import (
    paged_decode_attention_stacked, paged_decode_plain)
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
