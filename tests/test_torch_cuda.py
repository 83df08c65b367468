"""The CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: they skip (with the reason) where no CUDA device is
present, as on a CPU-only test host. On the GPU host run them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -m cuda

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
does not have). ``chip_smoke.py`` checks the kernels at the Llama-3.2-3B
and DeepSeek-V2-Lite shapes; these cover the other query-group sizes the
GQA kernels are built for, the latent (MLA) kernels at 16 and 128 heads
(V2-Lite's and V2/V3's), decode at ctx 1, odd chunk lengths, a decode row
inside a mixed batch, and the wrappers' argument checks. For the split-KV
decode kernel: one split, many splits, contexts ending on and either side
of a split boundary, a window starting inside a split; for the TMA + wgmma
prefill kernel: S not a multiple of the query tile, pad tiles, a prefix
whose end is not a multiple of the 64-position kv chunk, window + softcap,
and page sizes whose TMA boxes are 8, 16 and 64 rows, and the rows of
``chip_smoke.py``'s prefix-hit case that sit past 1 ulp of the plain
version held within 1 ulp of the kernel's own chunked rounding. For the
ragged
kernel's split-KV path (short rows spread over several blocks, then
merged): every G, decode rows whose contexts end on and either side of a
split boundary and fill the table, window + softcap, and rows with q_len
at the split cap and one past it beside a long chunk. For the split-KV MLA
decode kernel: B = 1, 8 and 32 at 16 and 32 heads, ctx 1, the split
boundaries and a full table, page sizes whose TMA boxes are 8, 16 and 32
rows, and latent widths of 128, 256 and 512. For the MLA prefill kernel
(4-slot wgmma tiles, TMA ring, split-KV decode rows): 16 and 128 heads at
S = 131 (a ragged last tile), decode rows whose contexts end on and either
side of a split boundary in a mixed batch, page sizes 8/24/64, latent and
rope widths 128/16, 256/128, 384/0 and 512/64, rings of 2, 3 and 4
stages (the depth a geometry's shared memory allows), bf16 and f32
queries, and its refusals (a latent wider than its register-held
output, half-precision or strided queries). For ``TorchEngine``'s fused
decode block (B1's and B4's engines): a graph replay equal bit for bit to
the same block run eagerly, replays counted as launches, the fetch of one
step waiting on that step's event and not on the stream, and a fused
serve token for token as the per-step serve.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels._wrap import GROUPS
from dynamo_tpu_torch.ops.kernels.decode import (
    decode_splits, paged_decode_attention_stacked, paged_decode_plain)
from dynamo_tpu_torch.ops.kernels.mla_decode import (mla_decode_plain,
                                                     mla_decode_splits,
                                                     mla_paged_decode_layer,
                                                     mla_paged_decode_stacked)
from dynamo_tpu_torch.ops.kernels._wrap import mla_prefill_stages
from dynamo_tpu_torch.ops.kernels.mla_prefill import (
    mla_paged_prefill_stacked, mla_prefill_plain, mla_prefill_splits)
from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
from dynamo_tpu_torch.ops.kernels.prefill import (
    paged_prefill_attention_stacked, paged_prefill_plain)
from dynamo_tpu_torch.ops.kernels.ragged import (
    SPLIT_Q_CAP, ragged_mixed_attention_stacked, ragged_mixed_plain,
    ragged_splits)

pytestmark = pytest.mark.cuda
TOL_ULPS = 2.0   # per (query, head) row, bf16 ulps of the row's largest value


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, Hq, Hkv, q_lens, ctxs, S, ps=16, seed=0, P=None):
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    P = P or -(-max(ctxs) // ps) + 2
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


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("G", GROUPS)
def test_decode_split_boundaries(dev, G):
    """Contexts ending one before, on and one after a split boundary, a
    full table, and a window whose start lies inside a split."""
    B, Hkv, P, ps = 4, 8, 256, 16
    splits, per = decode_splits(B, Hkv, P, ps, _sms(dev))
    assert splits > 1
    edge = per * ps
    args = _case(dev, G * Hkv, Hkv, [1] * B,
                 [edge - 1, edge, edge + 1, P * ps], 1, P=P, seed=G)
    _check(paged_decode_attention_stacked, paged_decode_plain, args,
           [1] * B, "paged_decode")
    window = edge // 2 + 3          # starts inside the split before the last
    _check(paged_decode_attention_stacked, paged_decode_plain, args,
           [1] * B, "paged_decode", window=window, softcap=25.0)


@pytest.mark.parametrize("ps", [16, 24, 128])
def test_decode_one_split_and_many(dev, ps):
    """A narrow table takes one split (the kernel writes bf16 itself); B=1
    at ctx 4096 takes many (the merge kernel runs)."""
    one = _case(dev, 24, 8, [1] * 3, [1, ps - 1, 100], 1, ps=ps, seed=1,
                P=-(-max(100, ps - 1) // ps))
    assert decode_splits(3, 8, one[3].shape[1], ps, _sms(dev))[0] == 1
    _check(paged_decode_attention_stacked, paged_decode_plain, one, [1] * 3,
           "paged_decode")
    many = _case(dev, 24, 8, [1], [4096], 1, ps=ps, seed=2)
    assert decode_splits(1, 8, many[3].shape[1], ps, _sms(dev))[0] > 8
    _check(paged_decode_attention_stacked, paged_decode_plain, many, [1],
           "paged_decode")
    _check(paged_decode_attention_stacked, paged_decode_plain, many, [1],
           "paged_decode", window=1000)


@pytest.mark.parametrize("G", GROUPS)
def test_prefill_tiles_pads_and_prefix(dev, G):
    """S = 131 is not a multiple of any query tile (128 // G slots); rows
    of q_len 1 and 5 leave whole pad tiles (zeros, no kv traffic); the
    130-token chunk over an 870-token prefix starts mid kv chunk."""
    q_lens, ctxs, S = [77, 1, 130, 5], [77, 400, 1000, 5], 131
    args = _case(dev, G * 4, 4, q_lens, ctxs, S, seed=10 + G)
    _check(paged_prefill_attention_stacked, paged_prefill_plain, args,
           q_lens, "paged_prefill")
    _check(paged_prefill_attention_stacked, paged_prefill_plain, args,
           q_lens, "paged_prefill", window=100, softcap=30.0)


def test_prefill_prefix_hit_rows_round_as_chunked(dev):
    """``chip_smoke.py`` phase 2's B2 case (B=4 S=512 with prefix hits,
    Llama-3.2-3B's heads), rebuilt from the same draws: the rows where the
    kernel is past 1 ulp from its plain version are a chunking difference.
    The kernel rounds p to bf16 against the running max of 64-position
    chunks (as the TPU kernel does per chunk); the plain version rounds
    against the row's final max. Against ``online_attention_rows``, which
    rounds as the kernel does, every real row is within 1 ulp."""
    import chip_smoke as cs
    case = next(c for name, label, c, _S, _d in cs.kernel_cases(
        np.random.default_rng(0)) if label == cs.PREFILL_PREFIX_LABEL)
    worst, flagged = cs.prefill_rows_report(case, 512)
    # the rows of chip run 1 of PR 6 (NVIDIA H100 80GB HBM3): 2.000, 1.062
    # and 1.062 ulps from the plain version, <= 0.016 from the chunked
    # rounding
    assert {(b, slot, head) for b, slot, head, *_ in flagged} == {
        (1, 490, 9), (2, 265, 7), (2, 48, 17)}, flagged
    assert worst["kernel_vs_chunked"] <= 1.0, worst
    assert worst["kernel_vs_plain"] <= TOL_ULPS, worst
    assert all(kp <= TOL_ULPS and km <= 1.0
               for _b, _s, _h, _p, kp, km, _pm in flagged), flagged


@pytest.mark.parametrize("ps", [8, 24, 64, 128])
def test_prefill_page_sizes(dev, ps):
    """TMA boxes of gcd(ps, 64) rows: 8 (ps 8, 24), 64 (ps 64, 128); a
    context ending inside a page zeroes that page's stale V rows."""
    q_lens, ctxs, S = [200, 64, 33], [200, 700, 1201], 200
    args = _case(dev, 24, 8, q_lens, ctxs, S, ps=ps, seed=ps)
    _check(paged_prefill_attention_stacked, paged_prefill_plain, args,
           q_lens, "paged_prefill")
    _check(paged_prefill_attention_stacked, paged_prefill_plain, args,
           q_lens, "paged_prefill", window=150)


@pytest.mark.parametrize("G", GROUPS)
def test_ragged_split_rows(dev, G):
    """Decode rows whose contexts end one before, on and one after a split
    boundary and at the full table, a row of q_len at the split cap and one
    of cap + 1 (tiles, no split), beside a chunk over a prefix."""
    Hkv, P, ps, S = 4, 256, 16, 40
    B = 7
    n_work, splits, per = ragged_splits(B, S, Hkv, G, P, ps, _sms(dev))
    assert splits > 1 and n_work >= splits
    edge = per * ps
    q_lens = [1, 1, 1, 1, SPLIT_Q_CAP, SPLIT_Q_CAP + 1, S - 3]
    ctxs = [edge - 1, edge, edge + 1, P * ps, 2 * edge + 5, 700, 900]
    args = _case(dev, G * Hkv, Hkv, q_lens, ctxs, S, P=P, seed=20 + G)
    _check(ragged_mixed_attention_stacked, ragged_mixed_plain, args, q_lens,
           "ragged_mixed")
    # a window starting inside a split, with softcap
    _check(ragged_mixed_attention_stacked, ragged_mixed_plain, args, q_lens,
           "ragged_mixed", window=edge // 2 + 3, softcap=30.0)


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


def _mla_case(dev, nh, q_lens, ctxs, S, dkv=512, dr=64, ps=16, seed=0,
              P=None):
    """Latent cache [2, N, 2, 1, ps, dkv] bf16 (slot 1 zero past dr, page 0
    NaN), float32 q_lat and bf16 q_pe at each row's last q_len positions."""
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    P = P or -(-max(ctxs) // ps) + 2
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


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("nh", [16, 32])
def test_mla_decode_splits(dev, B, nh):
    """ctx 1, contexts ending one before, on and one after a split
    boundary, and a full table, at B = 1, 8, 32 (the split count falls as B
    grows); at B = 1 one call per context."""
    P, ps = 256, 16
    splits, per = mla_decode_splits(B, nh, P, ps, _sms(dev))
    assert splits > 1
    edge = per * ps
    cases = [1, edge - 1, edge, edge + 1, P * ps]
    ctxs = [cases[i % len(cases)] for i in range(B)] if B > 1 else [P * ps]
    c = _mla_case(dev, nh, [1] * B, ctxs, 1, P=P, seed=B + nh)
    _check(mla_paged_decode_stacked, mla_decode_plain, _decode_args(c),
           [1] * B, "mla_decode")
    if B == 1:
        for ctx in cases[:-1]:
            c = _mla_case(dev, nh, [1], [ctx], 1, P=P, seed=ctx)
            _check(mla_paged_decode_stacked, mla_decode_plain,
                   _decode_args(c), [1], "mla_decode")


@pytest.mark.parametrize("ps,dkv,dr", [(8, 512, 64), (24, 512, 64),
                                       (64, 512, 64), (16, 128, 16),
                                       (16, 256, 128)])
def test_mla_decode_page_sizes_and_widths(dev, ps, dkv, dr):
    """TMA boxes of gcd(ps, 32) rows (8, 8, 32, 16), contexts ending
    inside a page and inside a box, and latents of 2, 4 and 8 register
    tiles a warp with rope widths below, at and above one 64-column box."""
    ctxs = [1, ps - 1, 3 * ps + 5, 1000, 2049]
    c = _mla_case(dev, 16, [1] * 5, ctxs, 1, dkv=dkv, dr=dr, ps=ps,
                  seed=ps + dkv)
    _check(mla_paged_decode_stacked, mla_decode_plain, _decode_args(c),
           [1] * 5, "mla_decode")


@pytest.mark.parametrize("nh", [16, 128])
def test_mla_prefill_odd_chunks_and_a_decode_row(dev, nh):
    """Odd chunk lengths over prefixes, a row of 5, and a decode row
    (q_len 1, its 130 pad slots skipped) in one mixed batch; S = 131 is odd,
    so the last 4-slot query tile is ragged (slots 128-130 and one past
    S)."""
    c = _mla_case(dev, nh, [77, 1, 130, 5], [77, 400, 1000, 5], 131, seed=3)
    _check(mla_paged_prefill_stacked, mla_prefill_plain, _prefill_args(c),
           [77, 1, 130, 5], "mla_prefill")


@pytest.mark.parametrize("nh", [16, 128])
def test_mla_prefill_split_rows(dev, nh):
    """Decode rows (the split-KV path) whose contexts are 1, end one
    before, on and one after a split boundary and fill the table, beside
    chunks of 77 and 130 over prefixes and a row of 5, at S = 131."""
    P, ps, S = 256, 16, 131
    q_lens = [77, 1, 130, 5, 1, 1, 1, 1]
    B = len(q_lens)
    n_work, splits, per = mla_prefill_splits(B, S, nh, P, ps, _sms(dev))
    assert splits > 2 and n_work >= splits
    edge = per * ps
    ctxs = [77, 1, 1000, 5, edge - 1, edge, edge + 1, P * ps]
    c = _mla_case(dev, nh, q_lens, ctxs, S, P=P, seed=nh)
    _check(mla_paged_prefill_stacked, mla_prefill_plain, _prefill_args(c),
           q_lens, "mla_prefill")


@pytest.mark.parametrize("ps,dkv,dr", [(8, 512, 64), (24, 512, 64),
                                       (64, 512, 64), (16, 128, 16),
                                       (16, 256, 128), (16, 384, 0)])
def test_mla_prefill_page_sizes_and_widths(dev, ps, dkv, dr):
    """TMA boxes of gcd(ps, 32) rows (8, 8, 32, 16), contexts ending inside
    a page and inside a box, latents of 1 to 4 output tiles a warpgroup and
    rope widths below, at and above one 64-column box (and none)."""
    q_lens, ctxs, S = [40, 1, 9, 1], [40, ps - 1, 3 * ps + 5, 1000], 40
    c = _mla_case(dev, 16, q_lens, ctxs, S, dkv=dkv, dr=dr, ps=ps,
                  seed=ps + dkv)
    _check(mla_paged_prefill_stacked, mla_prefill_plain, _prefill_args(c),
           q_lens, "mla_prefill")


@pytest.mark.parametrize("dkv,dr,stages", [(512, 256, 2), (384, 384, 2),
                                           (512, 128, 3), (512, 64, 4)])
def test_mla_prefill_rings(dev, dkv, dr, stages):
    """Every ring depth the kernel may run, each at a geometry whose shared
    memory allows no deeper ring, over odd chunk counts (the last pair's
    second warpgroup has no chunk) and a decode row; at 2 and 3 stages
    the query's rows take more than one staging round."""
    assert mla_prefill_stages(dkv, dr) == stages
    q_lens, ctxs = [130, 33, 1, 64], [2000, 33, 700, 100]
    c = _mla_case(dev, 16, q_lens, ctxs, 130, dkv=dkv, dr=dr,
                  seed=dkv + dr)
    _check(mla_paged_prefill_stacked, mla_prefill_plain, _prefill_args(c),
           q_lens, "mla_prefill")


def test_mla_prefill_many_rows(dev):
    """70 rows of short chunks, prefix hits and decode rows: a grid of 70
    (row, head group) columns."""
    rng = np.random.default_rng(70)
    q_lens = [int(q) for q in rng.integers(1, 9, size=70)]
    ctxs = [q + int(rng.integers(0, 300)) for q in q_lens]
    c = _mla_case(dev, 16, q_lens, ctxs, 8, seed=70)
    _check(mla_paged_prefill_stacked, mla_prefill_plain, _prefill_args(c),
           q_lens, "mla_prefill")


@pytest.mark.parametrize("nh", [16, 32])
def test_mla_prefill_query_dtypes_and_layouts(dev, nh):
    """bf16 q_lat and f32 q_pe are read as they come, as f32 q_lat and bf16
    q_pe are, and so are head-major rows (the model's absorbed q_lat is an
    einsum's [nh, B, S, dkv] result viewed as [B, S, nh, dkv])."""
    q_lens, ctxs = [20, 1], [300, 90]
    c = _mla_case(dev, nh, q_lens, ctxs, 20, seed=5)
    args = list(_prefill_args(c))
    args[0] = args[0].to(torch.bfloat16)
    args[1] = args[1].float()
    _check(mla_paged_prefill_stacked, mla_prefill_plain, tuple(args), q_lens,
           "mla_prefill")
    args = list(_prefill_args(c))
    args[0] = args[0].permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
    args[1] = args[1].permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
    assert not args[0].is_contiguous()
    _check(mla_paged_prefill_stacked, mla_prefill_plain, tuple(args), q_lens,
           "mla_prefill")


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
    # the prefill kernel holds O in registers: at most 512 latent columns
    # (the decode kernel takes 640)
    wide = _mla_case(dev, 16, [1], [40], 1, dkv=640, dr=32)
    with pytest.raises(ValueError, match="register-held"):
        mla_paged_prefill_stacked(*_prefill_args(wide))
    _check(mla_paged_decode_stacked, mla_decode_plain, _decode_args(wide),
           [1], "mla_decode")
    # the prefill kernel reads the query rows itself: f32/bf16, each row
    # contiguous
    args = list(_prefill_args(good))
    args[0] = good["q_lat"].half()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mla_paged_prefill_stacked(*args)
    args = list(_prefill_args(_mla_case(dev, 16, [2], [40], 2)))
    args[0] = torch.repeat_interleave(args[0], 2, dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="rows must be contiguous"):
        mla_paged_prefill_stacked(*args)


# -- the fused decode block as a CUDA graph (TorchEngine) ---------------------

BLOCK_W = 4


def _block_engine(dev, mla):
    """A two-layer bf16 engine on the card whose decode runs B1 (Llama
    tree, 8 query heads over 2 kv heads) or B4 (DeepSeek MLA, 16 heads,
    latent 128, rope 16)."""
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.models.config import ModelConfig
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, head_dim=128, dtype="bfloat16")
    if mla:
        cfg = ModelConfig(**base, num_heads=16, num_kv_heads=1,
                          model_type="deepseek_v2", q_lora_rank=0,
                          kv_lora_rank=128, qk_rope_head_dim=16,
                          qk_nope_head_dim=32, v_head_dim=32, num_experts=4,
                          num_experts_per_tok=2, moe_intermediate_size=64,
                          n_shared_experts=1, first_k_dense_replace=1,
                          routed_scaling_factor=1.0)
    else:
        cfg = ModelConfig(**base, num_heads=8, num_kv_heads=2)
    return TorchEngine.random_init(
        cfg, TorchEngineConfig(num_pages=160, page_size=16, max_num_seqs=8,
                               max_context=512), seed=1, device=dev)


def _block_inputs(eng, dev, draw, ctxs=(37, 200, 5, 480)):
    """A block's inputs over rows of the given contexts, each on pages of
    its own, random tokens; sampled (T 0.8, top-p 0.9, half the rows
    seeded) when ``draw``."""
    B = len(ctxs)
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.zeros((B, eng.table_width), dtype=torch.int32,
                        device=dev)
    n = eng.table_width
    table[:] = 1 + torch.arange(B * n, device=dev,
                                dtype=torch.int32).reshape(B, n)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    x = {"table": table,
         "tok": torch.randint(0, eng.model_cfg.vocab_size, (B, 1),
                              generator=g, device=dev, dtype=torch.int32),
         "pos": (ctx - 1)[:, None], "total": ctx,
         "alive": torch.ones(B, dtype=torch.bool, device=dev),
         "budget": torch.full((B,), 1 << 20, **i32),
         "min_gate": torch.zeros(B, **i32),
         "stop_ids": torch.full((B, 1), -1, **i32),
         "temp": torch.full((B,), 0.8 if draw else 0.0, device=dev),
         "top_k": torch.zeros(B, **i32),
         "top_p": torch.full((B,), 0.9 if draw else 1.0, device=dev),
         "step0": torch.tensor(11, dtype=torch.int64, device=dev)}
    if draw:
        x["seeds"] = torch.tensor([5, 0, 9, 0][:B], **i32)
        x["min_p"] = torch.zeros(B, device=dev)
    return x


@pytest.mark.parametrize("draw", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mla", [False, True], ids=["B1", "B4"])
def test_block_replay_equals_eager_block(dev, mla, draw):
    """One fused block run eagerly and as its graph's replay, from the same
    cache: the packed output, the carry and every KV page but the garbage
    page (which the capture's warm-up writes) are equal bit for bit; the
    replay counts its decode launches (the wrappers count in Python, which
    a replay does not run), and a second block of the shape replays
    without a capture."""
    from dynamo_tpu_torch.ops.kernels import reset_launch_counts
    eng = _block_engine(dev, mla)
    g = torch.Generator(device=dev).manual_seed(0)
    eng.pages.copy_(torch.randn(eng.pages.shape, generator=g, device=dev))
    saved = eng.pages.clone()
    x = _block_inputs(eng, dev, draw)
    want = {k: v.clone() for k, v in
            eng._block(x, BLOCK_W, draw).items()}
    want_kv = eng.pages.clone()
    assert not torch.equal(want_kv[:, 1:], saved[:, 1:])
    L = eng.model_cfg.num_layers
    k = eng.decode_kernel
    for rep in range(2):
        eng.pages.copy_(saved)
        reset_launch_counts()
        calls = eng.kernel_launches[k]
        got = eng._run_block(x, BLOCK_W, draw)
        torch.cuda.synchronize()
        assert len(eng.graphs) == 1 and eng.graphs.replays == rep + 1
        for name, v in want.items():
            assert torch.equal(got[name], v), (rep, name)
        assert torch.equal(eng.pages[:, 1:], want_kv[:, 1:]), rep
        # the first call also warmed the body up (real launches, dead rows)
        warm = BLOCK_W * L if rep == 0 else 0
        assert LAUNCHES[k] == BLOCK_W * L + warm, (rep, LAUNCHES)
        assert eng.kernel_launches[k] - calls == BLOCK_W * L + warm
    assert [e["kind"] for e in eng.drain_compile_events()] == ["multistep"]


def test_fetch_waits_for_its_own_step_only(dev):
    """``fetch_packed`` of step N returns while step N+1 is still queued
    behind a second of device work: it waits on step N's event, not on the
    stream; each handle has a pinned buffer of its own."""
    import time
    eng = _block_engine(dev, False)
    host = np.arange(12, dtype=np.int32).reshape(2, 6)
    step_n = torch.from_numpy(host).to(dev)
    h1 = eng._stage(step_n)
    torch.cuda._sleep(int(2e9))          # about a second on the card
    h2 = eng._stage(step_n + 1)
    assert h1.slot is not h2.slot
    t0 = time.perf_counter()
    sampled, _lps, extras = eng.fetch_packed(h1)
    waited = time.perf_counter() - t0
    assert not h2.event.query(), "step N+1 finished before N was fetched"
    assert waited < 0.5, waited
    np.testing.assert_array_equal(sampled, host[:, 0])
    np.testing.assert_array_equal(extras["top_ids"], host[:, 2:4])
    sampled2, _lps, _x = eng.fetch_packed(h2)
    np.testing.assert_array_equal(sampled2, host[:, 0] + 1)


GUIDED_SCHEMA = {"mode": "json_schema", "schema": {
    "type": "object", "properties": {"ok": {"type": "boolean"},
                                     "n": {"type": "integer"}},
    "required": ["ok", "n"]}}


def _byte_vocab(V):
    """ids 1-127 single ASCII bytes, the rest 2-4-byte JSON-ish strings or
    None (special); id 0 the EOS."""
    rng = np.random.default_rng(0)
    alphabet = list(b'{}[]":, 0123456789abcdefghijklmnoptrue')
    toks = [None] + [bytes([b]) for b in range(1, 128)]
    for _ in range(128, V):
        toks.append(None if rng.random() < 0.1 else bytes(
            rng.choice(alphabet, size=int(rng.integers(2, 5))).tolist()))
    return toks


def test_fused_serve_matches_per_step_on_the_card(dev):
    """A small greedy, seeded, penalized and guided workload served with
    the defaults (fused blocks replayed as graphs, pipelined; the guided
    row on its grammar's device table) and per step
    (``pipeline_decode=False``) on the card: the same tokens, graphs
    captured and replayed, and the wrappers' launch counts equal to the
    engine's attention calls (replays counted)."""
    import asyncio
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.ops.kernels import reset_launch_counts
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    rows = [("m0", [1, 2, 3, 4, 5], 5, dict(temperature=0.0)),
            ("m1", [2, 3, 4, 5, 6], 11, dict(temperature=0.0)),
            ("s", [9, 8, 7], 13, dict(temperature=1.0, seed=5)),
            ("p", [4, 4, 4], 10, dict(temperature=0.0,
                                      frequency_penalty=0.7,
                                      logit_bias={3: 2.0})),
            ("g", [3, 4, 5], 16, dict(temperature=0.7,
                                      guided=GUIDED_SCHEMA))]

    async def serve(eng):
        async def one(rid, prompt, n, so):
            req = PreprocessedRequest(
                token_ids=prompt, request_id=rid,
                stop_conditions=StopConditions(max_tokens=n),
                sampling_options=SamplingOptions(**so),
                eos_token_ids=[0] if rid == "g" else [])
            return [t async for f in eng.generate(req) for t in f.token_ids]
        try:
            return await asyncio.gather(*(one(*r) for r in rows))
        finally:
            await eng.stop()

    base = _block_engine(dev, False)
    out = {}
    for name, kw in (("fused", {}), ("per_step",
                                     dict(pipeline_decode=False))):
        eng = TorchEngine(base.model_cfg, base.params, TorchEngineConfig(
            num_pages=160, page_size=16, max_num_seqs=8, max_context=512,
            max_prefill_chunk=32, min_prefill_bucket=4, **kw), device=dev)
        eng.enable_guided(_byte_vocab(eng.model_cfg.vocab_size), [0])
        reset_launch_counts()
        out[name] = asyncio.run(serve(eng))
        torch.cuda.synchronize()
        assert {k: LAUNCHES[k] for k in eng.kernel_launches} \
            == eng.kernel_launches
        if name == "fused":
            assert eng.multistep_blocks > 0 and len(eng.graphs) > 0
            assert eng.graphs.replays == eng.multistep_blocks
            assert any(name == "gt_trans" for key in eng.graphs.graphs
                       for name, _shape, _dtype in key[1]), \
                "no block ran the guided table"
            assert not eng.scheduler.multistep_fallbacks.get("guided_table")
            assert eng.guided_parity_mismatches == 0
    assert out["fused"] == out["per_step"]
    assert [len(t) for t in out["fused"][:4]] == [5, 11, 13, 10]
