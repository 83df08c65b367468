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
``chip_smoke.py``'s prefix-hit case, and of its B2/B3 cases at the
widened geometries, that sit past 1 ulp of the plain version held within
1 ulp of the kernel's own chunked rounding. For the ragged kernel's split-KV path (short rows spread over several blocks, then
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
serve token for token as the per-step serve. For the KV data plane
(``engine/transfer.py``, ``kvbm/``): blocks injected in place through the
pinned staging pipeline under a captured block graph, which replays over
them with the sender's tokens; a CUDA IPC offer pulled card to card by
another process, byte for byte; KVBM spills and onboards on the card. For
int8, speculation and Gemma-2: ``quant.qdot``'s int32 products and
rescaled result equal to the CPU's at 1-40 rows (a batch of at most 16
padded to the 17 rows ``torch._int_mm`` takes); a verify step's forward
(``[B, K+1]``, logits window K+1) through B2, every layer against the
plain version; a speculating engine accepting drafts fed from the per-step
streams; a Gemma-2 forward (G = 2, window, softcap) through B1-B3, every
layer against the plain versions; ``TorchEngine`` refusing head_dim 256,
a group outside ``GROUPS`` and a float32 model at construction. For the
MoE family: a qwen3-MoE engine serving on both expert backends, and the
dispatch block's graph replay equal to its eager run, drop count included.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels._wrap import GROUPS
from dynamo_tpu_torch.ops.kernels.decode import (
    decode_splits, decode_subgroups, paged_decode_attention_stacked,
    paged_decode_plain)
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


def _case(dev, Hq, Hkv, q_lens, ctxs, S, ps=16, seed=0, P=None, Dh=128):
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    P = P or -(-max(ctxs) // ps) + 2
    N = sum(-(-c // ps) for c in ctxs) + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.randn((2, N, 2, Hkv, ps, Dh), generator=g, device=dev
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
    q = torch.randn((B, S, Hq, Dh), generator=g, device=dev
                    ).to(torch.bfloat16)
    return (q, pages, 1, torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev),
            torch.tensor(ctxs, dtype=torch.int32, device=dev), Dh ** -0.5)


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


# (Hq, Hkv, Dh): the groups at head_dim 128, then Gemma-2-9B's and -2B's
# head_dim 256, Llama-3.2-1B's 64, groups of 12 (Mistral-Large-2's 96/8)
# and 16 (Qwen3-235B-A22B's 64/4), which B1 splits into sub-groups of 6
# and 8 heads, and an odd split (G = 11: sub-groups of 6 and 5 heads)
GEOMETRIES = [(8, 8, 128), (8, 4, 128), (24, 8, 128), (16, 4, 128),
              (24, 4, 128), (32, 4, 128), (40, 8, 128), (28, 4, 128),
              (16, 8, 256), (8, 4, 256), (32, 8, 64), (96, 8, 128),
              (64, 4, 128), (16, 1, 64), (48, 4, 256), (11, 1, 128)]


@pytest.mark.parametrize("Hq,Hkv,Dh", GEOMETRIES)
def test_decode_groups(dev, Hq, Hkv, Dh):
    ctxs = [1, 17, 300, 2049]
    args = _case(dev, Hq, Hkv, [1] * 4, ctxs, 1, Dh=Dh)
    _check(paged_decode_attention_stacked, paged_decode_plain, args,
           [1] * 4, "paged_decode")
    _check(paged_decode_attention_stacked, paged_decode_plain, args,
           [1] * 4, "paged_decode", window=100, softcap=20.0)


@pytest.mark.parametrize("Hq,Hkv,Dh", GEOMETRIES)
def test_prefill_and_ragged_groups(dev, Hq, Hkv, Dh):
    q_lens, ctxs, S = [77, 1, 130, 5], [77, 400, 1000, 5], 130
    args = _case(dev, Hq, Hkv, q_lens, ctxs, S, seed=3, Dh=Dh)
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
    splits, per = decode_splits(B * decode_subgroups(G), Hkv, P, ps,
                                _sms(dev))
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


def test_geometry_rows_round_as_chunked(dev):
    """Phase 2's B2 and B3 cases at the widened geometries (head_dim 256
    with window and softcap, head_dim 64, groups 12 and 16), rebuilt from
    the same draws: every row more than 1 ulp from the plain version is
    within 1 ulp of ``online_attention_rows`` (a B3 decode row over its
    splits' ranges), so the excess is the chunked rounding."""
    import chip_smoke as cs
    labels = {label for label, _heads in cs.GEOMETRY_CASES}
    seen = 0
    for name, label, case, S, _d in cs.kernel_cases(
            np.random.default_rng(0)):
        if name == "paged_decode" or not any(label.startswith(t)
                                             for t in labels):
            continue
        worst, flagged = cs.prefill_rows_report(case, S, name=name,
                                                label=label)
        assert worst["kernel_vs_plain"] <= TOL_ULPS, (label, worst)
        assert all(km <= 1.0 for *_r, km, _pm in flagged), (label, flagged)
        seen += 1
    assert seen == 2 * len(labels)


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


@pytest.mark.parametrize("Dh", [64, 256])
@pytest.mark.parametrize("ps", [8, 64])
def test_head_dims_page_sizes(dev, Dh, ps):
    """Head dims 64 (a TMA row of one 64-column box) and 256 (Q in shared
    memory, a 2-stage ring) at TMA boxes of 8 and 64 rows, contexts past
    many ring turns, pad tiles, a window with softcap, and decode rows
    beside a chunk in the ragged entry."""
    q_lens, ctxs, S = [200, 1, 33, 1], [200, 1500, 1201, 4000], 200
    args = _case(dev, 16, 8, q_lens, ctxs, S, ps=ps, seed=Dh + ps, Dh=Dh)
    for fn, plain, name in (
            (paged_prefill_attention_stacked, paged_prefill_plain,
             "paged_prefill"),
            (ragged_mixed_attention_stacked, ragged_mixed_plain,
             "ragged_mixed")):
        _check(fn, plain, args, q_lens, name)
        _check(fn, plain, args, q_lens, name, window=150, softcap=50.0)
    dec = _case(dev, 16, 8, [1] * 4, ctxs, 1, ps=ps, seed=Dh + ps, Dh=Dh)
    _check(paged_decode_attention_stacked, paged_decode_plain, dec, [1] * 4,
           "paged_decode", window=1000, softcap=50.0)


def test_wrappers_reject_what_kernels_do_not_take(dev):
    args = list(_case(dev, 8, 4, [1], [40], 1))
    bad_dh = list(args)
    bad_dh[0] = torch.zeros((1, 1, 8, 96), dtype=torch.bfloat16, device=dev)
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
    bad_groups = list(_case(dev, 32, 1, [1], [40], 1))
    with pytest.raises(ValueError, match="group"):
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


# -- the serving entry points on the card ---------------------------------------


def test_loader_onto_the_card_bit_for_bit(dev, tmp_path):
    """A two-layer bf16 Llama checkpoint written by ``chip_smoke.py``'s
    header writer, read by the port's loader onto the card and onto the
    CPU: equal bit for bit to each other and to the tensors written."""
    import chip_smoke as cs
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.hf_loader import load_hf_params
    cfg = ModelConfig.tiny(dtype="bfloat16", tie_word_embeddings=False)
    g = torch.Generator().manual_seed(0)
    H, I = cfg.hidden_size, cfg.intermediate_size
    shapes = {"input_layernorm": (H,), "self_attn.q_proj": (cfg.q_size, H),
              "self_attn.k_proj": (cfg.kv_size, H),
              "self_attn.v_proj": (cfg.kv_size, H),
              "self_attn.o_proj": (H, cfg.q_size),
              "post_attention_layernorm": (H,), "mlp.gate_proj": (I, H),
              "mlp.up_proj": (I, H), "mlp.down_proj": (H, I)}
    tensors = {"model.embed_tokens.weight": (cfg.vocab_size, H),
               "model.norm.weight": (H,),
               "lm_head.weight": (cfg.vocab_size, H)}
    for l in range(cfg.num_layers):
        for name, shape in shapes.items():
            tensors[f"model.layers.{l}.{name}.weight"] = shape
    tensors = {k: torch.randn(s, generator=g).to(torch.bfloat16)
               for k, s in tensors.items()}
    cs.write_safetensors(str(tmp_path / "model.safetensors"), tensors)
    on_card = load_hf_params(cfg, str(tmp_path), device=dev)
    on_cpu = load_hf_params(cfg, str(tmp_path), device="cpu")
    assert on_card["layers"]["wq"].is_cuda
    want_wq = torch.stack([tensors[f"model.layers.{l}.self_attn.q_proj"
                                   ".weight"].t()
                           for l in range(cfg.num_layers)])
    assert torch.equal(on_cpu["layers"]["wq"].view(torch.int16),
                       want_wq.view(torch.int16))
    assert torch.equal(on_cpu["lm_head"].view(torch.int16),
                       tensors["lm_head.weight"].t().view(torch.int16))
    for k in ("embed", "final_norm", "lm_head"):
        assert torch.equal(on_card[k].cpu().view(torch.int16),
                           on_cpu[k].view(torch.int16)), k
    for k, v in on_cpu["layers"].items():
        assert torch.equal(on_card["layers"][k].cpu().view(torch.int16),
                           v.view(torch.int16)), k


def test_score_on_the_card_through_b2(dev):
    """``TorchEngine.score`` on the card (B2 through its wrapper) against
    the same engine's weights scoring on the CPU (the plain version):
    per prompt, the logprobs within 2 bf16 ulps of the row's largest."""
    import asyncio
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.ops.kernels import reset_launch_counts
    card = _block_engine(dev, False)
    cpu = TorchEngine(card.model_cfg,
                      {k: (v.cpu() if isinstance(v, torch.Tensor) else
                           {kk: vv.cpu() for kk, vv in v.items()})
                       for k, v in card.params.items()},
                      TorchEngineConfig(num_pages=160, page_size=16,
                                        max_num_seqs=8, max_context=512),
                      device="cpu")
    rng = np.random.default_rng(0)
    toks = [list(map(int, rng.integers(1, 512, size=n)))
            for n in (300, 17, 256)]
    async def score_on_card():
        # on the card score runs on the engine loop's exclusive lane
        try:
            return await card.score(toks)
        finally:
            await card.stop()

    reset_launch_counts()
    got = asyncio.run(score_on_card())
    torch.cuda.synchronize()
    # two chunks of 256 for the longest prompt, every layer through B2
    assert LAUNCHES["paged_prefill"] == 2 * card.model_cfg.num_layers
    want = asyncio.run(cpu.score(toks))
    for (lps, tids, tlps), (wl, wt, wtl), t in zip(got, want, toks):
        assert lps.shape == (len(t),) and np.all(np.isfinite(lps))
        err = row_ulp_error(torch.from_numpy(lps)[None],
                            torch.from_numpy(wl)[None])
        assert float(err.max()) <= TOL_ULPS, float(err.max())
        # the top-n alternatives: their logprobs by the same rule, and
        # their ids equal wherever the CPU run's neighbours stand further
        # apart than the two runs may each move them; the last rank's
        # next alternative is not returned, so it is left out
        assert tlps.shape == wtl.shape == tids.shape == wt.shape
        assert np.all(np.isfinite(tlps))
        err = row_ulp_error(torch.from_numpy(tlps).reshape(1, -1),
                            torch.from_numpy(wtl).reshape(1, -1))
        assert float(err.max()) <= TOL_ULPS, float(err.max())
        tol = TOL_ULPS * 2.0 ** (np.floor(np.log2(np.abs(wtl).max())) - 7)
        gap = wtl[:, :-1] - wtl[:, 1:]
        clear = np.ones(wt.shape, dtype=bool)
        clear[:, :-1] &= gap > 2 * tol
        clear[:, 1:] &= gap > 2 * tol
        clear[:, -1] = False
        assert clear[1:].any()
        assert np.array_equal(tids[clear], wt[clear]), \
            np.argwhere((tids != wt) & clear)[:8]


def test_worker_process_answers_on_the_card(tmp_path):
    """The port's coordinator, a torch worker on the card (bf16 random
    weights, head_dim 128) and the port's frontend as processes: one chat
    completion answered, B1 and B2 launched in the worker."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    import chip_smoke as cs
    from dynamo_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=8, num_kv_heads=2,
                      head_dim=128, dtype="bfloat16",
                      max_position_embeddings=1024)
    model = str(tmp_path / "tiny")
    cs.write_entry_model(model, cfg)
    coord, http, sysp = cs.free_port(), cs.free_port(), cs.free_port()
    kids = []
    try:
        kids.append(cs.Child("coordinator",
                             "dynamo_tpu_torch.runtime.coordinator",
                             ["--host", "127.0.0.1", "--port", str(coord)],
                             str(tmp_path)))
        kids[-1].wait_for("coordinator listening")
        kids.append(cs.Child(
            "worker", "dynamo_tpu_torch.worker.main",
            ["--coordinator", f"127.0.0.1:{coord}", "--model-path", model,
             "--random-weights", "--num-pages", "128", "--max-context",
             "512", "--max-num-seqs", "4"], str(tmp_path),
            {"DYN_SYSTEM_ENABLED": "1", "DYN_SYSTEM_PORT": str(sysp)}))
        kids.append(cs.Child(
            "frontend", "dynamo_tpu_torch.frontend.main",
            ["--coordinator", f"127.0.0.1:{coord}", "--http-host",
             "127.0.0.1", "--http-port", str(http)], str(tmp_path)))
        kids[1].wait_for("torch worker serving model")
        kids[2].wait_for("frontend listening")
        import json
        import time
        import urllib.request
        base = f"http://127.0.0.1:{http}"
        for _ in range(100):
            with urllib.request.urlopen(f"{base}/v1/models") as resp:
                if json.loads(resp.read())["data"]:
                    break
            time.sleep(0.1)
        r = cs.http_post(f"{base}/v1/chat/completions", {
            "model": "tiny", "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": "w1 w2 w3"}]})
        assert r["choices"][0]["finish_reason"] in ("length", "stop")
        assert 0 < r["usage"]["completion_tokens"] <= 8
        launches = cs.scrape_launches(sysp)
        assert launches["paged_prefill"] > 0 and launches["paged_decode"] > 0
    except Exception:
        for k in kids:
            print(f"--- {k.name}\n{k.tail()}")
        raise
    finally:
        for k in reversed(kids):
            k.stop()


# -- the KV data plane on the card ----------------------------------------------


def _serve_one(eng, prompt, rid, n=24):
    import asyncio
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)

    async def run():
        req = PreprocessedRequest(
            token_ids=list(prompt), request_id=rid,
            stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0))
        frames = [f async for f in eng.generate(req)]
        return [t for f in frames for t in f.token_ids], frames[-1]
    return run


def _prefill_hashes(eng, prompt):
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)

    async def run():
        req = PreprocessedRequest(
            token_ids=list(prompt), request_id="p",
            stop_conditions=StopConditions(max_tokens=1),
            sampling_options=SamplingOptions(temperature=0.0))
        req.prefill_only = True
        frames = [f async for f in eng.generate(req)]
        return [b[0] for b in frames[-1].kv_transfer_params["blocks"]]
    return run


def _twin_engines(dev):
    """Two bf16 engines on the card sharing one set of weights (B1-B3)."""
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    base = _block_engine(dev, False)
    kw = dict(num_pages=160, page_size=16, max_num_seqs=8, max_context=512,
              max_prefill_chunk=128, min_prefill_bucket=16)
    return [TorchEngine(base.model_cfg, base.params, TorchEngineConfig(**kw),
                        device=dev) for _ in range(2)]


def test_inject_keeps_a_captured_block_replay_correct(dev):
    """B captures its fused block graphs on one prompt, then KV blocks
    pulled from A are injected in place (frames through the staged,
    pinned inject pipeline): B's next serve replays the captured graphs
    (no new capture) over the injected prefix, with the tokens of A's hot
    serve of the same prompt, and B's pages hold A's bytes."""
    import asyncio
    from dynamo_tpu_torch.engine.transfer import (InjectPipeline,
                                                  export_frames,
                                                  stamp_frame_crcs)
    a, b = _twin_engines(dev)
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, 500, size=300).tolist()
    warm = rng.integers(1, 500, size=300).tolist()

    async def run():
        try:
            hashes = await _prefill_hashes(a, prompt)()
            await _serve_one(b, warm, "warm")()
            captured, replays = len(b.graphs), b.graphs.replays
            assert captured > 0
            ptr = b.pages.data_ptr()
            frames = stamp_frame_crcs(await a.run_exclusive(
                export_frames, a, hashes, "layer", 4))
            pipe = InjectPipeline(b, window=8)
            for f in frames:
                meta = dict(f.obj)
                meta["_raw"] = np.ascontiguousarray(f.raw).view(
                    np.uint8).tobytes()
                await pipe.add_frame(meta)
            assert await pipe.finish() == len(hashes) == 18
            assert b.page_scatter_dispatches == 3
            got, last = await _serve_one(b, prompt, "b")()
            want, _ = await _serve_one(a, prompt, "a")()
            assert last.cached_tokens == 288
            assert got == want
            assert len(b.graphs) == captured
            assert b.graphs.replays > replays
            assert b.pages.data_ptr() == ptr
            n = len(hashes)
            pa = a.dispatch_gather_pages(
                [a.allocator._by_hash[h] for h in hashes])[:, :n]
            pb = b.dispatch_gather_pages(
                [b.allocator._by_hash[h] for h in hashes])[:, :n]
            assert torch.equal(pa.view(torch.int16), pb.view(torch.int16))
        finally:
            await a.stop()
            await b.stop()
    asyncio.run(run())


def test_cuda_ipc_offer_pull_between_processes(dev, tmp_path):
    """The device-direct plane: an offer of gathered blocks made here is
    pulled card to card by another process (which imports no JAX), whose
    copy hashes to the bytes offered; a second pull from this process is
    refused (CUDA opens no handle in the process that made it)."""
    import asyncio
    import hashlib
    import os
    import subprocess
    import sys
    from dynamo_tpu_torch.engine.transfer import DeviceTransferPlane
    from dynamo_tpu_torch.runtime.codec import pack
    a, b = _twin_engines(dev)
    prompt = np.random.default_rng(8).integers(1, 500, size=300).tolist()
    plane = DeviceTransferPlane()

    async def offer():
        try:
            hashes = await _prefill_hashes(a, prompt)()
            out = await a.run_exclusive(plane.offer, a, hashes)
            data = a.dispatch_gather_pages(
                [a.allocator._by_hash[h] for h in hashes])[:, :len(hashes)]
            host = data.contiguous().view(torch.int16).cpu().numpy()
            return out, hashlib.sha256(host.tobytes()).hexdigest()
        finally:
            await a.stop()
            await b.stop()
    off, want = asyncio.run(offer())
    assert off["dtype"] == "bfloat16" and len(off["blocks"]) == 18
    path = tmp_path / "offer.bin"
    path.write_bytes(pack(off))
    code = r"""
import hashlib, sys
sys.modules["jax"] = None
import torch
from dynamo_tpu_torch.engine.transfer import DeviceTransferPlane
from dynamo_tpu_torch.runtime.codec import unpack
offer = unpack(open(sys.argv[1], "rb").read())
data = DeviceTransferPlane().pull(offer)
host = data.contiguous().view(torch.int16).cpu().numpy()
print(hashlib.sha256(host.tobytes()).hexdigest())
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code, str(path)], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == want
    with pytest.raises(ConnectionError):
        plane.pull(off)
    plane.ack(off["uuid"])
    assert not plane._offers


def test_kvbm_offload_onboard_on_the_card(dev, tmp_path):
    """``TieredEngine`` over a card engine whose page pool (15 usable
    pages) holds one request: the next request evicts the prompt's
    blocks, which spill (pinned copies on the spill stream) to host and,
    past a four-block host budget, to disk; served again, the prompt
    onboards them in place (synchronous onboarding: the prefetch race
    with the prefill cursor would change which positions are recomputed)
    and the serve equals a hot cache's."""
    import asyncio
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.kvbm import TieredEngine, TieredKvConfig
    base = _block_engine(dev, False)
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, 500, size=200).tolist()
    other = rng.integers(1, 500, size=200).tolist()
    cfg = base.model_cfg
    block = cfg.num_layers * 2 * cfg.num_kv_heads * 16 * cfg.head_dim * 2

    def engine(pages):
        return TorchEngine(cfg, base.params, TorchEngineConfig(
            num_pages=pages, page_size=16, max_num_seqs=2, max_context=512,
            max_prefill_chunk=64, min_prefill_bucket=16), device=dev)

    async def run():
        hot = engine(64)
        try:
            await _serve_one(hot, prompt, "w")()
            want, _ = await _serve_one(hot, prompt, "h")()
        finally:
            await hot.stop()
        eng = engine(16)
        ptr = eng.pages.data_ptr()
        t = TieredEngine(eng, TieredKvConfig(
            host_budget_bytes=4 * block, disk_budget_bytes=64 * block,
            disk_path=str(tmp_path), prefetch_depth_bytes=0))
        try:
            await _serve_one(t, prompt, "a")()
            await _serve_one(t, other, "b")()
            t.flush_spills()
            assert t.offloaded >= 12 and len(t.disk) >= 1
            got, last = await _serve_one(t, prompt, "a2")()
            assert got == want
            assert t.onboarded >= 1 and last.cached_tokens > 0
            assert eng.pages.data_ptr() == ptr
        finally:
            await t.stop()
    asyncio.run(run())


# -- int8, speculative verify and Gemma-2 on the card ---------------------------


@pytest.mark.parametrize("M", [1, 5, 16, 17, 40])
def test_qdot_on_the_card_equals_the_cpu(dev, M):
    """``quant.qdot`` on the card: the int32 products equal the CPU's
    (decode batches of at most 16 rows ride zero pad rows to the 17 that
    ``torch._int_mm`` takes), with the weights row-major and column-major
    (as ``quantize_params`` lays them out), and the rescaled float32
    result, and a bf16 activation's, equal the CPU's bit for bit."""
    from dynamo_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(M)
    x = torch.randn((M, 256), generator=g) * 3.0
    w8, scale = quant.quantize_weight(torch.randn((256, 384), generator=g)
                                      * 0.05, axis=0)
    x8 = torch.randint(-127, 128, (M, 256), generator=g, dtype=torch.int8)
    want = x8.int() @ w8.int()
    for w in (w8, w8.t().contiguous().t()):
        got = quant._int_mm(x8.to(dev), w.to(dev))
        assert got.dtype == torch.int32 and got.shape == (M, 384)
        assert torch.equal(got.cpu(), want)
        for xx in (x, x.to(torch.bfloat16)):
            cpu = quant.qdot(xx, w8, scale)
            card = quant.qdot(xx.to(dev), w.to(dev), scale.to(dev))
            assert card.dtype == xx.dtype
            assert torch.equal(card.cpu(), cpu)


def _checked(kernel, plain, errs):
    """An attention hook that runs ``kernel`` and holds it, on the same
    inputs, against ``plain`` (per (slot, head) row, bf16 ulps)."""
    def attn(q, pages, layer, table, positions, total, scale, **kw):
        out = kernel(q, pages, layer, table, positions, total, scale, **kw)
        ref = plain(q, pages, layer, table, positions, total, scale, **kw)
        errs.append(float(row_ulp_error(out, ref).max()))
        return out
    return attn


def _prefill_rows(eng, prompts):
    """Prefill ``prompts`` into ``eng``'s cache through the chunked-prefill
    kernel, each row on its own pages; returns the page table."""
    dev = eng.device
    ps, B = eng.cfg.page_size, len(prompts)
    S = max(len(p) for p in prompts)
    table = torch.zeros((B, eng.table_width), dtype=torch.int32, device=dev)
    per = -(-(S + 8) // ps)
    table[:, :per] = 1 + torch.arange(B * per, dtype=torch.int32,
                                      device=dev).reshape(B, per)
    toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
    pos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        pos[i, :len(p)] = torch.arange(len(p), dtype=torch.int32)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    eng.family.forward(eng.params, eng.model_cfg, toks, pos, eng.pages,
                       table, lens, lens,
                       attn_impl=paged_prefill_attention_stacked)
    return table


def test_spec_verify_forward_kernel_vs_plain(dev):
    """A verify step's forward (``[B, K+1]`` with K = 4, logits window 5)
    through the chunked-prefill kernel, every layer held against the
    plain version on the same inputs, and its logits against the plain
    forward's on a copy of the cache."""
    eng = _block_engine(dev, False)
    prompts = [list(range(3, 40)), list(range(100, 300)), [7, 8, 9]]
    table = _prefill_rows(eng, prompts)
    B, S = len(prompts), 5
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, eng.model_cfg.vocab_size, (B, S), generator=g,
                         device=dev, dtype=torch.int32)
    starts = torch.tensor([len(p) - 1 for p in prompts], device=dev)
    pos = (starts[:, None] + torch.arange(S, device=dev)).to(torch.int32)
    total = (starts + S).to(torch.int32)
    new = torch.full((B,), S, dtype=torch.int32, device=dev)
    saved = eng.pages.clone()
    errs = []
    n0 = LAUNCHES["paged_prefill"]
    logits, _ = eng.family.forward(
        eng.params, eng.model_cfg, toks, pos, eng.pages, table, total, new,
        attn_impl=_checked(paged_prefill_attention_stacked,
                           paged_prefill_plain, errs), logits_window=S)
    assert LAUNCHES["paged_prefill"] == n0 + eng.model_cfg.num_layers
    ref, _ = eng.family.forward(
        eng.params, eng.model_cfg, toks, pos, saved, table, total, new,
        attn_impl=paged_prefill_plain, logits_window=S)
    torch.cuda.synchronize()
    assert logits.shape == (B, S, eng.model_cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert max(errs) <= TOL_ULPS, errs
    scale = float(ref.abs().max())
    assert float((logits - ref).abs().max()) <= 0.05 * scale


def test_spec_serve_on_the_card_accepts_forced_drafts(dev, monkeypatch):
    """``TorchEngine(spec_tokens=4)`` on the card with the proposer fed
    the per-step engine's greedy streams: verify steps run through B2,
    drafts are accepted, and every stream finishes at its length."""
    import asyncio
    import dynamo_tpu_torch.engine.scheduler as sched
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
    prompts = {"a": list(range(5, 45)), "b": [3, 1, 4, 1, 5, 9, 2, 6] * 3}

    async def serve(eng):
        async def one(rid):
            req = PreprocessedRequest(
                token_ids=prompts[rid], request_id=rid,
                stop_conditions=StopConditions(max_tokens=16),
                sampling_options=SamplingOptions(temperature=0.0),
                eos_token_ids=[])
            return [t async for f in eng.generate(req) for t in f.token_ids]
        try:
            return dict(zip(prompts, await asyncio.gather(
                *(one(r) for r in prompts))))
        finally:
            await eng.stop()

    base = _block_engine(dev, False)
    sizes = dict(num_pages=160, page_size=16, max_num_seqs=8,
                 max_context=512, max_prefill_chunk=64)
    ref = asyncio.run(serve(TorchEngine(
        base.model_cfg, base.params,
        TorchEngineConfig(pipeline_decode=False, **sizes), device=dev)))
    full = {tuple(prompts[r]): prompts[r] + ref[r] for r in prompts}

    def oracle(tokens, k, max_n=4, min_n=2):
        for f in full.values():
            n = len(tokens)
            if n < len(f) and list(tokens) == f[:n]:
                cont = f[n:n + k]
                return cont + [cont[-1]] * (k - len(cont))
        return None
    monkeypatch.setattr(sched, "propose_ngram", oracle)
    eng = TorchEngine(base.model_cfg, base.params,
                      TorchEngineConfig(spec_tokens=4, **sizes), device=dev)
    n0 = LAUNCHES["paged_prefill"]
    got = asyncio.run(serve(eng))
    st = eng.stats().spec_decode_stats
    assert st.num_drafts > 0 and st.num_accepted_tokens > 0
    assert LAUNCHES["paged_prefill"] > n0
    assert all(len(t) == 16 for t in got.values())


def test_gemma_forward_kernels_vs_plain(dev):
    """A two-layer Gemma-2 (G = 2, head_dim 128, window 48 on layer 0,
    softcap 50) through the decode, prefill and ragged kernels: prefill
    rows past the window, a mixed step and a decode step, every layer
    held against the plain version on the same inputs."""
    from dynamo_tpu_torch.engine.torch_engine import (ATTENTION,
                                                      TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops.kernels.decode import paged_decode_plain
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                      dtype="bfloat16", model_type="gemma2",
                      sliding_window=48, attn_logit_softcap=50.0,
                      final_logit_softcap=30.0, query_pre_attn_scalar=144.0,
                      tie_word_embeddings=True)
    eng = TorchEngine.random_init(cfg, TorchEngineConfig(
        num_pages=64, page_size=16, max_num_seqs=4, max_context=256),
        seed=2, device=dev)
    plains = {"paged_decode": paged_decode_plain,
              "paged_prefill": paged_prefill_plain,
              "ragged_mixed": ragged_mixed_plain}
    B, P = 2, eng.table_width
    table = torch.zeros((B, P), dtype=torch.int32, device=dev)
    table[0, :8] = torch.arange(1, 9)
    table[1, :8] = torch.arange(9, 17)
    g = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, 512, (B, 160), generator=g, device=dev,
                        dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    steps = [("paged_prefill", ids[:, :100],
              torch.arange(100, **i32).expand(B, 100).contiguous(),
              [100, 100], [100, 100])]
    toks = torch.zeros((B, 40), **i32)
    pos = torch.zeros((B, 40), **i32)
    toks[0], pos[0] = ids[0, 100:140], torch.arange(100, 140, **i32)
    toks[1, 0], pos[1, 0] = ids[1, 100], 100
    steps.append(("ragged_mixed", toks, pos, [140, 101], [40, 1]))
    steps.append(("paged_decode", ids[:, 150:151].contiguous(),
                  torch.tensor([[140], [101]], **i32), [141, 102], [1, 1]))
    for kernel, toks, pos, total, new in steps:
        errs = []
        n0 = LAUNCHES[kernel]
        logits, _ = eng.family.forward(
            eng.params, cfg, toks, pos, eng.pages, table,
            torch.tensor(total, **i32), torch.tensor(new, **i32),
            attn_impl=_checked(ATTENTION[kernel], plains[kernel], errs))
        torch.cuda.synchronize()
        assert LAUNCHES[kernel] == n0 + cfg.num_layers, kernel
        assert bool(torch.isfinite(logits).all()), kernel
        assert float(logits.abs().max()) <= 30.0, kernel   # final softcap
        assert max(errs) <= TOL_ULPS, (kernel, errs)


def test_moe_engine_serves_both_backends_on_the_card(dev):
    """A two-layer bf16 qwen3-MoE engine (32 experts, top-4; B1-B3 at 8
    query heads over 2) on the card, on both expert backends: a fused serve
    of three greedy requests finishes each with the kernels' launches equal
    to the engine's attention calls, and the two backends give the same
    tokens where nothing drops. On the dispatch backend one block at B = 8
    (six rows on one token, so each decode step overflows the raised
    capacity of ``ceil(4 * 8 * 4 / 32) = 4``) replays from its graph equal
    to the eager block bit for bit, its drop count included, and the
    engine's stats fetch the queued drop counts. (Rows that write one
    page would race once their drops make them differ: each row has its
    own pages, six holding copies of one context.)"""
    import asyncio
    import dataclasses
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops.kernels import reset_launch_counts
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=8, num_kv_heads=2, head_dim=128,
                      dtype="bfloat16", model_type="qwen3_moe", qk_norm=True,
                      num_experts=32, num_experts_per_tok=4,
                      moe_intermediate_size=64)
    sizes = dict(num_pages=160, page_size=16, max_num_seqs=8,
                 max_context=512, max_prefill_chunk=64, min_prefill_bucket=16)
    base = TorchEngine.random_init(cfg, TorchEngineConfig(**sizes), seed=1,
                                   device=dev)
    prompts = [list(range(3, 40)), list(range(100, 110)), [7, 8, 9, 10]]
    out = {}
    for backend in ("dense", "dispatch"):
        eng = TorchEngine(dataclasses.replace(cfg, moe_backend=backend),
                          base.params, TorchEngineConfig(**sizes), device=dev)
        reset_launch_counts()

        async def serve():
            try:
                return await asyncio.gather(*(
                    _serve_one(eng, p, f"r{i}", n=12)()
                    for i, p in enumerate(prompts)))
            finally:
                await eng.stop()
        got = asyncio.run(serve())
        torch.cuda.synchronize()
        assert all(len(t) == 12 for t, _f in got)
        assert {k: LAUNCHES[k] for k in eng.kernel_launches} \
            == eng.kernel_launches
        assert eng.kernel_launches["paged_decode"] > 0
        assert eng.kernel_launches["paged_prefill"] > 0
        assert eng.multistep_blocks > 0 and eng.graphs.replays > 0
        out[backend] = ([t for t, _f in got],
                        eng.stats().worker_stats.moe_dropped_tokens)
    assert out["dense"][1] == 0
    if out["dispatch"][1] == 0:
        assert out["dispatch"][0] == out["dense"][0]
    # eight rows at ctx 37 on pages of their own (3 each); rows 0-5 hold
    # copies of one context and feed one token, so they route alike
    x = _block_inputs(eng, dev, False, ctxs=(37,) * 8)
    x["tok"][:6] = 11
    x["table"].zero_()
    x["table"][:, :3] = 1 + torch.arange(24, device=dev,
                                         dtype=torch.int32).reshape(8, 3)
    ctx0 = x["table"][0, :3].long()
    for r in range(1, 6):
        eng.pages[:, x["table"][r, :3].long()] = eng.pages[:, ctx0]
    saved = eng.pages.clone()
    want = {k: v.clone() for k, v in eng._block(x, BLOCK_W, False).items()}
    assert int(want["drops"]) > 0
    eng.pages.copy_(saved)
    got = eng._run_block(x, BLOCK_W, False)
    for name, v in want.items():
        assert torch.equal(got[name], v), name
    before = eng.moe_dropped_total()
    eng._queue_drops(got["drops"].clone())
    assert eng.moe_dropped_total() == before + int(want["drops"])


def test_engine_refuses_geometries_the_kernels_do_not_take(dev):
    """On the card ``TorchEngine`` refuses at construction what the GQA
    kernels do not take: head_dim 96 or 512 (ROADMAP Queue C), a query
    group outside ``GROUPS`` (32 heads over 1), a float32 model; and takes
    head_dim 64 and 256 with a group of 16."""
    from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                      TorchEngineConfig)
    from dynamo_tpu_torch.models.config import ModelConfig
    base = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                num_layers=1, dtype="bfloat16")
    sizes = TorchEngineConfig(num_pages=8, page_size=16, max_num_seqs=2,
                              max_context=64)
    for kw, match in ((dict(num_heads=4, num_kv_heads=2, head_dim=96),
                       "got 96"),
                      (dict(num_heads=4, num_kv_heads=2, head_dim=512,
                            model_type="gemma2"), "got 512"),
                      (dict(num_heads=32, num_kv_heads=1, head_dim=128),
                       "32/1 is not a group"),
                      (dict(num_heads=4, num_kv_heads=2, head_dim=128,
                            dtype="float32"), "bfloat16")):
        cfg = ModelConfig(**dict(base, **kw))
        with pytest.raises(ValueError, match=match):
            TorchEngine.random_init(cfg, sizes, device=dev)
    for kw in (dict(num_heads=16, num_kv_heads=1, head_dim=64),
               dict(num_heads=4, num_kv_heads=2, head_dim=256,
                    model_type="gemma2")):
        engine = TorchEngine.random_init(ModelConfig(**dict(base, **kw)),
                                         sizes, device=dev)
        del engine
