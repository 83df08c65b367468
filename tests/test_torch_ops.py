"""The port's ops against the JAX package's, on the CPU.

Same inputs (numpy, fixed seeds) through ``dynamo_tpu.ops`` and
``dynamo_tpu_torch.ops``:

- rope, the RMS norms, ``write_kv`` and the plain paged / ragged attention
  in float32, within 2e-5;
- each CUDA kernel's plain PyTorch version (what its wrapper computes on a
  CPU tensor) against the Pallas kernel it replaces, run in interpret mode,
  in bfloat16 within 2e-2: GQA, prefix hits, pad rows, a ragged mix of
  q_len 7/1/5, a sliding window and a softcap.

The q * sm_scale product is rounded to bf16 before both kernels (the TPU
kernels' contract); with bf16 outputs of magnitude <= ~3 the 2e-2 bound is
a few bf16 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops.rope import apply_rope as japply_rope
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops.kernels import LAUNCHES
from dynamo_tpu_torch.ops.kernels.decode import paged_decode_attention_stacked
from dynamo_tpu_torch.ops.kernels.prefill import (
    paged_prefill_attention_stacked)
from dynamo_tpu_torch.ops.kernels.ragged import ragged_mixed_attention_stacked
from dynamo_tpu_torch.ops.rope import apply_rope as tapply_rope

# small CPU shapes: keep torch off the cores other test workers time on
torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 2e-2


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(
        b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= tol, err
    return err


# -- float32 ops --------------------------------------------------------------


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 5)).astype(np.int32)
    ref = japply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    close(ref, tapply_rope(t(x), t(pos), 500000.0), F32_TOL)


@pytest.mark.parametrize("which", ["rms", "head_rms"])
def test_rms_norms_match_jax(which):
    rng = np.random.default_rng(1)
    shape = (2, 3, 64) if which == "rms" else (2, 3, 4, 16)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    jf = jllama._rms_norm if which == "rms" else jllama._head_rms_norm
    close(jf(jnp.asarray(x), jnp.asarray(w), 1e-5),
          tllama._rms_norm(t(x), t(w), 1e-5), F32_TOL)


def test_write_kv_pages_byte_equal_and_pads_hit_page0():
    rng = np.random.default_rng(2)
    L, N, Hkv, ps, Dh = 2, 16, 2, 4, 16
    B, S = 3, 5
    pages = rng.normal(size=(L, N, 2, Hkv, ps, Dh)).astype(np.float32)
    table = np.zeros((B, 4), np.int32)
    table[:, :3] = rng.permutation(np.arange(1, N))[:9].reshape(B, 3)
    starts = np.array([0, 6, 3])
    positions = (starts[:, None] + np.arange(S)).astype(np.int32)
    new_lens = np.array([5, 2, 0], np.int32)
    k = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    # pad slots carry one value, as the engine's do (token 0 at position
    # 0), so the colliding page-0 writes are order independent
    pad = np.arange(S)[None, :] >= new_lens[:, None]
    k[pad], v[pad] = k[0, 0], v[0, 0]
    ref = np.asarray(jattn.write_kv(jnp.asarray(pages), 1, jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(table),
                                    jnp.asarray(positions),
                                    jnp.asarray(new_lens)))
    tp = t(pages.copy())
    out = tattn.write_kv(tp, 1, t(k), t(v), t(table), t(positions),
                         t(new_lens))
    assert out is tp                       # updated in place
    assert np.array_equal(ref.view(np.uint32), tp.numpy().view(np.uint32))
    assert np.array_equal(tp.numpy()[1, 0, 0, :, 0], k[0, 0])
    # layer 0 untouched
    assert np.array_equal(tp.numpy()[0], pages[0])


def _paged_setup(seed, S, P=12, N=40, Hq=4, Hkv=2, ps=4, Dh=16):
    rng = np.random.default_rng(seed)
    pages = rng.normal(size=(2, N, 2, Hkv, ps, Dh)).astype(np.float32)
    table = rng.integers(1, N, size=(3, P)).astype(np.int32)
    total = np.array([17, 9, 30], np.int32)
    # each row's S queries end at its context (a prefix hit for rows 0/2)
    positions = np.stack([np.arange(tl - S, tl) for tl in total]).astype(
        np.int32)
    q = rng.normal(size=(3, S, Hq, Dh)).astype(np.float32)
    return pages, table, positions, total, q


@pytest.mark.parametrize("S,window,softcap", [
    (1, None, None), (6, None, None), (6, 5, None), (6, None, 3.0),
    (1, 4, 2.0)])
def test_paged_attention_matches_jax(S, window, softcap):
    pages, table, positions, total, q = _paged_setup(3, S)
    args = dict(window=window, softcap=softcap)
    jw = None if window is None else jnp.int32(window)
    ref = jattn.paged_attention(jnp.asarray(q), jnp.asarray(pages), 1,
                                jnp.asarray(table), jnp.asarray(positions),
                                jnp.asarray(total), 0.25, window=jw,
                                softcap=softcap)
    out = tattn.paged_attention(t(q), t(pages), 1, t(table), t(positions),
                                t(total), 0.25, **args)
    close(ref, out, F32_TOL)


def test_ragged_paged_attention_matches_jax():
    rng = np.random.default_rng(4)
    L, N, Hkv, ps, Dh, Hq, P = 2, 32, 2, 8, 128, 4, 12
    pages = rng.normal(size=(L, N, 2, Hkv, ps, Dh)).astype(np.float32)
    table = rng.integers(1, N, size=(3, P)).astype(np.int32)
    q_lens = np.array([7, 1, 5], np.int32)
    kv_lens = np.array([23, 9, 5], np.int32)
    q_starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    q = rng.normal(size=(int(q_lens.sum()) + 3, Hq, Dh)).astype(np.float32)
    ref = jattn.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(pages), 1, jnp.asarray(table),
        jnp.asarray(q_starts), jnp.asarray(q_lens), jnp.asarray(kv_lens), 0.09)
    out = tattn.ragged_paged_attention(t(q), t(pages), 1, t(table),
                                       t(q_starts), t(q_lens), t(kv_lens),
                                       0.09)
    close(ref, out, F32_TOL)
    assert float(out[int(q_lens.sum()):].abs().max()) == 0.0


# -- kernels' plain versions vs the Pallas kernels (interpret mode) ----------


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tb(a):
    return t(np.asarray(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)


def _kernel_setup(seed, B=3, P=6, N=48, Hq=4, Hkv=2, ps=8, Dh=128):
    rng = np.random.default_rng(seed)
    pages = _bf16(rng.normal(size=(2, N, 2, Hkv, ps, Dh)))
    table = np.zeros((B, P), np.int32)
    table[:] = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P)
    return rng, pages, table


@pytest.mark.parametrize("window,softcap", [
    (None, None), (16, None), (None, 30.0), (16, 8.0)])
def test_decode_plain_matches_pallas(window, softcap):
    from dynamo_tpu.ops.pallas.decode import (
        paged_decode_attention_stacked as pallas_decode)
    rng, pages, table = _kernel_setup(5, B=4)
    total = np.array([9, 17, 1, 48], np.int32)      # one-token + full-table
    q = _bf16(rng.normal(size=(4, 1, 4, 128)))
    positions = (total - 1)[:, None]
    ref = pallas_decode(q, pages, 1, jnp.asarray(table),
                        jnp.asarray(positions), jnp.asarray(total), 0.088,
                        window=window, softcap=softcap, interpret=True)
    before = dict(LAUNCHES)
    out = paged_decode_attention_stacked(
        _tb(q), _tb(pages), 1, t(table), t(positions), t(total), 0.088,
        window=window, softcap=softcap)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 1, 4, 128)
    close(np.asarray(ref, np.float32), out, BF16_TOL)
    assert LAUNCHES == before      # the CPU path launches no kernel


def _chunk_batch(rng, q_lens, ctxs, S, Hq=4, Dh=128):
    B = len(q_lens)
    q = np.zeros((B, S, Hq, Dh), np.float32)
    positions = np.zeros((B, S), np.int32)
    for i, (ql, c) in enumerate(zip(q_lens, ctxs)):
        q[i, :ql] = rng.normal(size=(ql, Hq, Dh))
        positions[i, :ql] = np.arange(c - ql, c)
    return _bf16(q), positions, np.asarray(ctxs, np.int32)


@pytest.mark.parametrize("window,softcap", [
    (None, None), (6, None), (None, 20.0)])
def test_prefill_plain_matches_pallas(window, softcap):
    from dynamo_tpu.ops.pallas.prefill import (
        paged_prefill_attention_stacked as pallas_prefill)
    rng, pages, table = _kernel_setup(6)
    # rows: fresh prompt, prefix hit (q_start 20), partial chunk over a hit
    q_lens, ctxs, S = [16, 16, 9], [16, 36, 45], 16
    q, positions, total = _chunk_batch(rng, q_lens, ctxs, S)
    ref = pallas_prefill(q, pages, 1, jnp.asarray(table),
                         jnp.asarray(positions), jnp.asarray(total), 0.088,
                         window=window, softcap=softcap, interpret=True)
    out = paged_prefill_attention_stacked(
        _tb(q), _tb(pages), 1, t(table), t(positions), t(total), 0.088,
        window=window, softcap=softcap)
    ref = np.asarray(ref, np.float32)
    for i, ql in enumerate(q_lens):
        close(ref[i, :ql], out[i, :ql], BF16_TOL)
    # pad query slots are zero (the Pallas kernel leaves finite garbage)
    assert float(out[2, 9:].float().abs().max()) == 0.0


def test_ragged_plain_matches_pallas():
    """The ragged mix of q_len 7/1/5 from ``tests/test_mixed_batch.py``, at
    S=256 so the decode row's second query block is genuinely skipped."""
    from dynamo_tpu.ops.pallas.ragged import (
        ragged_mixed_attention_stacked as pallas_ragged)
    rng, pages, table = _kernel_setup(7, P=12, N=40)
    q_lens, ctxs, S = [7, 1, 5], [23, 9, 5], 256
    q, positions, total = _chunk_batch(rng, q_lens, ctxs, S)
    ref = pallas_ragged(q, pages, 1, jnp.asarray(table),
                        jnp.asarray(positions), jnp.asarray(total), 0.09,
                        interpret=True)
    out = ragged_mixed_attention_stacked(
        _tb(q), _tb(pages), 1, t(table), t(positions), t(total), 0.09)
    ref = np.asarray(ref, np.float32)
    for i, ql in enumerate(q_lens):
        close(ref[i, :ql], out[i, :ql], BF16_TOL)
    # the skipped block writes zeros in both; every pad slot is zero here
    assert float(np.abs(ref[1, 128:]).max()) == 0.0
    assert float(out[1, 128:].float().abs().max()) == 0.0
    for i, ql in enumerate(q_lens):
        assert float(out[i, ql:].float().abs().max()) == 0.0


def test_kernel_plain_ignores_nan_in_garbage_page():
    """Masked positions are selected away, not multiplied by p=0: a NaN in
    the garbage page 0 (which unused table entries point at) stays out."""
    rng, pages, table = _kernel_setup(8)
    pages = _tb(pages)
    pages[:, 0] = float("nan")
    table[0, 2:] = 0                         # row 0 lives on 2 pages
    q_lens, ctxs, S = [5, 8, 1], [12, 40, 30], 8
    q, positions, total = _chunk_batch(rng, q_lens, ctxs, S)
    for fn in (paged_prefill_attention_stacked,
               ragged_mixed_attention_stacked):
        out = fn(_tb(q), pages, 1, t(table), t(positions), t(total), 0.1)
        assert bool(torch.isfinite(out).all())
    out = paged_decode_attention_stacked(
        _tb(q)[:, :1], pages, 0, t(table), t(positions[:, :1]),
        t(np.array([12, 40, 30], np.int32)), 0.1)
    assert bool(torch.isfinite(out).all())


def test_kernel_head_mapping_gqa():
    """q head h reads kv head h // G: with every kv head's V a constant
    (its index), each query head's output is exactly its group's index."""
    rng, pages, table = _kernel_setup(9, Hq=8, Hkv=2)
    pages = np.array(jnp.asarray(pages, jnp.float32))
    for hk in range(2):
        pages[:, :, 1, hk] = hk + 1.0
    pages = torch.from_numpy(pages).to(torch.bfloat16)
    q = torch.randn(3, 1, 8, 128).to(torch.bfloat16)
    total = torch.tensor([5, 17, 40], dtype=torch.int32)
    out = paged_decode_attention_stacked(q, pages, 1, t(table),
                                         (total - 1)[:, None], total, 0.1)
    expect = torch.tensor([1.0] * 4 + [2.0] * 4)[None, :, None]
    assert torch.equal(out[:, 0].float(), expect.expand(3, 8, 128))


def test_row_ulp_error_scales_with_each_row():
    """The kernels' tolerance measure: a difference counts in bf16 ulps of
    its own row's largest value, and a zero row must match exactly."""
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    ref = torch.tensor([[1.5, -0.25, 0.0],      # row max 1.5: ulp 2^-7
                        [0.03125, 0.01, -0.02],  # row max 2^-5: ulp 2^-12
                        [0.0, 0.0, 0.0]])       # a pad slot
    out = ref.clone()
    out[0, 1] += 2.0 ** -7
    out[1, 0] += 2.0 ** -7                      # same size, 32 ulps here
    e = row_ulp_error(out, ref)
    assert e.tolist() == [1.0, 32.0, 0.0]
    out[2, 2] = 2.0 ** -20
    assert float(row_ulp_error(out, ref)[2]) > 1e20
    assert float(row_ulp_error(ref.to(torch.bfloat16), ref).max()) <= 0.5
