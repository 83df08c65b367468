"""The port's ``ops/sampling.py`` against ``dynamo_tpu.ops.sampling``.

The same float32 logits and the same Gumbel noise — drawn here with
``jax.random.gumbel`` from the key the reference's ``sample_tokens`` draws
with — must give identical tokens over greedy, top-k, top-p, min-p and
plain temperature rows, and with tied logits. The port's own draw
(``sampling_noise``, the reference's key schedule) must pick the same
tokens as the reference's ``sample_tokens`` given only the key, with
seeded and unseeded rows mixed. Penalties, the penalty-window upkeep, the
guided mask and speculative verification must match exactly on the same
inputs. The logprobs agree within LOGPROB_RTOL, not bit for bit:
``logsumexp`` sums the exponentials in another order in XLA than in
PyTorch (a few float32 ulps; ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import sampling as jsamp
from dynamo_tpu_torch.ops import prng
from dynamo_tpu_torch.ops import sampling as tsamp

# small CPU shapes: keep torch off the cores other test workers time on
torch.set_num_threads(2)

B, V = 10, 300
LOGPROB_RTOL = 2e-6
K = min(tsamp.TOPK_MAX, V)


def _rows():
    # greedy, top-k, top-p, min-p, plain temperature — two of each
    temp = np.array([0, 0, .8, .7, 1., .9, 1., 1.2, 1., .5], np.float32)
    top_k = np.array([0, 0, 5, 3, 0, 0, 0, 0, 0, 0], np.int32)
    top_p = np.array([1, 1, 1, 1, .7, .5, 1, 1, 1, 1], np.float32)
    min_p = np.array([0, 0, 0, 0, 0, 0, .1, .3, 0, 0], np.float32)
    return temp, top_k, top_p, min_p


def _both(logits, seed, with_min_p=True):
    temp, top_k, top_p, min_p = _rows()
    key = jax.random.PRNGKey(seed)
    gumbel = np.array(jax.random.gumbel(key, (B, K), dtype=jnp.float32))
    jt, jl = jsamp.sample_tokens(
        jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p),
        min_p=jnp.asarray(min_p) if with_min_p else None)
    tt, tl = tsamp.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(gumbel),
        torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p),
        min_p=torch.from_numpy(min_p) if with_min_p else None)
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tl.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokens_and_logprobs_match_jax(seed):
    logits = (np.random.default_rng(seed).normal(size=(B, V)) * 3).astype(
        np.float32)
    (jt, jl), (tt, tl) = _both(logits, seed + 10)
    assert tt.dtype == np.int32
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_allclose(tl, jl, rtol=LOGPROB_RTOL, atol=0)


def test_without_min_p_matches_jax():
    logits = np.random.default_rng(7).normal(size=(B, V)).astype(np.float32)
    (jt, jl), (tt, tl) = _both(logits, 3, with_min_p=False)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_allclose(tl, jl, rtol=LOGPROB_RTOL, atol=0)


def test_tied_logits_resolve_like_jax():
    """Coarse logits tie often; ``torch.topk`` may order tied candidates
    either way, the port re-orders them as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(4)
    logits = np.round(rng.normal(size=(B, V)) * 2).astype(np.float32)
    (jt, _), (tt, _) = _both(logits, 5)
    np.testing.assert_array_equal(jt, tt)
    vals, idx = jax.lax.top_k(jnp.asarray(logits), K)
    tv, ti = tsamp.top_k_stable(torch.from_numpy(logits), K)
    np.testing.assert_array_equal(np.asarray(idx), ti.numpy())
    np.testing.assert_array_equal(np.asarray(vals), tv.numpy())


def test_gumbel_noise_seeded_and_finite():
    key = prng.fold_in(prng.PRNGKey(1), 3)
    a = tsamp.sampling_noise(key, 4, K)
    b = tsamp.sampling_noise(prng.fold_in(prng.PRNGKey(1), 3), 4, K)
    assert a.shape == (4, K)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert not torch.equal(a, tsamp.sampling_noise(
        prng.fold_in(prng.PRNGKey(1), 4), 4, K))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_sampling_matches_jax(seed):
    """Seeded and unseeded rows mixed, each seeded row at its own token
    position: the port draws from the key alone, as the reference does."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temp, top_k, top_p, min_p = _rows()
    temp[:2] = 1.0                        # no greedy rows: every draw counts
    seeds = np.array([0, 5, 0, 9, 1, 0, 2 ** 31 - 1, 0, 5, 77], np.int32)
    pos = rng.integers(0, 2048, size=B).astype(np.int32)
    base = jax.random.PRNGKey(seed + 3)
    step = jax.random.fold_in(base, 41)
    jt, jl = jsamp.sample_tokens(
        *_j(logits), step, *_j(temp, top_k, top_p), seeds=jnp.asarray(seeds),
        seed_rng=base, seed_pos=jnp.asarray(pos), min_p=jnp.asarray(min_p))
    tbase = prng.PRNGKey(seed + 3)
    noise = tsamp.sampling_noise(prng.fold_in(tbase, 41), B, K,
                                 seeds=torch.from_numpy(seeds),
                                 seed_rng=tbase,
                                 seed_pos=torch.from_numpy(pos))
    tt, tl = tsamp.sample_tokens(*_t(logits), noise, *_t(temp, top_k, top_p),
                                 min_p=torch.from_numpy(min_p))
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=LOGPROB_RTOL, atol=0)
    # batch-wide draw: no seeds, the step key alone
    jt, _ = jsamp.sample_tokens(*_j(logits), step, *_j(temp, top_k, top_p))
    tt, _ = tsamp.sample_tokens(*_t(logits),
                                tsamp.sampling_noise(prng.fold_in(tbase, 41),
                                                     B, K),
                                *_t(temp, top_k, top_p))
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


def _penalty_inputs(seed, W=6):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    ids = np.zeros((B, W), np.int32)
    cnt = np.zeros((B, W), np.float32)
    ctx = np.zeros((B, W), np.float32)
    bias = np.zeros((B, W), np.float32)
    for b in range(B):
        n = int(rng.integers(0, W + 1))          # the rest are pad entries
        ids[b, :n] = rng.choice(V, size=n, replace=False)
        cnt[b, :n] = rng.integers(0, 4, size=n)
        ctx[b, :n] = (rng.random(n) < 0.7) | (cnt[b, :n] > 0)
        bias[b, :n] = np.where(rng.random(n) < 0.3,
                               rng.normal(size=n) * 5, 0.0)
    fp = rng.uniform(0, 1.5, size=B).astype(np.float32)
    pp = rng.uniform(0, 1.5, size=B).astype(np.float32)
    rp = rng.uniform(0.5, 2.0, size=B).astype(np.float32)
    rp[:2] = [0.0, -1.0]                        # rep_pen <= 0 is off
    rp[2] = 1.0
    return logits, ids, cnt, ctx, fp, pp, rp, bias


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_matches_jax(seed):
    logits, ids, cnt, ctx, fp, pp, rp, bias = _penalty_inputs(seed)
    for pen_bias in (None, bias):
        want = np.asarray(jsamp.apply_penalties(
            *_j(logits, ids, cnt, ctx, fp, pp, rp),
            pen_bias=None if pen_bias is None else jnp.asarray(pen_bias)))
        got = tsamp.apply_penalties(
            *_t(logits, ids, cnt, ctx, fp, pp, rp),
            pen_bias=None if pen_bias is None else torch.from_numpy(pen_bias))
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.numpy().view(np.int32))
    # a zero-width window is the identity
    z = np.zeros((B, 0), np.int32)
    assert torch.equal(tsamp.apply_penalties(
        *_t(logits, z, z.astype(np.float32), z.astype(np.float32), fp, pp,
            rp)), torch.from_numpy(logits))


def test_update_penalty_window_matches_jax():
    rng = np.random.default_rng(3)
    W = 5
    ids = rng.integers(0, 12, size=(B, W)).astype(np.int32)
    n = rng.integers(0, W + 1, size=B).astype(np.int32)
    n[0], n[1] = W, 0                             # full and empty windows
    cnt = (rng.integers(1, 4, size=(B, W)) * (np.arange(W) < n[:, None])
           ).astype(np.float32)
    ctx = (rng.random((B, W)) < 0.5).astype(np.float32)
    state_j = _j(ids, cnt, ctx, n)
    state_t = _t(ids, cnt, ctx, n)
    for step in range(4):
        toks = rng.integers(0, 12, size=B).astype(np.int32)
        active = rng.random(B) < 0.8
        state_j = jsamp.update_penalty_window(*state_j, *_j(toks, active))
        state_t = tsamp.update_penalty_window(*state_t, *_t(toks, active))
        for a, b in zip(state_j, state_t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert np.asarray(a).dtype == b.numpy().dtype


def test_penalty_window_entries_matches_jax():
    rng = np.random.default_rng(4)
    W, S = 6, 12
    prompt = rng.integers(0, 20, size=(B, S)).astype(np.int32)
    valid = rng.random((B, S)) < 0.8
    ids = rng.integers(0, 20, size=(B, W)).astype(np.int32)
    n = rng.integers(0, W + 1, size=B).astype(np.int32)
    want = jsamp.penalty_window_entries(*_j(prompt, valid, ids, n))
    got = tsamp.penalty_window_entries(*_t(prompt, valid, ids, n))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _mask_words(rng, rows, V):
    words = rng.integers(0, 2 ** 32, size=(rows, -(-V // 32)),
                         dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF                         # an unconstrained row
    return words


@pytest.mark.parametrize("Vm", [300, 45, 64])
def test_apply_vocab_mask_matches_jax(Vm):
    rng = np.random.default_rng(Vm)
    logits = rng.normal(size=(4, Vm)).astype(np.float32)
    words = _mask_words(rng, 4, Vm)
    want = np.asarray(jsamp.apply_vocab_mask(*_j(logits, words)))
    got = tsamp.apply_vocab_mask(torch.from_numpy(logits),
                                 torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(got[0].numpy(), logits[0])   # no-op row


@pytest.mark.parametrize("with_mask", [False, True])
def test_spec_verify_matches_jax(with_mask):
    rng = np.random.default_rng(5 + with_mask)
    Bs, S = 6, 4
    logits = (rng.normal(size=(Bs, S, V)) * 2).astype(np.float32)
    tokens = rng.integers(0, V, size=(Bs, S)).astype(np.int32)
    # make some drafts the argmax so greedy rows accept a prefix
    tokens[:3, 1] = logits[:3, 0].argmax(-1)
    tokens[:2, 2] = logits[:2, 1].argmax(-1)
    temp = np.array([0, 0, 0, 1.0, 0.7, 1.3], np.float32)
    top_k = np.array([0, 0, 5, 0, 8, 0], np.int32)
    top_p = np.array([1, 1, 1, .9, 1, 1], np.float32)
    masks = None
    if with_mask:
        masks = _mask_words(rng, Bs * S, V).reshape(Bs, S, -1)
        masks[..., 0] |= 0xFFFF                  # keep some ids legal
    key = jax.random.PRNGKey(13)
    want = jsamp.spec_verify(*_j(logits, tokens), key,
                             *_j(temp, top_k, top_p),
                             None if masks is None else jnp.asarray(masks))
    got = tsamp.spec_verify(
        *_t(logits, tokens), prng.PRNGKey(13), *_t(temp, top_k, top_p),
        None if masks is None else torch.from_numpy(masks.view(np.int32)))
    for i in (0, 1):                              # n_acc, final token
        np.testing.assert_array_equal(np.asarray(want[i]), got[i].numpy())
    for i in (2, 3):                              # logprobs
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=LOGPROB_RTOL, atol=0)
    assert np.asarray(want[0]).max() > 0          # some drafts accepted
