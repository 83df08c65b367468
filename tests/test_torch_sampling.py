"""The port's ``sample_tokens`` against ``dynamo_tpu.ops.sampling``.

The same float32 logits and the same Gumbel noise — drawn here with
``jax.random.gumbel`` from the key the reference's ``sample_tokens`` draws
with — must give identical tokens over greedy, top-k, top-p, min-p and
plain temperature rows, and with tied logits. The logprobs agree within
LOGPROB_RTOL, not bit for bit: ``logsumexp`` sums the exponentials in
another order in XLA than in PyTorch (a few float32 ulps; ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import sampling as jsamp
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
    a = tsamp.gumbel_noise((4, K), torch.Generator().manual_seed(1), "cpu")
    b = tsamp.gumbel_noise((4, K), torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
