"""The port's ``ops/prng.py`` against ``jax.random``, bit for bit.

Keys, ``fold_in`` (scalar data and a tensor of rows), ``split``, 32-bit
random bits, ``uniform`` and ``gumbel`` must give the same words and the
same float bits as JAX's default PRNG in this repo's mode
(``threefry2x32``, partitionable), over several seeds and shapes —
including ``(B, 64)`` with odd B, the sampler's draw, and the nested
fold-in schedule of the sampler's seeded rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import prng

torch.set_num_threads(2)

SEEDS = [0, 1, 12345, 2 ** 31 - 1, -1]
SHAPES = [(1,), (5,), (2, 3, 5), (7, 64), (33, 64)]


def _words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_prng_mode_is_the_one_ported():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    for data in (0, 7, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _words(jax.random.fold_in(jk, data)),
            prng.fold_in(tk, data).numpy())
    rows = np.arange(9)
    want = np.stack([_words(jax.random.fold_in(jk, int(r))) for r in rows])
    np.testing.assert_array_equal(
        want, prng.fold_in(tk, torch.from_numpy(rows)).numpy())
    np.testing.assert_array_equal(
        _words(jax.random.split(jk, 3)), prng.split(tk, 3).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_gumbel_match_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32)
                   ).astype(np.int64),
        prng.random_bits(tk, shape).numpy())
    for lo, hi in ((0.0, 1.0), (0.25, 3.0), (-2.0, 5.0)):
        np.testing.assert_array_equal(
            _bits(jax.random.uniform(jk, shape, minval=lo, maxval=hi)),
            _bits(prng.uniform(tk, shape, lo, hi)))
    np.testing.assert_array_equal(
        _bits(jax.random.gumbel(jk, shape, dtype=jnp.float32)),
        _bits(prng.gumbel(tk, shape)))


def test_gumbel_large_draw_matches_jax():
    """A quarter-million draws: the log is XLA's own, not ``torch.log``
    (which differs from it by an ulp on about one input in five)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 3)
    tk = prng.fold_in(prng.PRNGKey(9), 3)
    want = _bits(jax.random.gumbel(jk, (500, 500), dtype=jnp.float32))
    np.testing.assert_array_equal(want, _bits(prng.gumbel(tk, (500, 500))))
    g = prng.gumbel(tk, (500, 500))
    assert not np.array_equal(_bits(-torch.log(-torch.log(
        prng.uniform(tk, (500, 500), prng._TINY, 1.0)))), want)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("B", [1, 3, 7])
def test_sampler_key_schedule_matches_jax(B):
    """The sampler's per-row keys, folded in one pass over a tensor of
    rows: unseeded rows ``fold_in(fold_in(step_key, 7), row)``, seeded
    rows ``fold_in(fold_in(base, seed), position)``, each drawing a
    ``(64,)`` Gumbel row; and the batch-wide ``(B, 64)`` draw."""
    base_j, base_t = jax.random.PRNGKey(5), prng.PRNGKey(5)
    step_j, step_t = jax.random.fold_in(base_j, 17), prng.fold_in(base_t, 17)
    rng = np.random.default_rng(B)
    seeds = rng.integers(1, 2 ** 31 - 1, size=B).astype(np.uint32)
    pos = rng.integers(0, 4096, size=B).astype(np.uint32)

    def draw(k):
        return jax.random.gumbel(k, (64,), dtype=jnp.float32)

    g_row = jax.vmap(lambda r: draw(jax.random.fold_in(
        jax.random.fold_in(step_j, 7), r)))(jnp.arange(B))
    g_seed = jax.vmap(lambda s, p: draw(jax.random.fold_in(
        jax.random.fold_in(base_j, s), p)))(jnp.asarray(seeds),
                                            jnp.asarray(pos))
    rows = prng.fold_in(prng.fold_in(step_t, 7)[None], torch.arange(B))
    seeded = prng.fold_in(prng.fold_in(base_t[None],
                                       torch.from_numpy(seeds.astype(
                                           np.int64))),
                          torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_array_equal(_bits(g_row),
                                  _bits(prng.gumbel(rows, (64,))))
    np.testing.assert_array_equal(_bits(g_seed),
                                  _bits(prng.gumbel(seeded, (64,))))
    np.testing.assert_array_equal(
        _bits(jax.random.gumbel(step_j, (B, 64), dtype=jnp.float32)),
        _bits(prng.gumbel(step_t, (B, 64))))
