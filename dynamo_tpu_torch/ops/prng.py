"""JAX's default PRNG in PyTorch: threefry2x32 keys, ``fold_in`` and the
``uniform`` / ``gumbel`` draws, bit for bit.

The reference samples with ``jax.random`` under
``jax_default_prng_impl=threefry2x32`` and ``jax_threefry_partitionable=True``;
a stream the port must hold token for token against it has to draw the
same noise. So this module reproduces, from ``jax/_src/prng.py`` and
``jax/_src/random.py``:

- ``PRNGKey(seed)``: the key ``(0, seed & 0xFFFFFFFF)`` (``threefry_seed``
  of a seed cut to 32 bits);
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``
  (``_threefry_fold_in``), and ``split``, whose key i is ``fold_in(key,
  i)`` in this layout;
- ``random_bits(key, shape)``: the partitionable layout, the 64-bit flat
  index of each element split into (hi, lo) counters, hashed, the two
  output words XORed into one 32-bit draw;
- ``uniform``: the top 23 bits as a mantissa of 1.x, minus 1, scaled and
  clamped below at ``minval``;
- ``gumbel``: ``mode="low"``, ``-log(-log(uniform(tiny, 1)))``, with the
  log computed as XLA's CPU backend computes it (``xla_log``).

A key is an int64 tensor ``[..., 2]`` holding two uint32 words (int64, so
32-bit sums, shifts and XORs never overflow and need no unsigned dtype);
every function takes a batch of keys, so B rows' keys fold and draw in
one pass. No kernel stands behind it: it is a few dozen elementwise ops,
the same on the CPU and the card.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds), elementwise over broadcast
    int64 tensors of uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor. Under
    JAX's default 32-bit mode the seed is cut to its low 32 bits and the
    high word is 0."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor,
            data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in`` over keys ``[..., 2]`` and data broadcast
    against the keys' batch shape (taken as uint32, as JAX does)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
        zero = torch.zeros_like(data)
    else:   # a Python int stays a scalar operand: no upload
        data, zero = int(data) & MASK32, 0
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], zero, data)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one key ``[2]``: ``[num, 2]``. In
    the partitionable layout key i hashes the counter (0, i), which is
    ``fold_in(key, i)``."""
    return fold_in(key[None, :], torch.arange(num, device=key.device))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits``: int64 words ``[*key_batch, *shape]``."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    idx = idx.reshape(shape)
    lead = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + lead)
    k2 = key[..., 1].reshape(key.shape[:-1] + lead)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` in ``[minval, maxval)``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval), _f32(maxval)
    # floats * (maxval - minval) + minval as one fused multiply-add, as
    # XLA emits it
    return torch.clamp(_fma(floats, _f32(hi - lo), lo), min=lo)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32
    values is exact in float64."""
    return (a.double() * b + c).float()


# Cephes' log(1 + x) polynomial on [sqrt(1/2) - 1, sqrt(2) - 1]
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive normal ``x`` as XLA's CPU backend
    computes it: Cephes' range reduction and polynomial, evaluated with
    fused multiply-adds. ``torch.log`` is correctly rounded far more often,
    and so differs from it by an ulp on about one input in five; the
    reference's Gumbel noise comes from this one. (Zero, infinite,
    negative and subnormal inputs, which a Gumbel draw never makes, are
    not handled.)"""
    p = [_f32(v) for v in _LOG_P]
    bits = x.float().contiguous().view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524)
    m = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = m * m
    x3 = x2 * m
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4))
    m = _fma(x2, -0.5, m) + y
    return _fma(e, _f32(0.693359375), m)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``jax.random.gumbel(key, shape)`` (``mode="low"``):
    ``-log(-log(u))`` with ``u = uniform(tiny, 1)``, the logs as XLA's."""
    return -xla_log(-xla_log(uniform(key, shape, _TINY, 1.0)))


__all__ = ["PRNGKey", "fold_in", "split", "random_bits", "uniform",
           "gumbel", "threefry2x32", "xla_log"]
