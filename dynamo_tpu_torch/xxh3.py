"""XXH3-64 with a seed, in plain Python.

Block hashing (``tokens.py``) must give the very hashes the JAX package and
the KV router compute with the ``xxhash`` package, but the GPU host does
not ship that package. This is the XXH3 64-bit algorithm (xxHash 0.8,
``XXH3_64bits_withSeed``) written out for every input length: the short
paths (0-16 bytes), the mid paths (17-240 bytes, which cover one block of
16 tokens plus its 8-byte parent hash) and the striped long path.
``tests/test_torch_tokens.py`` holds it equal to ``xxhash.xxh3_64_intdigest``.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX1 = 0x165667919E3779F9
_PMX2 = 0x9FB21C651E98DF25

_SECRET = bytes([
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c,
    0xf7, 0x21, 0xad, 0x1c, 0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb,
    0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f, 0xcb, 0x79, 0xe6, 0x4e,
    0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6,
    0x81, 0x3a, 0x26, 0x4c, 0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb,
    0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3, 0x71, 0x64, 0x48, 0x97,
    0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7,
    0xc7, 0x0b, 0x4f, 0x1d, 0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31,
    0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64, 0xea, 0xc5, 0xac, 0x83,
    0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26,
    0x29, 0xd4, 0x68, 0x9e, 0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc,
    0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce, 0x45, 0xcb, 0x3a, 0x8f,
    0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
])
_STRIPE = 64
_ACC_NB = 8
_SECRET_CONSUME = 8
_MIDSIZE_MAX = 240


def _r64(b: bytes, i: int) -> int:
    return struct.unpack_from("<Q", b, i)[0]


def _r32(b: bytes, i: int) -> int:
    return struct.unpack_from("<I", b, i)[0]


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, n: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * _PMX2) & _M64
    h ^= (h >> 35) + n
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _fold(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _mix16(data: bytes, i: int, sec: bytes, j: int, seed: int) -> int:
    lo = _r64(data, i) ^ ((_r64(sec, j) + seed) & _M64)
    hi = _r64(data, i + 8) ^ ((_r64(sec, j + 8) - seed) & _M64)
    return _fold(lo, hi)


def _len_0to16(data: bytes, n: int, seed: int) -> int:
    s = _SECRET
    if n > 8:
        f1 = ((_r64(s, 24) ^ _r64(s, 32)) + seed) & _M64
        f2 = ((_r64(s, 40) ^ _r64(s, 48)) - seed) & _M64
        lo = _r64(data, 0) ^ f1
        hi = _r64(data, n - 8) ^ f2
        acc = (n + _swap64(lo) + hi + _fold(lo, hi)) & _M64
        return _avalanche(acc)
    if n >= 4:
        seed ^= _swap32(seed & _M32) << 32
        in1 = _r32(data, 0)
        in2 = _r32(data, n - 4)
        flip = ((_r64(s, 8) ^ _r64(s, 16)) - seed) & _M64
        return _rrmxmx(((in2 + (in1 << 32)) & _M64) ^ flip, n)
    if n > 0:
        c1, c2, c3 = data[0], data[n >> 1], data[n - 1]
        combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
        flip = ((_r32(s, 0) ^ _r32(s, 4)) + seed) & _M64
        return _xxh64_avalanche(combined ^ flip)
    return _xxh64_avalanche(seed ^ _r64(s, 56) ^ _r64(s, 64))


def _len_17to128(data: bytes, n: int, seed: int) -> int:
    s = _SECRET
    acc = (n * _P64_1) & _M64
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(data, 48, s, 96, seed)
                acc += _mix16(data, n - 64, s, 112, seed)
            acc += _mix16(data, 32, s, 64, seed)
            acc += _mix16(data, n - 48, s, 80, seed)
        acc += _mix16(data, 16, s, 32, seed)
        acc += _mix16(data, n - 32, s, 48, seed)
    acc += _mix16(data, 0, s, 0, seed)
    acc += _mix16(data, n - 16, s, 16, seed)
    return _avalanche(acc & _M64)


def _len_129to240(data: bytes, n: int, seed: int) -> int:
    s = _SECRET
    acc = (n * _P64_1) & _M64
    for i in range(8):
        acc += _mix16(data, 16 * i, s, 16 * i, seed)
    acc = _avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc += _mix16(data, 16 * i, s, 16 * (i - 8) + 3, seed)
    acc += _mix16(data, n - 16, s, 136 - 17, seed)
    return _avalanche(acc & _M64)


def _accumulate_512(acc: list, data: bytes, i: int, sec: bytes, j: int):
    for k in range(_ACC_NB):
        val = _r64(data, i + 8 * k)
        key = val ^ _r64(sec, j + 8 * k)
        acc[k ^ 1] = (acc[k ^ 1] + val) & _M64
        acc[k] = (acc[k] + (key & _M32) * (key >> 32)) & _M64


def _scramble(acc: list, sec: bytes, j: int):
    for k in range(_ACC_NB):
        a = acc[k]
        a ^= a >> 47
        a ^= _r64(sec, j + 8 * k)
        acc[k] = (a * _P32_1) & _M64


def _hash_long(data: bytes, n: int, seed: int) -> int:
    if seed:
        sec = bytearray(len(_SECRET))
        for i in range(0, len(_SECRET), 16):
            struct.pack_into("<Q", sec, i, (_r64(_SECRET, i) + seed) & _M64)
            struct.pack_into("<Q", sec, i + 8,
                             (_r64(_SECRET, i + 8) - seed) & _M64)
        sec = bytes(sec)
    else:
        sec = _SECRET
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    stripes_per_block = (len(sec) - _STRIPE) // _SECRET_CONSUME
    block_len = _STRIPE * stripes_per_block
    nb_blocks = (n - 1) // block_len
    for blk in range(nb_blocks):
        for st in range(stripes_per_block):
            _accumulate_512(acc, data, blk * block_len + st * _STRIPE, sec,
                            st * _SECRET_CONSUME)
        _scramble(acc, sec, len(sec) - _STRIPE)
    nb_stripes = ((n - 1) - block_len * nb_blocks) // _STRIPE
    for st in range(nb_stripes):
        _accumulate_512(acc, data, nb_blocks * block_len + st * _STRIPE, sec,
                        st * _SECRET_CONSUME)
    _accumulate_512(acc, data, n - _STRIPE, sec, len(sec) - _STRIPE - 7)
    result = (n * _P64_1) & _M64
    for k in range(4):
        result += _fold(acc[2 * k] ^ _r64(sec, 11 + 16 * k),
                        acc[2 * k + 1] ^ _r64(sec, 11 + 16 * k + 8))
    return _avalanche(result & _M64)


def xxh3_64_intdigest(data: bytes, seed: int = 0) -> int:
    """``xxhash.xxh3_64_intdigest(data, seed=seed)``."""
    data = bytes(data)
    seed &= _M64
    n = len(data)
    if n <= 16:
        return _len_0to16(data, n, seed)
    if n <= 128:
        return _len_17to128(data, n, seed)
    if n <= _MIDSIZE_MAX:
        return _len_129to240(data, n, seed)
    return _hash_long(data, n, seed)


__all__ = ["xxh3_64_intdigest"]
