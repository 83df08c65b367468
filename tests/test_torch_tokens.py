"""The port's block hashing against ``dynamo_tpu.tokens``.

The port carries its own XXH3-64 (``dynamo_tpu_torch/xxh3.py``; the GPU
host's image is not assumed to ship ``xxhash``). Its digests must equal
``xxhash.xxh3_64_intdigest`` at every length class (0-16, 17-128, 129-240
bytes and the striped long path), and the port's ``TokenBlockSequence``
must give the reference's chained block hashes, which is what lets a KV
router match prefixes across both engines.
"""

import random

import pytest
import xxhash

from dynamo_tpu import tokens as jtokens
from dynamo_tpu_torch import tokens as ttokens
from dynamo_tpu_torch.xxh3 import xxh3_64_intdigest

LENGTHS = list(range(0, 260, 7)) + [1, 2, 3, 4, 8, 9, 16, 17, 72, 128, 129,
                                    240, 241, 1023, 1024, 1025, 4100]


@pytest.mark.parametrize("seed", [0, 1337, 2**63 + 11])
def test_xxh3_matches_xxhash(seed):
    rng = random.Random(seed)
    for n in LENGTHS:
        data = bytes(rng.getrandbits(8) for _ in range(n))
        assert xxh3_64_intdigest(data, seed) == xxhash.xxh3_64_intdigest(
            data, seed=seed), n


@pytest.mark.parametrize("block_size", [4, 16, 64])
def test_block_hashes_match_reference(block_size):
    rng = random.Random(block_size)
    toks = [rng.randrange(0, 128256) for _ in range(5 * block_size + 3)]
    salt = ttokens.compute_hash(b"model-salt")
    assert salt == jtokens.compute_hash(b"model-salt")
    assert ttokens.compute_block_hash_for_seq(toks, block_size, salt) == \
        jtokens.compute_block_hash_for_seq(toks, block_size, salt)
    a = ttokens.TokenBlockSequence(toks, block_size, salt)
    b = jtokens.TokenBlockSequence(toks, block_size, salt)
    assert a.block_hashes() == b.block_hashes()
    assert [x.local_hash for x in a.blocks] == [x.local_hash
                                                for x in b.blocks]
    a.unwind(block_size + 1)
    b.unwind(block_size + 1)
    assert a.block_hashes() == b.block_hashes() and a.tokens() == b.tokens()
