"""The port's ``engine/guided.py`` and ``TorchEngine``'s guided masks
against the reference.

- The module is a copy of ``dynamo_tpu/engine/guided.py`` (it imports only
  ``json``, ``typing`` and ``numpy``): the two files must be equal except in
  import lines.
- ``TorchEngine._guided_masks`` and ``JaxEngine._guided_masks`` must give
  the same packed allow-masks for the same rows, step by step along a
  grammar-legal path, on a small synthetic byte vocabulary.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from dynamo_tpu.engine.jax_engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.engine.torch_engine import (TorchEngine,
                                                  TorchEngineConfig)
from dynamo_tpu_torch.models.config import ModelConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 0
SCHEMA = {"mode": "json_schema", "schema": {
    "type": "object",
    "properties": {"ok": {"type": "boolean"},
                   "n": {"type": "integer"},
                   "tag": {"enum": ["ab", "cd"]}},
    "required": ["ok", "n"]}}


def byte_vocab(V, seed=0):
    """ids 1-127 are single ASCII bytes, the rest random 2-4-byte
    printable strings or None (special); id 0 is the EOS."""
    rng = np.random.default_rng(seed)
    alphabet = b'{}[]":, 0123456789abcdefghijklmnoptrue'
    toks = [None] + [bytes([b]) for b in range(1, 128)]
    for _ in range(128, V):
        if rng.random() < 0.1:
            toks.append(None)
        else:
            n = int(rng.integers(2, 5))
            toks.append(bytes(rng.choice(list(alphabet), size=n).tolist()))
    return toks


def _imports_dropped(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(("import ", "from "))]


def test_guided_copy_equals_reference_except_imports():
    ref = _imports_dropped(os.path.join(REPO, "dynamo_tpu/engine/guided.py"))
    port = _imports_dropped(
        os.path.join(REPO, "dynamo_tpu_torch/engine/guided.py"))
    assert port == ref


def _seq(rid, guided, generated):
    req = SimpleNamespace(request_id=rid, sampling_options=SimpleNamespace(
        guided=guided))
    return SimpleNamespace(request=req, generated=list(generated))


def test_guided_masks_match_jax_engine():
    V = 256
    toks = byte_vocab(V)
    sizes = dict(num_pages=16, page_size=4, max_num_seqs=4,
                 max_prefill_chunk=16, max_context=64)
    jeng = JaxEngine.random_init(JModelConfig.tiny(),
                                 JaxEngineConfig(**sizes))
    teng = TorchEngine.random_init(ModelConfig.tiny(),
                                   TorchEngineConfig(**sizes), device="cpu")
    for eng in (jeng, teng):
        eng.enable_guided(toks, [EOS])
    # walk a legal document through the guided row; row 1 is unconstrained
    doc = json.dumps({"ok": True, "n": 42, "tag": "cd"}).encode()
    path = list(doc) + [EOS]
    assert teng._guided_vocab.words == V // 32
    for k in range(len(path) + 1):
        rows = [_seq("g", SCHEMA, path[:k]), _seq("p", None, [])]
        want = jeng._guided_masks(rows, 4)
        got = teng._guided_masks(rows, 4)
        np.testing.assert_array_equal(want, got)
        assert got.dtype == np.uint32 and got.shape == (4, V // 32)
        assert (got[1:] == 0xFFFFFFFF).all()
        if k < len(path):
            t = path[k]                     # the next byte is allowed
            assert (int(got[0, t >> 5]) >> (t & 31)) & 1, k
    # no guided row: no masks at all
    assert teng._guided_masks([_seq("p", None, [])], 4) is None
