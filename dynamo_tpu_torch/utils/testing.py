"""Test fixtures: a tiny self-contained byte-level tokenizer + model dir.

The CI environment has no network access, so tests can't download HF
artifacts.  This builds a fully functional byte-level BPE tokenizer (256-byte
alphabet, no merges) programmatically — it round-trips arbitrary UTF-8 text —
plus an HF-style model directory (config.json / tokenizer.json /
tokenizer_config.json with a chat template), which exercises the same loading
paths as a real model repo.  Parity with the reference's
``lib/llm/tests/data/sample-models/`` golden fixtures.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from tokenizers import Tokenizer, decoders, models, pre_tokenizers

from dynamo_tpu_torch.model_card import ModelDeploymentCard

TEST_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>{{ message['content'] }}<|end|>"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}"
)


def make_test_tokenizer() -> Tokenizer:
    alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    for special in ("<|end|>", "<|assistant|>", "<|user|>", "<|system|>", "<eos>"):
        vocab[special] = len(vocab)
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    return tok


def make_test_model_dir(path: str, name: str = "test-model",
                        context_length: int = 2048,
                        vocab_size: Optional[int] = None,
                        **config_overrides) -> str:
    """Write an HF-style model dir usable by ModelDeploymentCard.from_local_path.

    Extra keyword args override config.json fields (e.g.
    ``num_key_value_heads=4`` for a tp=4-shardable toy model)."""
    os.makedirs(path, exist_ok=True)
    tok = make_test_tokenizer()
    eos_id = tok.token_to_id("<eos>")
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "llama",
            "max_position_embeddings": context_length,
            "vocab_size": vocab_size or tok.get_vocab_size(),
            "eos_token_id": eos_id,
            "bos_token_id": None,
            "hidden_size": 64,
            "intermediate_size": 128,
            "num_attention_heads": 4,
            "num_key_value_heads": 2,
            "num_hidden_layers": 2,
            "rms_norm_eps": 1e-5,
            "rope_theta": 10000.0,
            **config_overrides,
        }, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": TEST_CHAT_TEMPLATE,
                   "eos_token": "<eos>"}, f)
    return path


def make_test_card(name: str = "test-model",
                   context_length: int = 2048,
                   kv_cache_block_size: int = 16) -> ModelDeploymentCard:
    """In-memory model card with the inline test tokenizer."""
    tok = make_test_tokenizer()
    return ModelDeploymentCard(
        name=name,
        context_length=context_length,
        kv_cache_block_size=kv_cache_block_size,
        eos_token_ids=[tok.token_to_id("<eos>")],
        chat_template=TEST_CHAT_TEMPLATE,
        tokenizer_json=tok.to_str(),
    )


__all__ = ["make_test_tokenizer", "make_test_model_dir", "make_test_card",
           "TEST_CHAT_TEMPLATE"]
