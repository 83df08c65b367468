"""Model deployment card (MDC): everything a frontend needs to serve a model.

Parity: reference ``lib/llm/src/model_card/model.rs:87-230``
(``ModelDeploymentCard``: model info, tokenizer kind, prompt formatter,
context length, kv block size, migration limit, checksums) and
``local_model.rs`` (build from an HF repo dir, attach = publish).

The card is JSON-serializable and travels through the coordinator KV (the
reference ships tokenizer artifacts via the NATS object store; we inline the
tokenizer JSON in the card when no shared filesystem is available).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ModelDeploymentCard:
    name: str = ""
    model_path: Optional[str] = None  # local HF repo dir, if reachable
    context_length: int = 8192
    kv_cache_block_size: int = 16
    migration_limit: int = 3
    model_type: str = "chat"  # chat | completions | embedding | backend
    eos_token_ids: List[int] = field(default_factory=list)
    bos_token_id: Optional[int] = None
    chat_template: Optional[str] = None  # jinja2 source
    tokenizer_json: Optional[str] = None  # inline tokenizers-library JSON
    tokenizer_path: Optional[str] = None  # path to tokenizer.json
    hf_config: Dict[str, Any] = field(default_factory=dict)  # raw config.json
    # top-logprob alternatives the serving engine computes per token
    # (JaxEngineConfig.num_top_logprobs); the preprocessor clamps request
    # top_logprobs to this so accepted requests are actually served in
    # full. Default matches JaxEngineConfig's default — workers that raise
    # the engine K must set this too (worker/main.py does).
    num_top_logprobs: int = 8
    # widest sparse penalty/logit_bias window the serving engine ships per
    # request (JaxEngineConfig.penalty_window); the preprocessor rejects
    # logit_bias wider than this instead of silently dropping entries on
    # device. Workers that change the engine window must set this too
    # (worker/main.py does).
    penalty_window: int = 32
    extra: Dict[str, Any] = field(default_factory=dict)

    def load_tokenizer(self):
        """Resolve the card's tokenizer (inline JSON preferred, else path).

        A ``.model`` path selects the native SentencePiece backend
        (reference: ``lib/llm/src/tokenizers/sp.rs`` behind the same file
        dispatch, ``tokenizers.rs:586``); anything else is HF
        ``tokenizers`` JSON."""
        from dynamo_tpu_torch.preprocessor.tokenizer import HfTokenizer  # lazy: avoids cycle
        if self.tokenizer_json:
            return HfTokenizer.from_json(self.tokenizer_json)
        if self.tokenizer_path:
            if self.tokenizer_path.endswith(".model"):
                from dynamo_tpu_torch.preprocessor.sp_tokenizer import SpTokenizer
                return SpTokenizer.from_file(self.tokenizer_path)
            return HfTokenizer.from_file(self.tokenizer_path)
        raise ValueError(f"model card {self.name!r} carries no tokenizer")

    # -- identity ---------------------------------------------------------

    def checksum(self) -> str:
        """Stable digest used to detect frontend/worker config drift
        (parity: ``mdc_sum`` on PreprocessedRequest)."""
        payload = json.dumps({
            "name": self.name,
            "context_length": self.context_length,
            "kv_cache_block_size": self.kv_cache_block_size,
            "eos_token_ids": self.eos_token_ids,
            "chat_template": self.chat_template,
        }, sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()[:16]

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "model_path": self.model_path,
            "context_length": self.context_length,
            "kv_cache_block_size": self.kv_cache_block_size,
            "migration_limit": self.migration_limit,
            "model_type": self.model_type,
            "eos_token_ids": list(self.eos_token_ids),
            "bos_token_id": self.bos_token_id,
            "chat_template": self.chat_template,
            "tokenizer_json": self.tokenizer_json,
            "tokenizer_path": self.tokenizer_path,
            "hf_config": self.hf_config,
            # engine-capability advertisements: without these on the wire
            # the frontend preprocessor falls back to defaults and either
            # rejects requests the worker could serve or accepts ones the
            # device would truncate
            "num_top_logprobs": self.num_top_logprobs,
            "penalty_window": self.penalty_window,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelDeploymentCard":
        return cls(
            name=d.get("name", ""),
            model_path=d.get("model_path"),
            context_length=d.get("context_length", 8192),
            kv_cache_block_size=d.get("kv_cache_block_size", 16),
            migration_limit=d.get("migration_limit", 3),
            model_type=d.get("model_type", "chat"),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            bos_token_id=d.get("bos_token_id"),
            chat_template=d.get("chat_template"),
            tokenizer_json=d.get("tokenizer_json"),
            tokenizer_path=d.get("tokenizer_path"),
            hf_config=d.get("hf_config", {}),
            num_top_logprobs=d.get("num_top_logprobs", 8),
            penalty_window=d.get("penalty_window", 32),
            extra=d.get("extra", {}),
        )

    # -- construction from an HF-style local repo dir ---------------------

    @classmethod
    def from_local_path(cls, path: str, name: Optional[str] = None,
                        inline_tokenizer: bool = True,
                        **overrides: Any) -> "ModelDeploymentCard":
        """Build a card from a local HuggingFace-style model directory
        (config.json, tokenizer.json, tokenizer_config.json).

        Parity: reference ``model_card/create.rs`` (from_repo); GGUF files
        route through ``from_gguf`` (reference gguf loader).
        """
        if path.endswith(".gguf") and os.path.isfile(path):
            return cls.from_gguf(path, name=name, **overrides)
        card = cls(name=name or os.path.basename(os.path.normpath(path)),
                   model_path=path)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            card.hf_config = cfg
            card.context_length = int(
                cfg.get("max_position_embeddings")
                or cfg.get("n_positions") or card.context_length)
            eos = cfg.get("eos_token_id")
            if isinstance(eos, int):
                card.eos_token_ids = [eos]
            elif isinstance(eos, list):
                card.eos_token_ids = list(eos)
            bos = cfg.get("bos_token_id")
            if isinstance(bos, int):
                card.bos_token_id = bos
        tok_path = os.path.join(path, "tokenizer.json")
        sp_path = os.path.join(path, "tokenizer.model")
        if os.path.exists(tok_path):
            card.tokenizer_path = tok_path
            if inline_tokenizer:
                with open(tok_path) as f:
                    card.tokenizer_json = f.read()
        elif os.path.exists(sp_path):
            # SentencePiece-only checkpoint (original llama/mistral/gemma
            # releases): the native SP backend serves it
            card.tokenizer_path = sp_path
        tc_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tc_path):
            with open(tc_path) as f:
                tc = json.load(f)
            tmpl = tc.get("chat_template")
            if isinstance(tmpl, str):
                card.chat_template = tmpl
            elif isinstance(tmpl, list) and tmpl:  # named templates
                for entry in tmpl:
                    if entry.get("name") == "default":
                        card.chat_template = entry.get("template")
                        break
                else:
                    card.chat_template = tmpl[0].get("template")
        # standalone chat_template.json / chat_template.jinja override
        ct_json = os.path.join(path, "chat_template.json")
        if os.path.exists(ct_json):
            with open(ct_json) as f:
                card.chat_template = json.load(f).get("chat_template",
                                                      card.chat_template)
        ct_jinja = os.path.join(path, "chat_template.jinja")
        if os.path.exists(ct_jinja):
            with open(ct_jinja) as f:
                card.chat_template = f.read()
        for k, v in overrides.items():
            setattr(card, k, v)
        return card

    @classmethod
    def from_gguf(cls, path: str, name: Optional[str] = None,
                  **overrides: Any) -> "ModelDeploymentCard":
        """Card from a GGUF single-file model (metadata-driven).

        The GGUF vocab is not reconstructed into a fast tokenizer here; pair
        the file with a ``tokenizer.json`` next to it (checked automatically)
        or pass ``tokenizer_path`` explicitly.
        """
        from dynamo_tpu_torch.models.gguf import GgufFile
        gf = GgufFile(path)
        cfg = gf.to_model_config()
        base = os.path.basename(path)
        card = cls(name=name or base.rsplit(".", 1)[0], model_path=path,
                   context_length=cfg.max_position_embeddings)
        specials = gf.special_token_ids()
        if specials.get("eos") is not None:
            card.eos_token_ids = [int(specials["eos"])]
        if specials.get("bos") is not None:
            card.bos_token_id = int(specials["bos"])
        tmpl = gf.metadata.get("tokenizer.chat_template")
        if isinstance(tmpl, str):
            card.chat_template = tmpl
        sibling = os.path.join(os.path.dirname(path), "tokenizer.json")
        if os.path.exists(sibling):
            card.tokenizer_path = sibling
            with open(sibling) as f:
                card.tokenizer_json = f.read()
        for k, v in overrides.items():
            setattr(card, k, v)
        return card


@dataclass
class ModelEntry:
    """Registration of a served model, written to the coordinator KV under
    ``models/{name}/{instance_id:x}`` with the worker's lease.

    Parity: reference ``discovery/model_entry.rs`` + MODEL_ROOT_PATH watch.
    """

    name: str
    namespace: str
    component: str
    endpoint: str
    model_type: str = "chat"
    card: Optional[ModelDeploymentCard] = None

    def key(self, instance_id: int) -> str:
        return f"models/{self.name}/{instance_id:x}"

    def to_json(self) -> bytes:
        return json.dumps({
            "name": self.name,
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "model_type": self.model_type,
            "card": self.card.to_dict() if self.card else None,
        }).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "ModelEntry":
        d = json.loads(data)
        card = d.get("card")
        return cls(
            name=d["name"], namespace=d["namespace"], component=d["component"],
            endpoint=d["endpoint"], model_type=d.get("model_type", "chat"),
            card=ModelDeploymentCard.from_dict(card) if card else None)


MODEL_ROOT_PREFIX = "models/"

__all__ = ["ModelDeploymentCard", "ModelEntry", "MODEL_ROOT_PREFIX"]
