"""Model intake: resolve a local path OR download from the HF hub.

Capability parity: reference ``lib/llm/src/hub.rs`` (``from_hf`` — snapshot
download of config/tokenizer/weights into the HF cache, honoring offline
mode and revisions). A worker can be launched with
``--model-path meta-llama/Llama-3.2-1B`` and the checkpoint resolves
through the standard HF cache (``HF_HOME``/``HF_HUB_CACHE``), or instantly
when already cached / running offline (``HF_HUB_OFFLINE=1``).

Only inference-relevant files are pulled: config, tokenizer, safetensors
(never .bin/.pth duplicates or training states).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

# what an inference worker needs — mirrors hub.rs's ignore-list approach
# from the allow side
ALLOW_PATTERNS = [
    "*.json", "*.safetensors", "tokenizer.model", "*.gguf",
]


def is_local(name_or_path: str) -> bool:
    return (os.path.isdir(name_or_path)
            or (os.path.isfile(name_or_path)
                and name_or_path.endswith(".gguf")))


def resolve_model_path(name_or_path: str, revision: Optional[str] = None,
                       cache_dir: Optional[str] = None) -> str:
    """Return a local directory (or .gguf file) for a model reference.

    Local paths pass through untouched; anything else is treated as an HF
    repo id and snapshot-downloaded (cache-first, so a warm cache or
    ``HF_HUB_OFFLINE=1`` never touches the network)."""
    if is_local(name_or_path):
        return name_or_path
    if os.path.sep in name_or_path and not _looks_like_repo_id(name_or_path):
        raise FileNotFoundError(
            f"model path {name_or_path!r} does not exist locally and is "
            f"not an HF repo id")
    raise FileNotFoundError(
        f"{name_or_path!r} is not a local path; the port loads local "
        "checkpoints and downloads nothing from the HF hub "
        "(ROADMAP Queue C)")


def _looks_like_repo_id(s: str) -> bool:
    """org/name with exactly one slash and no leading dot/slash."""
    parts = s.split("/")
    return (len(parts) == 2 and all(parts)
            and not s.startswith((".", "/", "~")))


__all__ = ["resolve_model_path", "is_local", "ALLOW_PATTERNS"]
