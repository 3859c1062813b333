"""Tokenizer resolution from a local checkpoint directory (counterpart of
the reference's ``inference/tokenizers.py`` without the hub fallback).

``transformers`` is imported only here, when a tokenizer is resolved from
disk; a caller that hands the engine its own tokenizer never needs it.
"""

from __future__ import annotations

import asyncio
import os
import threading
from pathlib import Path

_cache: dict[str, object] = {}
_load_lock = threading.Lock()
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")


def _load_tokenizer(source: str):
  # Serialized: transformers' lazy module-attribute import is not thread-safe.
  with _load_lock:
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(source, trust_remote_code=False)


async def resolve_tokenizer(repo_id: str, local_dir: str | Path | None = None):
  """Resolve from ``local_dir`` (default ``XOT_TPU_MODEL_DIR``) when it holds
  tokenizer files; there is no hub download in the port yet."""
  if local_dir is None:
    local_dir = os.getenv("XOT_TPU_MODEL_DIR")
  if not local_dir or not any((Path(local_dir) / f).exists() for f in _TOKENIZER_FILES):
    raise FileNotFoundError(f"no tokenizer files for {repo_id!r} under {local_dir!r} (the PyTorch port resolves tokenizers from a local directory only)")
  key = str(local_dir)
  if (tok := _cache.get(key)) is None:
    tok = _cache[key] = await asyncio.get_running_loop().run_in_executor(None, _load_tokenizer, key)
  return tok
