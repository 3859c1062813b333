"""Tokenizer resolution from a local checkpoint directory (counterpart of
the reference's ``inference/tokenizers.py`` without the hub fallback).

``transformers`` is imported only here, when a tokenizer is resolved from
disk; a caller that hands the engine its own tokenizer never needs it. A
vision model (llava) resolves its ``AutoProcessor`` first
(``prefer_processor``): the image front end needs the processor's
``<image>`` expansion and pixel normalization, and the processor is
patched to answer the tokenizer's ``encode`` / ``decode`` /
``eos_token_id`` as the reference patches it.
"""

from __future__ import annotations

import asyncio
import os
import threading
from pathlib import Path

from ..utils.helpers import DEBUG

_cache: dict[str, object] = {}
_load_lock = threading.Lock()
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")


def _patch_processor(processor):
  """The processor answers the tokenizer surface (the reference's patch)."""
  inner = getattr(processor, "tokenizer", None)
  if inner is not None:
    processor.eos_token_id = getattr(inner, "eos_token_id", None)
    processor.encode = inner.encode
    processor.decode = inner.decode
    processor.all_special_tokens = getattr(inner, "all_special_tokens", [])
  return processor


def _load_tokenizer(source: str, prefer_processor: bool = False):
  # Serialized: transformers' lazy module-attribute import is not thread-safe.
  with _load_lock:
    from transformers import AutoProcessor, AutoTokenizer

    if prefer_processor:
      # Vision checkpoints ship tokenizer and processor files both: the
      # image path needs the processor, so it comes first.
      try:
        return _patch_processor(AutoProcessor.from_pretrained(source, trust_remote_code=False))
      except Exception as e:  # noqa: BLE001 — a directory without processor files: its tokenizer
        if DEBUG >= 2:
          print(f"[tokenizers] AutoProcessor failed for {source}: {e}; trying AutoTokenizer")
    return AutoTokenizer.from_pretrained(source, trust_remote_code=False)


async def resolve_tokenizer(repo_id: str, local_dir: str | Path | None = None, prefer_processor: bool = False):
  """Resolve from ``local_dir`` (default ``XOT_TPU_MODEL_DIR``) when it holds
  tokenizer files: the engine passes the checkpoint directory its shard
  downloader resolved or fetched (the fetch takes the tokenizer files with
  the weights); the tokenizer loader itself never reaches a hub.
  ``prefer_processor`` tries the directory's ``AutoProcessor`` first."""
  if local_dir is None:
    local_dir = os.getenv("XOT_TPU_MODEL_DIR")
  if not local_dir or not any((Path(local_dir) / f).exists() for f in _TOKENIZER_FILES):
    raise FileNotFoundError(f"no tokenizer files for {repo_id!r} under {local_dir!r} (the PyTorch port resolves tokenizers from a local directory only)")
  key = ("proc:" if prefer_processor else "") + str(local_dir)
  if (tok := _cache.get(key)) is None:
    tok = _cache[key] = await asyncio.get_running_loop().run_in_executor(None, _load_tokenizer, str(local_dir), prefer_processor)
  return tok
