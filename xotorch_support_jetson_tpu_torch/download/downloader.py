"""Checkpoint location: the ``XOT_TPU_MODEL_DIR`` local-directory path of
the reference's ``download/downloader.py``. There is no hub download in the
PyTorch port yet: a model is served from a local checkpoint directory. A
speculative draft named by registry id is looked up where the reference
keeps its downloads (``get_models_dir``).
"""

from __future__ import annotations

import os
from pathlib import Path

from ..inference.shard import Shard
from ..utils.helpers import XOT_HOME


def get_models_dir() -> Path:
  return XOT_HOME / "downloads"


def repo_to_dirname(repo_id: str) -> str:
  return repo_id.replace("/", "--")


class LocalShardDownloader:
  """Resolves every shard to ``XOT_TPU_MODEL_DIR``."""

  async def ensure_shard(self, shard: Shard, inference_engine_classname: str) -> Path:
    local = os.getenv("XOT_TPU_MODEL_DIR")
    if not local:
      raise FileNotFoundError(
        f"no local checkpoint for {shard.model_id!r}: set XOT_TPU_MODEL_DIR to a directory holding config.json and *.safetensors "
        "(the PyTorch port has no hub download yet)"
      )
    return Path(local)


def new_shard_downloader() -> LocalShardDownloader:
  return LocalShardDownloader()
