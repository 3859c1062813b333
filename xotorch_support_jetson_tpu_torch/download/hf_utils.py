"""Hub plumbing: the endpoint (``HF_ENDPOINT``), the token and auth headers
a fetch sends, and the shard-aware choice of a repo's files. Own copy of
the reference's ``download/hf_utils.py``; the fetch itself is
``download/downloader.py HFShardDownloader``.
"""

from __future__ import annotations

import fnmatch
import json
import os
from pathlib import Path
from typing import Iterable

from ..inference.shard import Shard


def get_hf_endpoint() -> str:
  return os.environ.get("HF_ENDPOINT", "https://huggingface.co")


def get_hf_home() -> Path:
  return Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface"))


def get_hf_token() -> str | None:
  if token := os.environ.get("HF_TOKEN"):
    return token
  token_path = get_hf_home() / "token"
  if token_path.exists():
    return token_path.read_text().strip() or None
  return None


def get_auth_headers() -> dict[str, str]:
  token = get_hf_token()
  return {"Authorization": f"Bearer {token}"} if token else {}


def filter_repo_objects(items: Iterable[str], allow_patterns: list[str] | None = None, ignore_patterns: list[str] | None = None) -> list[str]:
  out = []
  for item in items:
    if allow_patterns is not None and not any(fnmatch.fnmatch(item, p) for p in allow_patterns):
      continue
    if ignore_patterns is not None and any(fnmatch.fnmatch(item, p) for p in ignore_patterns):
      continue
    out.append(item)
  return out


DEFAULT_ALLOW_PATTERNS = [
  "*.json",
  "*.py",
  "tokenizer.model",
  "tokenizer.json",
  "*.tiktoken",
  "*.txt",
]


DIFFUSERS_WEIGHTS = (
  "text_encoder/model.safetensors",
  "unet/diffusion_pytorch_model.safetensors",
  "vae/diffusion_pytorch_model.safetensors",
)


def get_allow_patterns(weight_map: dict[str, str] | None, shard: Shard) -> list[str]:
  """The repo files this shard needs: with a weight map, only the
  safetensors files holding its layer range (plus embed / norm / lm_head
  when it holds the first or last layer); without one, every safetensors
  file (single-file repos), or for a stable-diffusion card the three
  component files of the diffusers layout."""
  patterns = list(DEFAULT_ALLOW_PATTERNS)
  if not weight_map:
    from .. import registry

    if registry.get_family(shard.model_id) == "stable-diffusion":
      # only the weights the loader reads (models/diffusion_loader.py): a
      # bare "*.safetensors" would also take the repo's multi-GB root
      # checkpoints and every .fp16 copy
      return patterns + list(DIFFUSERS_WEIGHTS)
    return patterns + ["*.safetensors"]
  needed: set[str] = set()
  for name, filename in weight_map.items():
    if name.startswith("model.layers."):
      layer = int(name.split(".")[2])
      if shard.start_layer <= layer <= shard.end_layer:
        needed.add(filename)
    elif shard.is_first_layer or shard.is_last_layer:
      needed.add(filename)  # embed_tokens / norm / lm_head
  return patterns + sorted(needed)


def extract_weight_map(index_json_text: str) -> dict[str, str] | None:
  try:
    return json.loads(index_json_text).get("weight_map")
  except (json.JSONDecodeError, AttributeError):
    return None
