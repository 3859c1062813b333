"""Where a model's checkpoint comes from: the offline logic of the
reference's ``download/downloader.py``.

``new_shard_downloader()`` is the reference's stack,
``SingletonShardDownloader(CachedShardDownloader(inner))``: concurrent
requests for one shard share one resolution, and a resolved path is kept
per (engine, shard) while it exists (the reference keeps it for good, so a
model deleted through ``DELETE /models/{name}`` would still resolve). The
innermost downloader (``LocalShardDownloader``)
resolves ``XOT_TPU_MODEL_DIR``, or else the model's own directory under
``get_models_dir()`` (``XOT_TPU_HOME/downloads/<owner>--<repo>``) when it
holds ``config.json`` and ``*.safetensors`` — a model seeded there
(``seed_models``) or fetched earlier; its files are reported complete on
``on_progress``. Anything else raises: the port has no hub fetch yet, and
nothing here pretends to download. ``delete_model`` removes a model's
directory under the same home.
"""

from __future__ import annotations

import asyncio
import os
import shutil
from abc import ABC, abstractmethod
from pathlib import Path

from ..inference.shard import Shard
from ..utils.helpers import DEBUG, AsyncCallbackSystem, xot_home
from .hf_utils import extract_weight_map, filter_repo_objects, get_allow_patterns
from .progress import RepoFileProgressEvent, RepoProgressEvent


class ShardDownloader(ABC):
  @abstractmethod
  async def ensure_shard(self, shard: Shard, inference_engine_classname: str) -> Path:
    ...

  @property
  @abstractmethod
  def on_progress(self) -> AsyncCallbackSystem:
    """Observers get ``(shard, RepoProgressEvent)``."""


class NoopShardDownloader(ShardDownloader):
  def __init__(self) -> None:
    self._on_progress = AsyncCallbackSystem()

  async def ensure_shard(self, shard: Shard, inference_engine_classname: str) -> Path:
    return Path(os.getenv("XOT_TPU_MODEL_DIR", "/tmp/noop_shard"))

  @property
  def on_progress(self) -> AsyncCallbackSystem:
    return self._on_progress


def get_models_dir() -> Path:
  return xot_home() / "downloads"


def ensure_models_dir() -> Path:
  d = get_models_dir()
  d.mkdir(parents=True, exist_ok=True)
  return d


def repo_to_dirname(repo_id: str) -> str:
  return repo_id.replace("/", "--")


async def seed_models(seed_dir: str | Path) -> None:
  """Move pre-fetched model directories from ``seed_dir`` into the
  downloads home (``models--owner--repo`` and ``owner--repo`` names are
  both accepted). Existing destinations are left untouched."""
  dest_root = ensure_models_dir()
  for path in Path(seed_dir).iterdir():
    if not path.is_dir():
      continue
    name = path.name.removeprefix("models--")
    dest = dest_root / name
    if dest.exists():
      if DEBUG >= 1:
        print(f"[seed] {dest} exists; skipping")
      continue
    try:
      await asyncio.to_thread(shutil.move, str(path), str(dest))
    except OSError as e:
      print(f"[seed] failed to seed {path} -> {dest}: {e}")


async def delete_model(model_id: str, engine_classname: str) -> bool:
  """Remove a model's directory under the downloads home; False when the
  model is unknown or has none."""
  from .. import registry

  repo = registry.get_repo(model_id, engine_classname)
  if repo is None:
    return False
  model_dir = get_models_dir() / repo_to_dirname(repo)
  if not model_dir.exists():
    return False
  await asyncio.get_running_loop().run_in_executor(None, shutil.rmtree, model_dir)
  return True


class LocalShardDownloader(ShardDownloader):
  """Resolves a shard to a checkpoint already on disk (module docstring)."""

  def __init__(self, revision: str = "main") -> None:
    self.revision = revision
    self._on_progress = AsyncCallbackSystem()

  @property
  def on_progress(self) -> AsyncCallbackSystem:
    return self._on_progress

  async def ensure_shard(self, shard: Shard, inference_engine_classname: str) -> Path:
    from .. import registry

    if local := os.getenv("XOT_TPU_MODEL_DIR"):
      return Path(local)
    repo = registry.get_repo(shard.model_id, inference_engine_classname)
    if repo is None:
      raise ValueError(f"no repo for model {shard.model_id!r} on engine {inference_engine_classname}")
    model_dir = get_models_dir() / repo_to_dirname(repo)
    if (model_dir / "config.json").is_file() and any(model_dir.glob("*.safetensors")):
      self._report_complete(shard, repo, model_dir)
      return model_dir
    raise FileNotFoundError(
      f"no local checkpoint for {shard.model_id!r}: set XOT_TPU_MODEL_DIR to a directory holding config.json and *.safetensors, "
      f"or place one at {model_dir} (the PyTorch port has no hub download yet)"
    )

  def _report_complete(self, shard: Shard, repo: str, model_dir: Path) -> None:
    """One ``complete`` event over the files the shard needs, as found on disk."""
    index = model_dir / "model.safetensors.index.json"
    weight_map = extract_weight_map(index.read_text()) if index.is_file() else None
    on_disk = sorted(p.relative_to(model_dir).as_posix() for p in model_dir.rglob("*") if p.is_file())
    sizes = {p: (model_dir / p).stat().st_size for p in filter_repo_objects(on_disk, allow_patterns=get_allow_patterns(weight_map, shard))}
    total = sum(sizes.values())
    files = {p: RepoFileProgressEvent(repo, self.revision, p, n, 0, n, 0.0, 0.0, "complete") for p, n in sizes.items()}
    event = RepoProgressEvent(shard.to_dict(), repo, self.revision, len(files), len(files), total, 0, total, 0.0, 0.0, files, "complete")
    self.on_progress.trigger_all(shard, event)


class SingletonShardDownloader(ShardDownloader):
  """Concurrent ``ensure_shard`` calls for one shard share one task, which
  is dropped once it ends."""

  def __init__(self, inner: ShardDownloader) -> None:
    self.inner = inner
    self._tasks: dict[Shard, asyncio.Task] = {}

  @property
  def on_progress(self) -> AsyncCallbackSystem:
    return self.inner.on_progress

  async def ensure_shard(self, shard: Shard, inference_engine_classname: str) -> Path:
    task = self._tasks.get(shard)
    if task is None:
      task = self._tasks[shard] = asyncio.create_task(self.inner.ensure_shard(shard, inference_engine_classname))
      task.add_done_callback(lambda t: self._tasks.pop(shard) if self._tasks.get(shard) is t else None)
    return await asyncio.shield(task)


class CachedShardDownloader(ShardDownloader):
  """Resolved paths kept per (engine, shard) while they exist."""

  def __init__(self, inner: ShardDownloader) -> None:
    self.inner = inner
    self._cache: dict[tuple[str, Shard], Path] = {}

  @property
  def on_progress(self) -> AsyncCallbackSystem:
    return self.inner.on_progress

  async def ensure_shard(self, shard: Shard, inference_engine_classname: str) -> Path:
    key = (inference_engine_classname, shard)
    if key not in self._cache or not self._cache[key].exists():
      self._cache[key] = await self.inner.ensure_shard(shard, inference_engine_classname)
    return self._cache[key]


def new_shard_downloader() -> ShardDownloader:
  return SingletonShardDownloader(CachedShardDownloader(LocalShardDownloader()))
