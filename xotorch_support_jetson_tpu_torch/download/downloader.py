"""Where a model's checkpoint comes from: the reference's
``download/downloader.py``.

``new_shard_downloader()`` is the reference's stack,
``SingletonShardDownloader(CachedShardDownloader(HFShardDownloader()))``:
concurrent requests for one shard share one resolution, and a resolved
path is kept per (engine, shard) while it exists (the reference keeps it
for good, so a model deleted through ``DELETE /models/{name}`` would still
resolve). The hub downloader first resolves what is on disk
(``LocalShardDownloader``): ``XOT_TPU_MODEL_DIR``, or else the model's own
directory under ``get_models_dir()`` (``XOT_TPU_HOME/downloads/<owner>--<repo>``)
when it holds ``config.json`` and every safetensors file the shard needs
(a diffusers checkpoint: ``model_index.json`` and its three component
weights) — a model seeded there (``seed_models``) or fetched earlier — its files
reported complete on ``on_progress``. Otherwise it fetches the shard's
files from the hub API at ``HF_ENDPOINT`` (``HFShardDownloader``: the
listing, ranged resume from ``.partial`` files, parallel fetches, the
reference's progress events) with the standard library's ``urllib`` in
worker threads; with ``HF_HUB_OFFLINE`` set it fetches nothing and raises.
``delete_model`` removes a model's directory under the same home.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import time
import urllib.error
import urllib.request
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from ..inference.shard import Shard
from ..utils.helpers import DEBUG, AsyncCallbackSystem, env_flag, xot_home
from .hf_utils import DIFFUSERS_WEIGHTS, extract_weight_map, filter_repo_objects, get_allow_patterns, get_auth_headers, get_hf_endpoint
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
    if _local_complete(model_dir, shard):
      self._report_complete(shard, repo, model_dir)
      return model_dir
    raise FileNotFoundError(
      f"no local checkpoint for {shard.model_id!r}: set XOT_TPU_MODEL_DIR to a directory holding config.json and *.safetensors, "
      f"or place one at {model_dir}"
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


def _local_complete(model_dir: Path, shard: Shard) -> bool:
  """Whether ``model_dir`` holds the shard's checkpoint whole: config.json,
  no ``.partial`` file left by an interrupted fetch, and every safetensors
  file the shard needs (those its weight map names, or any one without a
  map). A diffusers checkpoint has ``model_index.json`` and its three
  component weights instead."""
  if any(model_dir.rglob("*.partial")):
    return False
  if (model_dir / "model_index.json").is_file():
    return all((model_dir / p).is_file() for p in DIFFUSERS_WEIGHTS)
  if not (model_dir / "config.json").is_file():
    return False
  index = model_dir / "model.safetensors.index.json"
  weight_map = extract_weight_map(index.read_text()) if index.is_file() else None
  if not weight_map:
    return any(model_dir.glob("*.safetensors"))
  needed = [p for p in get_allow_patterns(weight_map, shard) if p.endswith(".safetensors")]
  return all((model_dir / p).is_file() for p in needed)


@dataclass
class _FileInfo:
  path: str
  size: int


class HFShardDownloader(LocalShardDownloader):
  """A checkpoint on disk (``LocalShardDownloader``), or else the files the
  shard needs fetched from the hub, with ranged resume (the reference's
  ``HFShardDownloader``). HTTP goes through ``urllib.request`` in worker
  threads (``asyncio.to_thread``); each 1 MiB read of a file is one
  progress callback on the event loop, as in the reference."""

  def __init__(self, max_parallel_downloads: int = 8, revision: str = "main") -> None:
    super().__init__(revision)
    self.max_parallel_downloads = max_parallel_downloads
    self._file_list_cache: dict[str, list[_FileInfo]] = {}
    self.session_timeout = float(os.getenv("XOT_TPU_DL_TIMEOUT", "30"))

  @staticmethod
  async def _retry_sleep(attempt: int) -> None:
    await asyncio.sleep(1.5**attempt)

  def _open(self, url: str, headers: dict):
    """A response to GET ``url`` (raises ``urllib.error.HTTPError`` on a
    status of 400 or more)."""
    return urllib.request.urlopen(urllib.request.Request(url, headers=headers), timeout=self.session_timeout)

  def _get_json(self, url: str):
    with self._open(url, get_auth_headers()) as resp:
      return json.loads(resp.read())

  async def _fetch_file_list(self, repo_id: str, path: str = "") -> list[_FileInfo]:
    """Every file of the repo under ``path``: the ``/api/models/{repo}/tree/{rev}``
    listing, recursing into directories; five attempts, 1.5^n s apart."""
    cache_key = f"{repo_id}/{path}"
    if cache_key in self._file_list_cache:
      return self._file_list_cache[cache_key]
    url = f"{get_hf_endpoint()}/api/models/{repo_id}/tree/{self.revision}"
    if path:
      url += f"/{path}"
    for attempt in range(5):
      try:
        entries = await asyncio.to_thread(self._get_json, url)
        files: list[_FileInfo] = []
        for entry in entries:
          if entry["type"] == "file":
            files.append(_FileInfo(entry["path"], entry.get("size", 0)))
          elif entry["type"] == "directory":
            files.extend(await self._fetch_file_list(repo_id, entry["path"]))
        self._file_list_cache[cache_key] = files
        return files
      except Exception:  # noqa: BLE001 — transient hub errors
        if attempt == 4:
          raise
        await self._retry_sleep(attempt)
    raise RuntimeError("unreachable")

  async def _download_file(self, repo_id: str, file: _FileInfo, target_dir: Path, progress_cb: Callable[[str, int, int], None]) -> Path:
    """One file through ``<name>.partial``: resumed with a Range request
    when a partial file exists; a 416 answer means it is complete; a 200
    answer to a Range request restarts it; renamed when done."""
    target = target_dir / file.path
    target.parent.mkdir(parents=True, exist_ok=True)
    if target.exists() and (file.size == 0 or target.stat().st_size == file.size):
      progress_cb(file.path, target.stat().st_size, 0)
      return target
    partial = target.with_suffix(target.suffix + ".partial")
    resume_from = partial.stat().st_size if partial.exists() else 0
    headers = get_auth_headers()
    if resume_from:
      headers["Range"] = f"bytes={resume_from}-"
    url = f"{get_hf_endpoint()}/{repo_id}/resolve/{self.revision}/{file.path}"
    try:
      resp = await asyncio.to_thread(self._open, url, headers)
    except urllib.error.HTTPError as e:
      if e.code != 416:
        raise
      partial.rename(target)  # the range starts at the end: already whole
      progress_cb(file.path, resume_from, 0)
      return target
    try:
      if resp.status != 206:
        resume_from = 0  # the server ignored the range: restart
      downloaded = resume_from
      with open(partial, "ab" if resume_from else "wb") as f:
        while chunk := await asyncio.to_thread(resp.read, 1 << 20):
          f.write(chunk)
          downloaded += len(chunk)
          progress_cb(file.path, downloaded, len(chunk))
    finally:
      resp.close()
    partial.rename(target)
    return target

  async def ensure_shard(self, shard: Shard, inference_engine_classname: str) -> Path:
    from .. import registry

    try:
      return await super().ensure_shard(shard, inference_engine_classname)
    except FileNotFoundError as e:
      if env_flag("HF_HUB_OFFLINE"):
        raise FileNotFoundError(f"{e}; HF_HUB_OFFLINE is set, so nothing is fetched") from None
    repo_id = registry.get_repo(shard.model_id, inference_engine_classname)
    target_dir = ensure_models_dir() / repo_to_dirname(repo_id)
    target_dir.mkdir(parents=True, exist_ok=True)
    all_files = await self._fetch_file_list(repo_id)
    # The weight map first (a small file), for the shard's allow patterns.
    weight_map = None
    index_name = "model.safetensors.index.json"
    index_file = next((f for f in all_files if f.path == index_name), None)
    if index_file is not None:
      await self._download_file(repo_id, index_file, target_dir, lambda *_: None)
      weight_map = extract_weight_map((target_dir / index_name).read_text())
    wanted_paths = set(filter_repo_objects([f.path for f in all_files], allow_patterns=get_allow_patterns(weight_map, shard)))
    wanted = [f for f in all_files if f.path in wanted_paths]
    total_bytes = sum(f.size for f in wanted)
    if DEBUG >= 1:
      print(f"[download] {repo_id} shard {shard.start_layer}-{shard.end_layer}: {len(wanted)}/{len(all_files)} files, {total_bytes / 1e9:.2f} GB")
    start_time = time.monotonic()
    downloaded_per_file: dict[str, int] = {}
    session_bytes: dict[str, int] = {}

    def progress_cb(path: str, downloaded: int, delta: int) -> None:
      downloaded_per_file[path] = downloaded
      session_bytes[path] = session_bytes.get(path, 0) + delta
      self._emit_progress(shard, repo_id, wanted, downloaded_per_file, session_bytes, total_bytes, start_time)

    sem = asyncio.Semaphore(self.max_parallel_downloads)

    async def fetch(file: _FileInfo) -> None:
      async with sem:
        await self._download_file(repo_id, file, target_dir, progress_cb)

    await asyncio.gather(*(fetch(f) for f in wanted))
    self._emit_progress(shard, repo_id, wanted, downloaded_per_file, session_bytes, total_bytes, start_time, final=True)
    return target_dir

  def _emit_progress(self, shard, repo_id, wanted, downloaded_per_file, session_bytes, total_bytes, start_time, final=False) -> None:
    downloaded = sum(downloaded_per_file.values())
    this_session = sum(session_bytes.values())
    elapsed = max(time.monotonic() - start_time, 1e-6)
    speed = this_session / elapsed
    remaining = max(total_bytes - downloaded, 0)
    eta = remaining / speed if speed > 0 else 0.0
    completed = sum(1 for f in wanted if downloaded_per_file.get(f.path, 0) >= f.size > 0)
    status = "complete" if final or (completed == len(wanted) and total_bytes > 0 and downloaded >= total_bytes) else "in_progress"
    event = RepoProgressEvent(
      shard=shard.to_dict(), repo_id=repo_id, repo_revision=self.revision, completed_files=completed, total_files=len(wanted),
      downloaded_bytes=downloaded, downloaded_bytes_this_session=this_session, total_bytes=total_bytes, overall_speed=speed, overall_eta=eta, status=status,
    )
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


def new_shard_downloader(max_parallel_downloads: int = 8) -> ShardDownloader:
  return SingletonShardDownloader(CachedShardDownloader(HFShardDownloader(max_parallel_downloads)))
