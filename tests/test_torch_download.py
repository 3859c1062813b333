"""The hub fetch (``download/downloader.py HFShardDownloader``) against the
JAX package's, on a loopback ``http.server`` in the hub API's shape
(``/api/models/{repo}/tree/{rev}[/{dir}]`` listings and
``/{repo}/resolve/{rev}/{file}`` with Range): the listing's recursion
into directories and its retries, the shard's allow patterns from the
weight map, a ``.partial`` resume, a 416 on a whole partial file, a server
that ignores Range, the auth header, and the progress events, which equal
the reference downloader's on the same fixture (its ``aiohttp`` client is
installed here; the port uses only the standard library). The cache and
the local-directory resolution stay as they were; ``HF_HUB_OFFLINE``
fetches nothing."""

import asyncio
import http.server
import json
import threading
from pathlib import Path

import pytest

from xotorch_support_jetson_tpu.download import downloader as jdl
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu_torch import registry as tregistry
from xotorch_support_jetson_tpu_torch.download import downloader as tdl, hf_utils as thf
from xotorch_support_jetson_tpu_torch.inference.shard import Shard

MODEL = "llama-3.2-1b"
JENGINE, TENGINE = "JaxShardedInferenceEngine", "TorchShardedInferenceEngine"
REPO = tregistry.get_repo(MODEL, TENGINE)
N_LAYERS = 16


def _repo_files() -> dict[str, bytes]:
  """A two-file checkpoint of the card's layers: the weight map puts layers
  0-7 and the embedding in the first file, 8-15, the norm and the head in
  the second; a README no shard needs; a JSON one directory down."""
  wmap = {"model.embed_tokens.weight": "model-00001-of-00002.safetensors", "model.norm.weight": "model-00002-of-00002.safetensors", "lm_head.weight": "model-00002-of-00002.safetensors"}
  for i in range(N_LAYERS):
    wmap[f"model.layers.{i}.mlp.up_proj.weight"] = f"model-0000{1 + i // 8}-of-00002.safetensors"
  return {
    "config.json": json.dumps({"model_type": "llama", "num_hidden_layers": N_LAYERS}).encode(),
    "tokenizer.json": b'{"version": "1.0"}',
    "model.safetensors.index.json": json.dumps({"weight_map": wmap}).encode(),
    "model-00001-of-00002.safetensors": bytes(range(256)) * 40,
    "model-00002-of-00002.safetensors": bytes(reversed(range(256))) * 24,
    "README.md": b"not needed",
    "extra/generation_config.json": b'{"eos_token_id": 2}',
  }


class _Hub(http.server.ThreadingHTTPServer):
  daemon_threads = True

  def __init__(self, files: dict[str, bytes]):
    super().__init__(("127.0.0.1", 0), _Handler)
    self.files = files
    self.ignore_range = False
    self.fail_listings = 0
    self.seen: list[tuple[str, str | None, str | None]] = []  # (path, Range, Authorization)


class _Handler(http.server.BaseHTTPRequestHandler):
  def log_message(self, *a):
    pass

  def _send(self, code: int, body: bytes, headers: dict | None = None) -> None:
    self.send_response(code)
    for k, v in (headers or {}).items():
      self.send_header(k, v)
    self.send_header("Content-Length", str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def do_GET(self):  # noqa: N802
    hub: _Hub = self.server
    hub.seen.append((self.path, self.headers.get("Range"), self.headers.get("Authorization")))
    tree = f"/api/models/{REPO}/tree/main"
    resolve = f"/{REPO}/resolve/main/"
    if self.path.startswith(tree):
      if hub.fail_listings:
        hub.fail_listings -= 1
        return self._send(500, b"busy")
      sub = self.path[len(tree):].strip("/")
      entries, dirs = [], set()
      for name, data in hub.files.items():
        parent = name.rsplit("/", 1)[0] if "/" in name else ""
        if parent == sub:
          entries.append({"type": "file", "path": name, "size": len(data)})
        elif name.startswith(f"{sub}/" if sub else "") and "/" in name[len(sub) + bool(sub):]:
          dirs.add(((sub + "/") if sub else "") + name[len(sub) + bool(sub):].split("/")[0])
      entries += [{"type": "directory", "path": d} for d in sorted(dirs)]
      return self._send(200, json.dumps(entries).encode(), {"Content-Type": "application/json"})
    if self.path.startswith(resolve):
      data = hub.files.get(self.path[len(resolve):])
      if data is None:
        return self._send(404, b"no such file")
      rng = self.headers.get("Range")
      if rng and not hub.ignore_range:
        start = int(rng.split("=")[1].split("-")[0])
        if start >= len(data):
          return self._send(416, b"")
        return self._send(206, data[start:], {"Content-Range": f"bytes {start}-{len(data) - 1}/{len(data)}"})
      return self._send(200, data)
    self._send(404, b"")


@pytest.fixture
def hub(monkeypatch, tmp_path):
  server = _Hub(_repo_files())
  thread = threading.Thread(target=server.serve_forever, daemon=True)
  thread.start()
  monkeypatch.setenv("HF_ENDPOINT", f"http://127.0.0.1:{server.server_address[1]}")
  monkeypatch.setenv("HF_TOKEN", "tok-123")
  monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)
  monkeypatch.delenv("XOT_TPU_MODEL_DIR", raising=False)
  monkeypatch.setenv("XOT_TPU_HOME", str(tmp_path / "port"))
  monkeypatch.setattr(jdl, "XOT_HOME", tmp_path / "ref")  # the reference reads its home at import
  yield server
  server.shutdown()
  server.server_close()


def _events(downloader, out: list) -> None:
  downloader.on_progress.register("t").on_next(lambda s, e: out.append(e.to_dict()))


def _timeless(events: list) -> list:
  """The events without their clock-dependent fields (speed, ETA)."""
  return [{k: v for k, v in e.items() if k not in ("overall_speed", "overall_eta")} for e in events]


@pytest.mark.parametrize("span", [(0, 15), (0, 7), (3, 6)], ids=["full", "head", "middle"])
def test_shard_fetch_matches_the_reference(hub, span):
  """Each package's downloader fetches the shard from the fixture (one
  file at a time, so the event order is fixed): the same files land on
  disk, the same progress events fire, and every request carried the auth
  header."""
  files = _repo_files()
  tev, jev = [], []

  async def go():
    t = tdl.HFShardDownloader(max_parallel_downloads=1)
    j = jdl.HFShardDownloader(max_parallel_downloads=1)
    _events(t, tev)
    _events(j, jev)
    return await t.ensure_shard(Shard(MODEL, *span, N_LAYERS), TENGINE), await j.ensure_shard(JShard(MODEL, *span, N_LAYERS), JENGINE)

  tdir, jdir = asyncio.run(go())
  got = sorted(p.relative_to(tdir).as_posix() for p in tdir.rglob("*") if p.is_file())
  want = sorted(p.relative_to(jdir).as_posix() for p in jdir.rglob("*") if p.is_file())
  assert got == want and "README.md" not in got and "extra/generation_config.json" in got
  assert ("model-00002-of-00002.safetensors" in got) == (span != (3, 6))  # a middle shard needs only its layers' file
  for name in got:
    assert (tdir / name).read_bytes() == files[name]
  assert _timeless(tev) == _timeless(jev) and tev[-1]["status"] == "complete"
  assert tev[-1]["downloaded_bytes"] == tev[-1]["total_bytes"] == sum(len(files[n]) for n in got)
  assert all(auth == "Bearer tok-123" for _, _, auth in hub.seen)


def test_parallel_fetch_ends_with_the_reference_event(hub):
  """Eight fetches at once (the default): the final event equals the
  reference's, after as many progress events (their running sums depend on
  the order the files finish in)."""
  tev, jev = [], []

  async def go():
    t, j = tdl.HFShardDownloader(), jdl.HFShardDownloader()
    _events(t, tev)
    _events(j, jev)
    await t.ensure_shard(Shard(MODEL, 0, 15, N_LAYERS), TENGINE)
    await j.ensure_shard(JShard(MODEL, 0, 15, N_LAYERS), JENGINE)

  asyncio.run(go())
  assert _timeless(tev)[-1] == _timeless(jev)[-1] and len(tev) == len(jev)


def test_listing_recurses_and_retries(hub, monkeypatch):
  """The tree listing recurses into directories, and a hub answering 500
  twice is retried (five attempts, 1.5^n s apart: the waits are counted
  here, not slept)."""
  waits = []

  async def no_sleep(attempt):
    waits.append(1.5**attempt)

  monkeypatch.setattr(tdl.HFShardDownloader, "_retry_sleep", staticmethod(no_sleep))
  hub.fail_listings = 2
  files = asyncio.run(tdl.HFShardDownloader()._fetch_file_list(REPO))
  assert sorted((f.path, f.size) for f in files) == sorted((n, len(d)) for n, d in _repo_files().items())
  assert waits == [1.0, 1.5]
  hub.fail_listings = 5
  with pytest.raises(Exception, match="500"):
    asyncio.run(tdl.HFShardDownloader()._fetch_file_list(REPO))
  assert waits[2:] == [1.0, 1.5, 2.25, 3.375]


@pytest.mark.parametrize("case", ["resume", "whole-partial", "range-ignored"])
def test_partial_files_resume(hub, tmp_path, case):
  """A ``.partial`` file resumes with a Range request from its length; a
  partial file already whole is answered 416 and renamed; a server that
  ignores Range restarts the file. Each ends with the file's bytes, and
  the progress callback saw the bytes it was told of."""
  name = "model-00001-of-00002.safetensors"
  data = _repo_files()[name]
  target_dir = tmp_path / "dl"
  target_dir.mkdir()
  cut = {"resume": 1000, "whole-partial": len(data), "range-ignored": 1000}[case]
  (target_dir / f"{name}.partial").write_bytes(data[:cut])
  hub.ignore_range = case == "range-ignored"
  seen = []
  d = tdl.HFShardDownloader()
  out = asyncio.run(d._download_file(REPO, tdl._FileInfo(name, len(data)), target_dir, lambda p, n, delta: seen.append((n, delta))))
  assert out.read_bytes() == data and not (target_dir / f"{name}.partial").exists()
  assert hub.seen[-1][1] == f"bytes={cut}-"
  if case == "resume":
    assert seen == [(len(data), len(data) - cut)]
  elif case == "whole-partial":
    assert seen == [(len(data), 0)]
  else:
    assert seen == [(len(data), len(data))]


def test_default_stack_fetches_once_then_resolves_on_disk(hub):
  """``new_shard_downloader()``: the model is not on disk, so it is
  fetched; concurrent requests share the fetch; a new stack then finds it
  on disk (no request to the hub) and reports it complete."""
  shard = Shard(MODEL, 0, 15, N_LAYERS)
  events = []

  async def go():
    dl = tdl.new_shard_downloader()
    a, b = await asyncio.gather(dl.ensure_shard(shard, TENGINE), dl.ensure_shard(shard, TENGINE))
    n_requests = len(hub.seen)
    again = tdl.new_shard_downloader()
    _events(again, events)
    c = await again.ensure_shard(shard, TENGINE)
    return a, b, c, n_requests

  a, b, c, n_requests = asyncio.run(go())
  assert a == b == c == tdl.get_models_dir() / tdl.repo_to_dirname(REPO)
  assert len(hub.seen) == n_requests and sum(p.startswith("/api/") for p, _, _ in hub.seen) == 2  # the root listing and the one directory
  assert len(events) == 1 and events[0]["status"] == "complete"


def test_offline_fetches_nothing(hub, monkeypatch):
  monkeypatch.setenv("HF_HUB_OFFLINE", "1")
  with pytest.raises(FileNotFoundError, match="no local checkpoint.*HF_HUB_OFFLINE"):
    asyncio.run(tdl.new_shard_downloader().ensure_shard(Shard(MODEL, 0, 15, N_LAYERS), TENGINE))
  assert hub.seen == []


def test_endpoint_and_auth_headers_match_the_reference(monkeypatch):
  from xotorch_support_jetson_tpu.download import hf_utils as jhf

  monkeypatch.delenv("HF_ENDPOINT", raising=False)
  assert thf.get_hf_endpoint() == jhf.get_hf_endpoint()
  monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:1")
  monkeypatch.setenv("HF_TOKEN", "abc")
  assert thf.get_hf_endpoint() == jhf.get_hf_endpoint() == "http://127.0.0.1:1"
  assert thf.get_auth_headers() == jhf.get_auth_headers() == {"Authorization": "Bearer abc"}


def test_an_interrupted_fetch_is_not_taken_as_on_disk(hub, tmp_path):
  """A model directory with a ``.partial`` file left, or missing a weight
  file the shard needs, is fetched (resumed), not served as it is."""
  shard = Shard(MODEL, 0, 15, N_LAYERS)
  model_dir = tdl.get_models_dir() / tdl.repo_to_dirname(REPO)
  model_dir.mkdir(parents=True)
  files = _repo_files()
  for name in ("config.json", "model.safetensors.index.json", "model-00001-of-00002.safetensors"):
    (model_dir / name).write_bytes(files[name])
  (model_dir / "model-00002-of-00002.safetensors.partial").write_bytes(files["model-00002-of-00002.safetensors"][:100])
  assert not tdl._local_complete(model_dir, shard) and not tdl._local_complete(Path(tmp_path / "nowhere"), shard)
  assert asyncio.run(tdl.new_shard_downloader().ensure_shard(shard, TENGINE)) == model_dir
  assert (model_dir / "model-00002-of-00002.safetensors").read_bytes() == files["model-00002-of-00002.safetensors"]
  assert any(r == "bytes=100-" for _, r, _ in hub.seen)
  assert tdl._local_complete(model_dir, shard)
