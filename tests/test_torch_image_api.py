"""The port's image routes on the CPU, with the tiny stable-diffusion
pipeline of tests/test_torch_diffusion.py (the same numpy weights in both
packages, f32, the JAX draws injected through the pipeline's ``_normal``).

The seven cases of tests/test_image_api.py on the port's HTTP server:
JSON-lines progress and a saved PNG's URL (and the same bytes again),
img2img from a data URL, the 400 / 501 refusals for a text model and an
engine without images, bad fields, a bad ``image_url``, the OpenAI route
(``url`` and ``b64_json``, a "WxH" size, its 400s) and ``n`` images on the
streaming route. The images of the text-to-image, img2img and OpenAI
``n=2`` requests equal the JAX engine's pipeline's for the same request
within one uint8 level. Also: an image request with
``XOT_TPU_BATCHED=1``, a daemon loading an exported diffusers directory
(bf16 on its device, text refused with the engine's 501), a request body
that never arrives (408) and a client that disconnects mid-denoise (the
generation stops at the next chunk).
"""

import asyncio
import base64
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_diffusion import JCFG, TCFG, _JaxDraws, _reference_tree
from xotorch_support_jetson_tpu.api.chatgpt_api import ChatGPTAPI as JAPI
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_support_jetson_tpu_torch.inference.diffusion_pipeline import DiffusionPipeline, GenerationCancelled
from xotorch_support_jetson_tpu_torch.inference.dummy_engine import DummyInferenceEngine
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import diffusion_loader as tdl
from xotorch_support_jetson_tpu_torch.models.convert import diffusion_params_from_jax
from xotorch_support_jetson_tpu_torch.orchestration.node import Node
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

MODEL = "stable-diffusion-2-1-base"


class _Server:
  """A port node and API on a background event loop."""

  def __init__(self, engine, node=None, response_timeout: float = 60) -> None:
    self.loop = asyncio.new_event_loop()
    self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
    self.thread.start()
    self.engine = engine
    self.node = node or Node("img-node", engine)
    self.api = ChatGPTAPI(self.node, type(engine).__name__, response_timeout=response_timeout, default_model="dummy")
    self.port = find_available_port("127.0.0.1")
    self.server = self.run(self.api.run(host="127.0.0.1", port=self.port))

  def run(self, coro, timeout: float = 120):
    return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

  def post(self, path: str, body) -> tuple[int, bytes]:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=data, headers={"Content-Type": "application/json"})
    try:
      with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
      return e.code, e.read()

  def get(self, url: str) -> tuple[int, bytes]:
    path = url[url.index("/images/"):] if "://" in url else url
    try:
      with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}", timeout=60) as resp:
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
      return e.code, e.read()

  async def _stop(self) -> None:
    self.server.close()  # on the loop's thread: asyncio servers are not thread-safe
    await self.server.wait_closed()

  def close(self) -> None:
    self.run(self._stop())
    self.loop.call_soon_threadsafe(self.loop.stop)
    self.thread.join(timeout=30)
    if hasattr(self.engine, "executor"):
      self.engine.executor.shutdown(wait=True)


def _inject_jax_draws(pipeline: DiffusionPipeline) -> None:
  """Every generation of ``pipeline`` draws the JAX pipeline's noise for
  its seed."""
  generate = pipeline.generate

  def with_jax_draws(*args, seed=0, **kw):
    pipeline._normal = _JaxDraws(seed)
    return generate(*args, seed=seed, **kw)

  pipeline.generate = with_jax_draws


@pytest.fixture(scope="module")
def weights():
  tree = _reference_tree(JCFG, seed=0)
  return tree, diffusion_params_from_jax(tree, TCFG)


@pytest.fixture(scope="module")
def jax_engine(weights):
  engine = JaxShardedInferenceEngine(use_local_mesh=False)
  engine.load_test_diffusion(JShard(MODEL, 0, 30, 31), JCFG, weights[0])
  return engine


def _port_engine(weights) -> TorchShardedInferenceEngine:
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_diffusion(Shard(MODEL, 0, 30, 31), TCFG, weights[1])
  _inject_jax_draws(engine.diffusion)
  return engine


@pytest.fixture(scope="module")
def server(weights, tmp_path_factory):
  mp = pytest.MonkeyPatch()
  mp.setenv("XOT_TPU_HOME", str(tmp_path_factory.mktemp("xot_home")))
  srv = _Server(_port_engine(weights))
  try:
    yield srv
  finally:
    srv.close()
    mp.undo()


def _lines(raw: bytes) -> list[dict]:
  return [json.loads(line) for line in raw.split(b"\n") if line.strip()]


def _png(raw: bytes) -> np.ndarray:
  return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def _close_to(got: np.ndarray, want: np.ndarray) -> None:
  assert got.shape == want.shape
  assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _data_url(w: int, h: int, color=(200, 30, 30)) -> str:
  buf = io.BytesIO()
  Image.new("RGB", (w, h), color).save(buf, format="PNG")
  return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def test_image_generation_streams_progress_and_url(server, jax_engine):
  body = {"model": MODEL, "prompt": "a red cube", "steps": 6, "seed": 3}
  status, raw = server.post("/v1/image/generations", body)
  assert status == 200
  lines = _lines(raw)
  progress = [line for line in lines if "progress" in line]
  assert [p["step"] for p in progress] == [0, 5, 6] and {p["total_steps"] for p in progress} == {6}
  assert "Progress: [" in progress[-1]["progress"]
  final = [line for line in lines if "images" in line]
  assert len(final) == 1 and final[0]["images"][0]["content_type"] == "image/png"
  url = final[0]["images"][0]["url"]
  assert url.startswith(f"http://127.0.0.1:{server.port}/images/")
  status, png = server.get(url)
  assert status == 200
  img = _png(png)
  assert img.shape == (16, 16, 3)
  _close_to(img, jax_engine.diffusion.generate("a red cube", steps=6, seed=3))
  # deterministic per seed: the same request, the same bytes
  url2 = [line for line in _lines(server.post("/v1/image/generations", body)[1]) if "images" in line][0]["images"][0]["url"]
  assert url2 != url and server.get(url2)[1] == png
  assert server.get("/images/..%2Fnothing.png")[0] == 404 and server.get("/images/missing.png")[0] == 404


def test_image_generation_img2img(server, jax_engine):
  url = _data_url(16, 16)
  status, raw = server.post("/v1/image/generations", {"model": MODEL, "prompt": "bluer", "steps": 4, "image_url": url, "strength": 0.5})
  assert status == 200
  lines = _lines(raw)
  assert [line["step"] for line in lines if "progress" in line] == [0, 2]  # strength · steps denoise steps
  final = [line for line in lines if "images" in line]
  assert len(final) == 1
  want = jax_engine.diffusion.generate("bluer", steps=4, init_image=JAPI._decode_image_b64(url), strength=0.5)
  _close_to(_png(server.get(final[0]["images"][0]["url"])[1]), want)


def test_image_generation_rejects_non_sd_model_and_dummy_engine(server):
  assert server.post("/v1/image/generations", {"model": "llama-3.2-1b", "prompt": "x"})[0] == 400
  srv = _Server(DummyInferenceEngine())
  try:
    assert srv.post("/v1/image/generations", {"model": "llama-3.2-1b", "prompt": "x"})[0] == 400
    status, raw = srv.post("/v1/image/generations", {"model": MODEL, "prompt": "x"})
    assert status == 501 and b"not supported by this engine" in raw  # an engine without images
    assert srv.post("/v1/images/generations", {"prompt": "x"})[0] == 501
  finally:
    srv.close()


def test_image_routes_without_pillow_are_501(server, monkeypatch):
  """PNGs need Pillow: without it both routes refuse before any device
  work, naming it."""
  import importlib.util

  find_spec = importlib.util.find_spec
  monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "PIL" else find_spec(name, *a))
  for path, body in (("/v1/image/generations", {"model": MODEL, "prompt": "x"}), ("/v1/images/generations", {"prompt": "x"})):
    status, raw = server.post(path, body)
    assert status == 501 and b"Pillow" in raw, (path, raw)


def test_image_generation_bad_params_are_400(server):
  for bad in ({"steps": "thirty"}, {"size": 512}, {"seed": None}, {"steps": 0}, {"size": [512]}, {"n": 5}, {"size": [4, 16]}):
    assert server.post("/v1/image/generations", {"model": MODEL, "prompt": "x", **bad})[0] == 400, bad
  assert server.post("/v1/image/generations", b"{not json")[0] == 400


def test_image_generation_bad_image_url_is_400(server):
  status, raw = server.post("/v1/image/generations", {"model": MODEL, "prompt": "x", "image_url": "data:image/png;base64,!!!notb64"})
  assert status == 400 and b"invalid image_url" in raw


def test_openai_images_alias_url_and_b64(server, jax_engine):
  status, raw = server.post("/v1/images/generations", {"prompt": "a cube", "n": 2, "steps": 4})
  assert status == 200
  body = json.loads(raw)
  assert "created" in body and len(body["data"]) == 2
  imgs = [server.get(entry["url"]) for entry in body["data"]]
  assert all(s == 200 for s, _ in imgs)
  want = jax_engine.diffusion.generate("a cube", steps=4, n=2)
  for (_, png), w in zip(imgs, want):
    _close_to(_png(png), w)
  assert not np.array_equal(_png(imgs[0][1]), _png(imgs[1][1]))  # per-candidate noise

  status, raw = server.post("/v1/images/generations", {"prompt": "a cube", "response_format": "b64_json", "steps": 3})
  assert status == 200
  assert _png(base64.b64decode(json.loads(raw)["data"][0]["b64_json"])).shape == (16, 16, 3)
  status, raw = server.post("/v1/images/generations", {"prompt": "x", "size": "24x16", "steps": 2})
  assert status == 200 and _png(server.get(json.loads(raw)["data"][0]["url"])[1]).shape == (16, 24, 3)  # "WxH"
  for bad in ({"n": 9}, {"size": "0x16"}, {"response_format": "gif"}, {"model": "llama-3.2-1b"}):
    assert server.post("/v1/images/generations", {"prompt": "x", **bad})[0] == 400, bad


def test_streaming_route_n_images(server):
  status, raw = server.post("/v1/image/generations", {"model": MODEL, "prompt": "cubes", "steps": 4, "n": 3, "seed": 5})
  assert status == 200
  final = [line for line in _lines(raw) if "images" in line]
  assert len(final) == 1 and len(final[0]["images"]) == 3
  urls = {img["url"] for img in final[0]["images"]}
  assert len(urls) == 3  # distinct files
  assert all(server.get(u)[0] == 200 for u in urls)


def test_image_request_with_batched_serving(weights, monkeypatch, tmp_path):
  """``XOT_TPU_BATCHED=1`` sends text to the batched server; an image
  request still runs on the engine's pipeline, counted in
  ``requests_total``."""
  monkeypatch.setenv("XOT_TPU_BATCHED", "1")
  monkeypatch.setenv("XOT_TPU_HOME", str(tmp_path))
  srv = _Server(_port_engine(weights))
  try:
    before = metrics.counter_value("requests_total")
    status, raw = srv.post("/v1/image/generations", {"model": MODEL, "prompt": "a cube", "steps": 2, "seed": 1})
    assert status == 200
    final = [line for line in _lines(raw) if "images" in line]
    assert _png(srv.get(final[0]["images"][0]["url"])[1]).shape == (16, 16, 3)
    assert metrics.counter_value("requests_total") == before + 1
    assert srv.engine._batched_server is None
  finally:
    srv.close()


def test_daemon_loads_a_diffusers_directory(weights, monkeypatch, tmp_path):
  """An exported diffusers directory under ``XOT_TPU_MODEL_DIR`` takes the
  image path: a bf16 pipeline on the engine's device with the checkpoint's
  weights; an image request answers; a chat request and a token encode on
  it get the engine's 501."""
  tdl.export_diffusers_checkpoint(tmp_path / "sd", TCFG, weights[1])
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tmp_path / "sd"))
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  monkeypatch.setenv("XOT_TPU_HOME", str(tmp_path / "home"))
  monkeypatch.setenv("XOT_TPU_QUANT", "int8")  # a diffusion model stays unquantized
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--node-id", "sd-node", "--default-model", MODEL])
  node, _, engine, _ = tmain.build_components(args)
  srv = _Server(engine, node=node)
  try:
    status, raw = srv.post("/v1/image/generations", {"model": MODEL, "prompt": "a cube", "steps": 2})
    assert status == 200
    final = [line for line in _lines(raw) if "images" in line]
    assert _png(srv.get(final[0]["images"][0]["url"])[1]).shape == (16, 16, 3)
    pipe = engine.diffusion
    assert isinstance(pipe, DiffusionPipeline) and pipe.dtype == torch.bfloat16 and engine.params is None and engine.cfg is None
    assert torch.equal(pipe.params["unet"]["conv_in_w"], weights[1]["unet"]["conv_in_w"].to(torch.bfloat16))
    assert pipe.params["vae"]["decoder"]["conv_out_w"].device.type == "cpu"
    chat = {"model": MODEL, "messages": [{"role": "user", "content": "hello"}]}
    status, raw = srv.post("/v1/chat/completions", chat)
    assert status == 501 and b"is an image-generation model" in raw
    assert srv.post("/v1/chat/token/encode", chat)[0] == 501
    with pytest.raises(NotImplementedError, match="image-generation model"):
      srv.run(engine.encode(Shard(MODEL, 0, 30, 31), "hello"))
  finally:
    srv.close()


def _stalled_post(server, monkeypatch, path: bytes) -> bytes:
  """POST ``path`` with a body that never arrives; the answer's head."""
  from xotorch_support_jetson_tpu_torch.api import chatgpt_api

  monkeypatch.setattr(chatgpt_api, "BODY_READ_TIMEOUT_S", 0.5)
  with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
    s.sendall(b"POST " + path + b" HTTP/1.1\r\nHost: x\r\nContent-Length: 100\r\n\r\n{")
    return s.recv(4096)


def test_stalled_body_is_408(server, monkeypatch):
  """An image route's body that does not arrive in time is a 408."""
  assert _stalled_post(server, monkeypatch, b"/v1/image/generations").startswith(b"HTTP/1.1 408")


def test_stalled_body_is_408_on_a_text_route(server, monkeypatch):
  """The body-read limit is the server's, not the image routes' alone."""
  assert _stalled_post(server, monkeypatch, b"/v1/chat/completions").startswith(b"HTTP/1.1 408")


def test_client_disconnect_stops_the_denoise(server):
  """A client that closes its connection after the first progress line
  stops the generation at the next chunk boundary."""
  pipe = server.engine.diffusion
  outcome: list = []
  generate = pipe.generate

  def recorded(*args, **kw):
    try:
      out = generate(*args, **kw)
    except GenerationCancelled as e:
      outcome.append(e)
      raise
    outcome.append("finished")
    return out

  pipe.generate = recorded
  try:
    body = json.dumps({"model": MODEL, "prompt": "a cube", "steps": 400}).encode()
    with socket.create_connection(("127.0.0.1", server.port), timeout=60) as s:
      s.sendall(b"POST /v1/image/generations HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
      got = b""
      while b'"step": 0' not in got:
        got += s.recv(4096)
    deadline = time.monotonic() + 60
    while not outcome and time.monotonic() < deadline:
      time.sleep(0.05)
  finally:
    pipe.generate = generate
  assert outcome and isinstance(outcome[0], GenerationCancelled), outcome
