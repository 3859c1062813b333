"""The default daemon's API surface of the port against the JAX daemon's.

Both daemons serve the verify skill's tiny llama checkpoint on the CPU at
f32, greedy, from one background event loop: every route the port added
(``/v1/completions`` blocking, streamed, with ``echo``, ``stop`` and
``logprobs``; chat ``logprobs``; ``stream_options``; token encode; the
model-management and download routes; ``/quit`` with ``os.kill``
replaced; the web page) answers the same body, ids and timestamps aside,
logprob values within the ROADMAP's rtol = atol = 2e-4. Then the pieces
underneath: the scoring forward against the JAX function (clipped leading
rows included), the engines' ``score_tokens`` and the program ledger's
``prefill.score_last`` record, ``_align_logprobs``'s contract, the
download helpers, the ``run`` command's tokens, ``/quit`` and the second
signal on a real port daemon process."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decoder import _pair
from test_torch_engine import make_tiny_llama
from tests_support_stubs import NoDiscovery, StubServer
from xotorch_support_jetson_tpu import registry as jregistry
from xotorch_support_jetson_tpu.api import chatgpt_api as japi
from xotorch_support_jetson_tpu.download import downloader as jdl, hf_utils as jhf, progress as jprogress
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import decoder as jdec
from xotorch_support_jetson_tpu.utils import programs as jprograms
from xotorch_support_jetson_tpu_torch import main as tmain, registry as tregistry
from xotorch_support_jetson_tpu_torch.api import chatgpt_api as tapi
from xotorch_support_jetson_tpu_torch.download import downloader as tdl, hf_utils as thf, progress as tprogress
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import decoder as tdec
from xotorch_support_jetson_tpu_torch.utils import programs as tprograms
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_TOKENS = 12
MODEL = "llama-3.2-1b"
JENGINE, TENGINE = "JaxShardedInferenceEngine", "TorchShardedInferenceEngine"
PROMPT = "the quick brown fox"  # greedy text 'world world brown' on the tiny checkpoint
THROWAWAY = "qwen-3-0.6b"  # a card whose directory under the downloads home the tests create and delete


# ------------------------------------------------------------------ daemons


class _Daemons:
  """The JAX daemon and the port daemon, serving from one background loop."""

  def __init__(self, tiny_dir: Path, home: Path) -> None:
    self.home = home
    self.loop = asyncio.new_event_loop()
    self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
    self.thread.start()
    self.jport, self.tport = find_available_port("127.0.0.1"), find_available_port("127.0.0.1")
    self.run(self._start())

  def run(self, coro, timeout=300):
    return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

  async def _start(self) -> None:
    from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
    from xotorch_support_jetson_tpu.orchestration.node import Node as JNode
    from xotorch_support_jetson_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy

    downloader = jdl.HFShardDownloader()
    self.jengine = JaxShardedInferenceEngine(downloader, use_local_mesh=False)
    self.jnode = JNode("jax-node", StubServer(), self.jengine, NoDiscovery(), downloader, RingMemoryWeightedPartitioningStrategy(), max_generate_tokens=MAX_TOKENS, default_sample_temp=0.0)
    self.japi = japi.ChatGPTAPI(self.jnode, JENGINE, response_timeout=120, default_model=MODEL)
    await self.jnode.start()
    self.jrunner = await self.japi.run(host="127.0.0.1", port=self.jport)
    args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(self.tport), "--temp", "0.0", "--max-generate-tokens", str(MAX_TOKENS), "--node-id", "torch-node"])
    self.tnode, self.tapi, self.tengine, _ = tmain.build_components(args)
    await self.tnode.start()
    self.tserver = await self.tapi.run(host="127.0.0.1", port=self.tport)
    # Loaded up front: a test may call an engine before any request did.
    await self.jengine.ensure_shard(JShard(MODEL, 0, 15, 16))
    await self.tengine.ensure_shard(Shard(MODEL, 0, 15, 16))

  async def _stop(self) -> None:
    self.tserver.close()
    await self.tnode.stop()
    await self.jrunner.cleanup()
    await self.jnode.stop()

  def close(self) -> None:
    self.run(self._stop())
    self.loop.call_soon_threadsafe(self.loop.stop)
    self.thread.join(timeout=30)
    self.tengine.executor.shutdown(wait=True)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_surface"))


@pytest.fixture(scope="module")
def daemons(tiny_dir, tmp_path_factory):
  home = tmp_path_factory.mktemp("xot_home")
  mp = pytest.MonkeyPatch()
  mp.setenv("XOT_TPU_MODEL_DIR", str(tiny_dir))
  mp.setenv("XOT_TPU_PLATFORM", "cpu")
  mp.setenv("XOT_TPU_HOME", str(home))  # the port reads it per call
  mp.setattr(jdl, "XOT_HOME", home)  # the JAX package read it at import
  d = _Daemons(tiny_dir, home)
  try:
    yield d
  finally:
    d.close()
    mp.undo()


def _http(port, method, path, body=None, raw=None):
  """(status, content type, body text) of one request."""
  data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
  req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method, headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=120) as resp:
      return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()
  except urllib.error.HTTPError as e:
    return e.code, e.headers.get("Content-Type", ""), e.read().decode()


def _both(d, method, path, body=None, raw=None):
  return _http(d.jport, method, path, body, raw), _http(d.tport, method, path, body, raw)


def _strip(obj):
  """A body without what differs per request (ids, timestamps)."""
  if isinstance(obj, dict):
    return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
  if isinstance(obj, list):
    return [_strip(v) for v in obj]
  return obj


def assert_same(got, want, where="$"):
  """Equal structure and values; floats within ``TOL``."""
  if isinstance(want, dict):
    assert isinstance(got, dict) and got.keys() == want.keys(), f"{where}: keys {sorted(got)} != {sorted(want)}"
    for k in want:
      assert_same(got[k], want[k], f"{where}.{k}")
  elif isinstance(want, list):
    assert isinstance(got, list) and len(got) == len(want), f"{where}: {got!r} != {want!r}"
    for i, (g, w) in enumerate(zip(got, want)):
      assert_same(g, w, f"{where}[{i}]")
  elif isinstance(want, float):
    assert isinstance(got, (int, float)) and not isinstance(got, bool), f"{where}: {got!r}"
    np.testing.assert_allclose(got, want, err_msg=where, **TOL)
  else:
    assert got == want, f"{where}: {got!r} != {want!r}"


def _events(text):
  events = [line[len("data: "):] for line in text.split("\n") if line.startswith("data: ")]
  assert events and events[-1] == "[DONE]", text
  return [json.loads(e) for e in events[:-1]]


def _port_cards(body):
  """The entries of the port's cards, in order (the JAX registry also
  holds the families the port does not serve yet)."""
  ids = list(tregistry.model_cards)
  if isinstance(body, dict) and "data" in body:
    return {**body, "data": [m for m in body["data"] if m["id"] in ids]}
  return {k: v for k, v in body.items() if k in ids}


# ------------------------------------------------------------ parity: bodies

COMPLETIONS = {
  "blocking": {"prompt": PROMPT, "max_tokens": 8},
  "list_prompt": {"prompt": [PROMPT], "max_tokens": 8},
  "echo": {"prompt": PROMPT, "echo": True, "max_tokens": 6},
  "stop": {"prompt": PROMPT, "stop": "brown"},
  "logprobs": {"prompt": PROMPT, "logprobs": 3},
  "logprobs_stop_echo": {"prompt": PROMPT, "logprobs": 2, "stop": ["brown", "zzz"], "echo": True},
  "logprobs_zero": {"prompt": "hello world", "logprobs": 0, "max_tokens": 4},
}


@pytest.mark.parametrize("case", sorted(COMPLETIONS))
def test_completions_blocking_body_equals_jax(daemons, case):
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", "/v1/completions", COMPLETIONS[case])
  assert js == ts == 200, (jb, tb)
  want, got = json.loads(jb), json.loads(tb)
  assert got["id"].startswith("cmpl-") and isinstance(got["created"], int)
  assert_same(_strip(got), _strip(want))
  if COMPLETIONS[case].get("logprobs"):
    lp = got["choices"][0]["logprobs"]
    assert lp is not None and len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["text_offset"]) == len(lp["top_logprobs"])


STREAMED = {
  "completions": ("/v1/completions", {"prompt": PROMPT}),
  "completions_stop": ("/v1/completions", {"prompt": PROMPT, "stop": "brown"}),
  "chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": PROMPT}]}),
  "chat_include_usage": ("/v1/chat/completions", {"messages": [{"role": "user", "content": PROMPT}], "stream_options": {"include_usage": True}}),
  "chat_stop_usage": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "how are you today"}], "stop": "ld", "stream_options": {"include_usage": True}}),
}


@pytest.mark.parametrize("case", sorted(STREAMED))
def test_streamed_text_finish_and_usage_equal_jax(daemons, case):
  path, body = STREAMED[case]
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", path, {**body, "stream": True})
  assert js == ts == 200, (jb, tb)

  def summary(raw):
    events = _events(raw)
    field = "delta" if path.endswith("chat/completions") else None
    text = "".join((c["delta"].get("content") or "") if field else c["text"] for e in events for c in e["choices"])
    finish = [c["finish_reason"] for e in events for c in e["choices"] if c["finish_reason"]]
    usage = [e["usage"] for e in events if "usage" in e]
    shapes = [_strip({k: v for k, v in e.items() if k != "choices"}) for e in events]
    return text, finish, usage, shapes

  assert summary(tb) == summary(jb)
  if "usage" in case:
    assert len(summary(tb)[2]) == 1 and summary(tb)[2][0]["completion_tokens"] > 0


CHAT_LOGPROBS = {
  "top5": {"messages": [{"role": "user", "content": PROMPT}], "logprobs": True, "top_logprobs": 5},
  "top0": {"messages": [{"role": "user", "content": "hello world"}], "logprobs": True, "max_tokens": 5},
  "top20_stop": {"messages": [{"role": "user", "content": "how are you today"}], "logprobs": True, "top_logprobs": 20, "stop": "ld"},
}


@pytest.mark.parametrize("case", sorted(CHAT_LOGPROBS))
def test_chat_logprobs_body_equals_jax(daemons, case):
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", "/v1/chat/completions", CHAT_LOGPROBS[case])
  assert js == ts == 200, (jb, tb)
  want, got = json.loads(jb), json.loads(tb)
  assert_same(_strip(got), _strip(want))
  entries = got["choices"][0]["logprobs"]["content"]
  assert len(entries) == got["usage"]["completion_tokens"]
  for e in entries:
    assert e["logprob"] <= 0 and len(e["top_logprobs"]) == CHAT_LOGPROBS[case].get("top_logprobs", 0)


REFUSED = {
  "completions_two_prompts": ("/v1/completions", {"prompt": ["a", "b"]}),
  "completions_empty_prompt": ("/v1/completions", {"prompt": ""}),
  "completions_logprobs_50": ("/v1/completions", {"prompt": "a", "logprobs": 50}),
  "completions_logprobs_bool": ("/v1/completions", {"prompt": "a", "logprobs": True}),
  "completions_logprobs_stream": ("/v1/completions", {"prompt": "a", "logprobs": 2, "stream": True}),
  "completions_max_tokens": ("/v1/completions", {"prompt": "a", "max_tokens": 0}),
  "completions_temperature": ("/v1/completions", {"prompt": "a", "temperature": 9}),
  "completions_stop": ("/v1/completions", {"prompt": "a", "stop": ["a", "b", "c", "d", "e"]}),
  "chat_logprobs_string": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a"}], "logprobs": "yes"}),
  "chat_top_without_logprobs": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a"}], "top_logprobs": 3}),
  "chat_top_21": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a"}], "logprobs": True, "top_logprobs": 21}),
  "chat_logprobs_stream": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a"}], "logprobs": True, "stream": True}),
  "chat_stream_options_string": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a"}], "stream": True, "stream_options": "usage"}),
  "chat_stream_options_list": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a"}], "stream_options": [1]}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_equal_jax(daemons, case):
  path, body = REFUSED[case]
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", path, body)
  assert js == ts == 400
  assert json.loads(tb) == json.loads(jb)


def test_completions_invalid_json_is_400(daemons):
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", "/v1/completions", raw=b"not json")
  assert js == ts == 400 and json.loads(tb) == json.loads(jb) == {"error": "invalid JSON body"}


ENCODE = {
  "default_model": {"messages": [{"role": "user", "content": PROMPT}]},
  "gpt_alias": {"model": "gpt-4o", "messages": [{"role": "user", "content": "hello"}, {"role": "assistant", "content": "world"}]},
  "unsupported": {"model": "no-such-model", "messages": [{"role": "user", "content": "a"}]},
}


@pytest.mark.parametrize("case", sorted(ENCODE))
def test_token_encode_equals_jax(daemons, case):
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", "/v1/chat/token/encode", ENCODE[case])
  assert js == ts and json.loads(tb) == json.loads(jb)
  if js == 200:
    body = json.loads(tb)
    assert body["num_tokens"] == len(body["encoded_tokens"]) > 0


@pytest.mark.parametrize("path", ["/initial_models", "/v1/models", "/models"])
def test_model_lists_equal_jax(daemons, path):
  (js, _, jb), (ts, _, tb) = _both(daemons, "GET", path)
  assert js == ts == 200
  assert json.loads(tb) == _port_cards(json.loads(jb))


def test_models_downloaded_is_per_card(daemons):
  """``downloaded`` is true only for a card whose own directory under the
  downloads home holds safetensors, not for every card whenever
  ``XOT_TPU_MODEL_DIR`` holds any (the port's fault before)."""
  d = daemons.home / "downloads" / tdl.repo_to_dirname(tregistry.get_repo(THROWAWAY, TENGINE))
  d.mkdir(parents=True, exist_ok=True)
  (d / "model.safetensors").write_bytes(b"")
  try:
    (js, _, jb), (ts, _, tb) = _both(daemons, "GET", "/v1/models")
    got = json.loads(tb)
    assert got == _port_cards(json.loads(jb))
    assert {m["id"] for m in got["data"] if m["downloaded"]} == {THROWAWAY}
  finally:
    (d / "model.safetensors").unlink()
    d.rmdir()


def test_modelpool_stream_equals_jax(daemons):
  (js, _, jb), (ts, tct, tb) = _both(daemons, "GET", "/modelpool")
  assert js == ts == 200 and tct == "text/event-stream"
  ids = set(tregistry.model_cards)
  assert _events(tb) == [e for e in _events(jb) if e["model"] in ids]


DOWNLOADS = {"served_model": {"model": MODEL}, "unknown_model": {"model": "no-such-model"}, "no_model": {}}


@pytest.mark.parametrize("case", sorted(DOWNLOADS))
def test_download_and_progress_equal_jax(daemons, case):
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", "/download", DOWNLOADS[case])
  assert js == ts and json.loads(tb) == json.loads(jb)
  time.sleep(0.2)  # the resolution runs in the background
  (js, _, jb), (ts, _, tb) = _both(daemons, "GET", "/v1/download/progress")
  assert js == ts == 200 and json.loads(tb) == json.loads(jb) == {}  # XOT_TPU_MODEL_DIR: nothing is fetched


@pytest.mark.parametrize("case", ["present", "absent", "unknown"])
def test_delete_model_equals_jax(daemons, case):
  model = "no-such-model" if case == "unknown" else THROWAWAY
  d = daemons.home / "downloads" / tdl.repo_to_dirname(tregistry.get_repo(THROWAWAY, TENGINE))
  results = []
  for port in (daemons.jport, daemons.tport):
    if case == "present":
      d.mkdir(parents=True, exist_ok=True)
      (d / "config.json").write_text("{}")
    results.append(_http(port, "DELETE", f"/models/{model}"))
    assert not d.exists()
  (js, _, jb), (ts, _, tb) = results
  assert js == ts == (200 if case == "present" else 404)
  assert json.loads(tb) == json.loads(jb)


def test_quit_answers_then_signals_its_process(daemons, monkeypatch):
  sent = []
  monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
  (js, _, jb), (ts, _, tb) = _both(daemons, "POST", "/quit")
  assert js == ts == 200 and json.loads(tb) == json.loads(jb) == {"detail": "Quit signal received"}
  # Both daemons answer before they signal: the second signal may follow
  # the client's read of the answer.
  deadline = time.monotonic() + 10
  while len(sent) < 2 and time.monotonic() < deadline:
    time.sleep(0.01)
  assert sent == [(os.getpid(), signal.SIGINT)] * 2


@pytest.mark.parametrize("path", ["/", "/index.html"])
def test_web_page_equals_jax(daemons, path):
  (js, jct, jb), (ts, tct, tb) = _both(daemons, "GET", path)
  assert js == ts == 200 and tb == jb and jct.startswith("text/html") and tct.startswith("text/html")
  for needle in ('id="model"', 'id="dl-btn"', 'id="del-btn"', 'id="stop"', "/v1/download/progress", "xot_tpu_histories", "renderMarkdown"):
    assert needle in tb


@pytest.mark.parametrize("path", ["/../README.md", "/%2e%2e/README.md", "/no-such-file.js", "/tinychat/../../README.md"])
def test_static_files_stay_inside_tinychat(daemons, path):
  req = urllib.request.Request(f"http://127.0.0.1:{daemons.tport}{path}")
  with pytest.raises(urllib.error.HTTPError) as e:
    urllib.request.urlopen(req, timeout=30)
  assert e.value.code == 404


def test_static_file_refuses_paths_that_leave_the_directory():
  assert tapi._static_file("index.html") == tapi.STATIC_DIR.resolve() / "index.html"
  assert tapi._static_file("/../README.md") is None
  assert tapi._static_file("%2e%2e/%2e%2e/README.md") is None
  assert (ROOT / "xotorch_support_jetson_tpu_torch" / "tinychat" / "index.html").read_bytes() == (ROOT / "xotorch_support_jetson_tpu" / "tinychat" / "index.html").read_bytes()


# ------------------------------------------------------------------ scoring

SCORE_CASES = {  # (S_pad, seq_len, n_scored, top_n)
  "bucket_exact": (32, 20, 5, 4),
  "n_bucketed": (32, 20, 8, 20),
  "over_bucketed_clipped": (32, 10, 16, 3),  # leading rows clip to position 0
  "whole_sequence": (16, 16, 15, 1),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_last_tokens_equals_jax(case):
  S_pad, L, n, top_n = SCORE_CASES[case]
  jc, tc, js, ts, jp, tp = _pair("llama")
  toks = np.zeros((1, S_pad), dtype=np.int32)
  toks[0, :L] = np.random.default_rng(5).integers(0, 256, L)
  want = [np.asarray(x) for x in jdec.score_last_tokens(jp, jc, js, jnp.asarray(toks), jnp.int32(L), n, top_n)]
  got = [x.numpy() for x in tdec.score_last_tokens(tp, tc, ts, torch.from_numpy(toks), L, n, top_n)]
  np.testing.assert_allclose(got[0], want[0], **TOL)
  np.testing.assert_array_equal(got[1], want[1])
  np.testing.assert_allclose(got[2], want[2], **TOL)
  assert got[0].shape == (n,) and got[1].shape == got[2].shape == (n, top_n)


def test_score_last_tokens_is_one_cacheless_forward():
  """The scoring forward's rows are the cache-less forward's log-softmax at
  the positions before each scored token."""
  _, tc, _, ts, _, tp = _pair("llama")
  toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 24)).astype(np.int32))
  logits, _ = tdec.shard_forward(tp, tc, ts, toks, torch.arange(24, dtype=torch.int32)[None], None)
  logp = torch.log_softmax(logits[0].float(), -1)
  chosen, ids, top = tdec.score_last_tokens(tp, tc, ts, toks, 24, 6, 5)
  rows = torch.arange(17, 23)
  torch.testing.assert_close(chosen, logp[rows, toks[0, rows + 1].long()])
  torch.testing.assert_close(top, logp[rows].topk(5).values)


@pytest.mark.parametrize("n", [-1, 0, 1, 7, 33, 39, 40])
def test_engine_score_tokens_equals_jax(daemons, n):
  """The engines' bucketed scoring: ids identical, values within TOL; None
  when there is nothing to score (n <= 0, n >= S)."""
  seq = np.random.default_rng(n + 1).integers(3, 512, 40).astype(np.int32)
  want = daemons.run(daemons.jengine.score_tokens(JShard(MODEL, 0, 15, 16), seq, n, 4))
  got = daemons.run(daemons.tengine.score_tokens(Shard(MODEL, 0, 15, 16), seq, n, 4))
  if not 0 < n < len(seq):
    assert want is None and got is None
    return
  assert got[0].shape == (n,) and got[1].shape == got[2].shape == (n, 4)
  np.testing.assert_allclose(got[0], want[0], **TOL)
  np.testing.assert_array_equal(got[1], want[1])
  np.testing.assert_allclose(got[2], want[2], **TOL)


def test_ledger_records_scoring_as_the_jax_ledger_does(daemons):
  """``prefill.score_last``: a build per new (bucket, n bucket), a dispatch
  per call, and a steady build for a new bucket after warmup, as in the
  JAX ledger; the family is outside the warmup manifest in both."""
  jax.clear_caches()  # the JAX ledger counts a build when jit traces
  jprograms.ledger.reset()
  tprograms.ledger.reset()
  calls = [(20, 5), (30, 10), (100, 40), None, (300, 5), (310, 7)]  # None: warmup done
  rng = np.random.default_rng(0)
  for c in calls:
    if c is None:
      jprograms.ledger.mark_steady(manifest=[])
      tprograms.ledger.mark_steady(manifest=[])
      continue
    seq = rng.integers(3, 512, c[0]).astype(np.int32)
    daemons.run(daemons.jengine.score_tokens(JShard(MODEL, 0, 15, 16), seq, c[1], 2))
    daemons.run(daemons.tengine.score_tokens(Shard(MODEL, 0, 15, 16), seq, c[1], 2))
  keys = ("compiles", "dispatches", "steady_compiles")
  want = {k: jprograms.ledger.snapshot()["families"]["prefill.score_last"][k] for k in keys}
  got = {k: tprograms.ledger.snapshot()["families"]["prefill.score_last"][k] for k in keys}
  assert got == want == {"compiles": 3, "dispatches": 5, "steady_compiles": 1}
  signatures = [tprograms.ledger.snapshot()["families"]["prefill.score_last"]["signatures"], jprograms.ledger.snapshot()["families"]["prefill.score_last"]["signatures"]]
  assert signatures[0] == signatures[1] and len(signatures[0]) == 3


# --------------------------------------------------------- _align_logprobs


class _SimpleTok:
  words = {1: "he", 2: "llo", 3: " wor", 4: "ld", 9: ""}

  def decode(self, ids):
    return "".join(self.words[i] for i in ids)


class _ByteTok:
  """Tokens 1 and 2 are halves of one multi-byte character."""

  def decode(self, ids):
    if list(ids) in ([1, 2], [1, 2, 3]):
      return "é" + ("x" if 3 in ids else "")
    return "".join({1: "�", 2: "�", 3: "x"}[i] for i in ids)


ALIGN = {  # (tokenizer, tokens, eos set, text, prompt length, stop cut) -> (tokens, offsets, kept)
  "eos_dropped": ((_SimpleTok(), [1, 2, 3, 4, 99], {99}, "hello world", 5, False), (["he", "llo", " wor", "ld"], [5, 7, 10, 14], [0, 1, 2, 3])),
  "stop_cut": ((_SimpleTok(), [1, 2, 3, 4, 99], {99}, "hello", 5, True), (["he", "llo"], [5, 7], [0, 1])),
  "straddling_kept": ((_SimpleTok(), [1, 2, 3, 4], set(), "hello w", 0, True), (["he", "llo", " wor"], [0, 2, 5], [0, 1, 2])),
  "joint_prefix_fallback": ((_ByteTok(), [1, 2, 3], set(), "éx", 0, False), (["�", "�", "x"], [0, 1, 1], [0, 1, 2])),
}


@pytest.mark.parametrize("case", sorted(ALIGN))
def test_align_logprobs_contract(case):
  args, want = ALIGN[case]
  assert tapi._align_logprobs(*args) == japi._align_logprobs(*args) == want


# ---------------------------------------------------------------- downloads


def test_progress_events_round_trip_like_the_reference():
  fe = dict(repo_id="o/r", repo_revision="main", file_path="a.safetensors", downloaded=5, downloaded_this_session=1, total=5, speed=2.0, eta=0.0, status="complete")
  ev = dict(shard={"model_id": "m", "start_layer": 0, "end_layer": 1, "n_layers": 2}, repo_id="o/r", repo_revision="main", completed_files=1, total_files=1, downloaded_bytes=5, downloaded_bytes_this_session=1, total_bytes=5, overall_speed=2.0, overall_eta=0.0, status="complete")
  t = tprogress.RepoProgressEvent(**ev, file_progress={"a.safetensors": tprogress.RepoFileProgressEvent(**fe)})
  j = jprogress.RepoProgressEvent(**ev, file_progress={"a.safetensors": jprogress.RepoFileProgressEvent(**fe)})
  assert t.to_dict() == j.to_dict()
  assert tprogress.RepoProgressEvent.from_dict(json.loads(json.dumps(t.to_dict()))) == t
  assert Shard("m", 0, 1, 2).to_dict() == JShard("m", 0, 1, 2).to_dict()


WEIGHT_MAP = {"model.embed_tokens.weight": "m-1.safetensors", "model.layers.0.mlp.up_proj.weight": "m-1.safetensors", "model.layers.1.mlp.up_proj.weight": "m-2.safetensors", "model.norm.weight": "m-3.safetensors"}
ALLOW = {
  "no_map": (None, (0, 1, 2)),
  "first_layer": (WEIGHT_MAP, (0, 0, 2)),
  "last_layer": (WEIGHT_MAP, (1, 1, 2)),
  "middle": (WEIGHT_MAP, (1, 1, 3)),
}


@pytest.mark.parametrize("case", sorted(ALLOW))
def test_allow_patterns_and_filtering_equal_the_reference(case):
  wm, (a, b, n) = ALLOW[case]
  tp, jp = thf.get_allow_patterns(wm, Shard("llama-3.2-1b", a, b, n)), jhf.get_allow_patterns(wm, JShard("llama-3.2-1b", a, b, n))
  assert tp == jp
  files = ["config.json", "m-1.safetensors", "m-2.safetensors", "m-3.safetensors", "tokenizer.json", "README.md", "sub/x.py"]
  assert thf.filter_repo_objects(files, tp, ["*.md"]) == jhf.filter_repo_objects(files, jp, ["*.md"])


def test_hf_helpers_equal_the_reference(monkeypatch, tmp_path):
  assert thf.extract_weight_map(json.dumps({"weight_map": WEIGHT_MAP})) == jhf.extract_weight_map(json.dumps({"weight_map": WEIGHT_MAP})) == WEIGHT_MAP
  assert thf.extract_weight_map("not json") is None is jhf.extract_weight_map("not json")
  monkeypatch.setenv("HF_HOME", str(tmp_path))
  monkeypatch.delenv("HF_TOKEN", raising=False)
  assert thf.get_hf_home() == jhf.get_hf_home() == tmp_path
  assert thf.get_auth_headers() == jhf.get_auth_headers() == {}
  (tmp_path / "token").write_text("file-token\n")
  assert thf.get_hf_token() == jhf.get_hf_token() == "file-token"
  monkeypatch.setenv("HF_TOKEN", "env-token")
  assert thf.get_auth_headers() == jhf.get_auth_headers() == {"Authorization": "Bearer env-token"}


@pytest.mark.parametrize("model", ["llama-3.2-1b", "qwen-3-0.6b", "phi-4-mini-instruct", "no-such-model"])
def test_registry_helpers_equal_the_reference(model):
  full = tregistry.build_full_shard(model, TENGINE)
  jfull = jregistry.build_full_shard(model, JENGINE)
  assert (full and full.to_dict()) == (jfull and jfull.to_dict())
  assert tregistry.get_pretty_name(model) == jregistry.get_pretty_name(model)
  assert tregistry.get_family(model) == jregistry.get_family(model)
  assert set(tregistry.get_supported_models([["torch"]])) == {m for m, card in tregistry.model_cards.items() if card.repo_for(TENGINE)}
  assert tregistry.get_supported_models() == list(tregistry.model_cards)
  assert tregistry.get_supported_models([["jax"]]) == []


def test_local_downloader_resolves_on_disk_checkpoints(tmp_path, monkeypatch, tiny_dir):
  """``XOT_TPU_MODEL_DIR`` first; else the card's own directory under the
  downloads home, its files reported complete; else the hub fetch, which
  ``HF_HUB_OFFLINE`` (set for the test suite) turns into a clear error
  instead (tests/test_torch_download.py fetches from a loopback hub)."""
  monkeypatch.setenv("HF_HUB_OFFLINE", "1")
  monkeypatch.setenv("XOT_TPU_HOME", str(tmp_path))
  monkeypatch.delenv("XOT_TPU_MODEL_DIR", raising=False)
  shard = tregistry.build_full_shard(MODEL, TENGINE)
  events = []

  async def go():
    dl = tdl.new_shard_downloader()
    dl.on_progress.register("t").on_next(lambda s, e: events.append((s, e)))
    with pytest.raises(FileNotFoundError, match="no local checkpoint.*HF_HUB_OFFLINE is set"):
      await dl.ensure_shard(shard, TENGINE)
    card_dir = tdl.get_models_dir() / tdl.repo_to_dirname(tregistry.get_repo(MODEL, TENGINE))
    card_dir.mkdir(parents=True)
    for f in tiny_dir.iterdir():
      (card_dir / f.name).write_bytes(f.read_bytes())
    (card_dir / "README.md").write_text("not needed")
    a, b = await asyncio.gather(dl.ensure_shard(shard, TENGINE), dl.ensure_shard(shard, TENGINE))
    assert a == b == card_dir
    assert await dl.ensure_shard(shard, TENGINE) == card_dir  # cached: no second event
    monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tiny_dir))
    assert await tdl.new_shard_downloader().ensure_shard(shard, TENGINE) == tiny_dir
    assert await tdl.NoopShardDownloader().ensure_shard(shard, TENGINE) == tiny_dir == await jdl.NoopShardDownloader().ensure_shard(JShard(MODEL, 0, 15, 16), JENGINE)
    assert await tdl.delete_model(MODEL, TENGINE) and not card_dir.exists()
    assert not await tdl.delete_model(MODEL, TENGINE) and not await tdl.delete_model("no-such-model", TENGINE)

  asyncio.run(go())
  assert len(events) == 1
  ev = events[0][1].to_dict()
  names = {f.name for f in tiny_dir.iterdir() if f.suffix in (".json", ".safetensors")}  # what the allow patterns take
  assert ev["status"] == "complete" and set(ev["file_progress"]) == names and ev["completed_files"] == ev["total_files"] == len(names)
  assert ev["downloaded_bytes"] == ev["total_bytes"] == sum((tiny_dir / n).stat().st_size for n in names)
  assert ev["shard"] == shard.to_dict()


def test_deleted_model_does_not_resolve_again(tmp_path, monkeypatch, tiny_dir):
  """After ``delete_model`` the stack that resolved the model's directory
  raises the no-local-checkpoint error instead of returning the deleted
  path; a directory placed there again resolves again."""
  monkeypatch.setenv("XOT_TPU_HOME", str(tmp_path))
  monkeypatch.delenv("XOT_TPU_MODEL_DIR", raising=False)
  shard = tregistry.build_full_shard(MODEL, TENGINE)
  card_dir = tdl.get_models_dir() / tdl.repo_to_dirname(tregistry.get_repo(MODEL, TENGINE))

  def place():
    card_dir.mkdir(parents=True)
    for f in tiny_dir.iterdir():
      (card_dir / f.name).write_bytes(f.read_bytes())

  async def go():
    dl = tdl.new_shard_downloader()
    place()
    assert await dl.ensure_shard(shard, TENGINE) == card_dir
    assert await tdl.delete_model(MODEL, TENGINE)
    with pytest.raises(FileNotFoundError, match="no local checkpoint"):
      await dl.ensure_shard(shard, TENGINE)
    place()
    assert await dl.ensure_shard(shard, TENGINE) == card_dir

  asyncio.run(go())


def test_download_route_fills_the_progress_of_this_node(tmp_path, monkeypatch, tiny_dir):
  """POST /download of a model whose directory is local: the node keeps
  its complete event under its id (main.py's on_progress wiring)."""
  monkeypatch.setenv("XOT_TPU_HOME", str(tmp_path))
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  monkeypatch.delenv("XOT_TPU_MODEL_DIR", raising=False)
  card_dir = tdl.get_models_dir() / tdl.repo_to_dirname(tregistry.get_repo(MODEL, TENGINE))
  card_dir.mkdir(parents=True)
  for f in tiny_dir.iterdir():
    (card_dir / f.name).write_bytes(f.read_bytes())
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--node-id", "dl-node"])

  async def go():
    node, api, engine, _ = tmain.build_components(args)
    server = await api.run(host="127.0.0.1", port=port)
    try:
      started = await asyncio.to_thread(_http, port, "POST", "/download", {"model": MODEL})
      for _ in range(100):
        if node.node_download_progress:
          break
        await asyncio.sleep(0.02)
      progress = await asyncio.to_thread(_http, port, "GET", "/v1/download/progress")
      models = await asyncio.to_thread(_http, port, "GET", "/v1/models")
    finally:
      server.close()
      engine.executor.shutdown(wait=True)
    return started, progress, models

  started, progress, models = asyncio.run(go())
  assert started[0] == 200 and json.loads(started[2]) == {"status": f"Download started for {MODEL}"}
  body = json.loads(progress[2])
  assert list(body) == ["dl-node"] and body["dl-node"]["status"] == "complete" and body["dl-node"]["repo_id"] == tregistry.get_repo(MODEL, TENGINE)
  assert {m["id"] for m in json.loads(models[2])["data"] if m["downloaded"]} == {MODEL}


@pytest.mark.parametrize("prefixed", [False, True])
def test_seed_models_moves_like_the_reference(tmp_path, monkeypatch, prefixed):
  results = []
  for name, mod in (("jax", jdl), ("torch", tdl)):
    home, seed = tmp_path / name / "home", tmp_path / name / "seed"
    monkeypatch.setenv("XOT_TPU_HOME", str(home))
    monkeypatch.setattr(jdl, "XOT_HOME", home)
    for repo in ("o--a", "o--b"):
      (seed / (f"models--{repo}" if prefixed else repo)).mkdir(parents=True)
      (seed / (f"models--{repo}" if prefixed else repo) / "config.json").write_text(repo)
    (seed / "stray.txt").write_text("x")
    (home / "downloads" / "o--b").mkdir(parents=True)  # exists: left untouched
    asyncio.run(mod.seed_models(seed))
    results.append((sorted(p.relative_to(home).as_posix() for p in home.rglob("*")), sorted(p.name for p in seed.iterdir())))
  assert results[0] == results[1]
  assert "downloads/o--a/config.json" in results[1][0] and "downloads/o--b/config.json" not in results[1][0]


# -------------------------------------------------------------- the run CLI


def test_run_command_prints_the_jax_tokens(daemons, capsys):
  from xotorch_support_jetson_tpu.main import run_model_cli as jrun

  def printed():
    out = capsys.readouterr().out
    text, stats = out.rsplit("\n[", 1)
    assert "tokens in" in stats and "tok/s" in stats
    return text, int(stats.split(" ")[0])

  capsys.readouterr()
  daemons.run(jrun(daemons.jnode, JENGINE, MODEL, PROMPT))
  want = printed()
  daemons.run(tmain.run_model_cli(daemons.tnode, TENGINE, MODEL, PROMPT))
  got = printed()
  assert got == want and got[1] > 0
  daemons.run(tmain.run_model_cli(daemons.tnode, TENGINE, "no-such-model", PROMPT))
  assert "unsupported model" in capsys.readouterr().out


def _port_process(args, env_extra, stdout=subprocess.PIPE, **kw):
  env = {**os.environ, "XOT_TPU_PLATFORM": "cpu", **env_extra}
  return subprocess.Popen([sys.executable, "-m", "xotorch_support_jetson_tpu_torch.main", *args], cwd=ROOT, env=env, stdout=stdout, stderr=subprocess.STDOUT, text=True, **kw)


def test_run_command_process_exits_zero(tiny_dir, tmp_path):
  proc = _port_process(["run", MODEL, "--discovery-module", "none", "--prompt", PROMPT, "--temp", "0", "--max-generate-tokens", "6"], {"XOT_TPU_MODEL_DIR": str(tiny_dir), "XOT_TPU_HOME": str(tmp_path)})
  out, _ = proc.communicate(timeout=120)
  assert proc.returncode == 0, out
  assert " tokens in " in out and "tok/s" in out


def _wait_up(port, proc, log, timeout=300):
  """Until the daemon answers its healthcheck; False when it exited first
  (its output in ``log``). The bound only ends a hung start: under a
  parallel test run the daemon's torch import alone can take a minute."""
  deadline = time.monotonic() + timeout
  while time.monotonic() < deadline:
    if proc.poll() is not None:
      return False
    try:
      if _http(port, "GET", "/healthcheck")[0] == 200:
        return True
    except OSError:
      pass
    time.sleep(0.2)
  raise AssertionError(f"the daemon did not come up:\n{log.read_text()}")


def test_quit_stops_a_daemon_process(tiny_dir, tmp_path):
  """``POST /quit`` answers 200 and the daemon exits 0. The daemon writes
  to a file (a pipe nobody reads would block it once full), and a start
  that lost its port to another process between the probe and the bind
  retries on a fresh one."""
  for attempt in range(3):
    port = find_available_port("127.0.0.1")
    log = tmp_path / f"daemon{attempt}.log"
    with log.open("w") as out:
      proc = _port_process(["--discovery-module", "none", "--chatgpt-api-host", "127.0.0.1", "--chatgpt-api-port", str(port)], {"XOT_TPU_MODEL_DIR": str(tiny_dir), "XOT_TPU_HOME": str(tmp_path)}, stdout=out)
    try:
      if not _wait_up(port, proc, log):
        assert "address already in use" in log.read_text().lower(), log.read_text()
        continue
      assert _http(port, "POST", "/quit")[:1] == (200,)
      assert proc.wait(timeout=120) == 0, log.read_text()
      return
    finally:
      proc.kill()
      proc.wait()
  raise AssertionError("no free port held for the daemon in three starts")


def test_second_signal_stops_the_drain_at_once(monkeypatch):
  """The first SIGINT starts the shutdown (the API closes, the node drains
  its outstanding requests); a second one ends the wait at once."""
  calls = []

  class _Server:
    def close(self):
      calls.append("closed")

    async def wait_closed(self):
      await asyncio.Event().wait()  # a connection that never closes

  class _Node:
    async def start(self):
      calls.append("started")

    async def graceful_drain(self, force=None):
      calls.append("drain")
      await force.wait()  # outstanding requests that never finish
      calls.append("forced")

    async def stop(self):
      calls.append("stopped")

  class _Api:
    async def run(self, host, port):
      asyncio.get_running_loop().call_later(0.05, os.kill, os.getpid(), signal.SIGINT)
      asyncio.get_running_loop().call_later(0.4, lambda: calls.append("second") or os.kill(os.getpid(), signal.SIGTERM))
      return _Server()

  monkeypatch.setattr(tmain, "build_components", lambda args: (_Node(), _Api(), None, TENGINE))
  t0 = time.monotonic()
  asyncio.run(asyncio.wait_for(tmain.async_main(tmain.build_parser().parse_args([])), timeout=20))
  assert time.monotonic() - t0 < 5
  assert calls == ["started", "closed", "drain", "second", "forced", "stopped"]
