"""The port's daemon (main → node → API) on the CPU, serving the verify
skill's tiny llama checkpoint: blocking and streaming
``/v1/chat/completions`` at temperature 0 return the same transcript, and
its token ids equal the JAX engine's greedy tokens for the same prompt."""

import asyncio
import json
import urllib.request

import numpy as np
import pytest

from test_torch_engine import DirDownloader, make_tiny_llama
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

MAX_TOKENS = 12
MESSAGES = [{"role": "user", "content": "hello world how are you"}]


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_api"))


def _post(port, body):
  req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as resp:
    return resp.status, resp.read().decode()


def _get(port, path):
  with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
    return json.loads(resp.read())


def _sse_text(raw: str) -> tuple[str, str | None]:
  text, finish = "", None
  events = [line[len("data: "):] for line in raw.split("\n") if line.startswith("data: ")]
  assert events[-1] == "[DONE]"
  for ev in events[:-1]:
    choice = json.loads(ev)["choices"][0]
    text += choice["delta"].get("content", "")
    finish = choice["finish_reason"] or finish
  return text, finish


async def _jax_greedy(path, prompt):
  engine = JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False)
  shard = JShard("llama-3.2-1b", 0, 15, 16)
  logits, _ = await engine.infer_prompt("j", shard, prompt)
  first = int(np.argmax(logits[0]))
  eos = {engine.tokenizer.eos_token_id, *engine.cfg.eos_token_ids}
  if first in eos:
    return [first]
  return [first] + await engine.generate_oneshot("j", shard, first, MAX_TOKENS - 1, eos_ids=tuple(eos), temp=0.0)


def test_daemon_blocking_and_streaming_match_jax_greedy(tiny_dir, monkeypatch):
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tiny_dir))
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--temp", "0.0", "--max-generate-tokens", str(MAX_TOKENS), "--node-id", "test"])

  async def run():
    node, api, engine, _ = tmain.build_components(args)
    assert engine.device.type == "cpu"
    ids: dict[str, list[int]] = {}
    node.on_token.register("test").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    server = await api.run(host="127.0.0.1", port=port)
    try:
      health = await asyncio.to_thread(_get, port, "/healthcheck")
      models = await asyncio.to_thread(_get, port, "/v1/models")
      body = {"model": "llama-3.2-1b", "messages": MESSAGES, "temperature": 0}
      status_b, raw_b = await asyncio.to_thread(_post, port, {**body, "stream": False})
      status_s, raw_s = await asyncio.to_thread(_post, port, {**body, "stream": True})
      status_bad, raw_bad = await asyncio.to_thread(_post_expect_error, port, {"messages": []})
    finally:
      server.close()
      await server.wait_closed()
    return health, models, (status_b, raw_b), (status_s, raw_s), (status_bad, raw_bad), list(ids.values()), engine

  health, models, (sb, rb), (ss, rs), (sbad, _), streams, engine = asyncio.run(run())
  assert health == {"status": "ok"}
  assert "llama-3.2-1b" in [m["id"] for m in models["data"]]
  assert sb == 200 and ss == 200 and sbad == 400
  blocking = json.loads(rb)
  text_b = blocking["choices"][0]["message"]["content"]
  text_s, finish_s = _sse_text(rs)
  assert text_b == text_s
  assert blocking["choices"][0]["finish_reason"] == finish_s
  assert len(streams) == 2 and streams[0] == streams[1]  # same greedy ids, blocking and streaming
  assert blocking["usage"]["completion_tokens"] == len(streams[0])
  assert engine.sessions == {}

  prompt = engine.tokenizer.apply_chat_template(MESSAGES, tokenize=False, add_generation_prompt=True)
  assert streams[0] == asyncio.run(_jax_greedy(tiny_dir, prompt))


def _post_expect_error(port, body):
  try:
    return _post(port, body)
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode()


TOOLS_TEMPLATE = (
  "{% if tools %}[tools:{% for t in tools %} {{ t['function']['name'] }}{% endfor %}]\n{% endif %}"
  "{% for m in messages %}<{{ m['role'] }}>{{ m['content'] }}"
  "{% if m['tools'] %} [own tools:{% for t in m['tools'] %} {{ t['function']['name'] }}{% endfor %}]{% endif %}\n{% endfor %}"
  "{% if add_generation_prompt %}<assistant>{% endif %}"
)


def _tool(name):
  return {"type": "function", "function": {"name": name, "description": f"{name} tool", "parameters": {"type": "object", "properties": {}}}}


def test_tools_reach_the_prompt_as_in_the_reference():
  """Request-level ``tools`` and per-message ``tools`` are rendered by the
  chat template exactly as the JAX package renders them (they were dropped
  before): the port's prompt equals the reference's, and names the tools."""
  from tokenizers import Tokenizer, models
  from transformers import PreTrainedTokenizerFast

  from xotorch_support_jetson_tpu.api import chatgpt_api as ref_api
  from xotorch_support_jetson_tpu_torch.api import chatgpt_api as port_api

  tok = PreTrainedTokenizerFast(tokenizer_object=Tokenizer(models.WordLevel({"<unk>": 0}, unk_token="<unk>")), unk_token="<unk>")
  tok.chat_template = TOOLS_TEMPLATE
  data = {
    "model": "llama-3.2-1b",
    "tools": [_tool("get_weather"), _tool("search")],
    "messages": [
      {"role": "system", "content": "Use the tools.", "tools": [_tool("calendar")]},
      {"role": "user", "content": [{"type": "text", "text": "Weather in"}, {"type": "text", "text": "Paris?"}]},
    ],
  }
  ref_req = ref_api.parse_chat_request(data, "llama-3.2-1b")
  want, _ = ref_api.build_prompt(tok, ref_req.messages, ref_req.tools)
  port_req = port_api.parse_chat_request(data, "llama-3.2-1b")
  got = port_api.build_prompt(tok, port_req.messages, port_req.tools)
  assert got == want
  assert "[tools: get_weather search]" in got and "[own tools: calendar]" in got and "Weather in Paris?" in got
  plain = port_api.build_prompt(tok, port_api.parse_chat_request({"messages": data["messages"][1:]}, "llama-3.2-1b").messages)
  assert "tools" not in plain and plain == ref_api.build_prompt(tok, ref_api.parse_chat_request({"messages": data["messages"][1:]}, "llama-3.2-1b").messages)[0]
