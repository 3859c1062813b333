"""The port's ring against the JAX package's, on the CPU.

- Partial shards (``ShardPrograms``): a 4-layer tiny llama (tied
  embeddings, f32) split [0–1 | 2–3] and [0 | 1–2 | 3]; each hop's hidden
  state and the tail's logits within rtol = atol = 2e-4 of the JAX
  engine's on the same shards, 16 greedy steps with identical ids, the
  ring families in the program ledger, hidden states in the model's dtype,
  and a bumped ``replay_epoch`` dropping a stale session.
- Whole rings on loopback: port rings of two and three nodes (TCP) give the
  greedy tokens of the JAX package's two-node gRPC ring with its JAX
  engine, and of the port's solo node; a request's ``temperature`` and
  ``max_tokens`` reach the tail; the tail's API answers as the head's; the
  dummy-engine ring yields 5 … 69; losing the middle node mid-stream
  replays over the survivors with no duplicated token; ``/v1/topology``
  and the ring-budget refusal (507) equal the JAX nodes'.
- Every refusal of the slice raises or answers an error.
"""

import asyncio
import json
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch import registry as tregistry
from xotorch_support_jetson_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_support_jetson_tpu_torch.inference.dummy_engine import DUMMY_EOS, DummyInferenceEngine
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.state import InferenceState
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models.decoder import ShardPrograms, SoloPrograms, init_kv_cache, init_shard_params
from xotorch_support_jetson_tpu_torch.networking.discovery import Discovery
from xotorch_support_jetson_tpu_torch.networking.tcp.tcp_peer_handle import TCPPeerHandle
from xotorch_support_jetson_tpu_torch.networking.tcp.tcp_server import TCPServer
from xotorch_support_jetson_tpu_torch.orchestration import node as tnode
from xotorch_support_jetson_tpu_torch.orchestration.node import Node
from xotorch_support_jetson_tpu_torch.topology.device_capabilities import DeviceCapabilities, DeviceFlops
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port
from xotorch_support_jetson_tpu_torch.utils.programs import ledger

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

MODEL = "llama-3.2-1b"  # the registry card the tiny checkpoint stands in for
N_LAYERS = 4
PROMPT = "hello world how are you today the quick brown fox "
STEPS = 16
TOL = dict(rtol=2e-4, atol=2e-4)


def make_tiny_llama4(path: Path) -> Path:
  """A 4-layer llama (f32, tied embeddings: the head and the tail both
  load the embedding) with a BPE tokenizer and a plain chat template."""
  from tokenizers import Tokenizer, models, pre_tokenizers, trainers
  from transformers import AutoConfig, AutoModelForCausalLM, PreTrainedTokenizerFast

  torch.manual_seed(0)
  cfg = AutoConfig.for_model(
    "llama", vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=N_LAYERS, num_attention_heads=4,
    num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=256, tie_word_embeddings=True,
    torch_dtype="float32", eos_token_id=2, bos_token_id=1,
  )
  AutoModelForCausalLM.from_config(cfg).to(torch.float32).eval().save_pretrained(path, safe_serialization=True)
  tm = Tokenizer(models.BPE(unk_token="<unk>"))
  tm.pre_tokenizer = pre_tokenizers.Whitespace()
  tm.train_from_iterator(["hello world how are you today", "the quick brown fox"] * 50, trainers.BpeTrainer(vocab_size=512, special_tokens=["<unk>", "<s>", "</s>"]))
  tok = PreTrainedTokenizerFast(tokenizer_object=tm, unk_token="<unk>", bos_token="<s>", eos_token="</s>")
  tok.chat_template = "{% for m in messages %}{{ m['content'] }} {% endfor %}"
  tok.save_pretrained(path)
  return path


class DirDownloader:
  def __init__(self, path) -> None:
    self.path = Path(path)

  async def ensure_shard(self, shard, engine_classname):
    return self.path


class StaticDiscovery(Discovery):
  def __init__(self, peers) -> None:
    self.peers = peers

  async def start(self):
    pass

  async def stop(self):
    pass

  async def discover_peers(self, wait_for_peers: int = 0):
    return list(self.peers)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama4(tmp_path_factory.mktemp("tiny_llama4"))


@pytest.fixture(autouse=True)
def _quick_retries(monkeypatch):
  monkeypatch.setenv("XOT_TPU_RETRY_DELAY_S", "0.2")
  for k in ("XOT_TPU_SPEC_DECODE", "XOT_TPU_BATCHED", "XOT_TPU_QUANT", "XOT_TPU_CHAOS", "XOT_TPU_DISAGG", "XOT_TPU_MEMORY_MB"):
    monkeypatch.delenv(k, raising=False)


def caps(mb: int) -> DeviceCapabilities:
  return DeviceCapabilities(model="test", chip="cpu", memory=mb, flops=DeviceFlops(1, 2, 4))


# ------------------------------------------------------------ partial shards


def _as_np(x):
  return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


async def _chain(engines, shards, rid, x, state):
  """One lap through every shard: each hop's output."""
  outs = []
  for engine, shard in zip(engines, shards):
    x, state = await engine.infer_tensor(rid, shard, x, state)
    outs.append(x)
  return outs, state


@pytest.mark.asyncio
@pytest.mark.parametrize("split", [((0, 1), (2, 3)), ((0, 0), (1, 2), (3, 3))], ids=["2-way", "3-way"])
async def test_partial_shards_equal_the_jax_engine(tiny_dir, split):
  from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
  from xotorch_support_jetson_tpu.inference.shard import Shard as JShard

  tshards = [Shard(MODEL, a, b, N_LAYERS) for a, b in split]
  jshards = [JShard(MODEL, a, b, N_LAYERS) for a, b in split]
  tes = [TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in split]
  jes = [JaxShardedInferenceEngine(DirDownloader(tiny_dir), use_local_mesh=False) for _ in split]
  ledger.reset()
  tokens = np.asarray(await tes[0].encode(tshards[0], PROMPT), np.int32).reshape(1, -1)
  t_outs, t_state = await _chain(tes, tshards, "r", tokens, None)
  j_outs, j_state = await _chain(jes, jshards, "r", tokens, None)
  ids_t, ids_j = [], []
  for step in range(STEPS + 1):
    for i, (t, j) in enumerate(zip(t_outs, j_outs)):
      if i < len(split) - 1:
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32 and not isinstance(j, torch.Tensor)
      np.testing.assert_allclose(_as_np(t), _as_np(j), **TOL, err_msg=f"step {step} hop {i}")
    ids_t.append(int(np.argmax(t_outs[-1][0])))
    ids_j.append(int(np.argmax(j_outs[-1][0])))
    if step == STEPS:
      break
    t_outs, t_state = await _chain(tes, tshards, "r", np.asarray([[ids_t[-1]]], np.int32), t_state)
    j_outs, j_state = await _chain(jes, jshards, "r", np.asarray([[ids_j[-1]]], np.int32), j_state)
  assert ids_t == ids_j and len(ids_t) == STEPS + 1
  assert t_state.tokens.shape[1] == tokens.shape[1] + STEPS and t_state.curr_pos == j_state.curr_pos
  snap = ledger.snapshot()["families"]
  # One build per program, one dispatch per hop: a prefill and STEPS steps per shard.
  assert snap["ring.prefill"]["dispatches"] == len(split) and snap["ring.step"]["dispatches"] == len(split) * STEPS
  assert snap["ring.prefill"]["compiles"] == len(split) and snap["ring.step"]["compiles"] == len(split)
  for e in tes:
    e.end_request("r")
    assert not e.sessions


@pytest.mark.asyncio
async def test_hidden_states_cross_in_the_model_dtype_and_a_replay_epoch_drops_the_session():
  from xotorch_support_jetson_tpu_torch.models.config import config_from_hf

  cfg = config_from_hf({"model_type": "llama", "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 128, "tie_word_embeddings": True}, dtype=torch.bfloat16)
  assert cfg.dtype == torch.bfloat16
  head, tail = Shard("m", 0, 0, 2), Shard("m", 1, 1, 2)
  g = torch.Generator().manual_seed(0)
  eh, et = (TorchShardedInferenceEngine(device="cpu") for _ in range(2))
  eh.load_test_model(head, cfg, init_shard_params(cfg, head, generator=g))
  et.load_test_model(tail, cfg, init_shard_params(cfg, tail, generator=g))
  prompt = np.asarray([[1, 5, 7, 9]], np.int32)
  h, st = await eh.infer_tensor("r", head, prompt, None)
  assert isinstance(h, torch.Tensor) and h.dtype == torch.bfloat16 and h.shape == (1, 128, 32) and h.device.type == "cpu"
  logits, st = await et.infer_tensor("r", tail, h, st)
  assert logits.dtype == np.float32 and logits.shape == (1, 64)
  h2, st = await eh.infer_tensor("r", head, np.asarray([[3]], np.int32), st)
  assert h2.shape == (1, 1, 32) and eh.sessions["r"].curr_pos == 5
  # A replay (a bumped epoch) prefills the history afresh: the stale session
  # is dropped, and the prefill equals a fresh engine's.
  replay = InferenceState(tokens=np.asarray([[1, 5, 7, 9, 3]], np.int32), prompt_len=5, extras={"replay_epoch": 1})
  h3, _ = await eh.infer_tensor("r", head, replay.tokens, replay)
  assert eh.sessions["r"].epoch == 1 and eh.sessions["r"].curr_pos == 5 and h3.shape == (1, 128, 32)
  fresh = TorchShardedInferenceEngine(device="cpu")
  fresh.load_test_model(head, cfg, eh.params)
  h4, _ = await fresh.infer_tensor("q", head, replay.tokens, InferenceState())
  assert torch.equal(h3, h4)
  # A hidden state where token ids belong (and ids on a middle shard) is refused.
  with pytest.raises(ValueError, match="takes"):
    await et.infer_tensor("x", tail, prompt, None)


def test_programs_by_shard():
  from xotorch_support_jetson_tpu_torch.models.config import config_from_hf

  cfg = config_from_hf({"model_type": "llama", "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 128}, dtype=torch.float32)
  full, part = Shard("m", 0, 1, 2), Shard("m", 0, 0, 2)
  with pytest.raises(ValueError, match="full-model shard"):
    SoloPrograms(init_shard_params(cfg, part), cfg, part, init_kv_cache(cfg, 1, 1, 16))
  with pytest.raises(ValueError, match="SoloPrograms"):
    ShardPrograms(init_shard_params(cfg, full), cfg, full, init_kv_cache(cfg, 2, 1, 16))


def test_speculation_refused_on_a_partial_shard(monkeypatch):
  from xotorch_support_jetson_tpu_torch.models.config import config_from_hf

  cfg = config_from_hf({"model_type": "llama", "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 128}, dtype=torch.float32)
  for mode in ("int8", "ngram"):
    engine = TorchShardedInferenceEngine(device="cpu", spec_decode=mode)
    with pytest.raises(ValueError, match="whole model"):
      engine.load_test_model(Shard("m", 1, 1, 2), cfg, init_shard_params(cfg, Shard("m", 1, 1, 2)))
    engine.load_test_model(Shard("m", 0, 1, 2), cfg, init_shard_params(cfg, Shard("m", 0, 1, 2)))  # the whole model serves


# ------------------------------------------------------------ rings


async def _converge(nodes, n_layers, n_shards):
  from xotorch_support_jetson_tpu_torch.topology.partitioning import map_partitions_to_shards

  for _ in range(200):
    await asyncio.gather(*(n.collect_topology(set()) for n in nodes))
    if all(len(n.topology.nodes) == len(nodes) and len(map_partitions_to_shards(n.partitioning_strategy.partition(n.topology), n_layers, "m")) == n_shards for n in nodes):
      return
    await asyncio.sleep(0.05)
  raise AssertionError("the ring's views did not converge")


async def port_ring(engines, mems, ids=None, max_tokens=200):
  """Port nodes on loopback, one TCP server each, statically discovered;
  ``mems`` sets each node's reported memory (so its share of layers)."""
  ids = ids or [f"node{i}" for i in range(len(engines))]
  ports = [find_available_port("127.0.0.1") for _ in engines]
  nodes = []
  for i, engine in enumerate(engines):
    peers = [TCPPeerHandle(ids[j], f"127.0.0.1:{ports[j]}", "test", caps(mems[j])) for j in range(len(engines)) if j != i]
    node = Node(ids[i], engine, max_generate_tokens=max_tokens, default_sample_temp=0.0, discovery=StaticDiscovery(peers))
    node.server = TCPServer(node, "127.0.0.1", ports[i])
    nodes.append(node)
  await asyncio.gather(*(n.start() for n in nodes))
  for n, mb in zip(nodes, mems):
    n.device_capabilities = caps(mb)
  await _converge(nodes, N_LAYERS, len(nodes))
  return nodes


async def jax_ring(tiny_dir, n=2):
  from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
  from xotorch_support_jetson_tpu.networking.grpc.grpc_peer_handle import GRPCPeerHandle
  from xotorch_support_jetson_tpu.networking.grpc.grpc_server import GRPCServer
  from xotorch_support_jetson_tpu.orchestration.node import Node as JNode
  from xotorch_support_jetson_tpu.topology.device_capabilities import DeviceCapabilities as JCaps
  from xotorch_support_jetson_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy
  from tests_support_stubs import NoDiscovery  # noqa: F401 — the suite's stubs module is importable

  class JStatic:
    def __init__(self, peers):
      self.peers = peers

    async def start(self):
      pass

    async def stop(self):
      pass

    async def discover_peers(self, wait_for_peers=0):
      return list(self.peers)

  ports = [find_available_port("127.0.0.1") for _ in range(n)]
  ids = [f"node{i}" for i in range(n)]
  nodes = []
  for i in range(n):
    peers = [GRPCPeerHandle(ids[j], f"127.0.0.1:{ports[j]}", "test", JCaps.from_dict(caps(1024).to_dict())) for j in range(n) if j != i]
    node = JNode(ids[i], None, JaxShardedInferenceEngine(DirDownloader(tiny_dir), use_local_mesh=False), JStatic(peers), None, RingMemoryWeightedPartitioningStrategy(), max_generate_tokens=200, default_sample_temp=0.0)
    node.server = GRPCServer(node, "127.0.0.1", ports[i])
    nodes.append(node)
  await asyncio.gather(*(node.start() for node in nodes))
  for node in nodes:
    node.device_capabilities = JCaps.from_dict(caps(1024).to_dict())
  await _converge(nodes, N_LAYERS, n)
  return nodes


async def _generate(nodes, origin: int, rid: str, prompt: str, max_tokens: int, temperature: float = 0.0, listener: int | None = None):
  """Tokens of one request sent to ``nodes[origin]``, read on
  ``nodes[listener]`` (default the origin)."""
  listener = origin if listener is None else listener
  got, done = [], asyncio.Event()

  def on_token(r, toks, fin):
    if r == rid:
      got.extend(int(t) for t in toks)
      if fin:
        done.set()

  nodes[listener].on_token.register(f"t-{rid}").on_next(on_token)
  nodes[origin].set_request_options(rid, max_tokens=max_tokens, temperature=temperature)
  await nodes[origin].process_prompt(tregistry.build_base_shard(MODEL, "TorchShardedInferenceEngine") if isinstance(nodes[origin], Node) else _jshard(), prompt, rid)
  await asyncio.wait_for(done.wait(), timeout=60)
  nodes[listener].on_token.deregister(f"t-{rid}")
  return got


def _jshard():
  from xotorch_support_jetson_tpu.registry import build_base_shard

  return build_base_shard(MODEL, "JaxShardedInferenceEngine")


async def _stop(nodes):
  for n in nodes:
    await n.stop()
  for n in nodes:
    ex = getattr(n.inference_engine, "executor", None)
    if ex is not None:
      ex.shutdown(wait=True)


@pytest.mark.asyncio
async def test_rings_give_the_jax_rings_and_the_solo_nodes_greedy_tokens(tiny_dir, monkeypatch):
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tiny_dir))
  jnodes = await jax_ring(tiny_dir)
  try:
    # The registry's 16 layers, remapped by each engine onto the checkpoint's 4.
    # (Equal memories: the larger node id heads the ring.)
    assert [(s.start_layer, s.end_layer) for s in (jnodes[0].get_current_shard(_jshard()), jnodes[1].get_current_shard(_jshard()))] == [(8, 15), (0, 7)]
    want = await _generate(jnodes, 0, "j", PROMPT, STEPS)
  finally:
    for n in jnodes:
      await n.stop()
  assert len(want) == STEPS
  solo = Node("solo", TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu"), default_sample_temp=0.0)
  assert await _generate([solo], 0, "s", PROMPT, STEPS) == want
  for mems, shards in (([1024, 1024], [(8, 15), (0, 7)]), ([2048, 1025, 1024], [(0, 7), (8, 11), (12, 15)])):
    nodes = await port_ring([TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in mems], mems)
    try:
      base = tregistry.build_base_shard(MODEL, "TorchShardedInferenceEngine")
      assert [(n.get_current_shard(base).start_layer, n.get_current_shard(base).end_layer) for n in nodes] == shards
      head = next(i for i, s in enumerate(shards) if s[0] == 0)
      tail = next(i for i, s in enumerate(shards) if s[1] == 15)
      # Sent to the head, read on the head (the tail's broadcasts), and sent
      # to the tail (the prompt forwarded to the head), read on the tail.
      assert await _generate(nodes, head, "h", PROMPT, STEPS) == want
      assert await _generate(nodes, tail, "t", PROMPT, STEPS) == want
      # Each engine remapped its shard onto the checkpoint's 4 layers.
      assert sorted((n.inference_engine._effective_shard.start_layer, n.inference_engine._effective_shard.end_layer) for n in nodes) == sorted((a // 4, (b + 1) // 4 - 1) for a, b in shards)
      await asyncio.sleep(0.1)
      assert all(not n.inference_engine.sessions for n in nodes)  # every share released at the finish
      assert all(not n.outstanding_requests for n in nodes)
    finally:
      await _stop(nodes)


@pytest.mark.asyncio
async def test_request_options_reach_the_tail(tiny_dir):
  nodes = await port_ring([TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in range(2)], [1025, 1024])
  seen = []
  tail = nodes[1].inference_engine  # the smaller memory: layers 8-15
  sample = tail.sample

  async def spy(x, temp=0.6, top_k=35):
    seen.append((temp, top_k))
    return await sample(x, temp=temp, top_k=top_k)

  tail.sample = spy
  try:
    nodes[0].set_request_options("o", top_k=7)
    got = await _generate(nodes, 0, "o", PROMPT, 5, temperature=0.9)
    assert len(got) == 5 and seen == [(0.9, 7)] * 5  # the head's defaults are 0.0 / 35
    assert "o" not in nodes[1].request_options  # the tail dropped them at the finish
  finally:
    await _stop(nodes)


@pytest.mark.asyncio
async def test_batched_knob_on_a_partial_shard_takes_the_ring_lap(tiny_dir, monkeypatch):
  """``XOT_TPU_BATCHED=1`` on a ring: the head's shard is not the whole
  model, so the request takes the ring lap (as in the reference) with the
  same tokens, and no batched server is built."""
  nodes = await port_ring([TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in range(2)], [1025, 1024])
  try:
    plain = await _generate(nodes, 0, "p", PROMPT, 6)
    monkeypatch.setenv("XOT_TPU_BATCHED", "1")
    assert await _generate(nodes, 0, "b", PROMPT, 6) == plain
    assert all(n.inference_engine._batched_server is None for n in nodes)
  finally:
    await _stop(nodes)


def _http(port, path, body=None):
  req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=None if body is None else json.dumps(body).encode(), headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=120) as r:
      return r.status, r.read().decode()
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode()


def _sse_text(raw: str) -> str:
  out = ""
  for line in raw.splitlines():
    if line.startswith("data: ") and line != "data: [DONE]":
      ev = json.loads(line[6:])
      out += (ev["choices"][0]["delta"].get("content") or "") if ev.get("choices") else ""
  return out


@pytest.mark.asyncio
async def test_the_tails_api_answers_as_the_heads_and_the_ring_refusals(tiny_dir, monkeypatch):
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tiny_dir))
  nodes = await port_ring([TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in range(2)], [1024, 1024])
  apis = [ChatGPTAPI(n, "TorchShardedInferenceEngine", response_timeout=120, default_model=MODEL) for n in nodes]
  ports = [find_available_port("127.0.0.1") for _ in nodes]
  servers = [await api.run(host="127.0.0.1", port=p) for api, p in zip(apis, ports)]
  chat = {"model": MODEL, "messages": [{"role": "user", "content": "hello world"}], "temperature": 0.0, "max_tokens": 12}
  try:
    answers = {}
    for name, port, stream in (("head", ports[0], False), ("head-stream", ports[0], True), ("tail", ports[1], False), ("tail-stream", ports[1], True)):
      st, raw = await asyncio.to_thread(_http, port, "/v1/chat/completions", {**chat, "stream": stream})
      assert st == 200, raw
      answers[name] = _sse_text(raw) if stream else json.loads(raw)["choices"][0]["message"]["content"]
    assert len(set(answers.values())) == 1 and answers["head"], answers
    # logprobs need the whole model on one node.
    st, raw = await asyncio.to_thread(_http, ports[0], "/v1/chat/completions", {**chat, "logprobs": True})
    assert st == 400 and "whole model" in raw
    st, raw = await asyncio.to_thread(_http, ports[1], "/v1/completions", {"model": MODEL, "prompt": "hello", "logprobs": 2})
    assert st == 400 and "whole model" in raw
    # The cluster pulls are not ported: with peers ?scope=cluster is a 501.
    for path in ("/metrics", "/v1/slo", "/v1/programs", "/v1/kv/tier"):
      assert (await asyncio.to_thread(_http, ports[0], path + "?scope=cluster"))[0] == 501, path
      assert (await asyncio.to_thread(_http, ports[0], path))[0] == 200, path
    st, raw = await asyncio.to_thread(_http, ports[0], "/metrics")
    assert 'xot_tpu_kernel_launches_total{kernel="flash_prefill"} 0' in raw and "xot_tpu_peer_rpcs_total" in raw
    # Both nodes list both in their topology.
    for port in ports:
      st, raw = await asyncio.to_thread(_http, port, "/v1/topology")
      assert st == 200 and set(json.loads(raw)["nodes"]) == {"node0", "node1"}
  finally:
    for s in servers:
      s.close()
    await _stop(nodes)


@pytest.mark.asyncio
async def test_topology_and_the_ring_budget_equal_the_jax_nodes(tiny_dir, monkeypatch, tmp_path):
  """Two nodes each side, the same ids and capabilities: the merged views,
  the partitions, and — once the memories cannot hold the model — the same
  ring-budget problems; the port's API answers 507 before loading
  anything. The budget reads llama-3.2-1b's published shapes from a
  config-only directory."""
  from xotorch_support_jetson_tpu.topology.device_capabilities import DeviceCapabilities as JCaps

  (tmp_path / "config.json").write_text(json.dumps({
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "max_position_embeddings": 131072, "tie_word_embeddings": True,
  }))
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tmp_path))
  jnodes = await jax_ring(tiny_dir)
  nodes = await port_ring([TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in range(2)], [1024, 1024])

  def body(node):
    j = node.current_topology.to_json()
    j["peer_graph"] = {k: sorted(v, key=json.dumps) for k, v in j["peer_graph"].items()}
    return j

  try:
    for t, j in zip(nodes, jnodes):
      assert body(t) == body(j)
      assert [p.to_dict() for p in t.partitioning_strategy.partition(t.topology)] == [p.to_dict() for p in j.partitioning_strategy.partition(j.topology)]
    # 1024 MB each: llama-3.2-1b's halves (about 1.4 GB of weights) do not fit.
    problems = nodes[0]._ring_budget_problems(Shard(MODEL, 0, 0, 16))
    assert len(problems) == 2 and problems == jnodes[0]._ring_budget_problems(_jshard())
    api = ChatGPTAPI(nodes[0], "TorchShardedInferenceEngine", response_timeout=30, default_model=MODEL)
    port = find_available_port("127.0.0.1")
    server = await api.run(host="127.0.0.1", port=port)
    try:
      st, raw = await asyncio.to_thread(_http, port, "/v1/chat/completions", {"model": MODEL, "messages": [{"role": "user", "content": "hi"}]})
    finally:
      server.close()
    assert st == 507 and json.loads(raw)["error"]["type"] == "insufficient_resources" and problems[0] in raw
    assert nodes[0].inference_engine.shard is None  # nothing was loaded
    # 8000 MB each: it fits on both sides.
    for n in (*nodes, *jnodes):
      n.device_capabilities = caps(8000) if isinstance(n, Node) else JCaps.from_dict(caps(8000).to_dict())
    await _converge(nodes, N_LAYERS, 2)
    await _converge(jnodes, N_LAYERS, 2)
    assert nodes[0]._ring_budget_problems(Shard(MODEL, 0, 0, 16)) == jnodes[0]._ring_budget_problems(_jshard()) == []
  finally:
    await _stop(nodes)
    for n in jnodes:
      await n.stop()


@pytest.mark.asyncio
async def test_dummy_engine_ring_generation():
  nodes = await port_ring([DummyInferenceEngine(), DummyInferenceEngine()], [1024, 1024])
  try:
    shard = tregistry.build_base_shard("dummy", "DummyInferenceEngine")
    got, done = [], asyncio.Event()
    nodes[0].on_token.register("t").on_next(lambda rid, toks, fin: (got.extend(toks), fin and done.set()))
    await nodes[0].process_prompt(shard, "aaaa", "req-dist")
    await asyncio.wait_for(done.wait(), timeout=30)
    assert got == list(range(5, DUMMY_EOS + 1))
  finally:
    await _stop(nodes)


@pytest.mark.asyncio
async def test_losing_the_middle_node_replays_over_the_survivors():
  """Three dummy nodes; the middle one stops mid-stream. The head's hop to
  it fails, the request replays its token history over head and tail, and
  the client's stream is 5 … 69 exactly once."""

  class SlowDummy(DummyInferenceEngine):
    async def infer_tensor(self, request_id, shard, input_data, inference_state=None):
      await asyncio.sleep(0.02)
      return await super().infer_tensor(request_id, shard, input_data, inference_state)

  nodes = await port_ring([SlowDummy() for _ in range(3)], [2048, 1025, 1024])
  try:
    shard = tregistry.build_base_shard("dummy", "DummyInferenceEngine")
    got, done = [], asyncio.Event()
    nodes[0].on_token.register("t").on_next(lambda rid, toks, fin: (got.extend(toks), fin and done.set()))
    task = asyncio.create_task(nodes[0].process_prompt(shard, "aaaa", "req-kill"))
    while len(got) < 10:
      await asyncio.sleep(0.01)
    await nodes[1].stop()
    # Discovery still lists it (as a manual config does): the survivors'
    # collections find it unreachable and leave it out of the partition map.
    await asyncio.wait_for(done.wait(), timeout=60)
    await asyncio.wait_for(task, timeout=30)
    assert got == list(range(5, DUMMY_EOS + 1))
  finally:
    await _stop([nodes[0], nodes[2]])


def test_unported_knobs_refuse_at_start(monkeypatch):
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--inference-engine", "dummy"])
  for knob, value in (("XOT_TPU_CHAOS", "kill:node1"), ("XOT_TPU_DISAGG", "1")):
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match="not ported"):
      tmain.build_components(args)
    with pytest.raises(ValueError, match="not ported"):
      asyncio.run(Node("n", DummyInferenceEngine()).start())
    monkeypatch.delenv(knob)
  node, api, engine, name = tmain.build_components(args)
  assert name == "DummyInferenceEngine" and isinstance(node.server, TCPServer)


def test_daemon_flags_equal_the_reference():
  """The ring's flags and their defaults (``udp`` discovery by default)."""
  from xotorch_support_jetson_tpu.main import build_parser as jparser

  flags = ["--node-host", "--node-port", "--listen-port", "--broadcast-port", "--discovery-module", "--discovery-timeout", "--discovery-config-path", "--wait-for-peers", "--allowed-node-ids", "--interface-type-filter"]
  t, j = vars(tmain.build_parser().parse_args([])), vars(jparser().parse_args([]))
  for flag in flags:
    key = flag[2:].replace("-", "_")
    assert t[key] == j[key], key
  assert t["discovery_module"] == "udp"
  with pytest.raises(ValueError, match="discovery-config-path"):
    tmain.build_components(tmain.build_parser().parse_args(["--discovery-module", "manual", "--inference-engine", "dummy"]))


def test_cluster_pull_statuses_are_refused():
  for kind in sorted(tnode.UNPORTED_STATUS_TYPES):
    with pytest.raises(ValueError, match="not ported"):
      tnode.check_opaque_status(json.dumps({"type": kind}))
  tnode.check_opaque_status(json.dumps({"type": "node_status"}))
  tnode.check_opaque_status("not json")
