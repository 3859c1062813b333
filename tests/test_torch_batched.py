"""The port's batched paged serving against the JAX package's, on the CPU,
on identical weights (JAX ``init_shard_params`` → numpy →
``params_from_jax``): the batched decoder programs (logits within
rtol = atol = 2e-4, greedy tokens identical, for bf16-layout, int8 and int4
KV), the ``BatchedServer`` (greedy tokens identical to the JAX
``BatchedServer`` run with ``XOT_TPU_QOS=0 XOT_TPU_KV_TIER=0
XOT_TPU_SPEC_BATCH=0 XOT_TPU_MIXED_TICK=0``, and to the port's solo path;
the defaults, QoS, mixed ticks, the KV tier and speculation on, are held
in test_torch_mixed_tick.py, test_torch_qos.py, test_torch_kv_tier.py and
test_torch_spec_batch.py),
and the daemon with ``XOT_TPU_BATCHED=1`` over HTTP. Sizes are small: 2
layers, width 64, 8-token pages."""

import asyncio
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import make_tiny_llama
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.engine import ServerOverloadedError
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.ops import paged
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
PS = 8
QUANTS = ["", "int8", "int4"]
# The reference's batched server with QoS, mixed ticks and the features the
# port has not got turned off: the FIFO, alternating-tick parity case.
REFERENCE_KNOBS = {"XOT_TPU_QOS": "0", "XOT_TPU_KV_TIER": "0", "XOT_TPU_SPEC_BATCH": "0", "XOT_TPU_MIXED_TICK": "0"}


@pytest.fixture(scope="module")
def model():
  jc = jconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  tc = tconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  jshard, tshard = JShard("tiny", 0, 1, 2), Shard("tiny", 0, 1, 2)
  jp = jdec.init_shard_params(jax.random.PRNGKey(3), jc, jshard)
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, tshard)
  return jc, tc, jshard, tshard, jp, tp


@pytest.fixture
def knobs(monkeypatch):
  for k, v in {**REFERENCE_KNOBS, "XOT_TPU_PAGE_SIZE": str(PS), "XOT_TPU_PREFILL_CHUNK": "16"}.items():
    monkeypatch.setenv(k, v)
  return monkeypatch


def _port_solo(model, prompt, n, quant=""):
  """The port's solo path: cached prefill, then fused_decode (greedy)."""
  _, tc, _, ts, _, tp = model
  S = len(prompt)
  cache = tdec.init_kv_cache(tc, 2, 1, 128, quant=quant)
  logits, cache = tdec.shard_forward(tp, tc, ts, torch.tensor([prompt], dtype=torch.int32), torch.arange(S, dtype=torch.int32)[None], cache)
  first = int(torch.argmax(logits[0, -1]))
  if n == 1:
    return [first]
  toks, _ = tdec.fused_decode(tp, tc, ts, torch.tensor([[first]], dtype=torch.int32), cache, torch.tensor([S], dtype=torch.int32), n - 1)
  return [first] + toks[0].tolist()


# ---------------------------------------------------------- decoder programs


@pytest.mark.parametrize("quant", QUANTS)
def test_paged_prefill_and_decode_programs_match_jax(model, quant):
  """Two rows prefill into shuffled pages (one resuming after an 8-token
  cached prefix, plus a padding row on the trash page), then decode a
  chunk with one inactive row: logits and greedy tokens equal JAX's."""
  jc, tc, js, ts, jp, tp = model
  rng = np.random.default_rng(7)
  jpool = jpaged.init_paged_pool(jc, 2, 13, PS, quant=quant)
  tpool = paged.init_paged_pool(tc, 2, 13, PS, quant=quant)
  prefix = rng.integers(0, 256, PS)
  # Row 0's first page already holds its prefix (written by a solo prefill).
  bt = np.array([[9, 3, 11, 6], [2, 12, 5, 0], [0, 0, 0, 0]], np.int32)
  seed_tok = np.zeros((3, 16), np.int32)
  seed_tok[0, :PS] = prefix
  lens0 = np.array([PS, 1, 1], np.int32)
  z = np.zeros(3, np.int32)
  _, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(seed_tok), jpool, jnp.asarray(bt), jnp.asarray(z), jnp.asarray(lens0), PS)
  tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(seed_tok), tpool, torch.from_numpy(bt), torch.from_numpy(z), torch.from_numpy(lens0), PS)
  suffix = rng.integers(0, 256, (3, 16)).astype(np.int32)
  prefix_lens = np.array([PS, 0, 0], np.int32)
  prompt_lens = np.array([PS + 11, 14, 1], np.int32)
  suffix[0, 11:] = 0
  suffix[1, 14:] = 0
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(suffix), jpool, jnp.asarray(bt), jnp.asarray(prefix_lens), jnp.asarray(prompt_lens), PS)
  tl, tpool = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(suffix), tpool, torch.from_numpy(bt), torch.from_numpy(prefix_lens), torch.from_numpy(prompt_lens), PS)
  np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
  first = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
  args = (first, bt, prompt_lens, np.array([True, True, False]), np.zeros(3, np.float32))
  jt, jnext, jpos, _ = jdec.fused_paged_batch_decode(jp, jc, js, jnp.asarray(args[0]), jpool, jnp.asarray(bt), jnp.asarray(args[2]), jnp.asarray(args[3]), jnp.asarray(args[4]), 6, page_size=PS)
  tt, tnext, tpos, _ = tdec.fused_paged_batch_decode(tp, tc, ts, *(torch.from_numpy(a) for a in args[:1]), tpool, *(torch.from_numpy(a) for a in args[1:]), 6, page_size=PS)
  np.testing.assert_array_equal(tt[:2].numpy(), np.asarray(jt)[:2])
  np.testing.assert_array_equal(tnext[:2].numpy(), np.asarray(jnext)[:2])
  np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))  # the inactive row does not advance


def test_int4_kv_solo_decode_matches_jax(model):
  """The int4 KV mode on the solo decoder: prefill logits and greedy decode."""
  jc, tc, js, ts, jp, tp = model
  toks = np.random.default_rng(9).integers(0, 256, (1, 7)).astype(np.int32)
  pos = np.arange(7, dtype=np.int32)[None]
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(pos), jdec.init_kv_cache(jc, 2, 1, 48, quant="int4"))
  tcache = tdec.init_kv_cache(tc, 2, 1, 48, quant="int4")
  assert tcache["k"].shape[-1] * 2 == tc.head_dim and tdec.pool_kv_quant(tcache, tc) == "int4"
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(pos), tcache)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([7], jnp.int32), 10)
  tt, _ = tdec.fused_decode(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([7], dtype=torch.int32), 10)
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ------------------------------------------------------------------ server


def _requests(model):
  """Eight requests for two slots: a shared 16-token prefix (two full
  pages), a 40-token prompt that prefills in 16-token chunks, an EOS hit,
  and max_tokens 1."""
  rng = np.random.default_rng(11)
  prefix = rng.integers(0, 256, 2 * PS).tolist()
  prompts = [prefix + rng.integers(0, 256, int(n)).tolist() for n in (3, 9, 1, 5)] + [rng.integers(0, 256, 40).tolist(), [5, 6, 7], prefix + [1], rng.integers(0, 256, 12).tolist()]
  max_tokens = [7, 9, 5, 7, 6, 1, 7, 8]
  eos = [(), (), (), (_port_solo(model, prompts[3], 4)[2],), (), (), (), ()]
  return prompts, max_tokens, eos


async def _serve(server, prompts, max_tokens, eos):
  streams: dict = {}

  def emit(rid, toks, fin):
    streams.setdefault(rid, []).extend(toks)

  outs = await asyncio.gather(*(
    server.submit(f"r{i}", np.asarray(p, np.int32), max_tokens=m, temp=0.0, top_k=35, eos_ids=e, emit=emit)
    for i, (p, m, e) in enumerate(zip(prompts, max_tokens, eos))
  ))
  assert [streams[f"r{i}"] for i in range(len(prompts))] == outs  # the stream carries exactly the result
  return outs


def _port_server(model, **kw):
  _, tc, _, ts, _, tp = model
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(ts, tc, tp)
  return BatchedServer(engine, n_slots=2, chunk=3, **kw)


@pytest.mark.parametrize("quant", QUANTS)
def test_batched_server_matches_jax_server_and_solo(model, knobs, quant):
  from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer

  knobs.setenv("XOT_TPU_KV_QUANT", quant)
  jc, tc, js, ts, jp, tp = model
  prompts, max_tokens, eos = _requests(model)
  jengine = JaxShardedInferenceEngine(use_local_mesh=False)
  jengine.load_test_model(js, jc, jp)
  want = asyncio.run(_serve(JaxBatchedServer(jengine, n_slots=2, chunk=3), prompts, max_tokens, eos))
  server = _port_server(model)
  got = asyncio.run(_serve(server, prompts, max_tokens, eos))
  assert got == want
  assert server.prefix_hit_pages > 0  # the shared prefix came from the prefix cache
  assert server.allocator.audit()["referenced"] == 0 and not server.busy()
  assert got[3][-1] in eos[3] and len(got[3]) == 3 and len(got[5]) == 1
  solo = [_port_solo(model, p, m, quant)[: len(g)] for p, m, g in zip(prompts, max_tokens, got)]
  assert got == solo  # batched == solo, token for token


@pytest.mark.parametrize("quant", ["", "int4"])
def test_batched_server_sync_tick_matches_lookahead(model, knobs, quant):
  knobs.setenv("XOT_TPU_KV_QUANT", quant)
  prompts, max_tokens, eos = _requests(model)
  a = asyncio.run(_serve(_port_server(model, lookahead=True), prompts, max_tokens, eos))
  b = asyncio.run(_serve(_port_server(model, lookahead=False), prompts, max_tokens, eos))
  assert a == b


def test_batched_server_sampled_rows_are_seeded_and_in_range(model, knobs):
  prompts, max_tokens, eos = _requests(model)

  async def run(server):
    return await asyncio.gather(*(server.submit(f"s{i}", np.asarray(p, np.int32), max_tokens=6, temp=0.9, top_k=5, eos_ids=(), emit=lambda *a: None) for i, p in enumerate(prompts[:4])))

  a, b = asyncio.run(run(_port_server(model))), asyncio.run(run(_port_server(model)))
  assert a == b and all(len(x) == 6 and all(0 <= t < 256 for t in x) for x in a)


def test_batched_server_cancel_frees_the_row(model, knobs):
  server = _port_server(model)
  prompt = [3, 25, 9]

  async def run():
    started = asyncio.Event()

    def emit(rid, toks, fin):
      if toks:
        started.set()

    long_task = asyncio.create_task(server.submit("long", np.asarray(prompt, np.int32), max_tokens=100, temp=0.0, top_k=35, eos_ids=(), emit=emit))
    await asyncio.wait_for(started.wait(), timeout=30)
    server.cancel("long")
    out_long = await asyncio.wait_for(long_task, timeout=30)
    out_next = await asyncio.wait_for(server.submit("next", np.asarray(prompt, np.int32), max_tokens=5, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None), timeout=30)
    return out_long, out_next

  out_long, out_next = asyncio.run(run())
  assert len(out_long) < 100
  assert out_next == _port_solo(model, prompt, 5)
  assert server.allocator.audit()["referenced"] == 0


def test_batched_server_backpressure_and_oversized_prompts(model, knobs):
  async def run():
    server = _port_server(model, max_queue=0)
    with pytest.raises(ServerOverloadedError, match="queue full"):
      await server.submit("x", np.arange(4, dtype=np.int32), max_tokens=3, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None)
    knobs.setenv("XOT_TPU_BATCH_PAGES", "3")  # two usable pages: 16 tokens
    small = _port_server(model)
    with pytest.raises(ServerOverloadedError, match="cannot fit"):
      await small.submit("y", np.arange(40, dtype=np.int32), max_tokens=3, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None)

  asyncio.run(run())


@pytest.mark.parametrize("knob,value", [("XOT_TPU_PAGED", "0"), ("XOT_TPU_PAGED", "auto")])
def test_unported_batched_features_refuse_at_build(model, knobs, knob, value):
  """``XOT_TPU_PAGED=0|auto`` no longer refuses: the server builds the
  layout the reference's does (dense; under ``auto`` the decode-path
  table's verdict, paged on the CPU) and answers the requests with the JAX
  server's tokens (tests/test_torch_dense_batched.py holds the dense
  layout in full)."""
  from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer

  knobs.setenv(knob, value)
  jc, _, js, _, jp, _ = model
  prompts, max_tokens, eos = _requests(model)
  jengine = JaxShardedInferenceEngine(use_local_mesh=False)
  jengine.load_test_model(js, jc, jp)
  jserver = JaxBatchedServer(jengine, n_slots=2, chunk=3)
  want = asyncio.run(_serve(jserver, prompts, max_tokens, eos))
  server = _port_server(model)
  assert asyncio.run(_serve(server, prompts, max_tokens, eos)) == want
  assert server.paged == jserver.paged == (value == "auto") and server.decode_path == jserver.decode_path


@pytest.mark.parametrize("value", ["1", "on"])
def test_spec_batch_knob_builds_a_speculating_server(model, knobs, value):
  """``XOT_TPU_SPEC_BATCH`` no longer refuses: set on (with the n-gram
  family on, its default), the server speculates draft-free with the n-gram
  proposer (tests/test_torch_spec_batch.py holds it against the
  reference)."""
  knobs.setenv("XOT_TPU_SPEC_BATCH", value)
  knobs.delenv("XOT_TPU_SPEC_NGRAM", raising=False)
  server = _port_server(model)
  server._ensure_cache()
  assert server.spec and server.spec_proposers == ("ngram",)


@pytest.mark.parametrize("value", ["1", "true"])
def test_kv_tier_knob_builds_a_tiered_server(model, knobs, value):
  """``XOT_TPU_KV_TIER`` no longer refuses: set on, the server builds its
  host KV tier with the pool (tests/test_torch_kv_tier.py holds the tier
  against the reference)."""
  knobs.setenv("XOT_TPU_KV_TIER", value)
  server = _port_server(model)
  asyncio.run(server.submit("t", np.arange(3, 12, dtype=np.int32), max_tokens=2, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None))
  assert server.tier is not None and server.allocator.spill_hook == server.tier.spill


# ------------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_batched"))


def test_batched_server_int4_weights_match_solo(tiny_dir, knobs):
  """``XOT_TPU_QUANT=int4``: the engine quantizes the checkpoint at load,
  and its batched server serves those weights with the solo engine's greedy
  tokens (page pool, prefix sharing and chunked prefill included)."""
  from test_torch_engine import DirDownloader

  knobs.setenv("XOT_TPU_QUANT", "int4")
  engine = TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu")
  shard = Shard("llama-3.2-1b", 0, 15, 16)
  rng = np.random.default_rng(12)
  prefix = rng.integers(3, 512, 2 * PS).tolist()
  prompts = [prefix + rng.integers(3, 512, int(n)).tolist() for n in (3, 9, 30)] + [rng.integers(3, 512, 5).tolist()]
  max_tokens = [7, 5, 6, 8]

  async def run():
    await engine.ensure_shard(shard)
    got = await _serve(BatchedServer(engine, n_slots=2, chunk=3), prompts, max_tokens, [()] * len(prompts))
    solo = []
    for i, (p, m) in enumerate(zip(prompts, max_tokens)):
      logits, _ = await engine.infer_tensor(f"solo{i}", shard, np.asarray([p], np.int32))
      first = int(np.argmax(logits[0]))
      solo.append([first] + await engine.generate_oneshot(f"solo{i}", shard, first, m - 1, temp=0.0))
      engine.end_request(f"solo{i}")
    return got, solo

  got, solo = asyncio.run(run())
  assert engine.params["layers"]["w_up"].shape[-2] * 2 == engine.cfg.dim and "lm_head_scale" in engine.params
  assert got == solo


def _post(port, body):
  req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=120) as resp:
      return resp.status, resp.read().decode()
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode()


def test_daemon_batched_serves_concurrent_requests(tiny_dir, monkeypatch):
  """Two concurrent chat requests through main → node → API with
  XOT_TPU_BATCHED=1 come back with the port's solo greedy tokens; a full
  queue answers 429."""
  for k, v in {**REFERENCE_KNOBS, "XOT_TPU_MODEL_DIR": str(tiny_dir), "XOT_TPU_PLATFORM": "cpu", "XOT_TPU_BATCHED": "1"}.items():
    monkeypatch.setenv(k, v)
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--temp", "0.0", "--max-generate-tokens", "10", "--node-id", "test"])
  messages = [[{"role": "user", "content": "hello world how are you"}], [{"role": "user", "content": "the quick brown fox"}]]

  async def run():
    node, api, engine, _ = tmain.build_components(args)
    ids: dict = {}
    node.on_token.register("test").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    server = await api.run(host="127.0.0.1", port=port)
    try:
      replies = await asyncio.gather(
        asyncio.to_thread(_post, port, {"model": "llama-3.2-1b", "messages": messages[0], "temperature": 0, "stream": True}),
        asyncio.to_thread(_post, port, {"model": "llama-3.2-1b", "messages": messages[1], "temperature": 0}),
      )
      engine.get_batched_server().admission.max_queue = 0
      overloaded = await asyncio.to_thread(_post, port, {"model": "llama-3.2-1b", "messages": messages[0]})
      solo = []
      for i, msg in enumerate(messages):
        prompt = engine.tokenizer.apply_chat_template(msg, tokenize=False, add_generation_prompt=True)
        logits, _ = await engine.infer_prompt(f"solo{i}", Shard("llama-3.2-1b", 0, 15, 16), prompt)
        first = int(np.argmax(logits[0]))
        eos = tuple({engine.tokenizer.eos_token_id, *engine.cfg.eos_token_ids})
        rest = [] if first in eos else await engine.generate_oneshot(f"solo{i}", Shard("llama-3.2-1b", 0, 15, 16), first, 9, eos_ids=eos, temp=0.0)
        engine.end_request(f"solo{i}")
        solo.append([first] + rest)
    finally:
      server.close()
      await server.wait_closed()
    return replies, overloaded, ids, solo, engine

  replies, overloaded, ids, solo, engine = asyncio.run(run())
  assert [status for status, _ in replies] == [200, 200]
  assert "[DONE]" in replies[0][1] and json.loads(replies[1][1])["choices"][0]["finish_reason"] in ("stop", "length")
  assert overloaded[0] == 429 and json.loads(overloaded[1])["error"]["type"] == "overloaded"
  assert sorted(ids.values()) == sorted(solo)
  assert not engine.get_batched_server().busy()
