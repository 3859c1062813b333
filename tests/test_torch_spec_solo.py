"""Solo speculative decoding in the port against the JAX package, on the
CPU at f32, on identical weights (JAX ``full_model_params`` → numpy →
``params_from_jax``; the cross-model draft is a tiny HF checkpoint both
packages load from disk). Tokens are held identical; logits within
rtol = atol = 2e-4.

- decoder: ``fused_speculative_generate`` at gamma 1, 2 and 4 with each
  package's int8 self-draft (``quantize_params``) and with an unrelated
  draft of another depth and width (``buf[:n]``, ``n``, ``rounds``); an EOS
  inside a round; runs that start two slots from the cache end (JAX clamps
  nothing there, torch must not raise); three chained
  ``fused_speculative_chunk`` calls (packed, seed, position); the draft-free
  dense ``fused_spec_batch_decode`` with and without proposals;
- engine, driven by the node's dispatch-ahead chunk loop, for
  ``XOT_TPU_SPEC_DECODE=ngram``, ``int8`` and ``XOT_TPU_SPEC_DRAFT=<dir>``:
  the tokens, the kind of every dispatch (spec / ngram / plain / none),
  each read's ``m``, rounds and proposed count, and the EWMA and depth after
  each read — for an accepting stream, the walk to depth 0 under an
  adversarial draft and on text that never repeats, the depth-1 reprobe
  after ``XOT_TPU_SPEC_REPROBE`` plain dispatches, and blocking
  (``generate_oneshot``) requests;
- the draft loader's verdicts (missing checkpoint, vocab mismatch, differing
  tokenizer files, a quantized target with no draft) equal the JAX
  engine's; the batched server offers a loaded draft as its "model"
  proposer, as the reference's does, and serves ``ngram`` alone without
  one;
- the port's daemon (main → node → API) with each proposer: streaming and
  blocking greedy ids equal to the JAX engine's under the node's loop.
"""

import asyncio
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import DirDownloader, make_tiny_llama
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquant
from xotorch_support_jetson_tpu.utils.synthetic import peaked_echo_params
from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquant
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics as tmetrics

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_SEQ = 128
SPEC_KNOBS = ("XOT_TPU_SPEC_DECODE", "XOT_TPU_SPEC_DRAFT", "XOT_TPU_SPEC_GAMMA", "XOT_TPU_SPEC_REPROBE", "XOT_TPU_SPEC_NGRAM_N", "XOT_TPU_SPEC_NGRAM_MAX", "XOT_TPU_SPEC_AUTOCAL", "XOT_TPU_QUANT", "XOT_TPU_KV_QUANT")
PROMPT = np.array([[5, 9, 2, 71, 33]], dtype=np.int32)
REPETITIVE = np.array([[5, 9, 2, 71, 33, 5, 9, 2, 71, 33, 5, 9, 2]], dtype=np.int32)
FLAT = np.array([[7, 12, 29, 41, 3, 88, 101, 55]], dtype=np.int32)


def _pair(cfg_kw: dict, seed: int, model_id: str = "m", echo: bool = False):
  """(jax cfg, torch cfg, jax shard, torch shard, jax params, torch params)
  for one full model on identical weights."""
  jc, tc = jconfig.tiny_test_config(**cfg_kw), tconfig.tiny_test_config(**cfg_kw)
  jp, js = jdec.full_model_params(jax.random.PRNGKey(seed), jc, model_id)
  if echo:
    jp = peaked_echo_params(jp)
  ts = Shard(model_id, 0, jc.n_layers - 1, jc.n_layers)
  return jc, tc, js, ts, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, ts)


TARGET = dict(n_layers=2, max_seq_len=MAX_SEQ)
DRAFT = dict(n_layers=1, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=1, max_seq_len=MAX_SEQ)


@pytest.fixture(scope="module")
def models():
  target = _pair(TARGET, 11)
  jc, tc, js, ts, jp, tp = target
  self_draft = (jc, tc, js, ts, jquant(jp), tquant(tp, "int8"))
  other = _pair(DRAFT, 42, "d")
  return {"target": target, "int8": self_draft, "other": other}


@pytest.fixture
def spec_env(monkeypatch):
  for knob in SPEC_KNOBS:
    monkeypatch.delenv(knob, raising=False)
  monkeypatch.setenv("XOT_TPU_SPEC_NGRAM", "1")
  return monkeypatch


# ------------------------------------------------------------------ decoder


def _prefilled(pkg, cfg, shard, params, prompt, max_seq=MAX_SEQ):
  """A cache of ``max_seq`` slots holding the prompt; returns (cache,
  logits of the last prompt token)."""
  B, S = prompt.shape
  if pkg == "jax":
    cache = jdec.init_kv_cache(cfg, shard.n_shard_layers, B, max_seq)
    logits, cache = jdec.shard_forward(params, cfg, shard, jnp.asarray(prompt), jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S)), cache)
    return cache, np.asarray(logits)[:, -1]
  cache = tdec.init_kv_cache(cfg, shard.n_shard_layers, B, max_seq)
  logits, cache = tdec.shard_forward(params, cfg, shard, torch.from_numpy(prompt), torch.arange(S, dtype=torch.int32).expand(B, S), cache)
  return cache, logits[:, -1].numpy()


def _spec_generate(models, draft: str, prompt, max_steps, gamma, eos_ids=(), max_seq=MAX_SEQ):
  """Both packages' ``fused_speculative_generate`` from the same prefilled
  state: (jax (tokens, n, rounds), torch (tokens, n, rounds), first-token
  logits of each)."""
  jc, tc, js, ts, jp, tp = models["target"]
  jcd, tcd, jsd, tsd, jpd, tpd = models[draft]
  out = {}
  for pkg in ("jax", "torch"):
    cfg, shard, params = (jc, js, jp) if pkg == "jax" else (tc, ts, tp)
    cfg_d, shard_d, params_d = (jcd, jsd, jpd) if pkg == "jax" else (tcd, tsd, tpd)
    cache_t, logits = _prefilled(pkg, cfg, shard, params, prompt, max_seq)
    cache_d, _ = _prefilled(pkg, cfg_d, shard_d, params_d, prompt, max_seq)
    first = int(np.argmax(logits[0]))
    S = prompt.shape[1]
    if pkg == "jax":
      buf, n, rounds, _, _ = jdec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, jnp.full((1, 1), first, jnp.int32), cache_t, cache_d, jnp.int32(S), max_steps, gamma=gamma, eos_ids=eos_ids)
      buf, n, rounds = np.asarray(buf), int(n), int(rounds)
    else:
      buf, n, rounds, _, _ = tdec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, torch.full((1, 1), first, dtype=torch.int32), cache_t, cache_d, S, max_steps, gamma=gamma, eos_ids=eos_ids)
      buf = buf.numpy()
    out[pkg] = (buf[:n].tolist(), n, rounds, logits)
  return out["jax"], out["torch"]


@pytest.mark.parametrize("draft", ["int8", "other"])
@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_speculative_generate_matches_reference(models, draft, gamma):
  j, t = _spec_generate(models, draft, PROMPT, 40, gamma)
  np.testing.assert_allclose(t[3], j[3], **TOL)
  assert t[:3] == j[:3]
  assert 40 <= t[1] <= 40 + gamma and 1 <= t[2] <= t[1]


def test_speculative_generate_eos_trim_matches_reference(models):
  """An EOS inside a round stops the loop at the reference's n and round;
  the rounds the host runs past it change nothing."""
  j, _ = _spec_generate(models, "other", PROMPT, 24, 3)
  eos = j[0][len(j[0]) // 2]
  j, t = _spec_generate(models, "other", PROMPT, 24, 3, eos_ids=(eos,))
  assert t[:3] == j[:3] and eos in t[0] and t[1] < 24


@pytest.mark.parametrize("gamma", [1, 4])
def test_speculative_generate_near_the_cache_end(models, gamma):
  """Two slots from the end of a 64-slot cache: depth 1 runs rounds while
  pos + 2 <= 64, depth 4 none; torch writes no slot past the cache."""
  prompt = np.asarray([(np.arange(62) * 7 + 3) % 256], dtype=np.int32)
  j, t = _spec_generate(models, "int8", prompt, 16, gamma, max_seq=64)
  assert t[:3] == j[:3]
  assert (t[1] > 0) == (gamma == 1)


def test_speculative_chunks_chain_like_the_reference(models):
  """Three chained streaming chunks (device seed and position): packed
  [m, rounds, tokens...], seed and position equal the reference's."""
  jc, tc, js, ts, jp, tp = models["target"]
  _, _, jsd, tsd, jpd, tpd = models["other"]
  jcd, tcd = models["other"][0], models["other"][1]
  S = PROMPT.shape[1]
  jct, jl = _prefilled("jax", jc, js, jp, PROMPT)
  jcdc, _ = _prefilled("jax", jcd, jsd, jpd, PROMPT)
  tct, tl = _prefilled("torch", tc, ts, tp, PROMPT)
  tcdc, _ = _prefilled("torch", tcd, tsd, tpd, PROMPT)
  first = int(np.argmax(jl[0]))
  assert first == int(np.argmax(tl[0]))
  jtok, jpos = jnp.full((1, 1), first, jnp.int32), jnp.int32(S)
  ttok, tpos = torch.full((1, 1), first, dtype=torch.int32), S
  for steps, limit in ((8, 6), (8, 8), (4, 3)):
    jpk, jtok, jpos, jct, jcdc = jdec.fused_speculative_chunk(jp, jc, js, jpd, jtok, jct, jcdc, jpos, steps, gamma=3, n_limit=limit, cfg_d=jcd, shard_d=jsd)
    tpk, ttok, tpos, tct, tcdc = tdec.fused_speculative_chunk(tp, tc, ts, tpd, ttok, tct, tcdc, tpos, steps, gamma=3, n_limit=limit, cfg_d=tcd, shard_d=tsd)
    jrow, trow = np.asarray(jpk), tpk.numpy()
    m = int(jrow[0])
    assert trow.shape == jrow.shape and trow[:2].tolist() == jrow[:2].tolist() and trow[2 : 2 + m].tolist() == jrow[2 : 2 + m].tolist()
    assert int(ttok[0, 0]) == int(jtok[0, 0]) and int(tpos) == int(jpos)


@pytest.mark.parametrize("with_props", [False, True])
def test_dense_spec_batch_decode_matches_reference(models, with_props):
  """The draft-free dense chunk at B=1 (the solo n-gram program): buffer,
  counts, proposed counts, next token and position; a draft given without
  its slot cache refuses."""
  jc, tc, js, ts, jp, tp = models["target"]
  ref = _spec_generate(models, "int8", PROMPT, 24, 2)[0]
  first, greedy = int(np.argmax(ref[3][0])), ref[0]
  S = PROMPT.shape[1]
  stream = np.asarray([greedy[:12] + [7, 7, 7]], dtype=np.int32)  # 12 right tokens, then a miss
  out = {}
  for pkg in ("jax", "torch"):
    cfg, shard, params = (jc, js, jp) if pkg == "jax" else (tc, ts, tp)
    cache, _ = _prefilled(pkg, cfg, shard, params, PROMPT)
    args = dict(n_rounds=4, gamma_max=4, top_k=1, k_max=1)
    if pkg == "jax":
      props = dict(props=jnp.asarray(stream), prop_counts=jnp.asarray([stream.shape[1]], jnp.int32)) if with_props else {}
      res = jdec.fused_spec_batch_decode(params, cfg, shard, None, cfg, shard, jnp.full((1, 1), first, jnp.int32), cache, None, jnp.full((1,), S, jnp.int32), jnp.ones((1,), bool), jnp.full((1,), 4, jnp.int32), jnp.zeros((1,), jnp.float32), **args, **props)
      res = [np.asarray(x) for x in res[:5]]
    else:
      props = dict(props=torch.from_numpy(stream), prop_counts=torch.tensor([stream.shape[1]], dtype=torch.int32)) if with_props else {}
      res = tdec.fused_spec_batch_decode(params, cfg, shard, None, cfg, shard, torch.full((1, 1), first, dtype=torch.int32), cache, None, torch.full((1,), S, dtype=torch.int32), torch.ones((1,), dtype=torch.bool), torch.full((1,), 4, dtype=torch.int32), torch.zeros((1,)), **args, **props)
      res = [x.numpy() for x in res[:5]]
    out[pkg] = res
  (jb, jcnt, jnp_, jtok, jpos), (tb, tcnt, tnp, ttok, tpos) = out["jax"], out["torch"]
  c = int(jcnt[0])
  assert tcnt.tolist() == jcnt.tolist() and tnp.tolist() == jnp_.tolist() and ttok.tolist() == jtok.tolist() and tpos.tolist() == jpos.tolist()
  assert tb[0, :c].tolist() == jb[0, :c].tolist() == greedy[:c]
  assert (c > 4) == with_props  # proposals accepted; without them each round emits one token
  with pytest.raises(ValueError, match="slot cache"):  # a draft proposes from its own cache (tests/test_torch_draft_batched.py)
    tdec.fused_spec_batch_decode(tp, tc, ts, tp, tc, ts, torch.zeros((1, 1), dtype=torch.int32), None, None, torch.zeros((1,), dtype=torch.int32), torch.ones((1,), dtype=torch.bool), torch.ones((1,), dtype=torch.int32), torch.zeros((1,)), 1, 1)


# ------------------------------------------------------------------ engine


def _engines(pair, spec_decode, draft=None):
  """A JAX and a port engine on the same model with ``spec_decode``; with
  ``draft`` ((jax params, torch params) of a same-config draft) swapped in
  for the self-draft on both."""
  jc, tc, js, ts, jp, tp = pair
  je = JaxShardedInferenceEngine(use_local_mesh=False, max_seq_len=MAX_SEQ, spec_decode=spec_decode)
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(max_seq_len=MAX_SEQ, device="cpu", spec_decode=spec_decode)
  te.load_test_model(ts, tc, tp)
  if draft is not None:
    je._draft_params, te._draft_params = draft
  return (je, js), (te, ts)


def _kind(handle) -> str:
  if handle is None:
    return "none"
  return handle[0] if isinstance(handle, tuple) else "plain"


def _state(engine, rid) -> tuple:
  s = engine.sessions.get(rid)
  ewma = None if engine._spec_ewma is None else round(float(engine._spec_ewma), 9)
  ngram = None if s is None else (None if s.ngram_ewma is None else round(float(s.ngram_ewma), 9), s.ngram_gamma)
  return ewma, engine._spec_gamma_live, engine._spec_plain_streak, ngram


async def _drive_stream(engine, shard, prompt, rid, chunk, max_tokens):
  """The node's streaming loop (orchestration/node.py ``_fast_decode_loop``):
  dispatch chunk N+1 before reading chunk N, re-dispatch when nothing is in
  flight. Returns (tokens, records): one record per dispatch (its kind) and
  per read (m, rounds or proposed count, then the policy state)."""
  logits, _ = await engine.infer_tensor(rid, shard, prompt)
  first = int(np.argmax(np.asarray(logits), -1)[0])
  tokens, records = [first], []

  async def dispatch(n, **kw):
    h = await engine.dispatch_chunk(rid, shard, n, 0.0, 35, **kw)
    records.append(("dispatch", _kind(h), h[3] if _kind(h) == "spec" else None))
    return h

  pending = await dispatch(chunk, first_token=first)
  while pending is not None:
    remaining = max_tokens - len(tokens)
    nxt = await dispatch(min(chunk, remaining - chunk)) if remaining > chunk else None
    if isinstance(pending, tuple):
      row = np.asarray(pending[-1]) if not isinstance(pending[-1], torch.Tensor) else pending[-1].numpy()
      counts = (int(row[0]), int(row[1]))
    else:
      counts = None
    new = (await engine.read_chunk(pending))[:remaining]
    records.append(("read", counts, _state(engine, rid)))
    tokens.extend(new)
    if len(tokens) >= max_tokens:
      break
    pending = nxt
    if pending is None and max_tokens - len(tokens) > 0:
      pending = await dispatch(min(chunk, max_tokens - len(tokens)))
  engine.end_request(rid)
  return tokens, records


def _both(je, te, fn):
  async def run():
    return await fn(*je), await fn(*te)

  return asyncio.run(run())


def _assert_same(j, t):
  (jt, jr), (tt, tr) = j, t
  assert tt == jt
  assert tr == jr


@pytest.mark.parametrize("scenario", ["accepting", "nonrepetitive", "flat"])
def test_ngram_chain_matches_reference(spec_env, scenario):
  """``XOT_TPU_SPEC_DECODE=ngram``: an echo model on a periodic prompt
  accepts and holds its depth; a random model rejects and walks to depth 0
  and plain chunks; a prompt that never repeats misses until plain."""
  pair = _pair(dict(n_layers=2, max_seq_len=256, tied_embedding=True), 11, echo=scenario == "accepting")
  (je, js), (te, ts) = _engines(pair, "ngram")
  prompt = FLAT if scenario == "flat" else REPETITIVE
  before = tmetrics.counter_value("spec_accepted_tokens_total", labels={"proposer": "ngram"})
  j, t = _both((je, js), (te, ts), lambda e, s: _drive_stream(e, s, prompt, "r", 8, 60))
  _assert_same(j, t)
  kinds = [r[1] for r in t[1] if r[0] == "dispatch"]
  assert kinds[0] == "ngram" and "none" in kinds  # an unread n-gram chunk answers the dispatch-ahead with None
  accepted = tmetrics.counter_value("spec_accepted_tokens_total", labels={"proposer": "ngram"}) - before
  if scenario == "accepting":
    assert accepted > 0 and t[1][-1][2][3][1] > 0
  else:
    assert [k for k in kinds if k != "none"][-1] == "plain" and t[1][-1][2][3][1] == 0


def test_ngram_blocking_requests_stay_plain(spec_env):
  """Blocking requests speculate only with a draft loaded: the n-gram
  proposer leaves them to ``fused_generate`` in both packages."""
  pair = _pair(dict(n_layers=2, max_seq_len=MAX_SEQ, tied_embedding=True), 11, echo=True)
  (je, js), (te, ts) = _engines(pair, "ngram")

  async def oneshot(e, s):
    logits, _ = await e.infer_tensor("b", s, REPETITIVE)
    first = int(np.argmax(np.asarray(logits), -1)[0])
    return [first] + await e.generate_oneshot("b", s, first, 30, eos_ids=(), temp=0.0), e.sessions["b"].ngram_index

  (jt, ji), (tt, ti) = _both((je, js), (te, ts), oneshot)
  assert tt == jt and ji is None and ti is None


@pytest.mark.parametrize("draft", ["int8", "adversarial"])
def test_draft_chain_matches_reference(spec_env, models, draft):
  """``XOT_TPU_SPEC_DECODE=int8`` streaming to cache exhaustion (the hand-off
  near the cache end included) with mixed chunk sizes: tokens, kinds, m and
  rounds per read, the EWMA and depth after each read; an adversarial
  (unrelated) draft walks the depth to 0 and the stream onto plain chunks."""
  pair = models["target"]
  swap = None
  if draft == "adversarial":
    bad = _pair(TARGET, 777)
    swap = (bad[4], bad[5])
  (je, js), (te, ts) = _engines(pair, "int8", swap)
  assert je._draft_params is not None and te._draft_params is not None

  async def drive(e, s):
    return await _drive_stream(e, s, PROMPT, "c", 8, 200)

  j, t = _both((je, js), (te, ts), drive)
  _assert_same(j, t)
  kinds = [r[1] for r in t[1] if r[0] == "dispatch"]
  assert kinds[0] == "spec"
  if draft == "adversarial":
    assert te._spec_gamma_live == 0 and [k for k in kinds if k != "none"][-1] == "plain"
  else:
    assert te._spec_gamma_live > 0 and "plain" in kinds  # the hand-off near the cache end
  assert len(t[0]) == MAX_SEQ - PROMPT.shape[1] + 1  # every slot filled: the tokens fed at positions 5..127 and the last one


def test_draft_chain_mixed_chunk_sizes(spec_env, models):
  """Chunk sizes that change between dispatches (the node shrinks them near
  the token budget): each unread chunk is accounted at its own size."""
  (je, js), (te, ts) = _engines(models["target"], "int8")

  async def drive(e, s):
    logits, _ = await e.infer_tensor("m", s, PROMPT)
    first = int(np.argmax(np.asarray(logits), -1)[0])
    out, sizes, i = [first], [16, 16, 4, 4, 2, 8, 16, 2], 1
    pending = await e.dispatch_chunk("m", s, sizes[0], 0.0, 35, first_token=first)
    while pending is not None:
      nxt = await e.dispatch_chunk("m", s, sizes[i % len(sizes)], 0.0, 35)
      i += 1
      out.extend(await e.read_chunk(pending))
      pending = nxt
    return out, e.sessions["m"].curr_pos

  j, t = _both((je, js), (te, ts), drive)
  assert t == j


def test_draft_chain_reprobes_after_the_plain_streak(spec_env, models):
  """At depth 0 the engine probes at depth 1 after ``XOT_TPU_SPEC_REPROBE``
  plain dispatches; the self-draft then earns its depth back."""
  spec_env.setenv("XOT_TPU_SPEC_REPROBE", "3")
  (je, js), (te, ts) = _engines(models["target"], "int8")
  je._spec_gamma_live = te._spec_gamma_live = 0

  async def requests(e, s):
    out = []
    for i in range(5):
      toks, rec = await _drive_stream(e, s, PROMPT, f"r{i}", 4, 9)
      out.append((toks, rec))
    return out

  j, t = _both((je, js), (te, ts), requests)
  assert t == j
  firsts = [rec[0][1] for _, rec in t]
  assert firsts[:3] == ["plain"] * 3 and "spec" in firsts[3:]
  assert te._spec_gamma_live >= 1


def test_draft_blocking_requests_match_reference(spec_env, models):
  """Blocking greedy requests with a draft: ``fused_speculative_generate``
  in both, the plain greedy tokens, the EWMA after each; with an EOS id."""
  (je, js), (te, ts) = _engines(models["target"], "int8")

  async def oneshots(e, s):
    out = []
    for rid, eos in (("a", ()), ("b", (-1,)), ("c", None)):
      logits, _ = await e.infer_tensor(rid, s, PROMPT)
      first = int(np.argmax(np.asarray(logits), -1)[0])
      eos = eos if eos is not None else (out[0][0][12],)
      toks = await e.generate_oneshot(rid, s, first, 30, eos_ids=eos, temp=0.0)
      out.append(([first] + toks, _state(e, rid)))
      e.end_request(rid)
    return out

  j, t = _both((je, js), (te, ts), oneshots)
  assert t == j
  assert t[1][0] == t[0][0] and len(t[0][0]) == 31
  assert te._spec_ewma is not None and t[2][0][-1] == t[0][0][12] and len(t[2][0]) <= 13  # trimmed at the EOS id


def _write_draft_checkpoint(path, vocab, tokenizer_text="shared"):
  """A 1-layer llama (width 32) as HF safetensors, with a tokenizer.json."""
  from transformers import AutoConfig, AutoModelForCausalLM

  torch.manual_seed(5)
  cfg = AutoConfig.for_model(
    "llama", vocab_size=vocab, hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
    rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=MAX_SEQ, tie_word_embeddings=False, torch_dtype="float32",
  )
  AutoModelForCausalLM.from_config(cfg).to(torch.float32).eval().save_pretrained(path, safe_serialization=True)
  (path / "tokenizer.json").write_text(json.dumps({"vocab": tokenizer_text}))
  return path


def test_cross_model_draft_matches_reference(spec_env, models, tmp_path):
  """``XOT_TPU_SPEC_DRAFT=<dir>``: a smaller checkpoint drafts (int8), with
  its own config and cache geometry; streaming and blocking tokens, kinds,
  counts and the policy state equal the reference's."""
  draft_dir = _write_draft_checkpoint(tmp_path / "draft", vocab=256)
  spec_env.setenv("XOT_TPU_SPEC_DRAFT", str(draft_dir))
  (je, js), (te, ts) = _engines(models["target"], "int8")
  assert te._draft_params is not None and je._draft_params is not None
  assert te._draft_cfg.n_layers == 1 and te._draft_cfg.dim == 32 and te._draft_params["layers"]["wq"].dtype == torch.int8

  async def drive(e, s):
    stream = await _drive_stream(e, s, PROMPT, "x", 8, 40)
    logits, _ = await e.infer_tensor("y", s, PROMPT)
    first = int(np.argmax(np.asarray(logits), -1)[0])
    blocking = [first] + await e.generate_oneshot("y", s, first, 39, eos_ids=(), temp=0.0)
    e.end_request("y")
    return stream, blocking, _state(e, "y")

  j, t = _both((je, js), (te, ts), drive)
  assert t == j
  assert t[1] == t[0][0]  # blocking == streaming
  assert [r[1] for r in t[0][1] if r[0] == "dispatch"][0] == "spec"


@pytest.mark.parametrize("case", ["missing", "vocab", "tokenizer", "same_tokenizer", "quantized_target"])
def test_draft_loader_verdicts_match_reference(spec_env, models, tmp_path, case):
  jc, tc, js, ts, jp, tp = models["target"]
  target_dir = tmp_path / "target"
  target_dir.mkdir()
  (target_dir / "tokenizer.json").write_text(json.dumps({"vocab": "shared"}))
  quant = None
  if case == "missing":
    spec_env.setenv("XOT_TPU_SPEC_DRAFT", str(tmp_path / "no-such-checkpoint"))
  elif case == "quantized_target":
    quant = "int8"
  else:
    vocab = 128 if case == "vocab" else 256
    text = "other" if case == "tokenizer" else "shared"
    spec_env.setenv("XOT_TPU_SPEC_DRAFT", str(_write_draft_checkpoint(tmp_path / "draft", vocab, text)))
  je = JaxShardedInferenceEngine(use_local_mesh=False, max_seq_len=MAX_SEQ, spec_decode="int8", quant=quant)
  te = TorchShardedInferenceEngine(max_seq_len=MAX_SEQ, device="cpu", spec_decode="int8", quant=quant)
  je._model_dir = te._model_dir = target_dir  # the target checkpoint, as an earlier load leaves it
  je.load_test_model(js, jc, jp)
  te.load_test_model(ts, tc, tp)
  loaded = te._draft_params is not None
  assert loaded == (je._draft_params is not None)
  assert loaded == (case == "same_tokenizer")


def test_batched_server_refuses_a_loaded_draft(spec_env, models):
  """A loaded draft no longer refuses the batched server: like the
  reference's, it offers the "model" proposer beside the n-gram one and
  builds the draft's slot cache with the pool
  (tests/test_torch_draft_batched.py serves it against the reference).
  ``XOT_TPU_SPEC_DECODE=ngram`` (no draft) builds the n-gram proposer
  alone, as before."""
  (je, _), (te, _) = _engines(models["target"], "int8")
  jserver, server = JaxBatchedServer(je, n_slots=2, chunk=4), BatchedServer(te, n_slots=2, chunk=4)
  try:
    assert jserver.ops.spec_supported() and server.ops.spec_supported()
    jserver._ensure_cache()
    server._ensure_cache()
    assert server.spec_proposers == jserver.spec_proposers == ("model", "ngram")
    assert server.draft_cache is not None and tuple(server.draft_cache["k"].shape) == tuple(jserver.draft_cache["k"].shape)
  finally:
    jserver.shutdown()
    server.shutdown()
  _, (te, _) = _engines(models["target"], "ngram")
  assert te._draft_params is None
  server = BatchedServer(te, n_slots=2, chunk=4)
  server._ensure_cache()
  assert server.spec_proposers == ("ngram",) and server.draft_cache is None
  server.shutdown()


# ------------------------------------------------------------------ daemon


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_spec"))


def _post(port, body):
  req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as resp:
    return resp.read().decode()


MAX_TOKENS = 40
MESSAGES = [{"role": "user", "content": "hello world how are you today the quick brown fox hello world how are you"}]


@pytest.mark.parametrize("proposer", ["ngram", "int8", "cross"])
def test_daemon_serves_each_proposer_like_the_reference(spec_env, tiny_dir, tmp_path, proposer):
  """The port's daemon with ``XOT_TPU_DECODE_CHUNK=8``: streaming and
  blocking greedy ids equal each other and the JAX engine's under the
  node's loop, with the same chunk kinds; spec chunks were dispatched."""
  spec_env.setenv("XOT_TPU_MODEL_DIR", str(tiny_dir))
  spec_env.setenv("XOT_TPU_PLATFORM", "cpu")
  spec_env.setenv("XOT_TPU_DECODE_CHUNK", "8")
  spec_env.setenv("XOT_TPU_SPEC_DECODE", "ngram" if proposer == "ngram" else "int8")
  if proposer == "cross":
    spec_env.setenv("XOT_TPU_SPEC_DRAFT", str(_write_draft_checkpoint(tmp_path / "draft", vocab=512)))
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--temp", "0.0", "--max-generate-tokens", str(MAX_TOKENS), "--node-id", "test"])

  async def serve():
    node, api, engine, _ = tmain.build_components(args)
    ids: dict[str, list[int]] = {}
    node.on_token.register("test").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    kinds = []
    dispatch = engine._dispatch_chunk_sync

    def spy(*a, **kw):
      h = dispatch(*a, **kw)
      kinds.append(_kind(h))
      return h

    engine._dispatch_chunk_sync = spy
    server = await api.run(host="127.0.0.1", port=port)
    try:
      body = {"model": "llama-3.2-1b", "messages": MESSAGES, "temperature": 0, "max_tokens": MAX_TOKENS}
      await asyncio.to_thread(_post, port, {**body, "stream": True})
      await asyncio.to_thread(_post, port, {**body, "stream": False})
    finally:
      server.close()
      await server.wait_closed()
    prompt = engine.tokenizer.apply_chat_template(MESSAGES, tokenize=False, add_generation_prompt=True)
    return list(ids.values()), kinds, engine, np.asarray([engine.tokenizer.encode(prompt)], dtype=np.int32)

  streams, kinds, engine, prompt = asyncio.run(serve())
  assert len(streams) == 2 and streams[0] == streams[1]
  assert engine.sessions == {}
  assert (engine._draft_params is not None) == (proposer != "ngram")
  if proposer == "cross":
    assert engine._draft_cfg.n_layers == 1

  async def reference():
    je = JaxShardedInferenceEngine(DirDownloader(tiny_dir), use_local_mesh=False)
    shard = JShard("llama-3.2-1b", 0, 15, 16)
    await je.ensure_shard(shard)
    return await _drive_stream(je, shard, prompt, "j", 8, MAX_TOKENS)

  jtoks, jrec = asyncio.run(reference())
  eos = {engine.tokenizer.eos_token_id, *engine.cfg.eos_token_ids}
  cut = next((i + 1 for i, tk in enumerate(jtoks) if tk in eos), len(jtoks))
  assert streams[0] == jtoks[:cut]
  assert kinds[0] == ("ngram" if proposer == "ngram" else "spec")
  assert kinds == [r[1] for r in jrec if r[0] == "dispatch"][: len(kinds)]
