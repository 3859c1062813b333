"""The batched server's dense slot layout (``XOT_TPU_PAGED=0|auto``)
against the JAX package's, on the CPU: the slot programs
(``prefill_into_slots[_sampled]``, ``fused_batch_decode``) on tiny llama,
gemma2, qwen3-moe and deepseek-v2-lite (MLA) models with bf16-layout and
int8 KV (logits within rtol = atol = 2e-4, greedy tokens identical), the
reference's "not donated" rule, the dense server (tokens and dispatches by
program name against the JAX server, plain and with n-gram speculation,
spare pad rows, the auto layout, the warmup manifest) and the dense MLA
server's speculation gate. Sizes are small: 2-3 layers, width 64."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gemma2 import make_tiny_gemma2
from test_torch_mla import make_tiny_mla
from test_torch_moe import make_tiny_moe
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec, loader as jloader
from xotorch_support_jetson_tpu.utils.programs import ledger as jledger
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec, loader as tloader
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics
from xotorch_support_jetson_tpu_torch.utils.programs import ledger

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ["llama", "gemma2", "qwen3-moe", "deepseek-v2-lite"]
# Every batched feature at a fixed setting on both sides: no QoS, no tier,
# no mixed tick (the dense layout has none), n-gram proposals off unless a
# test turns them on.
KNOBS = {"XOT_TPU_QOS": "0", "XOT_TPU_KV_TIER": "0", "XOT_TPU_MIXED_TICK": "0", "XOT_TPU_SPEC_BATCH": "0", "XOT_TPU_PAGED": "0", "XOT_TPU_SLO": "0"}
UNSET = ("XOT_TPU_KV_QUANT", "XOT_TPU_PAGED_KERNEL", "XOT_TPU_QUANT", "XOT_TPU_SPEC_DECODE", "XOT_TPU_SPEC_DRAFT", "XOT_TPU_MOE_GATHER")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
  """family → (jc, tc, js, ts, jp, tp), both packages' configs and params
  on the same weights."""
  out = {}
  jc = jconfig.tiny_test_config(n_layers=2, max_seq_len=64)
  tc = tconfig.tiny_test_config(n_layers=2, max_seq_len=64)
  js, ts = JShard("tiny", 0, 1, 2), Shard("tiny", 0, 1, 2)
  jp = jdec.init_shard_params(jax.random.PRNGKey(4), jc, js)
  out["llama"] = (jc, tc, js, ts, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, ts))
  for family, make in (("gemma2", make_tiny_gemma2), ("qwen3-moe", lambda p: make_tiny_moe(p, "qwen3-moe")), ("deepseek-v2-lite", lambda p: make_tiny_mla(p, "deepseek-v2-lite"))):
    path = tmp_path_factory.mktemp(f"dense_{family}")
    make(path)
    jc, tc = jconfig.load_model_config(path, dtype=jnp.float32), tconfig.load_model_config(path, dtype=torch.float32)
    n = tc.n_layers
    js, ts = JShard("tiny", 0, n - 1, n), Shard("tiny", 0, n - 1, n)
    out[family] = (jc, tc, js, ts, jloader.load_shard_weights(path, jc, js), tloader.load_shard_weights(path, tc, ts))
  return out


@pytest.fixture
def knobs(monkeypatch):
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  for k, v in KNOBS.items():
    monkeypatch.setenv(k, v)
  return monkeypatch


def _caches(model, quant, B, S, rng):
  """Both packages' slot caches, every leaf filled with the same random
  contents (what earlier occupants left behind)."""
  jc, tc = model[0], model[1]
  n = tc.n_layers
  jcache = jdec.init_kv_cache(jc, n, B, S, quant=quant)
  tcache = tdec.init_kv_cache(tc, n, B, S, quant=quant)
  for k, leaf in jcache.items():
    if leaf.dtype == jnp.int8:
      vals = rng.integers(-100, 100, leaf.shape).astype(np.int8)
    else:
      vals = rng.uniform(0.01, 1.0, leaf.shape).astype(np.float32)
    jcache[k] = jnp.asarray(vals, dtype=leaf.dtype)
    tcache[k].copy_(torch.from_numpy(vals).to(tcache[k].dtype))
  return jcache, tcache


def _assert_rows_close(jcache, tcache, rows, upto):
  """The caches agree on slots [0, n) of each row: floats within TOL, int8
  codes within one rounding step (as tests/test_torch_spec_batch.py holds
  pages)."""
  for k in jcache:
    for r, n in zip(rows, upto):
      got, want = tcache[k][:, r, :n], np.asarray(jcache[k][:, r, :n])
      if got.dtype == torch.int8:
        assert np.abs(got.numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1, k
      else:
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **TOL, err_msg=k)


@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_slot_programs_match_jax(models, knobs, family, quant):
  """Three prompts (one a padding row on a spare slot) prefill into rows
  3, 0 and 1 of a 4-row slot cache holding an earlier occupant's junk, then
  a decode chunk runs with row 2 inactive: last-token logits within 2e-4,
  the sampled first tokens and every decoded token identical, the written
  slots equal, the inactive row held."""
  jc, tc, js, ts, jp, tp = models[family]
  rng = np.random.default_rng(21)
  jcache, tcache = _caches(models[family], quant, 4, 48, rng)
  V = tc.vocab_size
  tokens = rng.integers(3, V, (3, 16)).astype(np.int32)
  lens = np.array([11, 16, 1], np.int32)
  tokens[0, 11:] = 0
  rows = np.array([3, 0, 1], np.int32)
  jl, jcache = jdec.prefill_into_slots(jp, jc, js, jnp.asarray(tokens), jcache, jnp.asarray(rows), jnp.asarray(lens))
  tl, _ = tdec.prefill_into_slots(tp, tc, ts, torch.from_numpy(tokens), tcache, torch.from_numpy(rows), torch.from_numpy(lens))
  np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
  _assert_rows_close(jcache, tcache, [3, 0], [11, 16])
  temps, top_ks = np.zeros(3, np.float32), np.full(3, 5, np.int32)
  jfirst, _ = jdec.prefill_into_slots_sampled(jp, jc, js, jnp.asarray(tokens), jcache, jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(temps), jnp.asarray(top_ks), jax.random.PRNGKey(0), 8)
  tfirst, _ = tdec.prefill_into_slots_sampled(tp, tc, ts, torch.from_numpy(tokens), tcache, torch.from_numpy(rows), torch.from_numpy(lens), torch.from_numpy(temps), torch.from_numpy(top_ks), torch.Generator().manual_seed(0), 8)
  np.testing.assert_array_equal(tfirst[:2].numpy(), np.asarray(jfirst)[:2])
  first = np.zeros((4, 1), np.int32)
  first[3, 0], first[0, 0] = np.asarray(jfirst)[0], np.asarray(jfirst)[1]
  positions = np.array([16, 0, 5, 11], np.int32)
  active = np.array([True, False, False, True])
  dtemps = np.zeros(4, np.float32)
  jt, jn, jpos, jcache = jdec.fused_batch_decode(jp, jc, js, jnp.asarray(first), jcache, jnp.asarray(positions), jnp.asarray(active), jnp.asarray(dtemps), 6)
  tt, tn, tpos, _ = tdec.fused_batch_decode(tp, tc, ts, torch.from_numpy(first), tcache, torch.from_numpy(positions), torch.from_numpy(active), torch.from_numpy(dtemps), 6)
  live = [0, 3]
  np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
  np.testing.assert_array_equal(tn.numpy()[live], np.asarray(jn)[live])
  np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
  assert tpos.numpy()[2] == 5 and tn.numpy()[2, 0] == 0  # the inactive row holds its token and position
  _assert_rows_close(jcache, tcache, [0, 3], [22, 17])


def test_failed_prefill_leaves_the_cache_intact(models, monkeypatch):
  """The reference's "not donated" rule: a prefill that raises inside the
  forward writes none of the pooled rows."""
  _, tc, _, ts, _, tp = models["llama"]
  cache = tdec.init_kv_cache(tc, 2, 4, 48)
  for leaf in cache.values():
    leaf.uniform_(generator=torch.Generator().manual_seed(2))
  before = {k: v.clone() for k, v in cache.items()}

  def boom(*a, **k):
    raise RuntimeError("device failure")

  monkeypatch.setattr(tdec, "head_logits", boom)
  with pytest.raises(RuntimeError, match="device failure"):
    tdec.prefill_into_slots(tp, tc, ts, torch.ones((2, 16), dtype=torch.int32), cache, torch.tensor([0, 2], dtype=torch.int32), torch.tensor([5, 9], dtype=torch.int32))
  for k in cache:
    assert torch.equal(cache[k], before[k])


# ------------------------------------------------------------------ server


def _prompts():
  rng = np.random.default_rng(13)
  prompts = [rng.integers(3, 120, int(n)).astype(np.int32) for n in (5, 19, 9, 30, 3, 12)]
  prompts[1][10:] = prompts[1][:9]  # a repeat, so the n-gram proposer has something to find
  return prompts, [7, 9, 5, 8, 6, 1]


def _spy(server, log):
  """Record every batched dispatch by ops method, in order."""
  for name in ("spec_paged_batch_decode", "spec_batch_decode", "paged_batch_decode", "batch_decode", "mixed_paged_batch_decode", "prefill_into_pages_many_sampled", "prefill_into_slots_sampled", "prefill_draft_into_slots"):
    orig = getattr(server.ops, name, None)
    if orig is None:
      continue

    def spy(*args, _orig=orig, _name=name, **kw):
      log.append(_name)
      return _orig(*args, **kw)

    setattr(server.ops, name, spy)


def serve(server, prompts, max_tokens, *, reset=True):
  """Serve every prompt concurrently (greedy); returns (tokens, dispatches
  by ops method in order, ledger dispatch counts by family)."""
  log: list = []
  _spy(server, log)
  lg = ledger if isinstance(server, BatchedServer) else jledger
  if reset:
    lg.reset()

  async def run():
    return await asyncio.gather(*(server.submit(f"r{i}", p, max_tokens=m, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None) for i, (p, m) in enumerate(zip(prompts, max_tokens))))

  out = asyncio.run(run())
  counts = {f: n for f, n in lg.dispatch_counts().items() if n}
  server.shutdown()
  return [[int(x) for x in o] for o in out], log, counts


def _engines(model):
  jc, tc, js, ts, jp, tp = model
  je = JaxShardedInferenceEngine(use_local_mesh=False)
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(device="cpu")
  te.load_test_model(ts, tc, tp)
  return je, te


@pytest.mark.parametrize("quant", ["", "int8"])
def test_dense_server_matches_jax_server(models, knobs, quant):
  """``XOT_TPU_PAGED=0``: six greedy requests over three slots (whole-prompt
  admissions, pad rows, a max_tokens-1 request) answer with the JAX dense
  server's tokens, through the same dispatches by program family."""
  knobs.setenv("XOT_TPU_KV_QUANT", quant)
  je, te = _engines(models["llama"])
  prompts, max_tokens = _prompts()
  got = serve(BatchedServer(te, n_slots=3, chunk=3), prompts, max_tokens)
  want = serve(JaxBatchedServer(je, n_slots=3, chunk=3), prompts, max_tokens)
  assert got[0] == want[0] and got[1] == want[1]
  assert got[2] == want[2] and set(got[2]) == {"prefill.slots_sampled", "decode.batch"}


def test_dense_server_with_ngram_speculation_matches_jax(models, knobs):
  """The dense spec chunk (``spec.batch``) at B rows with n-gram proposals:
  tokens, dispatches and accepted counts equal the JAX server's."""
  knobs.setenv("XOT_TPU_SPEC_BATCH", "auto")
  knobs.setenv("XOT_TPU_SPEC_NGRAM", "1")
  je, te = _engines(models["llama"])
  prompts, max_tokens = _prompts()
  prompts = [np.tile(p[:4], 5) for p in prompts]  # repetitive: rows propose and accept
  max_tokens = [12] * len(prompts)
  tserver, jserver = BatchedServer(te, n_slots=3, chunk=3), JaxBatchedServer(je, n_slots=3, chunk=3)
  got, want = serve(tserver, prompts, max_tokens), serve(jserver, prompts, max_tokens)
  assert got == want
  assert "spec_batch_decode" in got[1] and got[2].get("spec.batch", 0) > 0
  assert tserver.spec and tserver.spec_proposers == ("ngram",) and not tserver.paged


def test_pad_rows_take_distinct_spare_free_slots(models, knobs):
  """An admission batch of three rounds up to four rows: the pad row takes
  the one spare free slot, never an admitted row's; with no spare slot the
  batch stays exact."""
  _, te = _engines(models["llama"])
  server = BatchedServer(te, n_slots=4, chunk=2)
  seen = []
  orig = server.ops.prefill_into_slots_sampled

  def spy(tokens, cache, rows, *a, **k):
    seen.append(np.asarray(rows).tolist())
    return orig(tokens, cache, rows, *a, **k)

  server.ops.prefill_into_slots_sampled = spy
  prompts, _ = _prompts()

  async def run():
    return await asyncio.gather(*(server.submit(f"p{i}", p, max_tokens=3, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None) for i, p in enumerate(prompts[:3])))

  asyncio.run(run())
  server.shutdown()
  assert len(seen[0]) == len(set(seen[0]))
  assert seen[0] == [0, 1, 2, 3] or len(seen[0]) == 1  # three admissions and the spare pad, or the first alone
  assert all(len(r) == len(set(r)) for r in seen)


def test_auto_layout_and_labels_resolve_like_the_reference(models, knobs):
  """``XOT_TPU_PAGED=auto`` on the CPU: the table answers "gather", so both
  servers build the paged pool; ``XOT_TPU_PAGED=0`` labels its chunks
  "dense"; the ``paged_kernel_tile`` gauge reads 0 where K3 does not run."""
  knobs.setenv("XOT_TPU_PAGED", "auto")
  je, te = _engines(models["llama"])
  tserver, jserver = BatchedServer(te, n_slots=2, chunk=2), JaxBatchedServer(je, n_slots=2, chunk=2)
  tserver._ensure_cache()
  jserver._ensure_cache()
  assert tserver.paged == jserver.paged is True
  assert tserver.decode_path == jserver.decode_path == "gather"
  assert metrics.gauge_value("paged_kernel_tile") == 0
  assert [f["family"] for f in tserver.warmup_manifest()] == [f["family"] for f in jserver.warmup_manifest()]
  tserver.shutdown()
  jserver.shutdown()
  knobs.setenv("XOT_TPU_PAGED", "0")
  tserver, jserver = BatchedServer(te, n_slots=2, chunk=2), JaxBatchedServer(je, n_slots=2, chunk=2)
  tserver._ensure_cache()
  jserver._ensure_cache()
  assert not tserver.paged and tserver.decode_path == jserver.decode_path == "dense"
  assert [f["family"] for f in tserver.warmup_manifest()] == [f["family"] for f in jserver.warmup_manifest()] == ["prefill.slots_sampled", "decode.batch"]
  assert tserver.allocator is None and tuple(tserver.cache["k"].shape[1:3]) == (2, tserver.max_seq)
  tserver.shutdown()
  jserver.shutdown()


def test_dense_server_warmup_builds_the_dense_families(models, knobs):
  """``warmup`` on the dense server drives its manifest: both families
  warmed, the ledger steady, and nothing built by traffic after it."""
  _, te = _engines(models["llama"])
  server = BatchedServer(te, n_slots=2, chunk=2)
  ledger.reset()
  out = asyncio.run(server.warmup())
  assert [(f["family"], f["warmed"]) for f in out["manifest"]] == [("prefill.slots_sampled", True), ("decode.batch", True)]
  asyncio.run(server.submit("after", np.ones((4,), np.int32), max_tokens=3, temp=0.7, top_k=5, eos_ids=(), emit=lambda *a: None))
  assert ledger.snapshot()["totals"]["steady_compiles"] == 0
  server.shutdown()


@pytest.mark.parametrize("family", ["gemma2", "qwen3-moe", "deepseek-v2-lite"])
def test_dense_server_serves_every_family_like_jax(models, knobs, family):
  """gemma2, MoE and MLA through the dense server, at the defaults' n-gram
  speculation: the same tokens and dispatches as the JAX server. The dense
  MLA server speculates (the reference gates only the paged MLA server)."""
  knobs.setenv("XOT_TPU_SPEC_BATCH", "auto")
  knobs.setenv("XOT_TPU_SPEC_NGRAM", "1")
  je, te = _engines(models[family])
  prompts = [np.tile(np.array([9, 31, 7], np.int32), 4), np.arange(40, 52, dtype=np.int32)]
  tserver, jserver = BatchedServer(te, n_slots=2, chunk=3), JaxBatchedServer(je, n_slots=2, chunk=3)
  got, want = serve(tserver, prompts, [10, 10]), serve(jserver, prompts, [10, 10])
  assert got == want
  assert tserver.spec == jserver.spec is True
