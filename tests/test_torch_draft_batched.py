"""The batched draft-model proposer against the JAX package's, on the CPU
at f32 on identical weights: both speculative chunks with a draft
(``fused_spec_batch_decode`` on the slot cache, ``fused_spec_paged_batch_decode``
on the page pool) with the int8 self-draft and with a 1-layer draft of
another width — tokens, counts, ``n_prop``, next token and positions
equal, the draft's slot cache written alike — and the batched server with
a draft loaded, paged and dense: tokens, dispatches by program name,
proposers and the ``kv_draft_*`` gauges equal to the JAX server's; the
draft cache in the model dtype under int8 KV, its pages out of the pool
budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_batched import serve
from test_torch_spec_solo import DRAFT, MAX_SEQ, TARGET, _pair
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.models import decoder as jdec
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquant
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu.utils.metrics import metrics as jmetrics
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import decoder as tdec
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquant
from xotorch_support_jetson_tpu_torch.ops import paged as tpaged
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics as tmetrics

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
PS = 8
KNOBS = {"XOT_TPU_QOS": "0", "XOT_TPU_KV_TIER": "0", "XOT_TPU_MIXED_TICK": "0", "XOT_TPU_SLO": "0", "XOT_TPU_PAGE_SIZE": str(PS), "XOT_TPU_SPEC_BATCH": "auto"}
UNSET = ("XOT_TPU_KV_QUANT", "XOT_TPU_PAGED", "XOT_TPU_PAGED_KERNEL", "XOT_TPU_QUANT", "XOT_TPU_SPEC_DECODE", "XOT_TPU_SPEC_DRAFT", "XOT_TPU_SPEC_GAMMA", "XOT_TPU_SPEC_BATCH_GAMMA", "XOT_TPU_SPEC_REPROBE")
GAUGES = ("kv_draft_bytes", "kv_draft_slots", "kv_draft_pages_equivalent")


@pytest.fixture(scope="module")
def models():
  target = _pair(TARGET, 11)
  jc, tc, js, ts, jp, tp = target
  return {"target": target, "int8": (jc, tc, js, ts, jquant(jp), tquant(tp, "int8")), "other": _pair(DRAFT, 42, "d")}


@pytest.fixture
def knobs(monkeypatch):
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  for k, v in KNOBS.items():
    monkeypatch.setenv(k, v)
  return monkeypatch


# ------------------------------------------------------------------ decoder

B = 3
PROMPTS = np.array([[5, 9, 2, 71, 33, 5, 9, 2, 71, 33, 5, 9], [7, 12, 29, 41, 3, 88, 101, 55, 0, 0, 0, 0], [4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0]], np.int32)
LENS = np.array([12, 8, 6], np.int32)
ROWS = np.arange(B, dtype=np.int32)


def _dense_case(pkg, model, quant=""):
  """A slot cache of three rows holding the prompts; returns (cache,
  first greedy tokens [B, 1])."""
  jc, tc, js, ts, jp, tp = model
  n = tc.n_layers
  if pkg == "jax":
    cache = jdec.init_kv_cache(jc, n, B, MAX_SEQ, quant=quant)
    last, cache = jdec.prefill_into_slots(jp, jc, js, jnp.asarray(PROMPTS), cache, jnp.asarray(ROWS), jnp.asarray(LENS))
    return cache, np.argmax(np.asarray(last), -1).astype(np.int32)[:, None]
  cache = tdec.init_kv_cache(tc, n, B, MAX_SEQ, quant=quant)
  last, cache = tdec.prefill_into_slots(tp, tc, ts, torch.from_numpy(PROMPTS), cache, torch.from_numpy(ROWS), torch.from_numpy(LENS))
  return cache, np.argmax(last.numpy(), -1).astype(np.int32)[:, None]


BT = np.array([[3, 7, 1, 9, 12, 14, 16, 18], [2, 5, 11, 8, 13, 15, 17, 19], [4, 6, 10, 20, 21, 22, 23, 24]], np.int32)


def _paged_case(pkg, model):
  jc, tc, js, ts, jp, tp = model
  z = np.zeros(B, np.int32)
  if pkg == "jax":
    pool = jpaged.init_paged_pool(jc, tc.n_layers, 25, PS)
    last, pool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(PROMPTS), pool, jnp.asarray(BT), jnp.asarray(z), jnp.asarray(LENS), PS)
    return pool, np.argmax(np.asarray(last), -1).astype(np.int32)[:, None]
  pool = tpaged.init_paged_pool(tc, tc.n_layers, 25, PS)
  last, pool = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(PROMPTS), pool, torch.from_numpy(BT), torch.from_numpy(z), torch.from_numpy(LENS), PS)
  return pool, np.argmax(last.numpy(), -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("draft", ["int8", "other"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_chunks_with_a_draft_match_jax(models, draft, layout):
  """One spec chunk of 3 rounds at depth cap 4 with the draft proposing:
  row 0 model-drafted at depth 4, row 1 on an n-gram stream at depth 2,
  row 2 inactive. Tokens, counts, n_prop, next token and positions equal
  the JAX chunk's; the draft's cache holds the same K/V below each row's
  new position."""
  jc, tc, js, ts, jp, tp = models["target"]
  jcd, tcd, jsd, tsd, jpd, tpd = models[draft]
  out = {}
  for pkg in ("jax", "torch"):
    store, first = _dense_case(pkg, models["target"]) if layout == "dense" else _paged_case(pkg, models["target"])
    cache_d, _ = _dense_case(pkg, models[draft])
    props = np.zeros((B, 16), np.int32)
    props[1, :6] = [3, 88, 101, 55, 7, 12]
    args = dict(positions=LENS.copy(), active=np.array([True, True, False]), gammas=np.array([4, 2, 4], np.int32), temps=np.zeros(B, np.float32))
    counts = np.array([0, 6, 0], np.int32)
    if pkg == "jax":
      a = {k: jnp.asarray(v) for k, v in args.items()}
      common = (jp, jc, js, jpd, jcd, jsd, jnp.asarray(first))
      if layout == "dense":
        res = jdec.fused_spec_batch_decode(*common, store, cache_d, a["positions"], a["active"], a["gammas"], a["temps"], 3, 4, props=jnp.asarray(props), prop_counts=jnp.asarray(counts))
      else:
        res = jdec.fused_spec_paged_batch_decode(*common, store, cache_d, jnp.asarray(BT), a["positions"], a["active"], a["gammas"], a["temps"], 3, 4, page_size=PS, props=jnp.asarray(props), prop_counts=jnp.asarray(counts))
      res = [np.asarray(x) for x in res[:5]] + [res[6]]
    else:
      t = {k: torch.from_numpy(v) for k, v in args.items()}
      common = (tp, tc, ts, tpd, tcd, tsd, torch.from_numpy(first))
      if layout == "dense":
        res = tdec.fused_spec_batch_decode(*common, store, cache_d, t["positions"], t["active"], t["gammas"], t["temps"], 3, 4, props=torch.from_numpy(props), prop_counts=torch.from_numpy(counts))
      else:
        res = tdec.fused_spec_paged_batch_decode(*common, store, cache_d, torch.from_numpy(BT), t["positions"], t["active"], t["gammas"], t["temps"], 3, 4, page_size=PS, props=torch.from_numpy(props), prop_counts=torch.from_numpy(counts))
      res = [x.numpy() for x in res[:5]] + [res[6]]
    out[pkg] = res
  (jbuf, jcnt, jprop, jnext, jpos, jcd_out), (tbuf, tcnt, tprop, tnext, tpos, tcd_out) = out["jax"], out["torch"]
  np.testing.assert_array_equal(tcnt[:2], jcnt[:2])
  for i in range(2):
    assert tbuf[i, : tcnt[i]].tolist() == jbuf[i, : jcnt[i]].tolist()
  np.testing.assert_array_equal(tprop[:2], jprop[:2])
  np.testing.assert_array_equal(tnext[:2], jnext[:2])
  np.testing.assert_array_equal(tpos, jpos)
  assert tpos[2] == LENS[2] and tprop[0] == 3 * 4  # the inactive row holds; the model row proposes depth·rounds
  for k in jcd_out:
    for i in range(2):
      np.testing.assert_allclose(tcd_out[k][:, i, : tpos[i]].numpy(), np.asarray(jcd_out[k][:, i, : jpos[i]]), **TOL)


def test_spec_chunk_needs_the_draft_cache(models):
  _, tc, _, ts, _, tp = models["target"]
  with pytest.raises(ValueError, match="slot cache"):
    tdec.fused_spec_batch_decode(tp, tc, ts, tp, tc, ts, torch.zeros((1, 1), dtype=torch.int32), {}, None, torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool), torch.ones(1, dtype=torch.int32), torch.zeros(1), 2, 2)


# ------------------------------------------------------------------ server


def _engines(models, draft, knobs):
  """JAX and port engines on the target with ``draft`` loaded: "int8" is
  each engine's own int8 self-draft; "other" the 1-layer draft (its
  config and shard) set on both."""
  jc, tc, js, ts, jp, tp = models["target"]
  knobs.setenv("XOT_TPU_SPEC_DECODE", "int8")
  je = JaxShardedInferenceEngine(use_local_mesh=False, max_seq_len=MAX_SEQ, spec_decode="int8")
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(max_seq_len=MAX_SEQ, device="cpu", spec_decode="int8")
  te.load_test_model(ts, tc, tp)
  if draft == "other":
    jcd, tcd, jsd, tsd, jpd, tpd = models["other"]
    je._draft_params, je._draft_cfg, je._draft_shard = jpd, jcd, jsd
    te._draft_params, te._draft_cfg, te._draft_shard = tpd, tcd, tsd
  assert je._draft_params is not None and te._draft_params is not None
  return je, te


def _prompts():
  rng = np.random.default_rng(17)
  prompts = [np.tile(np.array([5, 9, 2, 71], np.int32), 4), rng.integers(3, 250, 9).astype(np.int32), np.tile(np.array([40, 41, 42], np.int32), 3), rng.integers(3, 250, 21).astype(np.int32)]
  return prompts, [14, 10, 12, 9]


def _proposers(m, n):
  return [m.gauge_value("spec_proposer", labels={"row": str(i)}) for i in range(n)]


@pytest.mark.parametrize("ngram", ["0", "1"])
@pytest.mark.parametrize("draft", ["int8", "other"])
@pytest.mark.parametrize("paged", ["1", "0"])
def test_drafted_server_matches_jax_server(models, knobs, paged, draft, ngram):
  """A batched server with a draft loaded (the "model" proposer; with the
  n-gram family too when it is on) serves four greedy requests over two
  slots like the JAX server: tokens, dispatches by ops method and by
  program family, the proposer and depth gauges, and ``kv_draft_*``."""
  knobs.setenv("XOT_TPU_PAGED", paged)
  knobs.setenv("XOT_TPU_SPEC_NGRAM", ngram)
  je, te = _engines(models, draft, knobs)
  prompts, max_tokens = _prompts()
  tserver, jserver = BatchedServer(te, n_slots=2, chunk=3), JaxBatchedServer(je, n_slots=2, chunk=3)
  got = serve(tserver, prompts, max_tokens)
  tg = [tmetrics.gauge_value(g) for g in GAUGES] + _proposers(tmetrics, 2)
  want = serve(jserver, prompts, max_tokens)
  jg = [jmetrics.gauge_value(g) for g in GAUGES] + _proposers(jmetrics, 2)
  assert got == want
  assert tg == jg and tg[1] == 2 and tg[0] > 0
  assert tserver.spec_proposers == jserver.spec_proposers == (("model", "ngram") if ngram == "1" else ("model",))
  assert "prefill_draft_into_slots" in got[1] and got[2].get("prefill.slots", 0) > 0
  assert got[2].get("spec.paged_batch" if paged == "1" else "spec.batch", 0) > 0


def test_draft_cache_keeps_the_model_dtype_and_the_page_budget(models, knobs):
  """Under ``XOT_TPU_KV_QUANT=int8`` the target's pool holds int8 pages
  while the draft's slot cache stays in the model dtype, and the draft's
  bytes come out of the default page budget exactly as in the reference."""
  knobs.setenv("XOT_TPU_KV_QUANT", "int8")
  je, te = _engines(models, "other", knobs)
  tserver, jserver = BatchedServer(te, n_slots=2, chunk=3), JaxBatchedServer(je, n_slots=2, chunk=3)
  tserver._ensure_cache()
  jserver._ensure_cache()
  assert tserver.cache["k"].dtype == torch.int8
  assert set(tserver.draft_cache) == {"k", "v"} and tserver.draft_cache["k"].dtype == models["other"][1].dtype
  assert tuple(tserver.draft_cache["k"].shape) == tuple(jserver.draft_cache["k"].shape)
  assert tserver.allocator.n_pages == jserver.allocator.n_pages
  assert [tmetrics.gauge_value(g) for g in GAUGES] == [jmetrics.gauge_value(g) for g in GAUGES]
  tserver.shutdown()
  jserver.shutdown()
  assert tserver.draft_cache is None
