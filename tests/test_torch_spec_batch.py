"""Batched draft-free n-gram speculation in the port against the JAX
package, on the CPU, on identical weights (JAX ``init_shard_params`` →
numpy → ``params_from_jax``; 2 layers, width 64, f32, 8-token pages).
Greedy tokens, counts and counter deltas are held identical; logits within
rtol = atol = 2e-4 (quantized pools: codes within one rounding step, as in
test_torch_mixed_tick.py):

- ``NgramIndex.propose`` on seeded random and periodic histories (N 1–4,
  depth 1–12); ``ngram_enabled`` and the ``XOT_TPU_SPEC_BATCH`` verdict for
  each value the reference parses;
- the per-row policy (``spec_adapt_gamma``, ``spec_select_proposer``,
  ``spec_reprobe_proposer``, ``spec_worst_advance``, ``ewma_update``) over
  a grid;
- ``paged_window_forward`` for bf16-layout, int8 and int4 pages, through
  the flattened K3 route (its plain version on the CPU) and the gather
  route;
- ``fused_spec_paged_batch_decode``, with and without proposals: an
  accepting stream, an adversarial one, an inactive row, and a cancelled
  row within one window of the context's end (the table clamp); the pool's
  pages below each row's new position;
- the ``BatchedServer`` at the defaults (``XOT_TPU_SPEC_BATCH`` and
  ``XOT_TPU_SPEC_NGRAM`` unset on both sides), lookahead on and off: the
  greedy tokens, the sequence of spec and plain dispatches with their depth
  caps, per-row depths and proposing rows, and the accepted / proposed
  counter deltas, on repetitive prompts (an echo model: the spec path fires
  and accepts; also on int8 and int4 pools), non-repetitive ones (rows fall
  back to plain), an EOS inside an accepted run, and a QoS preemption
  mid-speculation with its resume;
- sampled rows run at depth 0 and draw the plain chunk's tokens;
  ``XOT_TPU_SPEC_BATCH=0`` and ``XOT_TPU_SPEC_NGRAM=0`` dispatch no spec
  chunk; a failing spec dispatch fails its requests (no plain fallback);
  the daemon's ``/metrics`` shows the spec path and zero draft bytes."""

import asyncio
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import make_tiny_llama
from xotorch_support_jetson_tpu.inference import ngram as jngram, paging as jpaging, qos as jqos
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu.utils.metrics import metrics as jmetrics
from xotorch_support_jetson_tpu.utils.synthetic import peaked_echo_params
from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch.inference import ngram as tngram, paging as tpaging, qos as tqos
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.ops import paged
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics as tmetrics

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
PS = 8
MAX_SEQ = 128
SPEC_KNOBS = ("XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM", "XOT_TPU_SPEC_NGRAM_N", "XOT_TPU_SPEC_NGRAM_MAX", "XOT_TPU_SPEC_REPROBE", "XOT_TPU_SPEC_BATCH_GAMMA")
UNSET = SPEC_KNOBS + ("XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_SLO", "XOT_TPU_MIXED_BUDGET", "XOT_TPU_KV_QUANT", "XOT_TPU_PREFILL_CHUNK", "XOT_TPU_BATCH_PAGES")
# Periodic prompts: the echo model continues them, so suffix matches fire and accept.
REPETITIVE = [[3, 25, 9, 7] * 3, [7, 1, 88, 42, 5, 7, 1, 88, 42, 5], [9, 9, 9, 1, 9, 9, 9, 1], [100, 4, 100, 4, 100]]


def _model(echo: bool):
  jc = jconfig.tiny_test_config(n_layers=2, max_seq_len=MAX_SEQ, tied_embedding=True)
  tc = tconfig.tiny_test_config(n_layers=2, max_seq_len=MAX_SEQ, tied_embedding=True)
  jshard, tshard = JShard("tiny", 0, 1, 2), Shard("tiny", 0, 1, 2)
  jp = jdec.init_shard_params(jax.random.PRNGKey(3), jc, jshard)
  if echo:
    jp = peaked_echo_params(jp)
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, tshard)
  return jc, tc, jshard, tshard, jp, tp


@pytest.fixture(scope="module")
def models():
  return {"echo": _model(True), "random": _model(False)}


@pytest.fixture
def defaults(monkeypatch):
  """The reference's defaults (speculation on), 8-token pages."""
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  monkeypatch.setenv("XOT_TPU_PAGE_SIZE", str(PS))
  return monkeypatch


# ------------------------------------------------------------- host policy


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ngram_index_matches_reference(n):
  rng = np.random.default_rng(n)
  histories = [rng.integers(0, 6, 60).tolist(), rng.integers(0, 200, 40).tolist(), [4, 8, 15, 16, 23] * 8, [1] * 20 + [2, 3] * 10]
  for hist in histories:
    ours, theirs = tngram.NgramIndex(n), jngram.NgramIndex(n)
    i = 0
    while i < len(hist):
      step = int(rng.integers(1, 5))
      ours.extend(hist[i : i + step])
      theirs.extend(hist[i : i + step])
      i += step
      for depth in range(1, 13):
        got, want = ours.propose(depth), theirs.propose(depth)
        assert got.dtype == want.dtype and np.array_equal(got, want), (hist[:i], depth)
    assert len(ours) == len(theirs)


@pytest.mark.parametrize("value", [None, "", "0", "false", "no", "off", "1", "auto"])
def test_spec_knob_parse_matches_reference(models, defaults, value):
  """``XOT_TPU_SPEC_NGRAM`` and ``XOT_TPU_SPEC_BATCH`` take the same value
  in turn: only ``0`` and ``false`` turn either off, so ``no``, ``off`` and
  ``""`` speculate on both sides."""
  jc, tc, js, ts, jp, tp = models["random"]
  verdicts = []
  for knob in ("XOT_TPU_SPEC_NGRAM", "XOT_TPU_SPEC_BATCH"):
    for k in SPEC_KNOBS:
      defaults.delenv(k, raising=False)
    if value is not None:
      defaults.setenv(knob, value)
    if knob == "XOT_TPU_SPEC_NGRAM":
      assert tngram.ngram_enabled() == jngram.ngram_enabled()
      assert tngram.ngram_knobs() == jngram.ngram_knobs()
    jengine = JaxShardedInferenceEngine(use_local_mesh=False)
    jengine.load_test_model(js, jc, jp)
    tengine = TorchShardedInferenceEngine(device="cpu")
    tengine.load_test_model(ts, tc, tp)
    jserver, tserver = JaxBatchedServer(jengine, n_slots=2, chunk=4), BatchedServer(tengine, n_slots=2, chunk=4)
    jserver._ensure_cache()
    tserver._ensure_cache()
    assert (tserver.spec, tserver.spec_proposers) == (jserver.spec, jserver.spec_proposers)
    assert (tserver.spec_ngram_n, tserver.spec_ngram_max, tserver.spec_reprobe) == (jserver.spec_ngram_n, jserver.spec_ngram_max, jserver.spec_reprobe)
    verdicts.append(tserver.spec)
  assert verdicts == [value not in ("0", "false")] * 2


@pytest.mark.parametrize("priority", ["interactive", "standard", "batch"])
def test_spec_policy_matches_reference(priority):
  ewmas = [None, 0.0, 0.1, 0.149, 0.15, 0.2, 0.299, 0.3, 0.45, 0.549, 0.55, 0.8, 1.0]
  for ewma in ewmas:
    for gamma in range(-1, 10):
      for gamma_max in (1, 4, 8):
        args = (ewma, gamma, gamma_max, priority)
        assert tpaging.spec_adapt_gamma(*args) == jpaging.spec_adapt_gamma(*args), args
  books = [{}, {"ngram": 0.1}, {"ngram": 0.5}, {"model": 0.1}, {"model": 0.2, "ngram": 0.05}, {"model": 0.9, "ngram": 0.4}]
  for available in [(), ("ngram",), ("model",), ("model", "ngram")]:
    for book in books:
      for current in ("ngram", "model", "plain"):
        args = (current, book, available, priority)
        assert tpaging.spec_select_proposer(*args) == jpaging.spec_select_proposer(*args), args
      assert tpaging.spec_reprobe_proposer(book, available) == jpaging.spec_reprobe_proposer(book, available)
  for prev in ewmas:
    for obs in (-0.5, 0.0, 0.33, 1.0, 1.7):
      assert tpaging.ewma_update(prev, obs) == jpaging.ewma_update(prev, obs)
      assert tpaging.ewma_update(prev, obs, 0.5) == jpaging.ewma_update(prev, obs, 0.5)
  for rounds in (1, 3, 8):
    for gmax in (0, 1, 8):
      assert tpaging.spec_worst_advance(rounds, gmax) == jpaging.spec_worst_advance(rounds, gmax)
  assert tpaging.SPEC_PROPOSERS == jpaging.SPEC_PROPOSERS and tpaging._SPEC_GAMMA_TABLE == jpaging._SPEC_GAMMA_TABLE
  assert tpaging._SPEC_DEMOTE_FLOOR == jpaging._SPEC_DEMOTE_FLOOR


# --------------------------------------------------------------- programs


def _assert_pages_close(tpool, jpool, quant, pages, slots=None):
  """The two pools agree on ``pages`` (optionally only ``slots`` of each):
  floats within TOL; quantized codes within one rounding step and their
  scales within TOL."""
  for key in jpool:
    got, want = tpool[key].numpy()[:, pages], np.asarray(jpool[key])[:, pages]
    if slots is not None:
      got, want = got[:, :, :, :slots], want[:, :, :, :slots]
    if quant and key in ("k", "v"):
      if quant == "int4":  # two signed nibbles per byte
        got = np.stack([(got.astype(np.int16) << 12 >> 12), got.astype(np.int16) >> 4], -1)
        want = np.stack([(want.astype(np.int16) << 12 >> 12), want.astype(np.int16) >> 4], -1)
      assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, key
    else:
      np.testing.assert_allclose(got, want, **TOL, err_msg=key)


def _seeded_pools(model, quant, bt, lens, seed):
  """Both packages' pools with each row's prompt of ``lens[i]`` tokens
  prefilled through ``bt``'s first four pages; returns (jpool, tpool,
  greedy first tokens [B, 1])."""
  jc, tc, js, ts, jp, tp = model
  n_pages = int(bt.max()) + 1
  jpool = jpaged.init_paged_pool(jc, 2, n_pages, PS, quant=quant)
  tpool = paged.init_paged_pool(tc, 2, n_pages, PS, quant=quant)
  B = bt.shape[0]
  seed_tok = np.random.default_rng(seed).integers(0, 256, (B, 4 * PS)).astype(np.int32)
  z = np.zeros(B, np.int32)
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(seed_tok), jpool, jnp.asarray(bt[:, :4]), jnp.asarray(z), jnp.asarray(lens), PS)
  tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(seed_tok), tpool, torch.from_numpy(bt[:, :4]), torch.from_numpy(z), torch.from_numpy(lens), PS)
  return jpool, tpool, np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["k3-route", "gather-route"])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_paged_window_forward_matches_reference(models, quant, use_kernel):
  """A W = 5 window for three rows at different depths, one of them on the
  trash page: logits and the written pages equal the reference's."""
  jc, tc, js, ts, jp, tp = models["random"]
  bt = np.array([[3, 7, 1, 9, 0, 0], [2, 11, 5, 0, 0, 0], [0, 0, 0, 0, 0, 0]], np.int32)
  lens = np.array([19, 13, 1], np.int32)
  jpool, tpool, _ = _seeded_pools(models["random"], quant, bt, lens, seed=5)
  rng = np.random.default_rng(6)
  tokens = rng.integers(0, 256, (3, 5)).astype(np.int32)
  positions = (lens[:, None] + np.arange(5)[None, :]).astype(np.int32)
  jl, jpool = jdec.paged_window_forward(jp, jc, js, jnp.asarray(tokens), jnp.asarray(positions), jpool, jnp.asarray(bt), PS)
  before = paged.LAUNCHES["paged_decode"]
  tl, tpool = tdec.paged_window_forward(tp, tc, ts, torch.from_numpy(tokens), torch.from_numpy(positions), tpool, torch.from_numpy(bt), PS, use_kernel)
  assert paged.LAUNCHES["paged_decode"] == before  # the CPU takes K3's plain version: no launch
  np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
  _assert_pages_close(tpool, jpool, quant, [3, 7, 1, 2, 11])


def test_window_write_and_attention_match_their_plain_versions():
  """``write_window_kv`` (one indexed write) equals the per-position plain
  version, including a row whose window runs past its table (it clamps
  onto the row's last column); the flattened window attention equals the
  gather route; both at f32."""
  gen = torch.Generator().manual_seed(0)
  pool = torch.randn((9, 2, PS, 16), generator=gen)
  bt = torch.tensor([[1, 4, 6], [2, 8, 0], [0, 0, 0]], dtype=torch.int32)
  positions = torch.tensor([[9, 10, 11, 12], [3, 4, 5, 6], [22, 23, 24, 25]], dtype=torch.int32)  # row 2 passes 3·8
  new = torch.randn((3, 4, 2, 16), generator=gen)
  a, b = paged.write_window_kv(pool.clone(), new, bt, positions, PS), paged.write_window_kv_ref(pool.clone(), new, bt, positions, PS)
  assert torch.equal(a[1:], b[1:])
  q = torch.randn((2, 4, 4, 16), generator=gen)
  flat = paged.paged_window_attention(q, a, a, paged.window_block_tables(bt[:2], 4), positions[:2], PS)
  gathered = paged.paged_window_attention_ref(q, a, a, bt[:2], positions[:2], PS)
  torch.testing.assert_close(flat, gathered, **TOL)


def _spec_case(models, case: str):
  """Operands of one spec chunk (4 rounds, gamma_max 3) for three rows."""
  R, G = 4, 3
  bt = np.zeros((3, MAX_SEQ // PS), np.int32)
  bt[0, :8] = np.arange(1, 9)
  bt[1, :8] = np.arange(9, 17)
  bt[2, :8] = np.arange(17, 25)
  lens = np.array([12, 20, 7], np.int32)
  active = np.ones(3, bool)
  gammas = np.array([3, 2, 3], np.int32)
  jpool, tpool, first = _seeded_pools(models["random"], "", bt, lens, seed=9)
  positions = lens.copy()
  if case == "inactive":
    active[1] = False
  if case == "near_window":
    # A cancelled row held at a position within one window of the end:
    # its window writes reach past its table.
    active[2] = False
    positions[2] = MAX_SEQ - 2
  return dict(first=first, bt=bt, positions=positions, active=active, gammas=gammas, temps=np.zeros(3, np.float32), R=R, G=G), jpool, tpool


def _plain_stream(model, jpool, op, n):
  """The reference's plain greedy continuation of ``n`` steps per row, on a
  copy of its pool."""
  jc, _, js, _, jp, _ = model
  pool = jax.tree.map(jnp.copy, jpool)
  toks, _, _, _ = jdec.fused_paged_batch_decode(jp, jc, js, jnp.asarray(op["first"]), pool, jnp.asarray(op["bt"]), jnp.asarray(op["positions"]), jnp.asarray(np.ones(3, bool)), jnp.asarray(op["temps"]), n, page_size=PS)
  return np.array(toks)


@pytest.mark.parametrize("with_props", [True, False], ids=["props", "no-props"])
@pytest.mark.parametrize("case", ["accepting", "adversarial", "inactive", "near_window"])
def test_fused_spec_chunk_matches_reference(models, case, with_props):
  jc, tc, js, ts, jp, tp = models["random"]
  op, jpool, tpool = _spec_case(models, case)
  R, G = op["R"], op["G"]
  props = prop_counts = None
  if with_props:
    width = R * (G + 1) + G
    if case == "accepting":
      props = _plain_stream(models["random"], jpool, op, width)
    else:
      props = np.random.default_rng(3).integers(0, 256, (3, width)).astype(np.int32)
    prop_counts = np.array([width, 9, width], np.int32)
  jout = jdec.fused_spec_paged_batch_decode(
    jp, jc, js, None, jc, js, jnp.asarray(op["first"]), jpool, None, jnp.asarray(op["bt"]), jnp.asarray(op["positions"]), jnp.asarray(op["active"]),
    jnp.asarray(op["gammas"]), jnp.asarray(op["temps"]), R, G, page_size=PS,
    props=None if props is None else jnp.asarray(props), prop_counts=None if prop_counts is None else jnp.asarray(prop_counts),
  )
  tout = tdec.fused_spec_paged_batch_decode(
    tp, tc, ts, None, None, None, torch.from_numpy(op["first"]), tpool, None, torch.from_numpy(op["bt"]), torch.from_numpy(op["positions"]),
    torch.from_numpy(op["active"]), torch.from_numpy(op["gammas"]), torch.from_numpy(op["temps"]), R, G, page_size=PS,
    props=None if props is None else torch.from_numpy(props), prop_counts=None if prop_counts is None else torch.from_numpy(prop_counts),
  )
  buf, counts, n_prop, next_tok, next_pos, pool, _ = tout
  want_counts = np.asarray(jout[1])
  np.testing.assert_array_equal(counts.numpy(), want_counts)
  np.testing.assert_array_equal(n_prop.numpy(), np.asarray(jout[2]))
  np.testing.assert_array_equal(next_tok.numpy(), np.asarray(jout[3]))
  np.testing.assert_array_equal(next_pos.numpy(), np.asarray(jout[4]))
  for i in range(3):
    np.testing.assert_array_equal(buf[i, : want_counts[i]].numpy(), np.asarray(jout[0])[i, : want_counts[i]])
  if case == "accepting" and with_props:
    assert want_counts[0] == R * (G + 1)  # the plain stream accepts in full
  if case in ("inactive", "near_window"):
    held = 1 if case == "inactive" else 2
    assert want_counts[held] == 0 and next_pos[held] == op["positions"][held]
  # Pages below each active row's new position hold the reference's K/V.
  for i in range(3):
    if not op["active"][i]:
      continue
    end = int(next_pos[i])
    full = list(op["bt"][i, : end // PS])
    if full:
      _assert_pages_close(pool, jout[5], "", full)
    if end % PS:
      _assert_pages_close(pool, jout[5], "", [int(op["bt"][i, end // PS])], slots=end % PS)


def test_spec_chunk_refuses_a_draft_model(models):
  """A draft model now proposes inside the paged spec chunk (the model
  proposer; tests/test_torch_draft_batched.py holds it against the
  reference in full): given no slot cache for it, the chunk refuses; given
  one, a draft equal to the target proposes what the target verifies, so
  every round accepts its whole window, as in the reference's chunk."""
  jc, tc, js, ts, jp, tp = models["random"]
  with pytest.raises(ValueError, match="slot cache"):
    tdec.fused_spec_paged_batch_decode(tp, tc, ts, tp, tc, ts, torch.zeros((1, 1), dtype=torch.int32), {}, None, torch.zeros((1, 4), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool), torch.ones(1, dtype=torch.int32), torch.zeros(1), 2, 2, page_size=PS)
  prompt = np.array([[3, 14, 15, 92, 65]], np.int32)
  bt = np.array([[1, 2, 3, 4]], np.int32)
  z, lens = np.zeros(1, np.int32), np.array([5], np.int32)
  jpool, tpool = jpaged.init_paged_pool(jc, 2, 5, PS), paged.init_paged_pool(tc, 2, 5, PS)
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(prompt), jpool, jnp.asarray(bt), jnp.asarray(z), jnp.asarray(lens), PS)
  tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(prompt), tpool, torch.from_numpy(bt), torch.from_numpy(z), torch.from_numpy(lens), PS)
  jcd, tcd = jdec.init_kv_cache(jc, 2, 1, 32), tdec.init_kv_cache(tc, 2, 1, 32)
  _, jcd = jdec.prefill_into_slots(jp, jc, js, jnp.asarray(prompt), jcd, jnp.zeros(1, jnp.int32), jnp.asarray(lens))
  tdec.prefill_into_slots(tp, tc, ts, torch.from_numpy(prompt), tcd, torch.zeros(1, dtype=torch.int32), torch.from_numpy(lens))
  first = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
  rows = (np.array([5], np.int32), np.array([True]), np.array([2], np.int32), np.zeros(1, np.float32))
  jout = jdec.fused_spec_paged_batch_decode(jp, jc, js, jp, jc, js, jnp.asarray(first), jpool, jcd, jnp.asarray(bt), *map(jnp.asarray, rows), 3, 2, page_size=PS)
  tout = tdec.fused_spec_paged_batch_decode(tp, tc, ts, tp, tc, ts, torch.from_numpy(first), tpool, tcd, torch.from_numpy(bt), *map(torch.from_numpy, rows), 3, 2, page_size=PS)
  n = int(tout[1][0])
  assert n == int(jout[1][0]) == 9 and int(tout[2][0]) == int(jout[2][0]) == 6
  assert tout[0][0, :n].tolist() == np.asarray(jout[0])[0, :n].tolist()


def test_sampled_rows_run_plain_and_draw_the_plain_chunks_tokens(models):
  """A spec chunk whose sampled rows are given depth (the scheduler gives
  them 0) accepts nothing for them: one token per round, drawn from the
  window's first position with one draw of the generator per round, so for
  the same seed they are the plain chunk's tokens. Greedy rows beside them
  are the plain chunk's greedy tokens too."""
  _, tc, _, ts, _, tp = models["random"]
  op, _, tpool = _spec_case(models, "accepting")
  temps = torch.tensor([0.9, 0.0, 1.3])
  args = (torch.from_numpy(op["first"]),)
  rest = (torch.from_numpy(op["bt"]), torch.from_numpy(op["positions"]), torch.from_numpy(op["active"]))
  plain_pool = {k: v.clone() for k, v in tpool.items()}
  plain, _, _, _ = tdec.fused_paged_batch_decode(tp, tc, ts, *args, plain_pool, *rest, temps, 6, page_size=PS, generator=torch.Generator().manual_seed(21))
  spec = tdec.fused_spec_paged_batch_decode(
    tp, tc, ts, None, None, None, *args, tpool, None, *rest, torch.tensor([3, 3, 3], dtype=torch.int32), temps, 6, 3, page_size=PS,
    generator=torch.Generator().manual_seed(21),
  )
  buf, counts = spec[0], spec[1]
  for i in (0, 2):
    assert int(counts[i]) == 6
    assert torch.equal(buf[i, :6], plain[i])
  assert torch.equal(buf[1, :6], plain[1])  # greedy identity on the zero proposals


# ------------------------------------------------------------------ server


def _spy(server, log):
  """Record every decode dispatch: ("spec", depth cap, per-row depths,
  proposing rows) or ("plain",) / ("mixed",)."""
  for name in ("spec_paged_batch_decode", "paged_batch_decode", "mixed_paged_batch_decode"):
    orig = getattr(server.ops, name)

    def spy(*args, _orig=orig, _name=name, **kw):
      if _name == "spec_paged_batch_decode":
        pc = kw.get("prop_counts")
        log.append(("spec", int(args[10]), tuple(np.asarray(args[6]).tolist()), None if pc is None else tuple((np.asarray(pc) > 0).tolist())))
      else:
        log.append(("mixed" if _name.startswith("mixed") else "plain",))
      return _orig(*args, **kw)

    setattr(server.ops, name, spy)


SPEC_COUNTERS = [(name, prop) for name in ("spec_accepted_tokens_total", "spec_proposed_tokens_total") for prop in ("ngram", "plain")]


def _counters(metrics) -> list:
  return [metrics.counter_value(name, labels={"proposer": prop}) for name, prop in SPEC_COUNTERS]


def _server(model, pkg: str, **kw):
  jc, tc, js, ts, jp, tp = model
  if pkg == "jax":
    engine = JaxShardedInferenceEngine(use_local_mesh=False)
    engine.load_test_model(js, jc, jp)
    return JaxBatchedServer(engine, **kw)
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(ts, tc, tp)
  return BatchedServer(engine, **kw)


def _submit(server, rid, prompt, max_tokens, emit, eos=(), priority="standard", temp=0.0):
  return server.submit(rid, np.asarray(prompt, np.int32), max_tokens=max_tokens, temp=temp, top_k=35, eos_ids=eos, emit=emit, priority=priority)


def _run(model, pkg: str, scenario: str, lookahead: bool) -> tuple:
  """Serve one scenario; returns (tokens, dispatch log, counter deltas)."""
  metrics = jmetrics if pkg == "jax" else tmetrics
  streams: dict = {}

  def emit(rid, toks, fin):
    streams.setdefault(rid, []).extend(toks)

  if scenario == "preempt":
    qos = (jqos if pkg == "jax" else tqos).QosPolicy((jqos if pkg == "jax" else tqos).QosConfig(aging_s=10_000.0))
    server = _server(model, pkg, n_slots=1, chunk=2, lookahead=lookahead, qos=qos)
  else:
    server = _server(model, pkg, n_slots=4, chunk=4, lookahead=lookahead)
  log: list = []
  _spy(server, log)
  before = _counters(metrics)

  async def run():
    if scenario == "preempt":
      started = asyncio.Event()

      def emit_bg(rid, toks, fin):
        emit(rid, toks, fin)
        if len(streams[rid]) >= 4:
          started.set()

      bg = asyncio.create_task(_submit(server, "bg", REPETITIVE[0], 30, emit_bg, priority="batch"))
      await asyncio.wait_for(started.wait(), timeout=60)
      vip = await asyncio.wait_for(_submit(server, "vip", REPETITIVE[1], 12, emit, priority="interactive"), timeout=60)
      return [await asyncio.wait_for(bg, timeout=60), vip]
    if scenario == "nonrepetitive":
      rng = np.random.default_rng(31)
      prompts = [rng.integers(0, 256, int(n)).tolist() for n in (9, 14, 5, 21)]
      return await asyncio.gather(*(_submit(server, f"r{i}", p, 40, emit) for i, p in enumerate(prompts)))
    eos = (230,) if scenario == "eos" else ()  # the echo model's correction after an accepted run of 21s (row 1)
    return await asyncio.gather(*(_submit(server, f"r{i}", p, 40, emit, eos=eos) for i, p in enumerate(REPETITIVE)))

  outs = asyncio.run(run())
  rids = ["bg", "vip"] if scenario == "preempt" else [f"r{i}" for i in range(len(outs))]
  assert [streams[rid] for rid in rids] == outs
  assert all(s is None for s in server.slots) and server.allocator.audit()["referenced"] == 0
  server.shutdown()
  return outs, log, [a - b for a, b in zip(_counters(metrics), before)]


@pytest.mark.parametrize("lookahead", [True, False])
@pytest.mark.parametrize("scenario,quant", [("repetitive", ""), ("repetitive", "int8"), ("repetitive", "int4"), ("nonrepetitive", ""), ("eos", ""), ("preempt", "")])
def test_default_server_speculates_like_the_reference(models, defaults, scenario, quant, lookahead):
  defaults.setenv("XOT_TPU_KV_QUANT", quant)
  model = models["random" if scenario == "nonrepetitive" else "echo"]
  got, want = _run(model, "port", scenario, lookahead), _run(model, "jax", scenario, lookahead)
  assert got[0] == want[0]  # greedy tokens
  assert got[1] == want[1]  # spec / plain dispatches, depth caps, per-row depths, proposing rows
  assert got[2] == want[2]  # accepted / proposed tokens by proposer
  spec = [d for d in got[1] if d[0] == "spec"]
  assert spec, "no spec dispatch"
  accepted = got[2][0]
  if scenario in ("repetitive", "preempt"):
    assert accepted >= 32  # accepted runs carry most of the stream
  if scenario == "nonrepetitive":
    assert got[1][-3:] == [("plain",)] * 3  # the rows fell back to plain chunks
  if scenario == "eos":
    stopped = [out for out in got[0] if 230 in out]
    assert stopped and all(out[-1] == 230 and len(out) < 40 for out in stopped)
  if scenario == "preempt":
    assert [len(o) for o in got[0]] == [30, 12]


@pytest.mark.parametrize("knob", ["XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM"])
def test_spec_off_knobs_dispatch_no_spec_chunk(models, defaults, knob):
  defaults.setenv(knob, "0")
  got, want = _run(models["echo"], "port", "repetitive", True), _run(models["echo"], "jax", "repetitive", True)
  assert got[0] == want[0] and got[1] == want[1]
  assert got[1] and all(d == ("plain",) for d in got[1])
  assert got[2] == want[2] == [0.0] * 4


@pytest.mark.parametrize("lookahead", [True, False])
def test_sampled_rows_stay_at_depth_zero_in_the_server(models, defaults, lookahead):
  """Greedy repetitive rows speculate beside a sampled row, which every spec
  dispatch gives depth 0; its tokens are those of the same server with
  ``XOT_TPU_SPEC_BATCH=0`` (one draw per round, as one per plain step)."""
  outs = {}
  for spec in (True, False):
    if not spec:
      defaults.setenv("XOT_TPU_SPEC_BATCH", "0")
    server, log = _server(models["echo"], "port", n_slots=4, chunk=4, lookahead=lookahead), []
    _spy(server, log)

    async def run(server=server):
      subs = [_submit(server, f"r{i}", p, 24, lambda *a: None) for i, p in enumerate(REPETITIVE[:3])]
      subs.append(_submit(server, "s", [5, 6, 7, 8, 9], 24, lambda *a: None, temp=0.8))
      return await asyncio.gather(*subs)

    outs[spec] = asyncio.run(run())
    if spec:
      spec_log = [d for d in log if d[0] == "spec"]
      assert spec_log and all(d[2][3] == 0 for d in spec_log)
  assert outs[True] == outs[False]


def test_failed_spec_dispatch_fails_its_requests(models, defaults):
  """A spec dispatch that raises fails the requests in flight: the server
  does not serve them through plain chunks instead, and it serves the next
  request."""
  server = _server(models["echo"], "port", n_slots=4, chunk=4)

  def broken(*args, **kw):
    raise RuntimeError("spec launch failed")

  server.ops.spec_paged_batch_decode = broken

  async def run():
    results = await asyncio.gather(*(_submit(server, f"r{i}", p, 20, lambda *a: None) for i, p in enumerate(REPETITIVE)), return_exceptions=True)
    del server.ops.spec_paged_batch_decode
    after = await _submit(server, "after", REPETITIVE[0], 6, lambda *a: None)
    return results, after

  results, after = asyncio.run(run())
  assert results and all(isinstance(r, RuntimeError) and "spec launch failed" in str(r) for r in results)
  assert len(after) == 6


# ------------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_spec"))


def test_daemon_metrics_show_the_spec_path(tiny_dir, defaults):
  for k, v in {"XOT_TPU_MODEL_DIR": str(tiny_dir), "XOT_TPU_PLATFORM": "cpu", "XOT_TPU_BATCHED": "1"}.items():
    defaults.setenv(k, v)
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--temp", "0.0", "--max-generate-tokens", "40", "--node-id", "test"])
  body = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "hello world hello world hello world hello world"}]}

  async def run():
    node, api, engine, _ = tmain.build_components(args)
    server = await api.run(host="127.0.0.1", port=port)
    try:
      req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
      status = await asyncio.to_thread(lambda: urllib.request.urlopen(req, timeout=120).status)
      return status, await asyncio.to_thread(lambda: urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60).read().decode())
    finally:
      server.close()
      await server.wait_closed()

  status, text = asyncio.run(run())
  assert status == 200
  lines = text.splitlines()
  assert any(line.startswith('xot_tpu_decode_chunks_total{path="spec"}') for line in lines), text
  assert "xot_tpu_kv_draft_bytes 0" in lines and "xot_tpu_kv_draft_pages_equivalent 0" in lines
