"""Mixed prefill+decode ticks in the port against the JAX package, on the
CPU, on identical weights (JAX ``init_shard_params`` → numpy →
``params_from_jax``; 2 layers, width 64, 8-token pages):

- ``select_mixed_budget`` equals the reference's on a grid of (cap, burn,
  residents, backlog) points, free and pinned by ``XOT_TPU_MIXED_BUDGET``;
- ``fused_mixed_paged_batch_decode``: greedy tokens identical, the slice's
  K/V in the pool within rtol = atol = 2e-4 (quantized pools: equal codes
  up to one rounding step, scales within the tolerance), pages outside the
  slice untouched, and the logits of a final prefill over the slice's
  pages within 2e-4 of the reference's over the same pages — for
  bf16-layout, int8 and int4 KV;
- the port's ``BatchedServer`` at the defaults (speculation, QoS, mixed
  ticks and the host KV tier on, a pinned budget) against the JAX
  ``BatchedServer`` at the same defaults: identical greedy tokens and
  the identical sequence of slices, lookahead on and off, with the mixed
  program dispatched; mixed-on tokens equal mixed-off tokens; a slice
  shorter than 16 tokens pads to 16 inside the window (K1's shapes on a
  card); a failing mixed dispatch fails its requests instead of falling
  back."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.inference import paging as jpaging
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu_torch.inference import paging as tpaging
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import MIXED_MIN_PAD, BatchedServer
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.ops import paged

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
PS = 8
QUANTS = ["", "int8", "int4"]
# The reference's defaults: speculation, QoS, mixed ticks and the KV tier
# on (the suite's conftest pins XOT_TPU_SPEC_NGRAM=0, so it is unset here).
DEFAULT_KNOBS = {}
UNSET = ("XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_SLO", "XOT_TPU_MIXED_BUDGET", "XOT_TPU_KV_QUANT", "XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM")


@pytest.fixture(scope="module")
def model():
  jc = jconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  tc = tconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  jshard, tshard = JShard("tiny", 0, 1, 2), Shard("tiny", 0, 1, 2)
  jp = jdec.init_shard_params(jax.random.PRNGKey(5), jc, jshard)
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, tshard)
  return jc, tc, jshard, tshard, jp, tp


@pytest.fixture
def defaults(monkeypatch):
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  for k, v in {**DEFAULT_KNOBS, "XOT_TPU_PAGE_SIZE": str(PS), "XOT_TPU_PREFILL_CHUNK": "16", "XOT_TPU_MIXED_BUDGET": "8"}.items():
    monkeypatch.setenv(k, v)
  return monkeypatch


# ------------------------------------------------------------- budget policy

CAPS = (16, 100, 2048)
BURNS = (None, 0.0, 0.5, 0.999, 1.0, 1.9, 2.0, 3.99, 4.0, 40.0)


@pytest.mark.parametrize("pin", ["", "8", "5000", "0"])
def test_select_mixed_budget_matches_reference(monkeypatch, pin):
  if pin:
    monkeypatch.setenv("XOT_TPU_MIXED_BUDGET", pin)
  else:
    monkeypatch.delenv("XOT_TPU_MIXED_BUDGET", raising=False)
  for cap in CAPS:
    for burn in BURNS:
      for residents in (0, 1, 8):
        for backlog in (1, 2, 5):
          args = (cap, burn, residents, backlog)
          assert tpaging.select_mixed_budget(*args) == jpaging.select_mixed_budget(*args), args
  assert tpaging._MIXED_BUDGET_TABLE == jpaging._MIXED_BUDGET_TABLE


@pytest.mark.parametrize("value,on", [(None, True), ("1", True), ("0", False), ("false", False)])
def test_mixed_tick_knob_matches_reference(monkeypatch, value, on):
  if value is None:
    monkeypatch.delenv("XOT_TPU_MIXED_TICK", raising=False)
  else:
    monkeypatch.setenv("XOT_TPU_MIXED_TICK", value)
  assert tpaging.mixed_tick_enabled() is on and jpaging.mixed_tick_enabled() is on


# ------------------------------------------------------------ fused program


def _assert_pool_close(tpool, jpool, quant, pages):
  """The two pools agree on ``pages``: floats within TOL; quantized codes
  within one rounding step (f32 K/V differ in the last bits between the two
  packages) and their scales within TOL."""
  for key in jpool:
    got, want = tpool[key].numpy()[:, pages], np.asarray(jpool[key])[:, pages]
    if quant and key in ("k", "v"):
      if quant == "int4":  # two signed nibbles per byte
        got = np.stack([(got.astype(np.int16) << 12 >> 12), got.astype(np.int16) >> 4], -1)
        want = np.stack([(want.astype(np.int16) << 12 >> 12), want.astype(np.int16) >> 4], -1)
      assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, key
    else:
      np.testing.assert_allclose(got, want, **TOL, err_msg=key)


@pytest.mark.parametrize("quant", QUANTS)
def test_fused_mixed_program_matches_jax(model, quant):
  """Two decode rows resident (prompts 11 and 19 tokens) and one admission
  whose first two pages are prefilled: one fused call decodes 5 steps and
  prefills the admission's tokens [16, 29) (pad 16) into its pages. Then a
  final prefill of [29, 34) over the slice's pages samples the first token."""
  jc, tc, js, ts, jp, tp = model
  rng = np.random.default_rng(17)
  n_pages = 24
  jpool = jpaged.init_paged_pool(jc, 2, n_pages, PS, quant=quant)
  tpool = paged.init_paged_pool(tc, 2, n_pages, PS, quant=quant)
  prompt = rng.integers(0, 256, 34).astype(np.int32)
  dec_bt = np.array([[3, 1, 9, 4], [12, 2, 7, 20]], np.int32)
  adm_bt = np.array([[5, 17, 11, 6, 14, 0, 0, 0]], np.int32)
  # Seed: the two decode rows' prompts and the admission's first 16 tokens.
  seed = np.zeros((3, 32), np.int32)
  lens = np.array([11, 19, 16], np.int32)
  seed[0, :11] = rng.integers(0, 256, 11)
  seed[1, :19] = rng.integers(0, 256, 19)
  seed[2, :16] = prompt[:16]
  seed_bt = np.zeros((3, 8), np.int32)
  seed_bt[:2, :4] = dec_bt
  seed_bt[2] = adm_bt[0]
  z = np.zeros(3, np.int32)
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(seed), jpool, jnp.asarray(seed_bt), jnp.asarray(z), jnp.asarray(lens), PS)
  tl, tpool = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(seed), tpool, torch.from_numpy(seed_bt), torch.from_numpy(z), torch.from_numpy(lens), PS)
  before = {k: v.clone() for k, v in tpool.items()}
  first = np.argmax(np.asarray(jl)[:2], -1).astype(np.int32)[:, None]
  assert (first[:, 0] == tl[:2].argmax(-1).numpy()).all()
  pf_tokens = np.zeros((1, 16), np.int32)
  pf_tokens[0, :13] = prompt[16:29]
  pf_bt = adm_bt[:, :4]  # the window of [0, 16 + pad)
  pf_prefix, pf_end = np.array([16], np.int32), np.array([29], np.int32)
  positions, active, temps = lens[:2].copy(), np.array([True, True]), np.zeros(2, np.float32)
  jt, jnext, jpos, jpool = jdec.fused_mixed_paged_batch_decode(
    jp, jc, js, jnp.asarray(first), jpool, jnp.asarray(dec_bt), jnp.asarray(positions), jnp.asarray(active), jnp.asarray(temps),
    jnp.asarray(pf_tokens), jnp.asarray(pf_bt), jnp.asarray(pf_prefix), jnp.asarray(pf_end), 5, page_size=PS,
  )
  tt, tnext, tpos, tpool = tdec.fused_mixed_paged_batch_decode(
    tp, tc, ts, torch.from_numpy(first), tpool, torch.from_numpy(dec_bt), torch.from_numpy(positions), torch.from_numpy(active), torch.from_numpy(temps),
    torch.from_numpy(pf_tokens), torch.from_numpy(pf_bt), torch.from_numpy(pf_prefix), torch.from_numpy(pf_end), 5, page_size=PS,
  )
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
  np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
  np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
  # The slice's pages (positions 16..31) and the decode rows' pages agree;
  # every other page — the admission's prefix and its pages past the
  # slice's window — is byte-for-byte what it was.
  touched = [17, 11, 6] + list(dec_bt.reshape(-1))
  _assert_pool_close(tpool, jpool, quant, touched)
  untouched = [p for p in range(1, n_pages) if p not in touched]
  for key in tpool:
    assert torch.equal(tpool[key][:, untouched], before[key][:, untouched]), key
  # The final slice reads the mixed slice's K/V: the reference's final
  # prefill over the port's pool gives the port's logits. (Over its own
  # pool too where no code differs: one int4 code a rounding step apart
  # moves these logits by ~6e-3, which is the quantizer, not the slice.)
  fin = np.zeros((1, 8), np.int32)
  fin[0, :5] = prompt[29:34]
  fin_bt = adm_bt[:, :8]
  port_pool = {k: jnp.asarray(v.numpy()) for k, v in tpool.items()}
  same_codes = not quant or all(np.array_equal(tpool[k].numpy(), np.asarray(jpool[k])) for k in ("k", "v"))
  tfl, _ = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(fin), tpool, torch.from_numpy(fin_bt), torch.tensor([29], dtype=torch.int32), torch.tensor([34], dtype=torch.int32), PS)
  for pool in [port_pool] + ([jpool] if same_codes else []):
    jfl, _ = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(fin), pool, jnp.asarray(fin_bt), jnp.asarray([29], jnp.int32), jnp.asarray([34], jnp.int32), PS)
    np.testing.assert_allclose(tfl.numpy(), np.asarray(jfl), **TOL)


@pytest.mark.parametrize("quant", QUANTS)
def test_mixed_slice_writes_what_an_alternating_chunk_writes(model, quant):
  """Within the port: the pool after a mixed slice over tokens [16, 29)
  holds the same K/V for those positions as after an alternating prefill
  chunk over the same tokens (quantized modes quantize it the same way)."""
  _, tc, _, ts, _, tp = model
  rng = np.random.default_rng(23)
  prompt = rng.integers(0, 256, 29).astype(np.int32)
  bt = np.array([[5, 7, 2, 9]], np.int32)
  pools = []
  for mixed in (True, False):
    pool = paged.init_paged_pool(tc, 2, 12, PS, quant=quant)
    tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(prompt[None, :16]), pool, torch.from_numpy(bt), torch.tensor([0], dtype=torch.int32), torch.tensor([16], dtype=torch.int32), PS)
    if mixed:
      pf = np.zeros((1, 16), np.int32)
      pf[0, :13] = prompt[16:]
      tdec.fused_mixed_paged_batch_decode(
        tp, tc, ts, torch.tensor([[1]], dtype=torch.int32), pool, torch.zeros((1, 4), dtype=torch.int32), torch.tensor([0], dtype=torch.int32),
        torch.tensor([False]), torch.zeros(1), torch.from_numpy(pf), torch.from_numpy(bt), torch.tensor([16], dtype=torch.int32), torch.tensor([29], dtype=torch.int32), 2, page_size=PS,
      )
    else:
      chunk = np.zeros((1, 112), np.int32)  # the admission dispatch's pad: the 128 bucket, capped at the window
      chunk[0, :13] = prompt[16:]
      wide = np.zeros((1, 16), np.int32)
      wide[0, :4] = bt[0]
      tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(chunk), pool, torch.from_numpy(wide), torch.tensor([16], dtype=torch.int32), torch.tensor([29], dtype=torch.int32), PS)
    pools.append(pool)
  for key in pools[0]:
    # Positions 16..28: all of page 2 (16..23) and slots 0..4 of page 9.
    assert torch.equal(pools[0][key][:, 2], pools[1][key][:, 2]), key
    assert torch.equal(pools[0][key][:, 9, :, :5], pools[1][key][:, 9, :, :5]), key


# ------------------------------------------------------------------ server


def _requests():
  """Nine greedy requests for two slots: a 40-token and a 61-token prompt
  that arrive while rows are resident (sliced into the decode ticks), a
  shared 16-token prefix, max_tokens 1."""
  rng = np.random.default_rng(29)
  prefix = rng.integers(0, 256, 2 * PS).tolist()
  prompts = [
    rng.integers(0, 256, 12).tolist(), prefix + rng.integers(0, 256, 5).tolist(), rng.integers(0, 256, 40).tolist(),
    prefix + [7], rng.integers(0, 256, 61).tolist(), [5, 6, 7], prefix + rng.integers(0, 256, 27).tolist(),
    rng.integers(0, 256, 9).tolist(), rng.integers(0, 256, 33).tolist(),
  ]
  max_tokens = [9, 11, 6, 7, 5, 1, 8, 12, 6]
  return prompts, max_tokens


def _spy(server, slices):
  orig = server.ops.mixed_paged_batch_decode

  def spy(*args, **kw):
    slices.append((int(np.asarray(kw["pf_prefix"])[0]), int(np.asarray(kw["pf_end"])[0])))
    return orig(*args, **kw)

  server.ops.mixed_paged_batch_decode = spy


async def _serve(server, prompts, max_tokens):
  streams: dict = {}

  def emit(rid, toks, fin):
    streams.setdefault(rid, []).extend(toks)

  outs = await asyncio.gather(*(server.submit(f"r{i}", np.asarray(p, np.int32), max_tokens=m, temp=0.0, top_k=35, eos_ids=(), emit=emit) for i, (p, m) in enumerate(zip(prompts, max_tokens))))
  assert [streams[f"r{i}"] for i in range(len(prompts))] == outs
  return outs


def _jax_server(model, lookahead):
  jc, _, js, _, jp, _ = model
  engine = JaxShardedInferenceEngine(use_local_mesh=False)
  engine.load_test_model(js, jc, jp)
  return JaxBatchedServer(engine, n_slots=2, chunk=3, lookahead=lookahead)


def _port_server(model, lookahead, **kw):
  _, tc, _, ts, _, tp = model
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(ts, tc, tp)
  return BatchedServer(engine, n_slots=2, chunk=3, lookahead=lookahead, **kw)


@pytest.mark.parametrize("lookahead", [True, False])
@pytest.mark.parametrize("quant", QUANTS)
def test_default_server_matches_jax_server(model, defaults, quant, lookahead):
  defaults.setenv("XOT_TPU_KV_QUANT", quant)
  prompts, max_tokens = _requests()
  jserver, want_slices = _jax_server(model, lookahead), []
  _spy(jserver, want_slices)
  want = asyncio.run(_serve(jserver, prompts, max_tokens))
  server, slices = _port_server(model, lookahead), []
  assert server.qos is not None and server.mixed  # the defaults: QoS and mixed ticks on
  _spy(server, slices)
  got = asyncio.run(_serve(server, prompts, max_tokens))
  assert got == want
  assert len(slices) >= 2 and slices == want_slices  # the mixed program ran, cutting the reference's slices
  assert all(e - s <= 8 for s, e in slices)  # the pinned budget
  assert server.allocator.audit()["referenced"] == 0 and not server.busy()


@pytest.mark.parametrize("lookahead", [True, False])
def test_mixed_ticks_do_not_change_tokens(model, defaults, lookahead):
  prompts, max_tokens = _requests()
  server, slices = _port_server(model, lookahead), []
  _spy(server, slices)
  on = asyncio.run(_serve(server, prompts, max_tokens))
  defaults.setenv("XOT_TPU_MIXED_TICK", "0")
  off_server = _port_server(model, lookahead)
  assert not off_server._mixed_active()
  off = asyncio.run(_serve(off_server, prompts, max_tokens))
  assert slices and on == off


@pytest.mark.parametrize("lookahead", [True, False])
def test_short_slices_pad_to_k1_shapes(model, defaults, lookahead):
  """Slices shorter than MIXED_MIN_PAD (the pinned budget is 8) still pad
  to a power of two of at least 16 inside the window, so on a card every
  slice prefills through K1; the tokens stay the alternating schedule's."""
  prompts, max_tokens = _requests()
  server, shapes = _port_server(model, lookahead), []
  orig = server.ops.mixed_paged_batch_decode

  def spy(*args, **kw):
    shapes.append((int(kw["pf_prefix"][0]), int(kw["pf_end"][0]), kw["pf_tokens"].shape[1]))
    return orig(*args, **kw)

  server.ops.mixed_paged_batch_decode = spy
  on = asyncio.run(_serve(server, prompts, max_tokens))
  assert any(end - start < 8 for start, end, _ in shapes)  # the last slice before the final cap is short
  for start, end, pad in shapes:
    room = server.max_seq - start
    assert pad & (pad - 1) == 0 and end - start <= pad <= room, (start, end, pad)
    assert pad >= min(MIXED_MIN_PAD, 1 << (room.bit_length() - 1)), (start, end, pad)
  defaults.setenv("XOT_TPU_MIXED_TICK", "0")
  assert on == asyncio.run(_serve(_port_server(model, lookahead), prompts, max_tokens))


def test_failed_mixed_dispatch_fails_its_requests(model, defaults):
  """A mixed dispatch that raises fails the requests in flight; the server
  does not fall back to alternating ticks, and it serves the next request."""
  prompts, max_tokens = _requests()
  server = _port_server(model, True)

  def broken(*args, **kw):
    raise RuntimeError("mixed launch failed")

  server.ops.mixed_paged_batch_decode = broken

  async def run():
    results = await asyncio.gather(*(server.submit(f"r{i}", np.asarray(p, np.int32), max_tokens=m, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None) for i, (p, m) in enumerate(zip(prompts, max_tokens))), return_exceptions=True)
    after = await server.submit("after", np.asarray(prompts[0], np.int32), max_tokens=3, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None)
    return results, after

  results, after = asyncio.run(run())
  failed = [r for r in results if isinstance(r, Exception)]
  assert failed and all("mixed launch failed" in str(r) for r in failed)
  assert len(after) == 3
