"""The batched server's captured programs (models/decoder.py
``BatchedPrograms``, routed by inference/batch_ops.py for the pool
``init_pool`` makes) against the JAX package, on the CPU, on identical
weights (JAX ``init_shard_params`` → numpy → ``params_from_jax``; 2 layers,
width 64, f32, 8-token pages). On the CPU each program runs its body
eagerly through the same static buffers a replay reads on the card, so
these cases hold the plumbing: fills, output buffers, chaining, seeding,
signatures.

- Dispatch by dispatch against the reference's functions, per KV pool type
  (bf16 layout, int8, int4): an admission prefill, a plain chunk, a spec
  chunk with n-gram proposals and a mixed chunk, chained as the scheduler
  chains them: greedy tokens (and counts, positions) identical, the logits
  each dispatch samples from (the prefill's last tokens, a chunk's first
  step, a spec chunk's first verify position) within rtol = atol = 2e-4,
  the written pages within 2e-4 (quantized codes within one step).
- Refilled buffers: three rounds of the server's dispatches
  (``chip_smoke.batched_traffic``: other rows, positions, tables,
  proposals and keys each round, greedy and sampled rows) equal the eager
  functions on an identical pool, bit for bit.
- Chains across families (plain → spec → plain and others): a dispatch fed
  the previous one's device-resident token and positions equals the same
  dispatch fed host copies (the synchronous tick).
- The server at the defaults against the JAX server on the same traffic:
  per family the same builds (ledger compiles), one graph per build, and
  the same greedy tokens; ``POST /v1/warmup`` twice (the endpoint's
  handler) builds nothing the second time, in both servers."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_programs import OpsEngine
from test_torch_spec_batch import REPETITIVE, _assert_pages_close, _model
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.models import decoder as jdec
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu.utils.programs import ledger as jledger
from xotorch_support_jetson_tpu_torch.inference.batch_ops import DecoderBatchOps
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import decoder as tdec
from xotorch_support_jetson_tpu_torch.ops import paged
from xotorch_support_jetson_tpu_torch.utils.programs import ledger

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
PS = 8
FAMILIES = ("prefill.pages_many_sampled", "decode.paged_batch", "decode.mixed_paged_batch", "spec.paged_batch")
UNSET = (
  "XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM", "XOT_TPU_SPEC_NGRAM_N", "XOT_TPU_SPEC_NGRAM_MAX", "XOT_TPU_SPEC_REPROBE", "XOT_TPU_SPEC_BATCH_GAMMA",
  "XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_SLO", "XOT_TPU_MIXED_BUDGET", "XOT_TPU_KV_QUANT", "XOT_TPU_PREFILL_CHUNK", "XOT_TPU_BATCH_PAGES",
)


@pytest.fixture(scope="module")
def models():
  return {"echo": _model(True), "random": _model(False)}


@pytest.fixture
def defaults(monkeypatch):
  """The reference's batched defaults on both sides, 8-token pages, and
  both ledgers forgotten around the case."""
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  monkeypatch.setenv("XOT_TPU_PAGE_SIZE", str(PS))
  ledger.reset()
  jledger.reset()
  yield monkeypatch
  ledger.reset()
  jledger.reset()


def _ops(model) -> DecoderBatchOps:
  _, tc, _, ts, _, tp = model
  return DecoderBatchOps(OpsEngine(tc, ts, tp, device="cpu"))


def _spy_rows(monkeypatch) -> list:
  """Record the logits every sampling epilogue of the port's programs
  reads (the bodies run eagerly on the CPU)."""
  seen = []
  plain = tdec._next_token_batched

  def spy(rows, *a, **kw):
    seen.append(rows.detach().clone())
    return plain(rows, *a, **kw)

  monkeypatch.setattr(tdec, "_next_token_batched", spy)
  return seen


def _jcopy(pool):
  return jax.tree.map(jnp.copy, pool)


# ------------------------------------------------- dispatch by dispatch


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_programs_match_the_reference_dispatch_by_dispatch(models, defaults, quant):
  jc, tc, js, ts, jp, tp = models["random"]
  rng = np.random.default_rng(13)
  B, mp, n_pages = 4, 12, 4 * 12 + 4
  jpool = jpaged.init_paged_pool(jc, 2, n_pages, PS, quant=quant)
  ops = _ops(models["random"])
  defaults.setenv("XOT_TPU_KV_QUANT", quant)
  tpool = ops.init_pool(n_pages, PS)
  progs = ops.programs
  seen = _spy_rows(defaults)
  key = jax.random.PRNGKey(0)
  bt = (np.arange(B * mp, dtype=np.int32).reshape(B, mp) + 1)[rng.permutation(B)]
  lens = np.array([19, 11, 27, 1], np.int32)
  active = np.array([True, True, True, False])
  temps, top_ks = np.zeros(B, np.float32), np.ones(B, np.int32)
  a = jnp.asarray

  # The admission prefill: three prompts and the bucket's padding row.
  tokens = np.zeros((B, 32), np.int32)
  for i in range(3):
    tokens[i, : lens[i]] = rng.integers(0, 256, lens[i])
  bts = np.where(active[:, None], bt[:, :4], 0).astype(np.int32)
  zeros = np.zeros(B, np.int32)
  want_logits, _ = jdec.prefill_into_pages_many(jp, jc, js, a(tokens), _jcopy(jpool), a(bts), a(zeros), a(lens), PS)
  want, jpool = jdec.prefill_into_pages_many_sampled(jp, jc, js, a(tokens), jpool, a(bts), a(zeros), a(lens), PS, a(temps), a(top_ks), key, 64)
  got, tpool = ops.prefill_into_pages_many_sampled(tokens, tpool, bts, zeros, lens, PS, temps, top_ks, 64, 1)
  np.testing.assert_array_equal(got[:3].numpy(), np.asarray(want)[:3])
  np.testing.assert_allclose(seen[-1][:3].numpy(), np.asarray(want_logits)[:3], **TOL)

  # A plain chunk of 3 steps.
  tok = np.asarray(want).reshape(B, 1).astype(np.int32)
  tok[3] = 5
  jbt = np.where(active[:, None], bt, 0)
  want_logits, _ = jdec.paged_decode_forward(jp, jc, js, a(tok), a(lens[:, None]), _jcopy(jpool), a(jbt), PS, False)
  n = len(seen)
  jt, jnext, jpos, jpool = jdec.fused_paged_batch_decode(jp, jc, js, a(tok), jpool, a(bt), a(lens), a(active), a(temps), 3, top_k=a(top_ks), page_size=PS, key=key)
  tt, tnext, tpos, tpool = ops.paged_batch_decode(tok, tpool, bt, lens, active, temps, top_ks, 3, 64, PS, 2)
  np.testing.assert_array_equal(tt.numpy()[:3], np.asarray(jt)[:3])
  np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
  np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
  np.testing.assert_allclose(seen[n][:3].numpy(), np.asarray(want_logits)[:3, 0], **TOL)

  # A spec chunk with n-gram proposals, chained on the plain chunk's
  # device-resident next token (host positions, as the scheduler's plan).
  R, G = 2, 3
  width = R * (G + 1) + G
  props = rng.integers(0, 256, (B, width)).astype(np.int32)
  prop_counts = np.array([width, 0, 6, 0], np.int32)
  gammas = np.array([G, 2, G, 0], np.int32)
  pos = np.asarray(jpos).astype(np.int32)
  d = np.where((prop_counts > 0)[:, None], props[:, :G], 0)
  window = np.concatenate([np.asarray(jnext), d], axis=1).astype(np.int32)
  wpos = (pos[:, None] + np.arange(G + 1)[None, :]).astype(np.int32)
  want_logits, _ = jdec.paged_window_forward(jp, jc, js, a(window), a(wpos), _jcopy(jpool), a(jbt), PS)
  n = len(seen)
  jout = jdec.fused_spec_paged_batch_decode(
    jp, jc, js, None, jc, js, jnext, jpool, None, a(bt), a(pos), a(active), a(gammas), a(temps), R, G, top_k=a(top_ks), page_size=PS, key=key, props=a(props), prop_counts=a(prop_counts),
  )
  tout = ops.spec_paged_batch_decode(tnext, tpool, None, bt, pos, active, gammas, temps, top_ks, R, G, 64, PS, 3, props=props, prop_counts=prop_counts)
  jpool, tpool = jout[5], tout[5]
  counts = np.asarray(jout[1])
  for i in range(B):
    np.testing.assert_array_equal(tout[0][i, : counts[i]].numpy(), np.asarray(jout[0])[i, : counts[i]])
  for t, j in zip(tout[1:5], jout[1:5]):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
  np.testing.assert_allclose(seen[n][:3].numpy(), np.asarray(want_logits)[:3, 0], **TOL)

  # A mixed chunk (a 12-token slice of a fourth prompt into the spare
  # pages), chained on the spec chunk's next token, host positions.
  pos = np.asarray(jout[4]).astype(np.int32)
  pf_tokens = np.zeros((1, 16), np.int32)
  pf_tokens[0, :12] = rng.integers(0, 256, 12)
  pf_bt = (np.arange(2, dtype=np.int32) + B * mp + 1)[None]
  pf = (a(pf_tokens), a(pf_bt), a(np.array([0], np.int32)), a(np.array([12], np.int32)))
  _, sliced = jdec.prefill_into_pages_many(jp, jc, js, pf[0], _jcopy(jpool), pf[1], pf[2], pf[3], PS)
  want_logits, _ = jdec.paged_decode_forward(jp, jc, js, jout[3], a(pos[:, None]), sliced, a(jbt), PS, False)
  n = len(seen)
  jt, jnext, jpos, jpool = jdec.fused_mixed_paged_batch_decode(jp, jc, js, jout[3], jpool, a(bt), a(pos), a(active), a(temps), *pf, 2, top_k=a(top_ks), page_size=PS, key=key)
  tt, tnext, tpos, tpool = ops.mixed_paged_batch_decode(
    tout[3], tpool, bt, pos, active, temps, top_ks, 2, 64, PS, 4, pf_tokens=pf_tokens, pf_bt=pf_bt, pf_prefix=np.array([0], np.int32), pf_end=np.array([12], np.int32),
  )
  np.testing.assert_array_equal(tt.numpy()[:3], np.asarray(jt)[:3])
  np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
  np.testing.assert_allclose(seen[n][:3].numpy(), np.asarray(want_logits)[:3, 0], **TOL)

  # The pages every active row wrote, and the admission's slice.
  end = np.asarray(jpos)
  for i in range(3):
    full = [int(p) for p in bt[i, : end[i] // PS]]
    _assert_pages_close(tpool, jpool, quant, full)
  _assert_pages_close(tpool, jpool, quant, [int(pf_bt[0, 0])])
  _assert_pages_close(tpool, jpool, quant, [int(pf_bt[0, 1])], slots=12 - PS)
  assert sorted(g.family for g in progs.graphs()) == sorted(FAMILIES)


# ------------------------------------------------------ refilled buffers


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_refilled_buffers_equal_the_eager_functions(models, defaults, quant):
  """Three rounds of the server's dispatches through the programs and
  through the eager functions on an identical pool: identical outputs and
  pools, one graph per family signature, refilled each round."""
  import chip_smoke

  defaults.setenv("XOT_TPU_KV_QUANT", quant)
  ops = _ops(models["random"])
  captured = ops.init_pool(4 * 8 + 3, PS)
  eager = {k: v.clone() for k, v in captured.items()}
  for seed in (3, 4, 5):
    kw = dict(page=PS, mp=8, steps=4, gamma=3, slice_tokens=12, slice_pad=16)
    got = chip_smoke.batched_traffic(ops, captured, seed, [21, 9 + seed, 30], **kw)
    want = chip_smoke.batched_traffic(ops, eager, seed, [21, 9 + seed, 30], **kw)
    for (kind, g), (_, w) in zip(got, want):
      assert all(np.array_equal(x, y) for x, y in zip(g, w)), (seed, kind)
  for k in captured:
    assert torch.equal(captured[k][:, 1:], eager[k][:, 1:]), k  # page 0 is the trash page
  graphs = [g.family for g in ops.programs.graphs()]
  assert sorted(graphs) == sorted([*FAMILIES, "spec.paged_batch"])  # spec with and without proposals
  snap = ledger.snapshot()["families"]
  assert {f: snap[f]["compiles"] for f in FAMILIES} == {f: graphs.count(f) for f in FAMILIES}


# -------------------------------------------------------------- chains


def _chain_step(ops, pool, kind, tok, pos, bt, active, key):
  """One dispatch of ``kind`` from (tok, pos); returns (next token, next
  positions, what the server reads of it)."""
  B = bt.shape[0]
  temps, top_ks = np.where(np.arange(B) == 1, 0.8, 0.0).astype(np.float32), np.where(np.arange(B) == 1, 5, 1).astype(np.int32)
  if kind == "spec":
    props = np.tile(np.arange(11, dtype=np.int32)[None] + 40, (B, 1))
    out = ops.spec_paged_batch_decode(tok, pool, None, bt, pos, active, np.array([3, 0, 2, 0], np.int32), temps, top_ks, 2, 3, 64, PS, key, props=props, prop_counts=np.array([11, 0, 4, 0], np.int32))
    counts = out[1].numpy()
    read = [np.where(np.arange(out[0].shape[1])[None] < counts[:, None], out[0].numpy(), -1), counts, out[2].numpy()]
    return out[3], out[4], read
  if kind == "mixed":
    pf = dict(pf_tokens=np.arange(16, dtype=np.int32)[None] + 3, pf_bt=np.array([[33, 34]], np.int32), pf_prefix=np.array([0], np.int32), pf_end=np.array([13], np.int32))
    toks, nxt, npos, _ = ops.mixed_paged_batch_decode(tok, pool, bt, pos, active, temps, top_ks, 3, 64, PS, key, **pf)
  else:
    toks, nxt, npos, _ = ops.paged_batch_decode(tok, pool, bt, pos, active, temps, top_ks, 4, 64, PS, key)
  return nxt, npos, [toks.numpy().copy()]


@pytest.mark.parametrize("chain", [("plain", "spec", "plain"), ("mixed", "plain", "spec"), ("spec", "spec", "mixed")], ids="-".join)
def test_chained_dispatches_equal_the_synchronous_tick(models, defaults, chain):
  """Each dispatch fed the previous one's device-resident next token (and
  a spec chunk's device positions) equals the same dispatches fed host
  copies, on identical pools."""
  reads = []
  for chained in (True, False):
    ops = _ops(models["random"])
    pool = ops.init_pool(4 * 8 + 3, PS)
    bt = np.arange(32, dtype=np.int32).reshape(4, 8) + 1
    active = np.array([True, True, True, False])
    tok = np.array([[7], [8], [9], [1]], np.int32)
    pos = np.array([5, 9, 3, 1], np.int32)
    for i in range(3):  # seed the rows' first pages
      ops.prefill_into_pages_many_sampled(np.arange(16, dtype=np.int32)[None] + i, pool, bt[i : i + 1, :2], np.zeros(1, np.int32), pos[i : i + 1], PS, np.zeros(1, np.float32), np.ones(1, np.int32), 64, 1)
    got = []
    for j, kind in enumerate(chain):
      nxt, npos, read = _chain_step(ops, pool, kind, tok, pos, bt, active, 10 + j)
      got += read
      if chained:  # the scheduler's chain: the device token; a spec chunk's device positions, else the plan's
        tok, pos = nxt, (npos if kind == "spec" else npos.numpy().copy())
      else:
        tok, pos = nxt.numpy().copy(), npos.numpy().copy()
    reads.append(got)
  assert all(np.array_equal(x, y) for x, y in zip(*reads))


# ------------------------------------------------ the server and warmup


def _servers(model, n_slots=2, chunk=3):
  jc, tc, js, ts, jp, tp = model
  je = JaxShardedInferenceEngine(use_local_mesh=False)
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(device="cpu")
  te.load_test_model(ts, tc, tp)
  return JaxBatchedServer(je, n_slots=n_slots, chunk=chunk), BatchedServer(te, n_slots=n_slots, chunk=chunk)


async def _traffic(server):
  """Repetitive prompts (the spec path), then long ones that arrive while
  rows decode (mixed slices), greedy."""
  first = [server.submit(f"r{i}", np.asarray(p, np.int32), max_tokens=14, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None) for i, p in enumerate(REPETITIVE[:2])]
  await asyncio.sleep(0)
  rng = np.random.default_rng(41)
  later = [server.submit(f"l{i}", rng.integers(0, 256, n).astype(np.int32), max_tokens=5, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None) for i, n in enumerate((40, 27, 9))]
  return await asyncio.gather(*first, *later)


def test_server_builds_match_the_reference_and_warmup_replays(models, defaults):
  """The JAX server and the port's at the defaults on the same traffic:
  greedy tokens identical, per family the same builds, one graph per build
  in the port; then ``warmup`` (what ``POST /v1/warmup`` runs) twice: the
  second builds nothing in either server, and captures no graph."""
  defaults.setenv("XOT_TPU_MIXED_BUDGET", "8")
  defaults.setenv("XOT_TPU_PREFILL_CHUNK", "16")
  jserver, tserver = _servers(models["echo"])

  async def run(server, led):
    out = await _traffic(server)
    builds = {f: led.compile_count(f) for f in FAMILIES}
    first = await server.warmup()
    before = {f: led.compile_count(f) for f in FAMILIES}
    second = await server.warmup()
    after = {f: led.compile_count(f) for f in FAMILIES}
    return out, builds, first, second, before, after, led.steady_compile_count()

  want = asyncio.run(run(jserver, jledger))
  got = asyncio.run(run(tserver, ledger))
  assert got[0] == want[0]
  assert got[1] == want[1] and all(got[1][f] for f in ("prefill.pages_many_sampled", "spec.paged_batch", "decode.mixed_paged_batch"))
  assert got[5] == got[4] and want[5] == want[4]  # the second warmup built nothing
  assert got[6] == want[6] == 0
  assert [(e["family"], e["warmed"]) for e in got[2]["manifest"]] == [(e["family"], e["warmed"]) for e in want[2]["manifest"]]
  graphs = [g.family for g in tserver.ops.programs.graphs()]
  assert {f: graphs.count(f) for f in FAMILIES} == {f: ledger.compile_count(f) for f in FAMILIES}
  tserver.shutdown()
  assert tserver.ops.programs is None  # the graphs went with the pool
