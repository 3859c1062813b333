"""The port's multi-LoRA serving against the JAX package's, on the CPU, at
f32 on ``tiny_test_config(n_layers=2)``: the per-row delta
(``_alora_delta``), the adapter registry on the same sequence of register /
acquire / unpin / host eviction, npz files crossing both ways, the decoder
hook on every batched program (the mixed tick's ``pf_adapter``, both spec
chunks with adapter rows, int8 and int4 weights, an MoE and a gemma2 tiny
model), the batched server (each row of a mixed-adapter batch token-equal
to the JAX server's and to its ``merge_lora`` solo reference on paged int8
KV and on the dense layout, lookahead on and off; no pin left), a solo
adapter session, preempt-resume keeping its adapter, ``XOT_TPU_LORA=0``
with a poisoned hook, ``XOT_TPU_LORA_DIR``, the 400 and ``/v1/adapters``
bodies, and the program ledger's build and dispatch counts with adapters
on. Greedy tokens are identical; logits within rtol = atol = 2e-4."""

import asyncio
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_lora_serving as ref
from test_torch_gemma2 import make_tiny_gemma2
from test_torch_moe import make_tiny_moe
from xotorch_support_jetson_tpu.inference import adapters as jadapters
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JBatchedServer
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec, loader as jloader
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquantize
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu.utils import programs as jprograms
from xotorch_support_jetson_tpu_torch.api import chatgpt_api as tapi
from xotorch_support_jetson_tpu_torch.inference import adapters as tadapters
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.qos import QosConfig, QosPolicy
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec, loader as tloader
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquantize
from xotorch_support_jetson_tpu_torch.ops import paged
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics as tm
from xotorch_support_jetson_tpu_torch.utils.programs import ledger

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
TC = tconfig.tiny_test_config(n_layers=2, max_seq_len=256, tied_embedding=True)
TS = Shard("m", 0, 1, 2)
TP = params_from_jax(jax.tree.map(np.asarray, ref.PARAMS), TC, TS)
PS = 8


def _port_engine(capacity: int = 4):
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(TS, TC, TP)
  reg = engine.enable_multi_lora(capacity=capacity, rank=ref.RANK)
  reg.register("a1", ref.ADAPTER_1)
  reg.register("a2", ref.ADAPTER_2)
  return engine, reg


@functools.lru_cache(maxsize=None)
def _refs(n_gen: int) -> tuple:
  """Each mixed-batch row's ``merge_lora`` solo reference (the JAX package's)."""
  return tuple(tuple(r) for r in ref._mixed_refs(n_gen))


def _serve(server, prompts, names, n_gen, **kw):
  streams: dict[str, list] = {}

  async def run():
    def emit(rid, toks, fin):
      streams.setdefault(rid, []).extend(toks)

    return await asyncio.gather(*(
      server.submit(f"r{i}", np.asarray(p, np.int32), max_tokens=n_gen, temp=0.0, top_k=35, eos_ids=(), emit=emit, adapter=nm, **kw)
      for i, (p, nm) in enumerate(zip(prompts, names))
    ))

  outs = asyncio.run(run())
  return outs, [streams.get(f"r{i}", []) for i in range(len(prompts))]


def _stacked(cfg, params_np: dict, cap: int = 4, rank: int = 4, seed: int = 0) -> dict:
  """``params_np`` (numpy) with stacked ``{wq,wv}_alora_{a,b}`` leaves on
  each stack: slot 0 zero (the base), the others random and large enough
  to move the greedy tokens."""
  rng = np.random.default_rng(seed)
  out = dict(params_np)
  for stack in ("layers", "moe_layers"):
    if "wq" not in out.get(stack, {}):
      continue
    layers = dict(out[stack])
    L = layers["wq"].shape[0]
    for t in ("wq", "wv"):
      d_out = layers[t].shape[-1]
      a = rng.normal(0, 0.3, (L, cap, cfg.dim, rank)).astype(np.float32)
      b = rng.normal(0, 0.3, (L, cap, rank, d_out)).astype(np.float32)
      a[:, 0] = 0.0
      b[:, 0] = 0.0
      layers[f"{t}_alora_a"], layers[f"{t}_alora_b"] = a, b
    out[stack] = layers
  return out


def _to_jax(tree):
  return jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------------------ the delta


@pytest.mark.parametrize("S", [1, 5])
def test_alora_delta_matches_jax(S):
  rng = np.random.default_rng(S)
  x = rng.normal(size=(3, S, 16)).astype(np.float32)
  a = rng.normal(size=(4, 16, 4)).astype(np.float32)
  b = rng.normal(size=(4, 4, 24)).astype(np.float32)
  a[0], b[0] = 0.0, 0.0  # slot 0: the base model
  ids = np.array([2, 0, 3], np.int32)
  want = np.asarray(jdec._alora_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids)))
  got = tdec._alora_delta(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ids))
  np.testing.assert_allclose(got.numpy(), want, **TOL)
  np.testing.assert_allclose(got[2].numpy(), 2.0 * (x[2] @ a[3]) @ b[3], **TOL)
  assert not got[1].any()


# --------------------------------------------------------------- the registry


def _registry_trace(mod, tmp_path, budget: int) -> list:
  """One sequence of registry operations; every observable outcome."""
  installs = []
  geo = {"layers": {"wq": (2, 64, 64), "wv": (2, 64, 32)}}
  reg = mod.AdapterRegistry(geometry=geo, rank=4, capacity=4, install=lambda slot, arrays: installs.append((slot, sorted(arrays))), host_budget_bytes=budget)
  rng = np.random.default_rng(0)

  def adapter(r):
    return {"layers": {"wq": (rng.normal(size=(2, 64, r)).astype(np.float32), rng.normal(size=(2, r, 64)).astype(np.float32)),
                       "wv": (rng.normal(size=(2, 64, r)).astype(np.float32), rng.normal(size=(2, r, 32)).astype(np.float32))}}

  seen = []
  for i in range(5):
    path = mod.save_adapter(tmp_path / mod.__name__.split(".")[0] / f"a{i}", adapter(2 if i % 2 else 4))
    reg.register(f"n{i}", path=str(path))
  seen.append(reg.snapshot()["host_bytes"])
  seen.append([reg.acquire("n0", holder="h0"), reg.acquire("n1", holder="h1"), reg.acquire("n2", holder="h2")])
  try:
    reg.acquire("n3", holder="h3")
  except mod.AdapterSlotsPinnedError as e:
    seen.append(("pinned", str(e)))
  reg.unpin("h1")
  seen.append(reg.acquire("n3", holder="h3"))  # n1's slot, the only unpinned one
  seen.append(reg.resident_names())
  reg.unpin("h0")
  reg.unpin("h0")  # idempotent
  seen.append(reg.acquire("n1"))  # evicted host-side or not: it reloads
  seen.append(sorted(reg.pinned_holders()))
  try:
    reg.acquire("nope")
  except mod.UnknownAdapterError as e:
    seen.append(("unknown", str(e)))
  try:
    reg.register("big", adapter(8))
  except ValueError as e:
    seen.append(("rank", str(e)))
  try:
    reg.register("bad", {"layers": {"wq": (np.zeros((1, 2, 4), np.float32), np.zeros((1, 4, 3), np.float32))}})
  except ValueError as e:
    seen.append(("geometry", str(e)))
  snap = reg.snapshot()
  for entry in snap["adapters"].values():
    entry["path"] = entry["path"].rsplit("/", 1)[-1] if entry["path"] else None
  seen.append(snap)
  seen.append(installs)
  return seen


@pytest.mark.parametrize("budget", [1 << 30, 6000], ids=["roomy", "host-evicting"])
def test_registry_matches_jax_sequence(tmp_path, budget):
  assert _registry_trace(tadapters, tmp_path, budget) == _registry_trace(jadapters, tmp_path, budget)


def test_npz_files_cross_both_ways(tmp_path):
  """A file either package writes loads in the other, leaf for leaf."""
  for writer, reader in ((jadapters, tadapters), (tadapters, jadapters)):
    path = writer.save_adapter(tmp_path / f"{writer.__name__.split('.')[0]}", ref.ADAPTER_1)
    got = reader.load_adapter(path)
    assert set(got) == set(ref.ADAPTER_1)
    for stack, per in ref.ADAPTER_1.items():
      for t, (a, b) in per.items():
        np.testing.assert_array_equal(got[stack][t][0], a)
        np.testing.assert_array_equal(got[stack][t][1], b)
    assert reader.adapter_nbytes(got) == writer.adapter_nbytes(ref.ADAPTER_1)
  assert tadapters.round_pow2(5) == jadapters.round_pow2(5) == 8
  # A full training checkpoint's flat keystr form: the LoRA leaves only.
  flat = {f"['{stack}']['{t}_lora_{f}']": ab[i] for stack, per in ref.ADAPTER_1.items() for t, ab in per.items() for i, f in enumerate("ab")}
  flat["['layers']['wq']"] = np.zeros((2, 2), np.float32)
  np.savez(str(tmp_path / "full.npz"), **flat)
  got, want = tadapters.load_adapter(tmp_path / "full.npz"), jadapters.load_adapter(tmp_path / "full.npz")
  assert {s: sorted(p) for s, p in got.items()} == {s: sorted(p) for s, p in want.items()}
  np.testing.assert_array_equal(got["layers"]["wv"][1], want["layers"]["wv"][1])
  for mod in (tadapters, jadapters):
    with pytest.raises(FileNotFoundError):
      mod.load_adapter(tmp_path / "missing.npz")


# ------------------------------------------------------- the decoder programs


def _seeded(jc, tc, jp, tp, bt, lens, ids, quant=""):
  """Both pools with each row's prompt prefilled through its adapter."""
  n_pages = int(bt.max()) + 1
  jpool = jpaged.init_paged_pool(jc, 2, n_pages, PS, quant=quant)
  tpool = paged.init_paged_pool(tc, 2, n_pages, PS, quant=quant)
  B = bt.shape[0]
  tok = np.random.default_rng(4).integers(0, 256, (B, 4 * PS)).astype(np.int32)
  z = np.zeros(B, np.int32)
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, ref.SHARD, jnp.asarray(tok), jpool, jnp.asarray(bt[:, :4]), jnp.asarray(z), jnp.asarray(lens), PS, jnp.asarray(ids))
  tl, tpool = tdec.prefill_into_pages_many(tp, tc, TS, torch.from_numpy(tok), tpool, torch.from_numpy(bt[:, :4]), torch.from_numpy(z), torch.from_numpy(lens), PS, adapter_ids=torch.from_numpy(ids))
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  return jpool, tpool, np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]


@functools.lru_cache(maxsize=None)
def _stacked_model():
  np_params = _stacked(TC, jax.tree.map(np.asarray, ref.PARAMS))
  return _to_jax(np_params), params_from_jax(np_params, TC, TS)


def test_mixed_tick_slice_applies_pf_adapter():
  """The mixed program: decode rows on slots 1 and 2, the slice on its own
  ``pf_adapter`` 3; tokens and the slice's pages equal the reference's."""
  jp, tp = _stacked_model()
  jc = ref.CFG
  bt = np.array([[3, 1, 9, 4, 0, 0, 0, 0], [12, 2, 7, 20, 0, 0, 0, 0], [5, 17, 11, 6, 0, 0, 0, 0]], np.int32)
  lens = np.array([11, 19, 16], np.int32)
  ids = np.array([1, 2, 3], np.int32)
  jpool, tpool, first = _seeded(jc, TC, jp, tp, bt, lens, ids)
  pf_tokens = np.random.default_rng(8).integers(0, 256, (1, 16)).astype(np.int32)
  pf_bt, pf_prefix, pf_end, pf_ad = bt[2:, :4], np.array([16], np.int32), np.array([29], np.int32), np.array([3], np.int32)
  positions, active, temps = lens[:2].copy(), np.array([True, True]), np.zeros(2, np.float32)
  jout = jdec.fused_mixed_paged_batch_decode(
    jp, jc, ref.SHARD, jnp.asarray(first[:2]), jpool, jnp.asarray(bt[:2, :4]), jnp.asarray(positions), jnp.asarray(active), jnp.asarray(temps),
    jnp.asarray(pf_tokens), jnp.asarray(pf_bt), jnp.asarray(pf_prefix), jnp.asarray(pf_end), 5, page_size=PS, adapter_ids=jnp.asarray(ids[:2]), pf_adapter=jnp.asarray(pf_ad),
  )
  tout = tdec.fused_mixed_paged_batch_decode(
    tp, TC, TS, torch.from_numpy(first[:2]), tpool, torch.from_numpy(bt[:2, :4]), torch.from_numpy(positions), torch.from_numpy(active), torch.from_numpy(temps),
    torch.from_numpy(pf_tokens), torch.from_numpy(pf_bt), torch.from_numpy(pf_prefix), torch.from_numpy(pf_end), 5, page_size=PS,
    adapter_ids=torch.from_numpy(ids[:2]), pf_adapter=torch.from_numpy(pf_ad),
  )
  for got, want in zip(tout[:3], jout[:3]):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  for key in jout[3]:
    np.testing.assert_allclose(tout[3][key].numpy()[:, [17, 11]], np.asarray(jout[3][key])[:, [17, 11]], **TOL, err_msg=key)
  # The slice's pages differ from a base slice's: the adapter ran.
  base = tdec.fused_mixed_paged_batch_decode(
    tp, TC, TS, torch.from_numpy(first[:2]), {k: v.clone() for k, v in tpool.items()}, torch.from_numpy(bt[:2, :4]), torch.from_numpy(positions + 5), torch.from_numpy(active), torch.from_numpy(temps),
    torch.from_numpy(pf_tokens), torch.from_numpy(pf_bt), torch.from_numpy(pf_prefix), torch.from_numpy(pf_end), 1, page_size=PS, adapter_ids=torch.from_numpy(ids[:2]), pf_adapter=torch.zeros(1, dtype=torch.int32),
  )[3]
  assert not torch.allclose(base["v"][:, 11], tout[3]["v"][:, 11])


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_spec_chunks_apply_the_target_adapter(layout, proposer):
  """Both spec chunks with adapter rows (slots 2, 0, 1): the target
  applies each row's adapter and the draft (the base model) proposes;
  tokens, counts and next positions equal the reference's."""
  jp, tp = _stacked_model()
  jc = ref.CFG
  R, G, B = 3, 2, 3
  ids = np.array([2, 0, 1], np.int32)
  lens = np.array([12, 20, 7], np.int32)
  gammas, temps, active = np.array([2, 2, 1], np.int32), np.zeros(3, np.float32), np.ones(3, bool)
  props = prop_counts = None
  if proposer == "ngram":
    props = np.random.default_rng(3).integers(0, 256, (B, R * (G + 1) + G)).astype(np.int32)
    props[:, :3] = props[:, 3:6]
    prop_counts = np.array([props.shape[1], 5, props.shape[1]], np.int32)
  jd = tdd = None
  if proposer == "draft":
    jd, tdd = ref.PARAMS, TP
  if layout == "paged":
    bt = np.zeros((B, 8), np.int32)
    bt[:, :6] = np.arange(1, 19).reshape(B, 6)
    jstore, tstore, first = _seeded(jc, TC, jp, tp, bt, lens, ids)
  else:
    tok = np.random.default_rng(4).integers(0, 256, (B, 32)).astype(np.int32)
    jstore, tstore = jdec.init_kv_cache(jc, 2, B, 64), tdec.init_kv_cache(TC, 2, B, 64)
    rows = np.arange(B, dtype=np.int32)
    jl, jstore = jdec.prefill_into_slots(jp, jc, ref.SHARD, jnp.asarray(tok), jstore, jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(ids))
    tl, tstore = tdec.prefill_into_slots(tp, TC, TS, torch.from_numpy(tok), tstore, torch.from_numpy(rows), torch.from_numpy(lens), torch.from_numpy(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    first = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
  jcd = tcd = None
  if proposer == "draft":
    dtok = np.random.default_rng(4).integers(0, 256, (B, 32)).astype(np.int32)
    jcd, tcd = jdec.init_kv_cache(jc, 2, B, 64), tdec.init_kv_cache(TC, 2, B, 64)
    rows = np.arange(B, dtype=np.int32)
    _, jcd = jdec.prefill_into_slots(ref.PARAMS, jc, ref.SHARD, jnp.asarray(dtok), jcd, jnp.asarray(rows), jnp.asarray(lens))
    _, tcd = tdec.prefill_into_slots(TP, TC, TS, torch.from_numpy(dtok), tcd, torch.from_numpy(rows), torch.from_numpy(lens))
  jkw = dict(props=None if props is None else jnp.asarray(props), prop_counts=None if prop_counts is None else jnp.asarray(prop_counts), adapter_ids=jnp.asarray(ids))
  tkw = dict(props=None if props is None else torch.from_numpy(props), prop_counts=None if prop_counts is None else torch.from_numpy(prop_counts), adapter_ids=torch.from_numpy(ids))
  jrows = (jnp.asarray(lens), jnp.asarray(active), jnp.asarray(gammas), jnp.asarray(temps), R, G)
  trows = (torch.from_numpy(lens), torch.from_numpy(active), torch.from_numpy(gammas), torch.from_numpy(temps), R, G)
  if layout == "paged":
    jout = jdec.fused_spec_paged_batch_decode(jp, jc, ref.SHARD, jd, jc, ref.SHARD, jnp.asarray(first), jstore, jcd, jnp.asarray(bt), *jrows, page_size=PS, **jkw)
    tout = tdec.fused_spec_paged_batch_decode(tp, TC, TS, tdd, TC, TS, torch.from_numpy(first), tstore, tcd, torch.from_numpy(bt), *trows, page_size=PS, **tkw)
  else:
    jout = jdec.fused_spec_batch_decode(jp, jc, ref.SHARD, jd, jc, ref.SHARD, jnp.asarray(first), jstore, jcd, *jrows, **jkw)
    tout = tdec.fused_spec_batch_decode(tp, TC, TS, tdd, TC, TS, torch.from_numpy(first), tstore, tcd, *trows, **tkw)
  counts = np.asarray(jout[1])
  for k in (1, 2, 3, 4):
    np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
  for i in range(B):
    np.testing.assert_array_equal(tout[0][i, : counts[i]].numpy(), np.asarray(jout[0])[i, : counts[i]])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_weights_with_adapters_match_jax(quant):
  """int8 and int4 base weights, the adapters beside them in f32: cached
  prefill and decode logits per row equal the reference's."""
  np_params = jax.tree.map(np.asarray, jquantize(ref.PARAMS, quant))
  stacked = _stacked(TC, np_params)
  jp, tp = _to_jax(stacked), params_from_jax(stacked, TC, TS)
  assert tp["layers"]["wq_alora_a"].dtype == torch.float32 and tp["layers"]["wq"].dtype == torch.int8
  assert "wq_alora_a_scale" not in tquantize(tp, quant)["layers"]  # the exact-name table leaves adapters alone
  _forward_pair(ref.CFG, TC, ref.SHARD, TS, jp, tp)


def _forward_pair(jc, tc, js, ts, jp, tp):
  """A cached 9-token prefill then one decode step for three rows on
  slots 1, 0, 3: logits within TOL, greedy tokens equal; the adapter rows
  move off the base row's logits."""
  tokens = np.random.default_rng(1).integers(0, min(jc.vocab_size, 128), (3, 9)).astype(np.int32)
  ids = np.array([1, 0, 3], np.int32)
  pos = np.broadcast_to(np.arange(9, dtype=np.int32), (3, 9))
  L = js.n_shard_layers
  jcache, tcache = jdec.init_kv_cache(jc, L, 3, 32), tdec.init_kv_cache(tc, L, 3, 32)
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(tokens), jnp.asarray(pos), jcache, adapter_ids=jnp.asarray(ids))
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(tokens), torch.from_numpy(pos.copy()), tcache, adapter_ids=torch.from_numpy(ids))
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
  step = np.full((3, 1), 9, np.int32)
  jl2, _ = jdec.shard_forward(jp, jc, js, jnp.asarray(nxt), jnp.asarray(step), jcache, adapter_ids=jnp.asarray(ids))
  tl2, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(nxt), torch.from_numpy(step), tcache, adapter_ids=torch.from_numpy(ids))
  np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
  assert np.array_equal(tl2.numpy().argmax(-1), np.asarray(jl2).argmax(-1))
  base, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(tokens), torch.from_numpy(pos.copy()), None)
  adapted, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(tokens), torch.from_numpy(pos.copy()), None, adapter_ids=torch.from_numpy(ids))
  torch.testing.assert_close(adapted[1], base[1], **TOL)  # slot 0: the base model
  assert not torch.allclose(adapted[0], base[0], **TOL)


@pytest.mark.parametrize("family", ["qwen3-moe", "gemma2"])
def test_moe_and_gemma2_with_adapters_match_jax(tmp_path, family):
  """Adapters on an MoE model (both stacks) and on gemma2 (post norms,
  softcaps, sliding window)."""
  if family == "gemma2":
    make_tiny_gemma2(tmp_path)
  else:
    make_tiny_moe(tmp_path, family)
  jc, tc = jconfig.load_model_config(tmp_path, dtype=jnp.float32), tconfig.load_model_config(tmp_path, dtype=torch.float32)
  js, ts = JShard("tiny", 0, jc.n_layers - 1, jc.n_layers), Shard("tiny", 0, tc.n_layers - 1, tc.n_layers)
  stacked = _stacked(tc, jax.tree.map(np.asarray, jloader.load_shard_weights(tmp_path, jc, js)), seed=2)
  _forward_pair(jc, tc, js, ts, _to_jax(stacked), params_from_jax(stacked, tc, ts))
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(ts, tc, tloader.load_shard_weights(tmp_path, tc, ts))
  assert set(engine.enable_multi_lora(capacity=2, rank=2).geometry) == {s for s in ("layers", "moe_layers") if "wq_alora_a" in stacked.get(s, {})}


def test_mla_is_refused_with_the_references_message():
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(TS, dataclasses.replace(TC, kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=16), TP)
  with pytest.raises(ValueError, match="does not support MLA models"):
    engine.enable_multi_lora(capacity=2, rank=2)


# --------------------------------------------------------- the batched server


@pytest.mark.parametrize("layout", ["paged_int8", "dense"])
def test_mixed_batch_rows_match_jax_and_merged_solo(monkeypatch, layout):
  """Each row of a mixed-adapter batch (a1, a2, base, a1) equals the JAX
  server's row and its ``merge_lora`` solo reference, lookahead on and
  off, at the serving defaults; no pin is left in either registry."""
  if layout == "paged_int8":
    monkeypatch.setenv("XOT_TPU_PAGED", "1")
    monkeypatch.setenv("XOT_TPU_KV_QUANT", "int8")
  else:
    monkeypatch.setenv("XOT_TPU_PAGED", "0")
  n_gen = 6
  refs = [list(r) for r in _refs(n_gen)]
  je, jreg = ref._engine_with_adapters()
  jserver = JBatchedServer(je, n_slots=4, chunk=2)
  jouts, _ = ref._serve_mixed(jserver, n_gen)
  jserver.shutdown()
  assert jouts == refs and not jreg.pinned_holders()
  engine, reg = _port_engine()
  before = tm.counter_value("lora_requests_total", labels={"adapter": "a1"})
  for lookahead in (True, False):
    server = BatchedServer(engine, n_slots=4, chunk=2, lookahead=lookahead)
    outs, streams = _serve(server, ref.PROMPTS, ref.NAMES, n_gen)
    assert server._lora_active()
    server.shutdown()
    assert streams == outs
    assert outs == jouts, f"(layout={layout}, lookahead={lookahead})"
  assert not reg.pinned_holders()
  assert sorted(reg.resident_names()) == ["a1", "a2"]
  assert tm.counter_value("lora_requests_total", labels={"adapter": "a1"}) == before + 4  # two a1 rows a pass
  assert tm.gauge_value("lora_adapters_resident") == 2


def test_batched_adapter_install_runs_off_the_event_loop(monkeypatch):
  """A cold adapter's install at batched admission (the scheduler runs on
  the event loop) is written on the engine's executor thread, ahead of the
  admission's prefill: the loop's thread never copies factors, each row
  equals its merged solo reference, and ``lora_swap_seconds`` records every
  write. Without a running loop (a caller's own thread) the install runs
  where it is called, as before."""
  monkeypatch.setenv("XOT_TPU_PAGED", "1")
  engine, reg = _port_engine()
  writers: list = []
  write = engine._write_adapter_slot

  def spy(slot, arrays):
    writers.append(threading.current_thread())
    return write(slot, arrays)

  monkeypatch.setattr(engine, "_write_adapter_slot", spy)
  executor_thread = engine.executor.submit(threading.current_thread).result()
  server = BatchedServer(engine, n_slots=2, chunk=2)
  swaps = tm.hist_count("lora_swap_seconds")
  n_gen = 6
  prompts, names = ref.PROMPTS[:2], ref.NAMES[:2]
  outs, _ = _serve(server, prompts, names, n_gen)
  server.shutdown()
  assert writers and all(t is executor_thread for t in writers) and threading.main_thread() not in writers
  assert tm.hist_count("lora_swap_seconds") == swaps + len(writers) == swaps + 2  # a1 and a2, one write each
  merged = {"a1": ref.MERGED_1, "a2": ref.MERGED_2}
  assert outs == [ref._solo_ref(merged[nm], p, n_gen - 1) for p, nm in zip(prompts, names)]
  assert not reg.pinned_holders() and reg.pending_install(reg.slot_of("a1")) is None
  reg.register("a3", ref.ADAPTER_1)
  reg.acquire("a3")  # no running loop on this thread: written here, at once
  assert writers[-1] is threading.main_thread() and tm.hist_count("lora_swap_seconds") == swaps + 3


def test_block_math_and_pool_deduction_match_jax():
  """The adapter stacks' bytes and their deduction from the default page
  pool equal the reference's."""
  from xotorch_support_jetson_tpu.inference import paging as jpaging
  from xotorch_support_jetson_tpu_torch.inference import paging as tpaging

  for args in [(2, 64, 64, 4, 4), (16, 2048, 512, 16, 8)]:
    assert tpaging.lora_device_bytes(*args) == jpaging.lora_device_bytes(*args)
  assert tpaging.lora_pages_equivalent(1000, 300) == jpaging.lora_pages_equivalent(1000, 300) == 4
  je, jreg = ref._engine_with_adapters()
  engine, reg = _port_engine()
  assert reg.device_bytes() == jreg.device_bytes() > 0
  plain = TorchShardedInferenceEngine(device="cpu")
  plain.load_test_model(TS, TC, TP)
  servers = [JBatchedServer(je, n_slots=4, chunk=2), BatchedServer(engine, n_slots=4, chunk=2), BatchedServer(plain, n_slots=4, chunk=2)]
  for s in servers:
    s._ensure_cache()
  jn, tn, base = (s.allocator.n_pages for s in servers)
  for s in servers:
    s.shutdown()
  assert tn == jn < base


def test_prefix_pages_are_shared_only_within_one_adapter(monkeypatch):
  """A base request donates its prompt's full pages; requests on the same
  prompt under a1 and a2 must not reuse them (the reference's prefix cache
  keys on tokens alone and would serve them the base model's K/V), each
  equals its merged solo reference, and a second a1 request does reuse
  a1's pages."""
  monkeypatch.setenv("XOT_TPU_PAGE_SIZE", "8")
  prompt = [(7 * i + 3) % 256 for i in range(21)]
  engine, reg = _port_engine()
  server = BatchedServer(engine, n_slots=2, chunk=2)
  rounds = ([None], ["a1", "a2"], ["a1"])

  async def run():
    hits, outs = [], []
    for k, names in enumerate(rounds):
      before = server.prefix_hit_pages
      outs.append(await asyncio.gather(*(
        server.submit(f"q{k}{i}", np.asarray(prompt, np.int32), max_tokens=5, temp=0.0, top_k=35, eos_ids=(), emit=lambda *_: None, adapter=nm)
        for i, nm in enumerate(names)
      )))
      hits.append(server.prefix_hit_pages - before)
    return hits, outs

  hits, outs = asyncio.run(run())
  server.shutdown()
  for names, got in zip(rounds, outs):
    for out, nm in zip(got, names):
      assert out == ref._solo_ref({None: ref.PARAMS, "a1": ref.MERGED_1, "a2": ref.MERGED_2}[nm], prompt, 4), nm
  assert hits == [0, 0, 2] and not reg.pinned_holders()


def test_unknown_adapter_fails_only_its_request():
  engine, reg = _port_engine()
  server = BatchedServer(engine, n_slots=2, chunk=2)
  outs = None

  async def run():
    def emit(*_):
      pass

    bad = server.submit("bad", np.asarray(ref.PROMPTS[1], np.int32), max_tokens=4, temp=0.0, top_k=35, eos_ids=(), emit=emit, adapter="nope")
    good = server.submit("good", np.asarray(ref.PROMPTS[0], np.int32), max_tokens=4, temp=0.0, top_k=35, eos_ids=(), emit=emit)
    return await asyncio.gather(bad, good, return_exceptions=True)

  outs = asyncio.run(run())
  server.shutdown()
  assert isinstance(outs[0], tadapters.UnknownAdapterError)
  assert outs[1] == list(_base_refs(4)[0])
  assert all(s is None for s in server.slots) and not reg.pinned_holders()


@functools.lru_cache(maxsize=None)
def _base_refs(n_gen):
  return tuple(tuple(ref._solo_ref(ref.PARAMS, p, n_gen - 1)) for p in ref.PROMPTS)


def test_preempt_resume_keeps_its_adapter():
  """A preempted adapter row resumes on its adapter: its stream equals the
  merged solo reference (and the JAX package's), and no pin is left."""
  engine, reg = _port_engine()
  server = BatchedServer(engine, n_slots=1, chunk=2, qos=QosPolicy(QosConfig(aging_s=10_000.0)))
  p_batch, p_int = [3, 25, 9], [7, 1, 88, 42, 5]
  n_batch, n_int = 24, 4
  streams: dict[str, list] = {}

  async def run():
    started = asyncio.Event()

    def emit(rid, toks, fin):
      streams.setdefault(rid, []).extend(toks)
      if rid == "bg" and len(streams["bg"]) >= 4:
        started.set()

    bg = asyncio.create_task(server.submit("bg", np.asarray(p_batch, np.int32), max_tokens=n_batch, temp=0.0, top_k=35, eos_ids=(), emit=emit, priority="batch", tenant="bulk", adapter="a1"))
    await asyncio.wait_for(started.wait(), timeout=60)
    out_int = await asyncio.wait_for(server.submit("vip", np.asarray(p_int, np.int32), max_tokens=n_int, temp=0.0, top_k=35, eos_ids=(), emit=emit, priority="interactive", tenant="vip"), timeout=60)
    return out_int, await asyncio.wait_for(bg, timeout=60)

  before = tm.counter_value("qos_preemptions_total")
  out_int, out_bg = asyncio.run(run())
  server.shutdown()
  assert tm.counter_value("qos_preemptions_total") > before
  assert out_int == ref._solo_ref(ref.PARAMS, p_int, n_int - 1)
  assert out_bg == streams["bg"] == ref._solo_ref(ref.MERGED_1, p_batch, n_batch - 1)
  assert not reg.pinned_holders()


def test_lora_off_is_base_and_the_hook_never_runs(monkeypatch):
  """``XOT_TPU_LORA=0``: ``enable_multi_lora`` answers None, no adapter
  leaf enters the params, and batched and solo serving are the base model
  with the hook poisoned."""
  monkeypatch.setenv("XOT_TPU_LORA", "0")

  def boom(*a, **k):  # noqa: ANN002, ANN003
    raise AssertionError("_alora_delta must never run with XOT_TPU_LORA=0")

  monkeypatch.setattr(tdec, "_alora_delta", boom)
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(TS, TC, TP)
  assert engine.enable_multi_lora(capacity=4, rank=ref.RANK) is None
  assert not any("_alora_" in k for k in engine.params["layers"])
  server = BatchedServer(engine, n_slots=4, chunk=2)
  outs, _ = _serve(server, ref.PROMPTS, [None] * 4, 4)
  server.shutdown()
  assert outs == [list(r) for r in _base_refs(4)]
  with pytest.raises(tadapters.UnknownAdapterError, match="not enabled"):
    engine.set_request_adapter("x", "a1")


def test_solo_session_applies_its_adapter():
  """A solo session naming an adapter decodes its merged reference through
  the captured-program path (prefill, step, plain chunk, oneshot); a base
  session stays base; a session's end drops its pin."""
  engine, reg = _port_engine()
  n = 5
  for name, mp in (("a1", ref.MERGED_1), (None, ref.PARAMS)):
    want = ref._solo_ref(mp, ref.PROMPTS[0], n + 1)
    for mode in ("chunk", "oneshot"):
      rid = f"solo-{name}-{mode}"
      engine.set_request_adapter(rid, name)
      out, _ = asyncio.run(engine.infer_tensor(rid, TS, np.asarray([ref.PROMPTS[0]], np.int32)))
      first = int(np.argmax(out[0]))
      step, _ = asyncio.run(engine.infer_tensor(rid, TS, np.asarray([[first]], np.int32)))
      nxt = int(np.argmax(step[0]))
      if mode == "chunk":
        toks = asyncio.run(engine.generate_chunk(rid, TS, nxt, n, temp=0.0))
      else:
        toks = asyncio.run(engine.generate_oneshot(rid, TS, nxt, n, eos_ids=(), temp=0.0))
      assert [first, nxt] + [int(t) for t in toks] == want, (name, mode)
      assert engine.sessions[rid].adapter_slot == (reg.slot_of(name) if name else 0)
      engine.end_request(rid)
  assert not reg.pinned_holders()
  with pytest.raises(tadapters.UnknownAdapterError):
    engine.set_request_adapter("solo-x", "nope")


def test_lora_dir_registers_every_npz(tmp_path, monkeypatch):
  """``XOT_TPU_LORA_DIR``: every npz registers under its stem, a bad file
  is skipped, as the JAX engine does."""
  jadapters.save_adapter(tmp_path / "alpha", ref.ADAPTER_1)
  tadapters.save_adapter(tmp_path / "beta", ref.ADAPTER_2)
  np.savez(tmp_path / "broken.npz", nothing=np.zeros(3))
  monkeypatch.setenv("XOT_TPU_LORA_DIR", str(tmp_path))
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(TS, TC, TP)
  engine._maybe_load_adapter_dir()
  from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine

  je = JaxShardedInferenceEngine(use_local_mesh=False)
  je.load_test_model(ref.SHARD, ref.CFG, ref.PARAMS)
  je._maybe_load_adapter_dir()
  assert engine.adapter_registry.names() == je.adapter_registry.names() == ["alpha", "beta"]
  assert engine.adapter_registry.rank == je.adapter_registry.rank and engine.adapter_registry.capacity == je.adapter_registry.capacity


# --------------------------------------------------------------- API, ledger


class _Node:
  """What the API reads of a node, with the port engine behind it."""

  def __init__(self, engine):
    self.inference_engine = engine
    self.request_options: dict = {}

    class _Reg:
      def register(self, _name):
        return self

      def on_next(self, _fn):
        return None

    self.on_token = _Reg()


def _api_body(api, method, path, body=None, headers=None):
  import json

  req = tapi._Request(method, path, {k.lower(): v for k, v in (headers or {}).items()}, json.dumps(body).encode() if body is not None else b"")
  resp = asyncio.run(api.routes[(method, path)](req, None))
  return resp.status, resp.body


def test_api_unknown_adapter_400_and_adapters_bodies(monkeypatch):
  """``x-adapter`` naming an unknown adapter answers 400 ``unknown_adapter``
  on chat and completions before any device work; ``GET /v1/adapters``
  answers as the JAX package's registry snapshot does; the tenant map and
  the model-field alias resolve as in the reference."""
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(TS, TC, TP)
  api = tapi.ChatGPTAPI(_Node(engine), "TorchShardedInferenceEngine", default_model="llama-3.2-1b")
  assert _api_body(api, "GET", "/v1/adapters") == (200, {"enabled": False, "detail": "multi-LoRA serving off (XOT_TPU_LORA=0 or no adapters loaded)"})
  engine2, _ = _port_engine()
  je, jreg = ref._engine_with_adapters()
  api = tapi.ChatGPTAPI(_Node(engine2), "TorchShardedInferenceEngine", default_model="llama-3.2-1b")
  status, body = _api_body(api, "GET", "/v1/adapters")
  assert status == 200 and body == {"enabled": True, **jreg.snapshot()}
  for path, payload in (("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}]}), ("/v1/completions", {"prompt": "hi"})):
    status, body = _api_body(api, "POST", path, payload, {"x-adapter": "nope"})
    assert status == 400 and body["error"]["code"] == "unknown_adapter", (path, body)
  monkeypatch.setenv("XOT_TPU_LORA_TENANTS", '{"acme": "a2"}')
  for data, headers, tenant in (({}, {"x-adapter": "a1"}, None), ({"model": "a1"}, {}, None), ({"model": "llama-3.2-1b"}, {}, None), ({}, {}, "acme"), ({}, {}, "other")):
    known = engine2.adapter_registry.known
    from xotorch_support_jetson_tpu.api.chatgpt_api import parse_adapter_field

    assert tapi.parse_adapter_field(data, headers, tenant, known) == parse_adapter_field(data, headers, tenant, known)


def test_ledger_counts_with_adapters_equal_the_jax_engines():
  """Builds and dispatches per family, the JAX server against the port's,
  on the same mixed-adapter traffic (paged defaults, lookahead on)."""
  ledger.reset()
  jprograms.ledger.reset()
  jax.clear_caches()
  je, _ = ref._engine_with_adapters()
  jserver = JBatchedServer(je, n_slots=4, chunk=2)
  ref._serve_mixed(jserver, 6)
  jserver.shutdown()
  engine, _ = _port_engine()
  server = BatchedServer(engine, n_slots=4, chunk=2)
  _serve(server, ref.PROMPTS, ref.NAMES, 6)
  server.shutdown()
  jsnap, tsnap = jprograms.ledger.snapshot()["families"], ledger.snapshot()["families"]
  fams = [f for f in jsnap if f.startswith(("prefill.", "decode.", "spec."))]
  assert fams
  for fam in fams:
    assert (tsnap[fam]["compiles"], tsnap[fam]["dispatches"]) == (jsnap[fam]["compiles"], jsnap[fam]["dispatches"]), fam
  ledger.reset()
  jprograms.ledger.reset()
