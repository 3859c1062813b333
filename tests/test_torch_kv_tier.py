"""The port's host KV tier against the JAX package's, on the CPU, on the same
seeded inputs; every comparison is exact:

- ``PageAllocator.chain_keys_extend``: equal key bytes on random streams;
- the allocator under a seeded churn of admissions, donations, lookups,
  restore adoptions and evictions: the same eviction batches ``(key,
  page)`` reach the spill hook, and ``audit`` holds after every step;
- ``KvTierManager`` on fake page copies: the same decisions and ``stats()``
  under spill, copy-on-write restore, the byte budget, LRU and FIFO host
  eviction, the inflight cap on pending spills, an entry replaced while its
  spill was pending, and ``adopt_wire``'s quant-tag and geometry refusals;
- the real page copies (``DecoderBatchOps.read_pages`` / ``write_pages``
  against the reference's ``gather_pages`` / ``scatter_pages``) on bf16,
  int8 and int4 pools: host entries byte-equal (bf16 as ``uint16``) and the
  pools equal after the restore;
- the ``BatchedServer`` at the defaults with the tier on (2 layers, width
  64, f32 weights from ``params_from_jax``, speculation on both sides but
  for the multi-turn sessions, whose pool it would exhaust, a small
  ``XOT_TPU_BATCH_PAGES``): a preempted row resuming through a host
  restore (lookahead on and off, each KV quant), more open multi-turn
  sessions than slots parking through the host tier, a restore run that
  stops at a still-cached suffix, and a failed restore that recomputes —
  identical greedy tokens and equal spilled / restored page counts;
- ``PrefixRegistry`` bounds, TTL and staleness on a fake clock;
  ``kv_tier_enabled``'s parse; ``GET /v1/kv/tier``'s keys;
  ``XOT_TPU_KV_TIER=0`` as the single-tier pool."""

import asyncio
import hashlib
import json
import types
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.api.chatgpt_api import ChatGPTAPI as JaxChatGPTAPI
from xotorch_support_jetson_tpu.inference import kv_tier as jtier, qos as jqos
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.paging import PageAllocator as JaxPageAllocator
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu.utils.metrics import metrics as jmetrics
from xotorch_support_jetson_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_support_jetson_tpu_torch.inference import kv_tier as ttier, qos as tqos
from xotorch_support_jetson_tpu_torch.inference.batch_ops import DecoderBatchOps
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.paging import PageAllocator
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.ops import paged as tpaged
from xotorch_support_jetson_tpu_torch.utils.helpers import AsyncCallbackSystem
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics as tmetrics

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

PACKAGES = {"jax": (jtier, jqos, jmetrics, JaxBatchedServer), "port": (ttier, tqos, tmetrics, BatchedServer)}
TIER_COUNTERS = ("kv_tier_spilled_pages_total", "kv_tier_restored_pages_total", "kv_tier_host_evictions_total", "qos_preemptions_total")


# ------------------------------------------------------------ chain keys


@pytest.mark.parametrize("seed,page_size", [(0, 4), (1, 8), (2, 64)])
def test_chain_keys_extend_matches_reference(seed, page_size):
  rng = np.random.default_rng(seed)
  toks = rng.integers(0, 130000, 9 * page_size + 3).astype(np.int32)
  full = PageAllocator.chain_keys(toks, page_size)
  assert full == JaxPageAllocator.chain_keys(toks, page_size) and len(full) == 9
  for cut in (0, 1, 4, 9):
    assert PageAllocator.chain_keys_extend(full[:cut], toks, page_size) == JaxPageAllocator.chain_keys_extend(full[:cut], toks, page_size) == full
  longer = np.concatenate([toks, rng.integers(0, 130000, 2 * page_size)])
  ext = PageAllocator.chain_keys_extend(full, longer, page_size)
  assert ext == JaxPageAllocator.chain_keys_extend(full, longer, page_size) == PageAllocator.chain_keys(longer, page_size)
  # The first key is blake2b over the first page's int64 ids.
  assert full[0] == hashlib.blake2b(toks[:page_size].astype(np.int64).tobytes(), digest_size=16).digest()


# ------------------------------------------------------ allocator churn


def _churn(alloc_cls, seed: int) -> list:
  """A seeded script of admissions (which may evict), donations, prefix
  lookups, restore adoptions and preemptions; returns every eviction batch
  and the audit after every step."""
  rng = np.random.default_rng(seed)
  alloc = alloc_cls(33, 4)
  batches: list = []
  alloc.spill_hook = lambda batch: batches.append(list(batch))
  in_use: list = []
  held: list = []
  trace: list = []
  n_keys = 0
  for _ in range(500):
    op = int(rng.integers(0, 5))
    if op == 0:
      got = alloc.alloc(int(rng.integers(1, 5)))
      if got is not None:
        in_use.append(got)
        held.append([])
      trace.append(("alloc", got))
    elif op == 1 and in_use:
      i = int(rng.integers(0, len(in_use)))
      pages, refs = in_use.pop(i), held.pop(i)
      for p in refs:
        alloc.release(p)
      free = []
      for p in pages:
        n_keys += 1
        if rng.random() < 0.5 and alloc.insert_cached(f"k{n_keys}".encode(), p):
          continue
        free.append(p)
      alloc.free(free)
    elif op == 2:
      recent = [k for b in batches[-2:] for k, _ in b] + [f"k{n_keys - j}".encode() for j in range(3)]
      keys = [k for k in recent if alloc.is_cached(k)][:2]
      got = alloc.lookup_prefix(keys)
      if in_use:
        held[int(rng.integers(0, len(held)))].extend(got)
      else:
        for p in got:
          alloc.release(p)
      trace.append(("lookup", got))
    elif op == 3:
      got = alloc.alloc(1)
      if got is not None:
        n_keys += 1
        alloc.adopt_restored(f"r{n_keys}".encode(), got[0])
        if in_use:
          held[int(rng.integers(0, len(held)))].append(got[0])
        else:
          alloc.release(got[0])
    elif op == 4 and in_use:
      i = int(rng.integers(0, len(in_use)))
      pages, refs = in_use.pop(i), held.pop(i)
      for p in refs:
        alloc.release(p)
      alloc.free(pages)
    state = alloc.audit()
    assert state["free"] + state["cached"] + sum(len(p) for p in in_use) == alloc.n_pages - 1
    trace.append(("audit", state, [k.hex() for k in alloc.cached_keys()]))
  return [batches, trace]


@pytest.mark.parametrize("seed", [7, 8])
def test_allocator_churn_evicts_like_the_reference(seed):
  got, want = _churn(PageAllocator, seed), _churn(JaxPageAllocator, seed)
  assert got == want
  batches = got[0]
  assert len(batches) > 10 and sum(len(b) for b in batches) > 20
  flat = [kp for b in batches for kp in b]
  assert len(flat) == len(set(flat))  # every cached page spilled at most once per key


# ------------------------------------------------------ tier mechanics


class _FakePool:
  """A numpy page pool ``[L, P, ...]`` with the read/write contract of each
  package: the reference's ``(arrays, n)`` / stacked arrays, the port's
  ``(host tensors, ready)`` / per-page tensors."""

  def __init__(self, pkg: str, n_pages: int, leaves=("k", "v")) -> None:
    self.pkg = pkg
    self.data = {name: np.random.default_rng(i).standard_normal((2, n_pages, 3, 4, 5)).astype(np.float32) for i, name in enumerate(leaves)}
    self.writes: list = []

  def read(self, pages):
    if self.pkg == "jax":
      return {name: arr[:, pages] for name, arr in self.data.items()}, len(pages)
    return {name: torch.from_numpy(arr[:, pages]) for name, arr in self.data.items()}, None

  def write(self, pages, data):
    self.writes.append(list(pages))
    for name, arr in self.data.items():
      arr[:, pages] = data[name] if self.pkg == "jax" else torch.stack(data[name], 1).numpy()

  @property
  def page_bytes(self) -> int:
    return sum(int(np.prod(a.shape[2:])) * a.shape[0] * a.dtype.itemsize for a in self.data.values())


def _tier_script(pkg: str, policy: str) -> list:
  """Spill, copy-on-write restore, budget eviction, a restore of an evicted
  key, the inflight cap, a key re-spilled while pending, ``adopt_wire``
  refusals; returns every observable decision."""
  tier_mod, _, metrics, _ = PACKAGES[pkg]
  pool = _FakePool(pkg, 16)
  c0 = {k: metrics.counter_value(k) for k in TIER_COUNTERS}
  tier = tier_mod.KvTierManager(page_size=4, read_pages=pool.read, write_pages=pool.write, budget_bytes=pool.page_bytes * 3, evict_policy=policy, max_inflight=2)
  keys = [f"key{i}".encode() for i in range(8)]
  golden = {k: {n: pool.data[n][:, i + 1].copy() for n in pool.data} for i, k in enumerate(keys)}
  out = []

  def note(tag):
    out.append((tag, tier.stats(), len(tier._pending), [tier.host_has(k) for k in keys], tier.host_run(keys, 0, 8)))

  tier.spill([(keys[0], 1), (keys[1], 2)])
  note("spill 2")
  tier.spill([(keys[2], 3)])
  note("spill 1")
  out.append(("run", tier.host_run(keys, 1, 2), tier.host_run(keys, 3, 8)))
  for arr in pool.data.values():
    arr[:] = 0  # the device pages were reused
  tier.restore_into(keys[:2], [7, 8])
  for i, k in enumerate(keys[:2]):
    for n in golden[k]:
      np.testing.assert_array_equal(pool.data[n][:, 7 + i], golden[k][n])
  note("restore")
  tier.spill([(keys[3], 4)])  # over budget: LRU drops keys[2], FIFO keys[0]
  note("budget")
  try:
    tier.restore_into([keys[2]], [9])
    out.append(("restore evicted", None))
  except KeyError:
    out.append(("restore evicted", "KeyError"))
  tier.spill([(keys[4], 5)])
  tier.spill([(keys[5], 6)])
  tier.spill([(keys[6], 10)])  # a third pending batch: the cap of 2 materializes the oldest
  note("inflight")
  tier.spill([(keys[6], 11)])  # re-spilled while its first spill is pending: charged twice until it settles
  note("replaced")
  tier.restore_into([keys[6]], [12])  # materializes the newer batch; the older one settles at the cap
  note("settled")
  leaves = {name: arr[:, [1, 2]].copy() for name, arr in pool.data.items()}
  if pkg == "port":
    leaves = {name: torch.from_numpy(arr) for name, arr in leaves.items()}
  tier.kv_quant = "int8"
  wire = [f"w{i}".encode() for i in range(2)]
  out.append(("adopt other tag", tier.adopt_wire(wire, leaves, quant="int4")))
  small = {name: arr[:, :, :2] for name, arr in leaves.items()}
  out.append(("adopt other geometry", tier.adopt_wire(wire, small, quant="int8")))
  out.append(("adopt", tier.adopt_wire(wire, leaves, quant="int8"), tier.adopt_wire(wire, leaves)))
  note("adopted")
  out.append(("hex", [k.hex() for k in tier.host_keys()]))
  out.append(("counters", {k: metrics.counter_value(k) - v for k, v in c0.items()}))
  tier.clear()
  note("clear")
  return out


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_tier_manager_decisions_match_reference(policy):
  want = _tier_script("jax", policy)
  assert _tier_script("port", policy) == want
  # Under LRU the restore touched keys 0-1, so the budget dropped key 2;
  # under FIFO it dropped key 0 and key 2 still restores.
  assert ("restore evicted", "KeyError" if policy == "lru" else None) in want
  assert ("adopt other tag", 0) in want and ("adopt other geometry", 0) in want


def test_spill_failure_degrades_to_plain_eviction_and_is_counted():
  def broken(pages):
    raise RuntimeError("injected spill failure")

  tier = ttier.KvTierManager(page_size=4, read_pages=broken, write_pages=None, budget_bytes=1 << 20)
  before = tmetrics.counter_value("kv_tier_spill_failures_total", labels={"error": "RuntimeError"})
  tier.spill([(b"a", 1)])
  assert tier.host_pages == 0
  assert tmetrics.counter_value("kv_tier_spill_failures_total", labels={"error": "RuntimeError"}) == before + 1


# ------------------------------------------------- real page round trip


def _filled_pools(quant: str, rng, P: int = 9, ps: int = 8):
  """The same seeded bytes in a JAX pool and a port pool (bf16 pages, or
  int8 / int4 codes with f32 scales)."""
  jc, tc = jconfig.tiny_test_config(n_layers=2), tconfig.tiny_test_config(n_layers=2)
  jpool = jpaged.init_paged_pool(jc, 2, P, ps, dtype=jnp.bfloat16, quant=quant)
  tpool = tpaged.init_paged_pool(tc, 2, P, ps, dtype=torch.bfloat16, quant=quant)
  jout, tout = {}, {}
  for name, leaf in jpool.items():
    assert tuple(tpool[name].shape) == tuple(leaf.shape)
    if name.endswith("_scale"):
      vals = rng.uniform(0.005, 0.05, size=leaf.shape).astype(np.float32)
    elif quant:
      vals = rng.integers(-128, 128, size=leaf.shape).astype(np.int8)
    else:
      vals = rng.standard_normal(leaf.shape).astype(np.float32)
    jout[name] = jnp.asarray(vals, leaf.dtype)
    tout[name] = torch.from_numpy(vals).to(tpool[name].dtype)
  return jout, tout


def _bits(x) -> np.ndarray:
  """A host page as comparable bits: bf16 as uint16, anything else as is."""
  if isinstance(x, torch.Tensor):
    return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
  x = np.asarray(x)
  return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_page_round_trip_is_byte_identical_to_the_reference(quant):
  jpool, tpool = _filled_pools(quant, np.random.default_rng(61))
  for name in jpool:
    np.testing.assert_array_equal(_bits(tpool[name]), _bits(np.asarray(jpool[name])))
  box = {"jax": jpool, "port": tpool}
  ops = DecoderBatchOps(types.SimpleNamespace(device=torch.device("cpu")))

  def jwrite(pages, data):
    box["jax"] = jtier.scatter_pages(box["jax"], pages, data)

  def twrite(pages, data):
    box["port"] = ops.write_pages(box["port"], pages, data)

  tiers = {
    "jax": jtier.KvTierManager(page_size=8, read_pages=lambda p: jtier.gather_pages(box["jax"], p), write_pages=jwrite, budget_bytes=1 << 24),
    "port": ttier.KvTierManager(page_size=8, read_pages=lambda p: ops.read_pages(box["port"], p), write_pages=twrite, budget_bytes=1 << 24),
  }
  keys = [f"rt-{quant}-{i}".encode() for i in range(3)]
  golden = {name: _bits(tpool[name][:, [2, 3, 5]].clone()) for name in tpool}
  for tier in tiers.values():
    tier.kv_quant = quant
    tier.spill(list(zip(keys, [2, 3, 5])))
    with tier._lock:
      tier._materialize_locked(tier._pending[0])
  for key in keys:
    j, t = tiers["jax"]._entries[key]["data"], tiers["port"]._entries[key]["data"]
    assert set(j) == set(t)
    for name in j:
      np.testing.assert_array_equal(_bits(t[name]), _bits(j[name]), err_msg=f"{quant}/{name}")
  assert tiers["port"].stats() == tiers["jax"].stats()
  # The device reuses the evicted pages; restore into three others.
  box["jax"] = {name: leaf.at[:, [2, 3, 5]].set(0) for name, leaf in box["jax"].items()}
  for leaf in box["port"].values():
    leaf[:, [2, 3, 5]] = 0
  for tier in tiers.values():
    tier.restore_into(keys, [6, 7, 8])
  for name in golden:
    # Page 0 is the trash page: the reference pads its scatter to a power
    # of two with writes there.
    np.testing.assert_array_equal(_bits(box["port"][name][:, 1:]), _bits(np.asarray(box["jax"][name])[:, 1:]), err_msg=f"{quant}/{name}")
    np.testing.assert_array_equal(_bits(box["port"][name][:, [6, 7, 8]]), golden[name])


# -------------------------------------------------------------- servers


@pytest.fixture(scope="module")
def model():
  jc = jconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  tc = tconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  jshard, tshard = JShard("tiny", 0, 1, 2), Shard("tiny", 0, 1, 2)
  jp = jdec.init_shard_params(jax.random.PRNGKey(8), jc, jshard)
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, tshard)
  return jc, tc, jshard, tshard, jp, tp


@pytest.fixture
def knobs(monkeypatch):
  for k in ("XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_MIXED_BUDGET", "XOT_TPU_KV_QUANT", "XOT_TPU_BATCH_PAGES", "XOT_TPU_QOS_PREEMPT_SPILL", "XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM"):
    monkeypatch.delenv(k, raising=False)
  monkeypatch.setenv("XOT_TPU_PAGE_SIZE", "4")
  return monkeypatch


def _server(model, pkg: str, **kw):
  jc, tc, js, ts, jp, tp = model
  if pkg == "jax":
    engine = JaxShardedInferenceEngine(use_local_mesh=False)
    engine.load_test_model(js, jc, jp)
  else:
    engine = TorchShardedInferenceEngine(device="cpu")
    engine.load_test_model(ts, tc, tp)
  return PACKAGES[pkg][3](engine, **kw)


def _counters(pkg: str) -> dict:
  metrics = PACKAGES[pkg][2]
  return {k: metrics.counter_value(k) for k in TIER_COUNTERS}


def _deltas(pkg: str, before: dict) -> dict:
  return {k: v - before[k] for k, v in _counters(pkg).items()}


def _submit(server, rid, prompt, max_tokens, emit=lambda *a: None, **kw):
  return server.submit(rid, np.asarray(prompt, np.int32), max_tokens=max_tokens, temp=0.0, top_k=35, eos_ids=(), emit=emit, **kw)


def _preempt_run(model, pkg: str, lookahead: bool, preempt_spill: bool = True) -> tuple:
  """One slot: a batch row streams, an interactive request preempts it;
  its donated pages spill while the interactive row runs and its resume
  restores them from the host. Returns tokens, streams, counter deltas and
  each admission's prefix hit."""
  qos = PACKAGES[pkg][1]
  server = _server(model, pkg, n_slots=1, chunk=2, lookahead=lookahead, qos=qos.QosPolicy(qos.QosConfig(aging_s=10_000.0, preempt_spill=preempt_spill)))
  admissions = []
  prepare = server._prepare

  def spy(req, row, **kw):
    status, r = prepare(req, row, **kw)
    if r is not None:
      admissions.append((req.request_id, len(req.tokens), r.prefix_len))
    return status, r

  server._prepare = spy
  before = _counters(pkg)
  streams: dict = {}

  async def run():
    started = asyncio.Event()

    def emit(rid, toks, fin):
      streams.setdefault(rid, []).extend(toks)
      if rid == "bg" and len(streams["bg"]) >= 4:
        started.set()

    bg = asyncio.create_task(_submit(server, "bg", [3, 25, 9], 10, emit, priority="batch"))
    await asyncio.wait_for(started.wait(), timeout=60)
    vip = await asyncio.wait_for(_submit(server, "vip", [7, 1, 88, 42, 5, 11, 23, 4, 91, 33, 8, 17, 2], 4, emit, priority="interactive"), timeout=60)
    return vip, await asyncio.wait_for(bg, timeout=60)

  out = asyncio.run(run())
  state = server.allocator.audit()
  assert all(s is None for s in server.slots) and state["referenced"] == 0
  server.shutdown()
  return out, streams, _deltas(pkg, before), admissions


@pytest.mark.parametrize("lookahead", [True, False])
@pytest.mark.parametrize("kv_quant", ["", "int8", "int4"])
def test_preempted_row_resumes_through_host_restore_like_the_reference(model, knobs, lookahead, kv_quant):
  knobs.setenv("XOT_TPU_KV_QUANT", kv_quant)
  knobs.setenv("XOT_TPU_BATCH_PAGES", "6")  # 5 usable pages: the interactive row's footprint evicts the victim's
  got, want = _preempt_run(model, "port", lookahead), _preempt_run(model, "jax", lookahead)
  assert got[:3] == want[:3]
  (vip, bg), streams, deltas, admissions = got
  assert streams["bg"] == bg and len(bg) == 10 and len(vip) == 4
  assert deltas["qos_preemptions_total"] == 1 and deltas["kv_tier_spilled_pages_total"] > 0 and deltas["kv_tier_restored_pages_total"] > 0
  # The resume admits with every full page of its absorbed stream (prompt
  # and generated tokens) as a prefix, less the one suffix token prefill needs.
  rid, S, prefix = admissions[-1]
  assert rid == "bg" and prefix == ((S - 1) // 4) * 4 and prefix > 3
  assert admissions == want[3]


def test_preempt_spill_off_resumes_by_recompute(model, knobs):
  """``preempt_spill`` off (``XOT_TPU_QOS_PREEMPT_SPILL=0``) donates only
  the victim's prompt pages, so its resume recomputes the generated span;
  the tokens are those of the transfer resume."""
  got, want = _preempt_run(model, "port", True, preempt_spill=False), _preempt_run(model, "jax", True, preempt_spill=False)
  assert got[:3] == want[:3] and got[0] == _preempt_run(model, "port", True)[0]
  assert got[3][-1][0] == "bg" and got[3][-1][2] == 0  # nothing of the 3-token prompt is a full page


def _sessions_run(model, pkg: str) -> tuple:
  """Six three-turn conversations on two slots and 12 usable pages: every
  turn of every session is sent at once, and turn t+1 carries turn t's
  prompt, answer and one more user token, so history parks on the host
  between turns and comes back by restore."""
  server = _server(model, pkg, n_slots=2, chunk=2, qos=False)
  before = _counters(pkg)
  prompts = {s: [10 + s, 40 + s, 70 + s] for s in range(6)}
  results = []

  async def run():
    for turn in range(3):
      outs = await asyncio.wait_for(asyncio.gather(*(_submit(server, f"s{s}-t{turn}", prompts[s], 4) for s in prompts)), timeout=120)
      server.allocator.audit()
      for s, out in zip(prompts, outs):
        results.append((s, turn, list(prompts[s]), list(out)))
        prompts[s] = prompts[s] + list(out) + [5 + s + turn]

  asyncio.run(run())
  server.allocator.audit()
  server.shutdown()
  return results, _deltas(pkg, before)


def test_open_sessions_exceed_slots_with_host_parking_like_the_reference(model, knobs):
  knobs.setenv("XOT_TPU_BATCH_PAGES", "13")
  # Speculation's worst-case page headroom (chunk·(gamma_max+1) tokens a
  # row) exhausts this 12-page pool in both packages alike, so the pin
  # stays on both sides here.
  knobs.setenv("XOT_TPU_SPEC_BATCH", "0")
  got, want = _sessions_run(model, "port"), _sessions_run(model, "jax")
  assert got == want
  results, deltas = got
  assert len(results) == 18 and deltas["kv_tier_spilled_pages_total"] > 0 and deltas["kv_tier_restored_pages_total"] > 0


def _suffix_run(model, pkg: str) -> list:
  """A chain whose first page is evicted while its later pages stay
  device-cached: the restore run stops at the first cached key."""
  server = _server(model, pkg, n_slots=1, chunk=2, qos=False)
  prompt = [3, 25, 9, 14, 7, 2, 81, 5, 6, 44, 12, 31, 19]
  metrics = PACKAGES[pkg][2]
  out = []

  async def run():
    out.append(await _submit(server, "t1", prompt, 4))
    server.allocator._evict(len(server.allocator._lru))  # the whole chain to the host
    r0 = metrics.counter_value("kv_tier_restored_pages_total")
    out.append(await _submit(server, "t2", prompt, 4))
    out.append(metrics.counter_value("kv_tier_restored_pages_total") - r0)
    server.allocator._evict(1)  # only the chain's first key: the suffix stays cached
    r0 = metrics.counter_value("kv_tier_restored_pages_total")
    out.append(await _submit(server, "t3", prompt, 4))
    out.append(metrics.counter_value("kv_tier_restored_pages_total") - r0)

  asyncio.run(run())
  server.allocator.audit()
  server.shutdown()
  return out


def test_restore_run_stops_at_a_device_cached_suffix(model, knobs):
  got = _suffix_run(model, "port")
  assert got == _suffix_run(model, "jax")
  assert got[0] == got[1] == got[3] and got[2] == 3 and got[4] == 1


def _failed_restore_run(model, pkg: str) -> list:
  server = _server(model, pkg, n_slots=1, chunk=2, qos=False)
  prompt = [3, 25, 9, 14, 7, 2, 81, 5]

  async def run():
    first = await _submit(server, "a", prompt, 4)
    server.allocator._evict(len(server.allocator._lru))

    def broken_write(pages, data):
      raise RuntimeError("injected restore failure")

    server.tier._write = broken_write
    return [first, await _submit(server, "b", prompt + first + [50], 4)]

  out = asyncio.run(run())
  server.allocator.audit()
  server.shutdown()
  return out


def test_failed_restore_recomputes_and_is_counted(model, knobs):
  knobs.setenv("XOT_TPU_BATCH_PAGES", "6")
  label = {"error": "RuntimeError"}
  before = tmetrics.counter_value("kv_tier_restore_failures_total", labels=label)
  got = _failed_restore_run(model, "port")
  assert tmetrics.counter_value("kv_tier_restore_failures_total", labels=label) == before + 1
  assert got == _failed_restore_run(model, "jax")


def _single_tier_run(model, pkg: str, tier_on: bool, knobs) -> tuple:
  if tier_on:
    knobs.delenv("XOT_TPU_KV_TIER", raising=False)
  else:
    knobs.setenv("XOT_TPU_KV_TIER", "0")
  server = _server(model, pkg, n_slots=2, chunk=2, qos=False)
  out = asyncio.run(_submit(server, "t", [3, 25, 9, 14, 7, 2, 81, 5, 6], 8))
  state = server.allocator.audit()
  res = (list(out), state, server.tier is None, server.allocator.spill_hook is None)
  server.shutdown()
  return res


@pytest.mark.parametrize("tier_on", [False, True])
def test_kv_tier_off_is_the_single_tier_pool(model, knobs, tier_on):
  """``XOT_TPU_KV_TIER=0``: no tier, no spill hook, only the prompt's full
  pages donated (the single-tier pool); on: the generated full pages too. The
  tokens are the same either way and equal the reference's."""
  got = _single_tier_run(model, "port", tier_on, knobs)
  assert got == _single_tier_run(model, "jax", tier_on, knobs)
  assert got[2] is got[3] is (not tier_on)
  assert got[1]["cached"] == ((9 + 8 - 1) // 4 if tier_on else 9 // 4)
  if tier_on:
    assert got[0] == _single_tier_run(model, "port", False, knobs)[0]


def test_tier_knob_parse_matches_reference(monkeypatch):
  for value in (None, "", "0", "false", "no", "off", "1", "true", "FALSE"):
    if value is None:
      monkeypatch.delenv("XOT_TPU_KV_TIER", raising=False)
    else:
      monkeypatch.setenv("XOT_TPU_KV_TIER", value)
    assert ttier.kv_tier_enabled() is jtier.kv_tier_enabled(), value
  for k, v in {"XOT_TPU_KV_TIER_HOST_MB": "3", "XOT_TPU_KV_TIER_EVICT": "fifo", "XOT_TPU_KV_TIER_INFLIGHT": "bad", "XOT_TPU_QOS_PREEMPT_SPILL": "false"}.items():
    monkeypatch.setenv(k, v)
  j = jtier.KvTierManager.from_env(page_size=8, read_pages=None, write_pages=None)
  t = ttier.KvTierManager.from_env(page_size=8, read_pages=None, write_pages=None)
  assert (t.budget_bytes, t.evict_policy, t.max_inflight) == (j.budget_bytes, j.evict_policy, j.max_inflight) == (3 << 20, "fifo", 4)
  assert tqos.QosConfig.from_env().preempt_spill is jqos.QosConfig.from_env().preempt_spill is False


# -------------------------------------------------------- prefix registry


class Clock:
  def __init__(self) -> None:
    self.t = 50.0

  def __call__(self) -> float:
    return self.t


def _registry_script(pkg: str, monkeypatch) -> list:
  monkeypatch.setenv("XOT_TPU_PREFIX_ADVERT_TTL_S", "30")
  clock = Clock()
  reg = PACKAGES[pkg][0].PrefixRegistry(max_keys=4, clock=clock)
  keys = [f"k{i}".encode() for i in range(6)]
  out = []
  reg.note(keys)
  reg.note([keys[2]])
  out.append(reg.local_hexes())
  out.append(reg.local_hexes(limit=2))
  reg.update_remote("peer-a", [keys[0].hex(), "zz-not-hex", keys[1].hex()])
  clock.t += 10
  reg.update_remote("peer-b", [keys[1].hex()] * 3 + [k.hex() for k in keys])
  out.append((reg.locate(keys[0]), reg.locate(keys[1]), reg.locate(keys[5]), reg.snapshot()))
  clock.t += 25  # peer-a's advert is 35 s old: past the TTL
  out.append((reg.locate(keys[1]), reg.stale_remote_ids(), reg.snapshot()))
  monkeypatch.setenv("XOT_TPU_PREFIX_ADVERT_TTL_S", "0")  # no expiry
  out.append((reg.locate(keys[1]), reg.stale_remote_ids()))
  monkeypatch.setenv("XOT_TPU_PREFIX_ADVERT_TTL_S", "bad")
  out.append((reg.locate(keys[1]), reg.stale_remote_ids()))
  reg.update_remote("peer-a", [keys[2].hex()])
  reg.forget_remote("peer-b")
  out.append((reg.locate(keys[0]), reg.locate(keys[2]), reg.snapshot()))
  reg.clear_local()
  out.append((reg.local_hexes(), reg.snapshot()))
  reg.clear()
  out.append(reg.snapshot())
  return out


def test_prefix_registry_matches_reference(monkeypatch):
  want = _registry_script("jax", monkeypatch)
  assert _registry_script("port", monkeypatch) == want
  assert want[0][0] == b"k2".hex() and len(want[0]) == 4 and want[3][1] == ["peer-a"]


# --------------------------------------------------------------------- API


def _jax_kv_tier_body(server) -> dict:
  node = types.SimpleNamespace(inference_engine=types.SimpleNamespace(_batched_server=server))
  resp = asyncio.run(JaxChatGPTAPI.handle_kv_tier(types.SimpleNamespace(node=node), types.SimpleNamespace(query={})))
  return json.loads(resp.body)


def _port_kv_tier_body(server) -> dict:
  node = types.SimpleNamespace(on_token=AsyncCallbackSystem(), inference_engine=types.SimpleNamespace(_batched_server=server))
  api = ChatGPTAPI(node, "TorchShardedInferenceEngine")
  port = find_available_port("127.0.0.1")

  async def run():
    http = await api.run(host="127.0.0.1", port=port)
    try:
      def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
          return json.loads(resp.read())

      return await asyncio.to_thread(get, "/v1/kv/tier"), await asyncio.to_thread(get, "/v1/kv/tier?scope=cluster")
    finally:
      http.close()
      await http.wait_closed()

  local, cluster = asyncio.run(run())
  assert set(cluster) == set(local)
  return local


def _key_tree(body: dict) -> dict:
  """Each top-level key with its nested keys (or its value's type)."""
  return {k: sorted(v) if isinstance(v, dict) else type(v).__name__ for k, v in body.items()}


def test_kv_tier_endpoint_has_the_reference_keys(model, knobs):
  want = _jax_kv_tier_body(None)
  got = _port_kv_tier_body(None)
  assert _key_tree(got) == _key_tree(want) and got["enabled"] is True
  servers = {pkg: _server(model, pkg, n_slots=1, chunk=2, qos=False) for pkg in PACKAGES}
  for s in servers.values():
    asyncio.run(_submit(s, "x", [3, 25, 9, 14, 7], 3))
    s.allocator._evict(len(s.allocator._lru))
  got, want = _port_kv_tier_body(servers["port"]), _jax_kv_tier_body(servers["jax"])
  assert _key_tree(got) == _key_tree(want)
  assert got["host"] == want["host"] and got["host"]["host_pages"] == 1
  for s in servers.values():
    assert s.prefix_hexes() == [k.hex() for k in s.tier.host_keys()]
    s.shutdown()
    assert s.tier.host_pages == 0
