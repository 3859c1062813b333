"""Multi-LoRA serving on the card: adapter rows through the captured solo
and batched programs equal the uncaptured functions, an adapter installed
after a capture changes the next replay's output (the stacked leaves keep
their addresses: installs are in-place copies), and adapter rows through
K1, K2, K3 and K4 agree with their plain versions.

Needs an NVIDIA GPU; every test here is marked ``cuda`` and skips without a
card. This file imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_lora_cuda.py``. Tolerances: captured against uncaptured
runs the same kernels on the same inputs, so greedy tokens are identical
and logits equal to 1e-3 relative L2; a kernel against its plain version
at bf16 through two layers within 2e-2 relative L2 (the tolerance of the
kernels' own card tests at these widths).
"""

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params
from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged

pytestmark = pytest.mark.cuda
CAPTURED_REL = 1e-3
KERNEL_REL = 2e-2
CFG = tconfig.tiny_test_config(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512, max_seq_len=512, dtype=torch.bfloat16)
SHARD = Shard("card", 0, 1, 2)


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU")
  return torch.device("cuda")


def _rel(a, b):
  return float((a.float() - b.float()).norm() / b.float().norm())


def _adapter(seed: int, rank: int = 8) -> dict:
  rng = np.random.default_rng(seed)
  L, D = CFG.n_layers, CFG.dim
  outs = {"wq": CFG.n_heads * CFG.head_dim, "wv": CFG.n_kv_heads * CFG.head_dim}
  return {"layers": {t: (rng.normal(0, D**-0.5, (L, D, rank)).astype(np.float32), rng.normal(0, 0.5 / rank**0.5, (L, rank, o)).astype(np.float32)) for t, o in outs.items()}}


def _engine(dev, quant: str = ""):
  """A card engine on random weights with two adapters installed."""
  engine = TorchShardedInferenceEngine(device=dev)
  params = tdec.init_shard_params(CFG, SHARD, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
  engine.load_test_model(SHARD, CFG, quantize_params(params, quant) if quant else params)
  reg = engine.enable_multi_lora(capacity=4, rank=8)
  reg.register("a1", _adapter(1))
  reg.register("a2", _adapter(2))
  return engine, reg.acquire("a1"), reg.acquire("a2")


def _prompt(dev, B=1, S=40, seed=0):
  return torch.randint(0, CFG.vocab_size, (B, S), generator=torch.Generator(device=dev).manual_seed(seed), device=dev, dtype=torch.int32)


def test_captured_solo_programs_equal_eager_with_adapters(dev):
  engine, s1, _ = _engine(dev)
  p = engine.params
  toks = _prompt(dev)
  x = np.zeros((1, 128), np.int32)
  x[0, :40] = toks[0].cpu().numpy()
  cache = tdec.init_kv_cache(CFG, 2, 1, 512, device=dev)
  progs = tdec.SoloPrograms(p, CFG, SHARD, tdec.init_kv_cache(CFG, 2, 1, 512, device=dev))
  got = progs.prefill(x, 40, adapter_ids=s1)
  want, _ = tdec.shard_forward(p, CFG, SHARD, torch.from_numpy(x).to(dev), torch.arange(128, dtype=torch.int32, device=dev)[None], cache, head_pos=torch.tensor([39], device=dev), adapter_ids=torch.tensor([s1], dtype=torch.int32, device=dev))
  assert _rel(got, want[:, 0]) < CAPTURED_REL
  first = int(got.argmax())
  rep, _ = tdec.fused_decode(p, CFG, SHARD, first, progs.cache, 40, 12, programs=progs, adapter_ids=s1)
  eag, _ = tdec.fused_decode(p, CFG, SHARD, torch.tensor([[first]], dtype=torch.int32, device=dev), cache, torch.tensor([40], dtype=torch.int32, device=dev), 12, adapter_ids=s1)
  assert torch.equal(rep, eag)
  base, _ = tdec.fused_decode(p, CFG, SHARD, first, progs.cache, 40, 12, programs=progs)
  assert not torch.equal(base, rep)  # the hook-off graph is another graph, and the adapter moves the tokens


def test_install_after_capture_changes_the_next_replay(dev):
  """A captured step reads the slot's factors at replay: a new adapter
  installed into the same slot after the capture gives the eager
  function's output on the new factors."""
  engine, s1, _ = _engine(dev)
  p, reg = engine.params, engine.adapter_registry
  progs = tdec.SoloPrograms(p, CFG, SHARD, tdec.init_kv_cache(CFG, 2, 1, 512, device=dev))
  x = np.zeros((1, 128), np.int32)
  x[0, :40] = _prompt(dev)[0].cpu().numpy()
  before = progs.prefill(x, 40, adapter_ids=s1)
  addr = p["layers"]["wq_alora_a"].data_ptr()
  reg.register("a1", _adapter(7))  # a refresh of a resident adapter reinstalls its slot in place
  assert p["layers"]["wq_alora_a"].data_ptr() == addr and reg.slot_of("a1") == s1
  after = progs.prefill(x, 40, adapter_ids=s1)
  cache = tdec.init_kv_cache(CFG, 2, 1, 512, device=dev)
  want, _ = tdec.shard_forward(p, CFG, SHARD, torch.from_numpy(x).to(dev), torch.arange(128, dtype=torch.int32, device=dev)[None], cache, head_pos=torch.tensor([39], device=dev), adapter_ids=torch.tensor([s1], dtype=torch.int32, device=dev))
  assert _rel(after, want[:, 0]) < CAPTURED_REL and _rel(after, before) > 10 * CAPTURED_REL


@pytest.mark.parametrize("dense", [False, True], ids=["paged", "dense"])
def test_captured_batched_chunk_equals_eager_with_adapter_rows(dev, dense):
  """B=4 rows on slots (a1, base, a2, a1): the admission prefill and a
  plain chunk as replays equal the uncaptured functions."""
  engine, s1, s2 = _engine(dev)
  ops = engine.batch_ops
  ids = np.array([s1, 0, s2, s1], np.int32)
  tok = _prompt(dev, B=4, S=40).cpu().numpy()
  tok = np.pad(tok, ((0, 0), (0, 88)))
  lens = np.array([40, 33, 27, 40], np.int32)
  temps, tks = np.zeros(4, np.float32), np.ones(4, np.int32)
  firsts = []
  chunks = []
  for captured in (True, False):
    if dense:
      store = ops.init_cache(4, 512) if captured else tdec.init_kv_cache(CFG, 2, 4, 512, device=dev)
      first, store = ops.prefill_into_slots_sampled(tok, store, np.arange(4, dtype=np.int32), lens, temps, tks, 8, 5, adapter_ids=ids)
      out = ops.batch_decode(first.reshape(4, 1), store, lens, np.ones(4, bool), temps, tks, 8, 8, 6, adapter_ids=ids)
    else:
      store = ops.init_pool(4 * 8 + 1, 64) if captured else paged.init_paged_pool(CFG, 2, 4 * 8 + 1, 64, device=dev)
      bt = (1 + np.arange(32, dtype=np.int32)).reshape(4, 8)
      first, store = ops.prefill_into_pages_many_sampled(tok, store, bt[:, :2], np.zeros(4, np.int32), lens, 64, temps, tks, 8, 5, adapter_ids=ids)
      out = ops.paged_batch_decode(first.reshape(4, 1), store, bt, lens, np.ones(4, bool), temps, tks, 8, 8, 64, 6, adapter_ids=ids)
    firsts.append(first.cpu())
    chunks.append(out[0].cpu())
  assert torch.equal(firsts[0], firsts[1]) and torch.equal(chunks[0], chunks[1])


def _adapter_logits(dev, engine, s1, s2, B=2, S=40):
  """Cached prefill then one decode step for rows on (a1, a2)."""
  p = engine.params
  toks = _prompt(dev, B=B, S=S, seed=4)
  ids = torch.tensor([s1, s2][:B], dtype=torch.int32, device=dev)
  cache = tdec.init_kv_cache(CFG, 2, B, 512, device=dev)
  pre, cache = tdec.shard_forward(p, CFG, SHARD, toks, torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S), cache, adapter_ids=ids)
  step, _ = tdec.shard_forward(p, CFG, SHARD, toks[:, -1:], torch.full((B, 1), S, dtype=torch.int32, device=dev), cache, adapter_ids=ids)
  return pre, step


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_adapter_rows_through_each_kernel_match_its_plain_version(dev, monkeypatch, kernel):
  engine, s1, s2 = _engine(dev, quant="int4" if kernel == "K4" else "")
  if kernel in ("K1", "K2"):
    knob, off = ("XOT_TPU_FLASH_DECODE", "XOT_TPU_NO_FLASH") if kernel == "K2" else (None, "XOT_TPU_NO_FLASH")
    if knob:
      monkeypatch.setenv(knob, "1")
      monkeypatch.setenv("XOT_TPU_FLASH_DECODE_MIN", "1")
    fa.reset_launch_counts()
    got = _adapter_logits(dev, engine, s1, s2)
    name = "flash_decode" if kernel == "K2" else "flash_prefill"
    assert fa.LAUNCHES[name] > 0
    monkeypatch.setenv(off, "1")
    want = _adapter_logits(dev, engine, s1, s2)
  elif kernel == "K4":
    k4.reset_launch_counts()
    got = _adapter_logits(dev, engine, s1, s2)
    assert k4.LAUNCHES["int4_matmul"] > 0
    monkeypatch.setenv("XOT_TPU_INT4_KERNEL", "0")
    want = _adapter_logits(dev, engine, s1, s2)
  else:
    p = engine.params
    pool = paged.init_paged_pool(CFG, 2, 9, 64, device=dev)
    bt = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
    toks = _prompt(dev, B=2, S=40, seed=4)
    ids = torch.tensor([s1, s2], dtype=torch.int32, device=dev)
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    tdec.prefill_into_pages_many(p, CFG, SHARD, toks, pool, bt[:, :1], z, torch.full((2,), 40, dtype=torch.int32, device=dev), 64, adapter_ids=ids)
    step = (toks[:, -1:], torch.full((2, 1), 40, dtype=torch.int32, device=dev))
    paged.reset_launch_counts()
    got = tdec.paged_decode_forward(p, CFG, SHARD, *step, {k: v.clone() for k, v in pool.items()}, bt, 64, True, adapter_ids=ids)[0]
    assert paged.LAUNCHES["paged_decode"] > 0
    want = tdec.paged_decode_forward(p, CFG, SHARD, *step, pool, bt, 64, False, adapter_ids=ids)[0]
    got, want = (got,), (want,)
  for a, b in zip(got, want):
    assert _rel(a, b) < KERNEL_REL
    assert torch.equal(a[:, -1].argmax(-1), b[:, -1].argmax(-1))
