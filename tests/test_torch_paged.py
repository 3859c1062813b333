"""The port's paged-KV pieces against the JAX package's, on the CPU, with
inputs made by numpy from a seed: the page-pool ops, the plain version of
K3 against the Pallas paged decode kernel in interpret mode and the gather
reference (bf16-layout, int8 and int4 pools; lengths on page edges; a
trash-page row; shuffled tables; mp not a multiple of the page tile), the
int4 KV quantizers, per-row sampling, and the page allocator.

Tolerance: f32 attention at rtol = atol = 2e-4 (the HF golden tolerance,
tests/test_hf_golden.py:334); pool ops, quantizers and the allocator are
compared exactly. The CUDA kernel itself is held against the plain version
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.inference import paging as jpaging
from xotorch_support_jetson_tpu.models import config as jconfig
from xotorch_support_jetson_tpu.models.quantize import quantize_kv as jax_quantize_kv, quantize_kv_int4 as jax_quantize_kv_int4, unpack_int4_kv as jax_unpack_int4_kv
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu_torch.inference import paging as tpaging
from xotorch_support_jetson_tpu_torch.models import config as tconfig
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv_int4, unpack_int4_kv
from xotorch_support_jetson_tpu_torch.ops import paged
from xotorch_support_jetson_tpu_torch.ops.sampling import sample_logits_per_row

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
PS = 8


def _t(a):
  return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ pool ops


def test_init_paged_pool_matches_jax_layout():
  for quant in ("", "int8", "int4"):
    jc, tc = jconfig.tiny_test_config(n_layers=2), tconfig.tiny_test_config(n_layers=2)
    want = jpaged.init_paged_pool(jc, 2, 5, PS, quant=quant)
    got = paged.init_paged_pool(tc, 2, 5, PS, quant=quant)
    assert sorted(got) == sorted(want)
    for key in want:
      assert tuple(got[key].shape) == tuple(want[key].shape), (quant, key)
      np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))


def test_write_token_kv_matches_jax_and_updates_in_place():
  rng = np.random.default_rng(0)
  pool = rng.standard_normal((7, 2, PS, 16)).astype(np.float32)
  new = rng.standard_normal((3, 2, 16)).astype(np.float32)
  bt = np.array([[3, 5, 0], [1, 2, 6], [0, 0, 0]], np.int32)  # row 2: inactive, trash page
  pos = np.array([12, 3, 0], np.int32)
  want = np.asarray(jpaged.write_token_kv(jnp.asarray(pool), jnp.asarray(new), jnp.asarray(bt), jnp.asarray(pos), PS))
  tpool = _t(pool.copy())
  got = paged.write_token_kv(tpool, _t(new), _t(bt), _t(pos), PS)
  assert got is tpool
  np.testing.assert_array_equal(tpool.numpy(), want)


def test_gather_scatter_and_touched_targets_match_jax():
  rng = np.random.default_rng(1)
  pool = rng.standard_normal((2, 9, 2, PS, 4)).astype(np.float32)  # [L, P, H, ps, kd]
  bt = np.array([[4, 7, 2, 0], [1, 8, 0, 0], [0, 0, 0, 0]], np.int32)
  prefix = np.array([8, 0, 0], np.int32)
  prompt = np.array([25, 9, 1], np.int32)
  np.testing.assert_array_equal(_np(paged.gather_pages(_t(pool[0]), _t(bt))), np.asarray(jpaged.gather_pages(jnp.asarray(pool[0]), jnp.asarray(bt))))
  g_want = np.asarray(jpaged.gather_row_pages(jnp.asarray(pool), jnp.asarray(bt)))
  g_got = paged.gather_row_pages(_t(pool), _t(bt))
  np.testing.assert_array_equal(g_got.numpy(), g_want)
  tgt_want = np.asarray(jpaged.touched_page_targets(jnp.asarray(bt), jnp.asarray(prefix), jnp.asarray(prompt), PS))
  tgt_got = paged.touched_page_targets(_t(bt), _t(prefix), _t(prompt), PS)
  np.testing.assert_array_equal(tgt_got.numpy(), tgt_want)
  update = rng.standard_normal(g_want.shape).astype(np.float32)
  want = np.asarray(jpaged.scatter_row_pages(jnp.asarray(pool), jnp.asarray(update), jnp.asarray(tgt_want)))
  tpool = _t(pool.copy())
  paged.scatter_row_pages(tpool, _t(update), tgt_got)
  real = np.ones(9, bool)
  real[0] = False  # the trash page takes whichever duplicate write lands last
  np.testing.assert_array_equal(tpool.numpy()[:, real], want[:, real])


@pytest.mark.parametrize("width", [1, 3])
def test_gather_row_pages_is_contiguous_at_any_window(width):
  """A one-page window (a short prompt's prefill or mixed slice) too: K1
  takes the gathered K/V only as contiguous tensors."""
  rng = np.random.default_rng(2)
  pool = rng.standard_normal((2, 9, 2, PS, 4)).astype(np.float32)
  bt = np.array([[4, 7, 2], [1, 8, 5]], np.int32)[:, :width]
  got = paged.gather_row_pages(_t(pool), _t(bt))
  assert got.is_contiguous()
  np.testing.assert_array_equal(got.numpy(), np.asarray(jpaged.gather_row_pages(jnp.asarray(pool), jnp.asarray(bt))))


# ------------------------------------------------------------- attention


def _attention_case(kv, lengths, mp=6, Hq=4, Hkv=2, hd=16, seed=0):
  """q, pools (JAX-quantized when asked) and shuffled tables: rows own
  distinct non-contiguous pages; a length-1 row whose table is all trash
  page stands for an inactive row;
  entries past a row's last page point at other rows' pages."""
  rng = np.random.default_rng(seed)
  B = len(lengths)
  P = B * mp + 1
  q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
  k = rng.standard_normal((P, Hkv, PS, hd)).astype(np.float32)
  v = rng.standard_normal((P, Hkv, PS, hd)).astype(np.float32)
  bt = rng.permutation(np.arange(1, P)).reshape(B, mp).astype(np.int32)
  for b, n in enumerate(lengths):
    if n == 1:
      bt[b] = 0  # a row held on the trash page (an inactive row's table)
  scales = {}
  if kv != "bf16":
    quant = jax_quantize_kv_int4 if kv == "int4" else jax_quantize_kv
    (k, ks), (v, vs) = quant(jnp.asarray(k)), quant(jnp.asarray(v))
    k, v, ks, vs = (np.asarray(a) for a in (k, v, ks, vs))
    scales = dict(k_scale_pool_l=ks, v_scale_pool_l=vs)
  return q, k, v, bt, np.asarray(lengths, np.int32), scales


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("lengths", [[1, PS, PS + 1], [5 * PS + 3, 17, 2 * PS]])
def test_paged_decode_plain_matches_jax_kernel_and_gather(kv, lengths):
  q, k, v, bt, lens, scales = _attention_case(kv, lengths)
  jscales = {n: jnp.asarray(a) for n, a in scales.items()}
  # mp = 6 is not a multiple of the 4-page tile: the kernel's trailing tile
  # slots clamp and mask.
  want_kernel = np.asarray(jpaged.paged_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(lens), PS, pages_per_step=4, interpret=True, **jscales))
  want_gather = np.asarray(jpaged.paged_gqa_attention_ref(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(lens), PS, **jscales))[:, 0]
  tscales = {n: _t(a) for n, a in scales.items()}
  got = paged.paged_decode_attention_ref(_t(q), _t(k), _t(v), _t(bt), _t(lens), PS, **tscales)
  np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
  np.testing.assert_allclose(got.numpy(), want_gather, **TOL)
  # The wrapper takes the plain version for CPU tensors, and counts nothing.
  before = paged.LAUNCHES["paged_decode"]
  np.testing.assert_array_equal(paged.paged_decode_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), PS, **tscales).numpy(), got.numpy())
  assert paged.LAUNCHES["paged_decode"] == before


def test_paged_decode_wrapper_requires_both_scales():
  q, k, v, bt, lens, scales = _attention_case("int8", [3])
  with pytest.raises(ValueError, match="passed together"):
    paged.paged_decode_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), PS, k_scale_pool_l=_t(scales["k_scale_pool_l"]))


def test_paged_kernel_gate_honours_the_reference_knobs(monkeypatch):
  """Only XOT_TPU_PAGED_KERNEL=0 asks for the gather path; on a CUDA device a
  head dim with no K3 variant is refused, never sent to the gather path."""
  cfg = tconfig.tiny_test_config(dim=256, n_heads=4)  # head_dim 64
  odd = tconfig.tiny_test_config()  # head_dim 16: no kernel variant
  assert paged.paged_kernel_supported(cfg) and paged.paged_kernel_supported(odd)
  monkeypatch.setenv("XOT_TPU_NO_FLASH", "1")  # K1's knob: not an opt-out of K3
  assert paged.paged_kernel_supported(cfg)
  paged.check_paged_kernel(cfg, "cuda")
  paged.check_paged_kernel(odd, "cpu")  # the CPU runs the plain version at any head dim
  with pytest.raises(NotImplementedError, match="head dim 16"):
    paged.check_paged_kernel(odd, "cuda")
  monkeypatch.setenv("XOT_TPU_PAGED_KERNEL", "0")
  assert not paged.paged_kernel_supported(cfg)
  paged.check_paged_kernel(odd, "cuda")


def test_batched_server_refuses_a_head_dim_k3_lacks_on_cuda():
  from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer

  class CudaEngine:  # a built engine on a card; the check runs before any device work
    cfg = tconfig.tiny_test_config()
    device = torch.device("cuda")

  with pytest.raises(NotImplementedError, match="head dim 16"):
    BatchedServer(CudaEngine())


# ------------------------------------------------------------- quantizers


def test_int4_kv_quantizers_are_bit_identical_to_jax():
  x = np.random.default_rng(3).standard_normal((4, 9, 2, 64)).astype(np.float32) * 3.0
  x[0, 0, 0] = 0.0  # an all-zero vector keeps scale 1
  jcodes, jscale = jax_quantize_kv_int4(jnp.asarray(x))
  codes, scale = quantize_kv_int4(_t(x))
  np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
  np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
  np.testing.assert_array_equal(unpack_int4_kv(codes).numpy(), np.asarray(jax_unpack_int4_kv(jcodes)))
  with pytest.raises(ValueError, match="even head dim"):
    quantize_kv_int4(torch.zeros(2, 3))


# --------------------------------------------------------------- sampling


def test_sample_logits_per_row_support_and_greedy_limits():
  rng = np.random.default_rng(4)
  logits = _t(rng.standard_normal((4, 50)).astype(np.float32))
  temps = torch.tensor([1.0, 0.7, 1e-7, 2.0])
  top_ks = torch.tensor([1, 3, 10, 200])  # 200 clips to k_max
  gen = torch.Generator().manual_seed(0)
  draws = torch.stack([sample_logits_per_row(logits, gen, temps, top_ks, k_max=8) for _ in range(200)])
  order = torch.argsort(logits, dim=-1, descending=True)
  assert (draws[:, 0] == order[0, 0]).all()  # top_k 1 is greedy
  assert torch.isin(draws[:, 1], order[1, :3]).all() and len(set(draws[:, 1].tolist())) > 1
  assert (draws[:, 2] == order[2, 0]).all()  # a vanishing temperature is greedy
  assert torch.isin(draws[:, 3], order[3, :8]).all()  # capped at k_max
  again = torch.stack([sample_logits_per_row(logits, torch.Generator().manual_seed(0), temps, top_ks, k_max=8)])
  np.testing.assert_array_equal(again[0].numpy(), draws[0].numpy())  # seeded: reproducible


def test_sample_logits_per_row_follows_the_softmax():
  logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
  gen = torch.Generator().manual_seed(1)
  counts = np.bincount(sample_logits_per_row(logits.expand(20000, 4), gen, torch.ones(20000), torch.full((20000,), 3), k_max=4).numpy(), minlength=4)
  want = torch.softmax(logits[0, :3], -1).numpy()
  np.testing.assert_allclose(counts[:3] / counts.sum(), want, atol=0.015)
  assert counts[3] == 0


# ------------------------------------------------------------- allocator


def test_kv_cache_bytes_and_pages_to_cover_match_jax():
  jc, tc = jconfig.tiny_test_config(), tconfig.tiny_test_config()
  for quant in ("", "int8", "int4"):
    assert tpaging.kv_cache_bytes(tc, 3, 100, quant) == jpaging.kv_cache_bytes(jc, 3, 100, quant)
  for end in (0, 1, 63, 64, 65, 4096):
    assert tpaging.pages_to_cover(end, 64) == jpaging.pages_to_cover(end, 64)


def test_page_allocator_matches_jax_sequence():
  """One scripted life of both allocators — allocations, prefix hits,
  donations, releases and LRU evictions — gives the same pages and the
  same chain-key bytes at every step."""
  rng = np.random.default_rng(5)
  toks = rng.integers(0, 1000, 40)
  assert tpaging.PageAllocator.chain_keys(toks, PS) == jpaging.PageAllocator.chain_keys(toks, PS)
  assert tpaging.PageAllocator.chain_keys(toks.astype(np.int32), PS) == tpaging.PageAllocator.chain_keys(toks, PS)  # dtype-blind
  a, b = tpaging.PageAllocator(12, PS), jpaging.PageAllocator(12, PS)
  log = []
  for alloc in (a, b):
    steps = []
    keys = alloc.chain_keys(toks, PS)
    p1 = alloc.alloc(5)
    for key, page in zip(keys[:3], p1[:3]):
      steps.append(alloc.insert_cached(key, page))
    alloc.free(p1[3:])
    steps.append(alloc.lookup_prefix(keys))  # hits the 3 donated pages
    steps.append(alloc.alloc(8))  # 8 free pages exactly
    steps.append(alloc.alloc(1))  # none left: None
    for p in steps[-3]:
      alloc.release(p)
    steps.append(alloc.alloc(2))  # evicts the two oldest cached pages
    steps.append(alloc.lookup_prefix(keys))  # the chain's head is gone
    steps.append((alloc.n_available, alloc.audit()))
    log.append(steps)
  assert log[0] == log[1]
