"""The port's CUDA kernels (K1 flash prefill, K2 flash decode, K3 paged
decode, K4 int4 matmul) against their plain PyTorch versions, on the card,
at llama-3.2-1b's shapes (attention: Hq 32, Hkv 8, hd 64, bf16, cache 4096,
page size 64 for K3; K4: its five projection shapes, T = 1 … 512, and f32
x) plus other
head dims, page sizes and ragged matmul widths.

The host KV tier's page copies round-trip byte-identically on every pool
type, and K3 reads restored pages bit-identically.

K3 also carries the verify window of batched speculation: B=8 rows × W=9
positions flattened into one launch (``paged_window_attention``); K1 the
solo verify windows (B=1, Sq 5 and 9, offsets up to 4086) and the logprobs
scoring forward's shape (Sq = Skv, offset 0), once per layer there.

K2 and K3 are also held at caches past 4096 and at windows that are not a
whole number of cluster ranges, at GQA groups 1, 2 and 8, and to one device
kernel and one allocation (the output) per call.

Needs an NVIDIA GPU and nvcc; every test here is marked ``cuda`` and skips
without a card. This file imports no JAX, so it runs on a machine with only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.

Tolerances: outputs are bf16 (ulp 2^-8 relative) and K1 rounds the softmax
probabilities to bf16 for its tensor-core P·V product, so kernel and plain
version agree to about 1e-2 on unit-scale values; 3e-2 is the stated bound
(``ATOL``), and the long-prompt, GQA, head-dim and int8 cases are also held
elementwise to ``1e-2 + 2^-7·|ref|`` (``K1_TOL``, chip_smoke.py
``K1_EW_ATOL``).
K3 keeps f32 inside and rounds only its bf16 output, and is held
elementwise to ``atol 2.5e-4 + 2^-7·|ref|`` (``K3_TOL``): one bf16 rounding
step of the value, plus twice the largest absolute reading on an H100
(1.2e-4), so a split-K merge off by a few percent at a 4k context (outputs
~0.02) fails. K2 runs the same device core on a dense cache and is held to
the same bound (``K2_TOL``). K4 sums in f32 and rounds only its bf16 output, as
its plain version does: ``K4_TOL`` is one bf16 rounding step of the value
plus 1e-4 absolute for the f32 summation-order difference near zero (largest
reading on an H100 6.3e-8; outputs are ~N(0, 1), see ``chip_smoke.py``
``K4_ATOL``). With f32 x the kernel writes f32 y with no final rounding:
``K4_F32_TOL`` keeps the same absolute part for the summation order and a
relative part of 1e-5 (f32 sums of up to 8192 terms in another order).
"""

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv, quantize_kv_int4, quantize_weight_int4
from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged

pytestmark = pytest.mark.cuda
ATOL = 3e-2
K3_TOL = dict(atol=2.5e-4, rtol=2.0**-7)
K2_TOL = K3_TOL  # the same device core (csrc/decode_attention.cuh)
K4_TOL = dict(atol=1e-4, rtol=2.0**-7)
K1_TOL = dict(atol=1e-2, rtol=2.0**-7)  # chip_smoke.py K1_EW_ATOL / K1_RTOL, beside the 3e-2 cap
K4_F32_TOL = dict(atol=1e-4, rtol=1e-5)
LLAMA_1B_MATMULS = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256)]  # (in, out): wq/wo, wk/wv, gate/up, down, head


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
  return torch.device("cuda")


def _rand(shape, seed, dev, dtype=torch.bfloat16):
  return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("Sq,offset,hd", [(128, 0, 64), (512, 0, 64), (128, 128, 64), (100, 37, 64), (128, 0, 128), (64, 16, 256)])
def test_flash_prefill_matches_plain(dev, Sq, offset, hd):
  B, Skv, Hq, Hkv = 1, 4096 if hd == 64 else 640, 32 if hd == 64 else 8, 8 if hd == 64 else 2
  q = _rand((B, Sq, Hq, hd), 1, dev)
  k = _rand((B, Skv, Hkv, hd), 2, dev)
  v = _rand((B, Skv, Hkv, hd), 3, dev)
  k[:, offset + Sq :] = 1e4  # junk past the positions must stay masked
  v[:, offset + Sq :] = 1e4
  before = fa.LAUNCHES["flash_prefill"]
  got = fa.flash_attention_prefill(q, k, v, q_offset=offset)
  torch.cuda.synchronize()
  assert fa.LAUNCHES["flash_prefill"] == before + 1
  want = fa.flash_attention_prefill_ref(q, k, v, q_offset=offset)
  assert torch.isfinite(got).all()
  torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("Sq,offsets", [(128, [0]), (512, [0]), (128, [128]), (128, [0, 64])])
def test_flash_prefill_int8_matches_plain(dev, Sq, offsets):
  B, Skv, Hq, Hkv, hd = len(offsets), 4096, 32, 8, 64
  q = _rand((B, Sq, Hq, hd), 4, dev)
  kq, ks = quantize_kv(_rand((B, Skv, Hkv, hd), 5, dev))
  vq, vs = quantize_kv(_rand((B, Skv, Hkv, hd), 6, dev))
  off = torch.tensor(offsets, dtype=torch.int32, device=dev)
  got = fa.flash_attention_prefill(q, kq, vq, q_offset=off, k_scale=ks, v_scale=vs)
  want = fa.flash_attention_prefill_ref(q, kq, vq, q_offset=off, k_scale=ks, v_scale=vs)
  torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=ATOL)


def _check_prefill(dev, Sq, offsets, hd=64, Hq=32, Hkv=8, Skv=4096, quant=False, seed=31):
  """K1 against its plain version on one case: junk (1e4) in every slot
  past a row's last position, offsets as a device tensor (as the decoder
  passes them), int8 codes and scales when ``quant``."""
  B = len(offsets)
  q = _rand((B, Sq, Hq, hd), seed, dev)
  k = _rand((B, Skv, Hkv, hd), seed + 1, dev)
  v = _rand((B, Skv, Hkv, hd), seed + 2, dev)
  for b, off in enumerate(offsets):
    k[b, off + Sq :] = 1e4
    v[b, off + Sq :] = 1e4
  kw = {"q_offset": torch.tensor(offsets, dtype=torch.int32, device=dev)}
  if quant:
    (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    kw.update(k_scale=ks, v_scale=vs)
  before = fa.LAUNCHES["flash_prefill"]
  got = fa.flash_attention_prefill(q, k, v, **kw)
  torch.cuda.synchronize()
  assert fa.LAUNCHES["flash_prefill"] == before + 1
  assert torch.isfinite(got).all()
  for b in range(B):  # row by row: the plain version's scores at Sq 4096 are 2 GB a row
    want = fa.flash_attention_prefill_ref(q[b : b + 1], k[b : b + 1], v[b : b + 1], q_offset=offsets[b], **({"k_scale": kw["k_scale"][b : b + 1], "v_scale": kw["v_scale"][b : b + 1]} if quant else {}))
    assert (got[b : b + 1].float() - want.float()).abs().max().item() <= ATOL
    torch.testing.assert_close(got[b : b + 1].float(), want.float(), **K1_TOL)


@pytest.mark.parametrize("Sq,offset", [(1, 0), (2, 0), (1, 4095), (65, 0), (65, 1000), (777, 0), (777, 3000), (3000, 0), (4096, 0), (512, 3584), (2048, 2048)])
def test_flash_prefill_long_and_ragged_prompts(dev, Sq, offset):
  _check_prefill(dev, Sq, [offset])


@pytest.mark.parametrize("S", [128, 3072])
def test_flash_prefill_scoring_shape(dev, S):
  """The logprobs scoring forward's shape: the sequence's own K/V (Sq =
  Skv), from position 0."""
  _check_prefill(dev, S, [0], Skv=S)


def test_scoring_forward_runs_k1_once_per_layer(dev, monkeypatch):
  """``score_last_tokens`` on the card: K1 in every layer of the
  cache-less forward (hd 64, bf16), chosen log-probs within the serving
  gate's 5e-2 relative L2 of the plain-attention route
  (``XOT_TPU_NO_FLASH``), which launches no K1."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec

  cfg = tconfig.tiny_test_config(dim=256, n_heads=4, n_kv_heads=2, hidden_dim=512, vocab_size=512, max_seq_len=512, dtype=torch.bfloat16)
  shard = Shard("tiny", 0, cfg.n_layers - 1, cfg.n_layers)
  params = tdec.init_shard_params(cfg, shard, torch.Generator(device=dev).manual_seed(0), device=dev)
  toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (1, 256)).astype(np.int32)).to(dev)
  before = fa.LAUNCHES["flash_prefill"]
  got = tdec.score_last_tokens(params, cfg, shard, toks, 200, 64, 20)
  torch.cuda.synchronize()
  assert fa.LAUNCHES["flash_prefill"] - before == cfg.n_layers
  monkeypatch.setenv("XOT_TPU_NO_FLASH", "1")
  want = tdec.score_last_tokens(params, cfg, shard, toks, 200, 64, 20)
  assert fa.LAUNCHES["flash_prefill"] - before == cfg.n_layers
  assert ((got[0] - want[0]).norm() / want[0].norm()).item() < 5e-2
  assert bool((got[0] <= 0).all()) and bool((got[2][:, :-1] >= got[2][:, 1:]).all())


@pytest.mark.parametrize("Sq,offsets", [(512, [0, 128, 128, 1536]), (65, [0, 1000, 3, 3584]), (777, [3000, 0, 17, 2048])])
def test_flash_prefill_mixed_row_offsets(dev, Sq, offsets):
  _check_prefill(dev, Sq, offsets)


@pytest.mark.parametrize("Sq", [5, 9])
@pytest.mark.parametrize("offset", [0, 72, 1024, 4086])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_prefill_verify_windows(dev, Sq, offset, quant):
  """Solo speculation's verify window (and the draft's catch-up): B=1,
  Sq = gamma+1 = 5 (int8 draft, depth 4) or 9 (n-gram depth 8), anywhere
  in the 4096-slot cache up to its last window (4086 + 9 = 4095 slots)."""
  _check_prefill(dev, Sq, [offset], quant=quant)


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (16, 8), (32, 8), (64, 8), (24, 2), (64, 1)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_prefill_gqa_groups(dev, Hq, Hkv, hd):
  _check_prefill(dev, 300, [37], hd=hd, Hq=Hq, Hkv=Hkv, Skv=1024)


@pytest.mark.parametrize("hd,Sq,offset", [(64, 3000, 0), (128, 777, 100), (128, 2048, 0), (256, 777, 100), (256, 130, 0)])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_prefill_head_dims_and_int8(dev, hd, Sq, offset, quant):
  _check_prefill(dev, Sq, [offset], hd=hd, Hq=32 if hd == 64 else 16, Hkv=8 if hd == 64 else 4, Skv=4096 if hd == 64 else 3000, quant=quant)


def test_flash_prefill_rejects_misaligned_tensors(dev):
  """The kernel's TMA reads q, k and v: a view that does not start on a
  16-byte boundary raises instead of launching."""
  q, k = _rand((1, 128, 32, 64), 1, dev), _rand((1, 256, 8, 64), 2, dev)
  shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
  shifted.copy_(q)
  with pytest.raises(ValueError, match="16-byte aligned"):
    fa.flash_attention_prefill(shifted, k, k)


@pytest.mark.parametrize("quant", [False, True])
def test_flash_prefill_is_one_kernel_and_one_allocation_per_call(dev, quant):
  """One device kernel per K1 call at Sq 128 and 2048, and no scratch:
  the output is the call's only allocation (the offsets come as a device
  tensor, as the decoder passes them)."""
  import chip_smoke

  for Sq in (128, 2048):
    q, k, v = _rand((1, Sq, 32, 64), 7, dev), _rand((1, 4096, 8, 64), 8, dev), _rand((1, 4096, 8, 64), 9, dev)
    kw = {"q_offset": torch.zeros(1, dtype=torch.int32, device=dev)}
    if quant:
      (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
      kw.update(k_scale=ks, v_scale=vs)
    assert chip_smoke._kernels_per_call(torch, lambda: fa.flash_attention_prefill(q, k, v, **kw)) == 1
    assert _allocations(lambda: fa.flash_attention_prefill(q, k, v, **kw)) == 1


# The dense batched layout's shapes: verify windows of B=8 rows at their
# own offsets over the 4096-slot cache (spec.batch), and decode steps of
# B=8 rows at mixed positions (decode.batch with XOT_TPU_FLASH_DECODE=1).
B8_WINDOW_OFFSETS = [[150, 214, 278, 342, 407, 471, 535, 600], [0, 1, 63, 64, 777, 2048, 3333, 4086]]
B8_DECODE_POSITIONS = [[1, 64, 65, 777, 1500, 2048, 3333, 4095], [4095, 0, 2047, 8, 4000, 513, 96, 3071]]


@pytest.mark.parametrize("Sq", [5, 9])
@pytest.mark.parametrize("offsets", B8_WINDOW_OFFSETS, ids=["150-600", "0-4086"])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_prefill_b8_verify_windows(dev, Sq, offsets, quant):
  """K1 at the dense layout's verify windows: B=8 rows, Sq = gamma+1 (5:
  a model draft at depth 4; 9: n-gram depth 8), each row at its own
  offset, one launch, against the plain version."""
  _check_prefill(dev, Sq, offsets, quant=quant)


@pytest.mark.parametrize("positions", B8_DECODE_POSITIONS, ids=["ascending", "shuffled"])
def test_flash_decode_b8_mixed_positions(dev, positions):
  """K2 at B=8 rows of mixed positions in one launch (the dense layout's
  decode step), against the plain version."""
  _check_flash_decode(dev, positions, 4096, 64)


@pytest.mark.parametrize("positions,Skv,hd", [([4095], 4096, 64), ([0, 1, 700, 4095], 4096, 64), ([0], 4096, 64), ([999, 3], 1000, 64), ([300, 0], 512, 128), ([511], 512, 256)])
def test_flash_decode_matches_plain(dev, positions, Skv, hd):
  _check_flash_decode(dev, positions, Skv, hd)


@pytest.mark.parametrize(
  "positions,Skv",
  [([0, 1, 8191], 8192), ([8191], 8192), ([0, 1, 8191, 16383], 16384), ([16383], 16384), ([999, 500, 0], 1000), ([4096, 0, 2048, 4095], 4097), ([4096], 4097)],
)
def test_flash_decode_long_and_ragged_windows(dev, positions, Skv):
  """Caches past 4096 (K2's default threshold is 8192), and windows that
  are not a whole number of cluster ranges or 8-slot octets."""
  _check_flash_decode(dev, positions, Skv, 64)


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (16, 8), (16, 2), (24, 2)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_decode_gqa_groups(dev, Hq, Hkv, hd):
  """GQA groups 1, 2, 8 and 12 (two blocks of up to 8 q heads per kv head)."""
  _check_flash_decode(dev, [0, 777, 2047], 2048, hd, Hq=Hq, Hkv=Hkv)


def _check_flash_decode(dev, positions, Skv, hd, Hq=32, Hkv=8):
  B = len(positions)
  q = _rand((B, 1, Hq, hd), 7, dev)
  k = _rand((B, Skv, Hkv, hd), 8, dev)
  v = _rand((B, Skv, Hkv, hd), 9, dev)
  pos = torch.tensor(positions, dtype=torch.int32, device=dev)[:, None]
  before = fa.LAUNCHES["flash_decode"]
  got = fa.flash_decode_attention(q, k, v, pos)
  torch.cuda.synchronize()
  assert fa.LAUNCHES["flash_decode"] == before + 1
  want = fa.flash_decode_attention_ref(q, k, v, pos)
  torch.testing.assert_close(got.float(), want.float(), **K2_TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
  q = _rand((1, 128, 32, 64), 1, dev)
  k = _rand((1, 256, 8, 64), 2, dev)
  with pytest.raises(ValueError, match="expected torch.bfloat16"):
    fa.flash_attention_prefill(q.float(), k, k)
  with pytest.raises(ValueError, match="contiguous"):
    fa.flash_attention_prefill(q, k.transpose(1, 2).contiguous().transpose(1, 2), k)
  with pytest.raises(ValueError, match="unsupported geometry"):
    fa.flash_attention_prefill(_rand((1, 128, 32, 48), 1, dev), _rand((1, 256, 8, 48), 2, dev), _rand((1, 256, 8, 48), 3, dev))
  with pytest.raises(ValueError, match="k_scale and v_scale"):
    fa.flash_attention_prefill(q, k, k, k_scale=torch.ones(1, 256, 8, 1, device=dev))
  with pytest.raises(ValueError, match="unsupported geometry"):
    fa.flash_decode_attention(q, k, k, torch.zeros(1, 128, dtype=torch.int32, device=dev))


def _paged_case(dev, lengths, kv, hd=64, Hq=32, Hkv=8, ps=64, mp=64, seed=11):
  """q, pools and block tables for K3: each row's pages are distinct,
  shuffled, non-contiguous ids; table entries past a row's last page hold
  junk that must never be read (the plain version gets them zeroed)."""
  rng = np.random.default_rng(seed)
  B = len(lengths)
  P = B * mp + 1
  q = _rand((B, Hq, hd), seed, dev)
  k = _rand((P, Hkv, ps, hd), seed + 1, dev)
  v = _rand((P, Hkv, ps, hd), seed + 2, dev)
  ids = rng.permutation(np.arange(1, P)).reshape(B, mp).astype(np.int32)
  junk = ids.copy()
  for b, n in enumerate(lengths):
    junk[b, -(-n // ps) :] = 1 << 30
  scales = {}
  if kv != "bf16":
    quant = quantize_kv_int4 if kv == "int4" else quantize_kv
    (k, ks), (v, vs) = quant(k), quant(v)
    scales = dict(k_scale_pool_l=ks, v_scale_pool_l=vs)
  lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
  return q, k, v, torch.from_numpy(junk).to(dev), torch.from_numpy(np.where(junk == 1 << 30, 0, junk)).to(dev), lens, scales


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("lengths", [[1], [64], [65], [4096], [1, 64, 65, 700, 2048, 3001, 4000, 4096]])
def test_paged_decode_matches_plain(dev, kv, lengths):
  q, k, v, bt, bt_clean, lens, scales = _paged_case(dev, lengths, kv)
  before = paged.LAUNCHES["paged_decode"]
  got = paged.paged_decode_attention(q, k, v, bt, lens, 64, **scales)
  torch.cuda.synchronize()
  assert paged.LAUNCHES["paged_decode"] == before + 1
  want = paged.paged_decode_attention_ref(q, k, v, bt_clean, lens, 64, **scales)
  assert torch.isfinite(got).all()
  torch.testing.assert_close(got.float(), want.float(), **K3_TOL)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("starts", [[150, 214, 278, 342, 407, 471, 535, 600], [1, 64, 65, 777, 1500, 2048, 3333, 4087]])
def test_paged_window_attention_is_one_k3_launch(dev, kv, starts):
  """The verify window of batched speculation (B=8 rows × W=9 positions)
  flattens into ONE K3 launch over 72 rows, each with its own length, and
  equals its plain version (the gather route with per-query positions)."""
  W = 9
  _, k, v, bt, bt_clean, _, scales = _paged_case(dev, [n + W for n in starts], kv)
  q = _rand((len(starts), W, 32, 64), 5, dev)
  positions = torch.tensor(starts, dtype=torch.int32, device=dev)[:, None] + torch.arange(W, dtype=torch.int32, device=dev)[None, :]
  before = paged.LAUNCHES["paged_decode"]
  got = paged.paged_window_attention(q, k, v, paged.window_block_tables(bt, W), positions, 64, **scales)
  torch.cuda.synchronize()
  assert paged.LAUNCHES["paged_decode"] == before + 1
  want = paged.paged_window_attention_ref(q, k, v, bt_clean, positions, 64, **scales)
  assert got.shape == (len(starts), W, 32, 64) and torch.isfinite(got).all()
  torch.testing.assert_close(got.float(), want.float(), **K3_TOL)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("hd,Hq,Hkv,ps,mp,lengths", [(128, 16, 2, 16, 40, [1, 17, 640]), (256, 8, 8, 32, 12, [33, 384]), (64, 12, 4, 128, 5, [129, 640, 1])])
def test_paged_decode_geometries(dev, kv, hd, Hq, Hkv, ps, mp, lengths):
  q, k, v, bt, bt_clean, lens, scales = _paged_case(dev, lengths, kv, hd=hd, Hq=Hq, Hkv=Hkv, ps=ps, mp=mp)
  got = paged.paged_decode_attention(q, k, v, bt, lens, ps, **scales)
  want = paged.paged_decode_attention_ref(q, k, v, bt_clean, lens, ps, **scales)
  torch.testing.assert_close(got.float(), want.float(), **K3_TOL)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (16, 8), (16, 2)])
def test_paged_decode_gqa_groups(dev, kv, Hq, Hkv):
  """GQA groups 1, 2 and 8 at every pool type."""
  q, k, v, bt, bt_clean, lens, scales = _paged_case(dev, [1, 700, 4096], kv, Hq=Hq, Hkv=Hkv)
  got = paged.paged_decode_attention(q, k, v, bt, lens, 64, **scales)
  want = paged.paged_decode_attention_ref(q, k, v, bt_clean, lens, 64, **scales)
  torch.testing.assert_close(got.float(), want.float(), **K3_TOL)


def test_flash_decode_is_one_kernel_and_one_allocation_per_call(dev):
  """One device kernel per K2 call (the kernel nodes of a CUDA graph
  captured around a call, as chip_smoke.py counts it), and no scratch: the
  output is the call's only allocation."""
  import chip_smoke

  q, k, v = _rand((1, 1, 32, 64), 7, dev), _rand((1, 4096, 8, 64), 8, dev), _rand((1, 4096, 8, 64), 9, dev)
  pos = torch.tensor([[4095]], dtype=torch.int32, device=dev)
  assert chip_smoke._kernels_per_call(torch, lambda: fa.flash_decode_attention(q, k, v, pos)) == 1
  assert _allocations(lambda: fa.flash_decode_attention(q, k, v, pos)) == 1


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_paged_decode_is_one_kernel_and_one_allocation_per_call(dev, kv):
  import chip_smoke

  q, k, v, bt, _, lens, scales = _paged_case(dev, [1, 700, 4096], kv)
  assert chip_smoke._kernels_per_call(torch, lambda: paged.paged_decode_attention(q, k, v, bt, lens, 64, **scales)) == 1
  assert _allocations(lambda: paged.paged_decode_attention(q, k, v, bt, lens, 64, **scales)) == 1


def _allocations(fn):
  fn()
  torch.cuda.synchronize()
  before = torch.cuda.memory_stats()["allocation.all.allocated"]
  out = fn()
  after = torch.cuda.memory_stats()["allocation.all.allocated"]
  del out
  return after - before


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(dev):
  q, k, v, bt, _, lens, _ = _paged_case(dev, [65], "bf16", mp=4)
  with pytest.raises(ValueError, match="expected torch.bfloat16"):
    paged.paged_decode_attention(q.float(), k, v, bt, lens, 64)
  with pytest.raises(ValueError, match="expected torch.int32"):
    paged.paged_decode_attention(q, k, v, bt.long(), lens, 64)
  with pytest.raises(ValueError, match="unsupported geometry"):
    paged.paged_decode_attention(q, k, v, bt, lens, 32)
  with pytest.raises(ValueError, match="contiguous"):
    paged.paged_decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, bt, lens, 64)
  with pytest.raises(ValueError, match="passed together"):
    paged.paged_decode_attention(q, k, v, bt, lens, 64, k_scale_pool_l=torch.ones(1, device=dev))


def _int4_case(dev, T, d_in, d_out, seed=21):
  x = _rand((T, d_in), seed, dev)
  packed, scale = quantize_weight_int4(_rand((d_in, d_out), seed + 1, dev, torch.float32) * d_in**-0.5)
  return x, packed, scale


@pytest.mark.parametrize("d_in,d_out", [*LLAMA_1B_MATMULS, (2048, 1000), (1536, 512)])
@pytest.mark.parametrize("T", [1, 3, 8, 17, 64, 128, 256, 300, 512])
def test_int4_matmul_matches_plain(dev, T, d_in, d_out):
  x, packed, scale = _int4_case(dev, T, d_in, d_out)
  before = k4.LAUNCHES["int4_matmul"]
  got = k4.int4_matmul(x, packed, scale)
  torch.cuda.synchronize()
  assert k4.LAUNCHES["int4_matmul"] == before + 1
  want = k4.int4_matmul_ref(x, packed, scale)
  assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
  torch.testing.assert_close(got.float(), want.float(), **K4_TOL)


@pytest.mark.parametrize("T,d_in,d_out", [(1024, 2048, 1000), (300, 8192, 1000)])
def test_int4_matmul_wide_tile_with_ragged_out(dev, T, d_in, d_out):
  """Products long enough for the 128 x 128 wgmma tile, but with out % 16
  != 0: wgmma does not take them, so they run the 32-token mma.sync tile
  with the weight staged element by element (wgmma takes the aligned bf16
  case, covered above)."""
  x, packed, _ = _int4_case(dev, T, d_in, d_out)
  assert not k4.wide_ok(x, packed) and k4.plan(T, d_in, d_out, k4.sm_count(x.device.index), True)[0] == 2
  assert k4.plan(T, d_in, d_out, k4.sm_count(x.device.index), False)[0] == 1
  test_int4_matmul_matches_plain(dev, T, d_in, d_out)


@pytest.mark.parametrize("d_in,d_out", [(1000, 512), (1000, 2048), (1002, 2048)])
@pytest.mark.parametrize("T", [1, 8, 128, 600])
def test_int4_matmul_partial_last_stage(dev, T, d_in, d_out):
  """An in-axis that is not a whole number of pipeline stages: in 1000 is
  500 packed rows, not a multiple of the 64- or 32-row stage, so the copies
  past it are zero filled (T=600 on (1000, 2048) takes the wgmma tile); in
  1002 also breaks the 16-byte alignment of x rows, so x is staged element
  by element."""
  if (T, d_in, d_out) == (600, 1000, 2048):
    assert k4.plan(T, d_in, d_out, k4.sm_count(dev.index or 0), True)[0] == 2
  test_int4_matmul_matches_plain(dev, T, d_in, d_out)


@pytest.mark.parametrize("T,d_in,d_out", [(1, 2048, 512), (8, 2048, 2048), (17, 1536, 1000), (128, 2048, 8192), (257, 8192, 2048)])
def test_int4_matmul_takes_f32_x(dev, T, d_in, d_out):
  """f32 x (an f32 checkpoint served with XOT_TPU_QUANT=int4): the kernel
  rounds x to bf16 for the tensor cores, as the TPU kernel does, and writes
  f32 y. Held to the plain version on x rounded to bf16, in f32."""
  x, packed, scale = _int4_case(dev, T, d_in, d_out)
  x = x.float() + _rand((T, d_in), 5, dev, torch.float32) * 2.0**-10  # off the bf16 grid
  got = k4.int4_matmul(x, packed, scale)
  torch.cuda.synchronize()
  want = k4.int4_matmul_ref(x.to(torch.bfloat16).float(), packed, scale)
  assert got.dtype == torch.float32 and torch.isfinite(got).all()
  torch.testing.assert_close(got, want, **K4_F32_TOL)


def test_int4_wrapper_rejects_what_the_kernel_does_not_take(dev):
  x, packed, scale = _int4_case(dev, 4, 256, 64)
  with pytest.raises(ValueError, match="torch.bfloat16 or torch.float32"):
    k4.int4_matmul(x.half(), packed, scale)
  with pytest.raises(ValueError, match="expected torch.float32"):
    k4.int4_matmul(x, packed, scale.to(torch.bfloat16))
  with pytest.raises(ValueError, match="expected a tensor on cuda"):
    k4.int4_matmul(x, packed.cpu(), scale)
  with pytest.raises(ValueError, match="contiguous"):
    k4.int4_matmul(x, packed.t().contiguous().t(), scale)
  with pytest.raises(ValueError, match="unsupported geometry"):
    k4.int4_matmul(_rand((4, 128), 1, dev), packed, scale)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_kv_tier_round_trip_is_byte_identical_and_k3_reads_it_alike(dev, kv):
  """The host KV tier on the card (chip_smoke.py ``tier_round_trip``):
  pages of a seeded pool at llama-3.2-1b's page geometry spill through
  ``KvTierManager`` with the real ``DecoderBatchOps.read_pages`` (gather on
  the compute stream, pinned copy on a copy stream) and restore into other
  pages with the real ``write_pages``. Every leaf and every host entry is
  equal to the source pages, the host entries are pageable, and a K3 step
  over block tables on the restored pages is bit-identical to the same
  step on the originals in every layer."""
  import types

  import chip_smoke
  from xotorch_support_jetson_tpu_torch.inference.batch_ops import DecoderBatchOps
  from xotorch_support_jetson_tpu_torch.models.config import tiny_test_config

  # llama-3.2-1b's attention geometry; the pool reads the config's cache geometry.
  cfg = tiny_test_config(dim=2048, n_layers=4, n_heads=32, n_kv_heads=8, head_dim=64, dtype=torch.bfloat16)
  ops = DecoderBatchOps(types.SimpleNamespace(device=dev))
  res = chip_smoke.tier_round_trip(torch, ops, cfg, 4, kv, n=16)
  assert all(res["leaves_equal"].values()) and res["host_entries_equal"] and res["host_entries_pageable"]
  assert res["k3_bit_identical"]


# gemma-2-9b's weight products (in, out): wq, wk/wv, wo, gate/up, down, the tied head.
GEMMA_2_9B_MATMULS = [(3584, 4096), (3584, 2048), (4096, 3584), (3584, 14336), (14336, 3584), (3584, 256000)]


@pytest.mark.parametrize("d_in,d_out", GEMMA_2_9B_MATMULS)
@pytest.mark.parametrize("T", [1, 8])
def test_int4_matmul_at_gemma2_shapes(dev, T, d_in, d_out):
  x, packed, scale = _int4_case(dev, T, d_in, d_out, seed=31)
  before = k4.LAUNCHES["int4_matmul"]
  got = k4.int4_matmul(x, packed, scale)
  torch.cuda.synchronize()
  assert k4.LAUNCHES["int4_matmul"] == before + 1
  torch.testing.assert_close(got.float(), k4.int4_matmul_ref(x, packed, scale).float(), **K4_TOL)


def _tiny_gemma2(dev):
  """A tiny bf16 gemma2 (3 layers: 0 and 2 slide over 32 positions, head
  dim 64, query_pre_attn_scalar 48, softcaps 50 / 30) with random weights."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec

  cfg = tconfig.tiny_test_config(
    vocab_size=512, dim=256, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=64, hidden_dim=512, max_seq_len=512, dtype=torch.bfloat16, family="gemma2",
    post_norms=True, mlp_act="gelu_tanh", attn_logit_softcap=50.0, final_logit_softcap=30.0, query_pre_attn_scalar=48.0, sliding_window=32, embed_scale=16.0, tied_embedding=True,
  )
  shard = Shard("tiny-gemma2", 0, 2, 3)
  return cfg, shard, tdec.init_shard_params(cfg, shard, generator=torch.Generator(device=dev).manual_seed(5), device=dev)


def test_gemma2_captured_equals_eager_and_launches_no_attention_kernel(dev):
  """The captured solo programs on a tiny gemma2 equal the eager functions
  (prefill logits, 40 greedy steps past the window), and no attention
  kernel launches, captured or eager: K1–K3 implement no softcap or
  window. The paged decode resolves to the gather route on the card."""
  from xotorch_support_jetson_tpu_torch.models import decoder as tdec
  from xotorch_support_jetson_tpu_torch.utils import programs

  cfg, shard, params = _tiny_gemma2(dev)
  prompt = np.random.default_rng(0).integers(3, 512, (1, 128)).astype(np.int32)
  L = 100
  before = (fa.LAUNCHES["flash_prefill"], fa.LAUNCHES["flash_decode"], paged.LAUNCHES["paged_decode"])
  programs.reset_replayed()
  prog = tdec.SoloPrograms(params, cfg, shard, tdec.init_kv_cache(cfg, 3, 1, 512, device=dev), generator=torch.Generator(device=dev), pool=torch.cuda.graph_pool_handle())
  for _ in range(2):  # the first round builds, the second replays
    eager = tdec.init_kv_cache(cfg, 3, 1, 512, device=dev)
    want, _ = tdec.shard_forward(params, cfg, shard, torch.from_numpy(prompt).to(dev), torch.arange(128, dtype=torch.int32, device=dev)[None], eager, head_pos=torch.tensor([L - 1], device=dev))
    got = prog.prefill(prompt, L)
    torch.testing.assert_close(got, want[:, 0, :], atol=ATOL, rtol=0)
    first = int(torch.argmax(want[0, 0]))
    w, _ = tdec.fused_decode(params, cfg, shard, torch.tensor([[first]], dtype=torch.int32, device=dev), eager, torch.tensor([L], dtype=torch.int32, device=dev), 40)
    g, _ = tdec.fused_decode(params, cfg, shard, first, prog.cache, L, 40, programs=prog)
    assert torch.equal(g, w)
  assert (fa.LAUNCHES["flash_prefill"], fa.LAUNCHES["flash_decode"], paged.LAUNCHES["paged_decode"]) == before and not programs.REPLAYED
  pool = paged.init_paged_pool(cfg, 3, 9, 64, device=dev)
  bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32, device=dev)
  args = (torch.tensor([[7], [9]], dtype=torch.int32, device=dev), pool, bt, torch.tensor([40, 90], dtype=torch.int32, device=dev), torch.ones(2, dtype=torch.bool, device=dev), torch.zeros(2, device=dev), 4)
  toks = tdec.fused_paged_batch_decode(params, cfg, shard, *args, page_size=64)[0]
  assert paged.LAUNCHES["paged_decode"] == before[2]
  assert toks.shape == (2, 4)
