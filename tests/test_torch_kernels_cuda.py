"""The port's CUDA kernels (K1 flash prefill, K2 flash decode) against their
plain PyTorch versions, on the card, at llama-3.2-1b's attention shapes
(Hq 32, Hkv 8, hd 64, bf16, cache 4096) plus the other head dims.

Needs an NVIDIA GPU and nvcc; every test here is marked ``cuda`` and skips
without a card. This file imports no JAX, so it runs on a machine with only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.

Tolerances: outputs are bf16 (ulp 2^-8 relative) and K1 rounds the softmax
probabilities to bf16 for its tensor-core P·V product, so kernel and plain
version agree to about 1e-2 on unit-scale values; 3e-2 is the stated bound.
"""

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv
from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
ATOL = 3e-2


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


@pytest.mark.parametrize("positions,Skv,hd", [([4095], 4096, 64), ([0, 1, 700, 4095], 4096, 64), ([0], 4096, 64), ([999, 3], 1000, 64), ([300, 0], 512, 128), ([511], 512, 256)])
def test_flash_decode_matches_plain(dev, positions, Skv, hd):
  B, Hq, Hkv = len(positions), 32, 8
  q = _rand((B, 1, Hq, hd), 7, dev)
  k = _rand((B, Skv, Hkv, hd), 8, dev)
  v = _rand((B, Skv, Hkv, hd), 9, dev)
  pos = torch.tensor(positions, dtype=torch.int32, device=dev)[:, None]
  before = fa.LAUNCHES["flash_decode"]
  got = fa.flash_decode_attention(q, k, v, pos)
  torch.cuda.synchronize()
  assert fa.LAUNCHES["flash_decode"] == before + 1
  want = fa.flash_decode_attention_ref(q, k, v, pos)
  torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


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
