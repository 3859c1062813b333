"""The port's flash-attention module on the CPU: the plain versions of K1
(flash prefill) and K2 (flash decode) against the JAX package's Pallas
kernels in interpret mode and its ``gqa_attention``, in f32 with the
reference's own tolerance (rtol = atol = 2e-5, tests/test_pallas_attention.py),
plus the gates and the CPU dispatch of the wrappers. The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.models.quantize import quantize_kv as jax_quantize_kv
from xotorch_support_jetson_tpu.ops import pallas_attention as jpa
from xotorch_support_jetson_tpu.ops.attention import gqa_attention as jax_gqa
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv
from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B=2, Sq=128, Skv=256, Hq=8, Hkv=2, hd=64, seed=0):
  rng = np.random.default_rng(seed)
  return tuple(rng.standard_normal(s).astype(np.float32) for s in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))


def _t(*arrays):
  return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("Sq,Skv,offset", [(128, 128, 0), (128, 384, 128), (128, 256, [0, 64])])
def test_prefill_plain_matches_jax_flash_and_dense(Sq, Skv, offset):
  q, k, v = _qkv(Sq=Sq, Skv=Skv)
  off = np.asarray(offset, np.int32)
  want = np.asarray(jpa.flash_attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(off), interpret=True))
  q_pos = np.broadcast_to(off, (2,))[:, None] + np.arange(Sq, dtype=np.int32)[None, :]
  dense = np.asarray(jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos), jnp.arange(Skv, dtype=jnp.int32)))
  got = fa.flash_attention_prefill_ref(*_t(q, k, v), q_offset=torch.from_numpy(np.broadcast_to(off, (2,)).copy())).numpy()
  np.testing.assert_allclose(got, want, **TOL)
  np.testing.assert_allclose(got, dense, **TOL)


def test_prefill_plain_masks_junk_beyond_positions():
  """Cache slots past the prompt hold junk; positional masking hides it."""
  q, k, v = _qkv(Sq=128, Skv=256)
  k[:, 128:] = 1e4
  v[:, 128:] = 1e4
  want = np.asarray(jpa.flash_attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=0, interpret=True))
  got = fa.flash_attention_prefill_ref(*_t(q, k, v), q_offset=0).numpy()
  np.testing.assert_allclose(got, want, **TOL)
  assert np.isfinite(got).all()


def test_prefill_plain_int8_matches_jax_flash_int8():
  q, k, v = _qkv(Sq=128, Skv=256, seed=21)
  kq, ks = jax_quantize_kv(jnp.asarray(k))
  vq, vs = jax_quantize_kv(jnp.asarray(v))
  off = jnp.asarray([0, 64], jnp.int32)
  want = np.asarray(jpa.flash_attention_prefill(jnp.asarray(q), kq, vq, q_offset=off, k_scale=ks, v_scale=vs, interpret=True))
  tkq, tks = quantize_kv(torch.from_numpy(k))
  tvq, tvs = quantize_kv(torch.from_numpy(v))
  np.testing.assert_array_equal(tkq.numpy(), np.asarray(kq))  # same codes, same scales
  np.testing.assert_allclose(tks.numpy(), np.asarray(ks), rtol=1e-7, atol=0)
  got = fa.flash_attention_prefill(torch.from_numpy(q), tkq, tvq, q_offset=torch.tensor([0, 64], dtype=torch.int32), k_scale=tks, v_scale=tvs).numpy()
  np.testing.assert_allclose(got, want, **TOL)


def test_prefill_half_specified_quant_raises():
  q, k, v = _t(*_qkv(Sq=128, Skv=128))
  scale = torch.ones((2, 128, 2, 1))
  with pytest.raises(ValueError, match="k_scale and v_scale"):
    fa.flash_attention_prefill(q, k, v, k_scale=scale)
  with pytest.raises(ValueError, match="k_scale and v_scale"):
    fa.flash_attention_prefill(q, k, v, v_scale=scale)


@pytest.mark.parametrize("positions", [[37, 12], [127, 0], [0, 0]])
def test_decode_plain_matches_jax_flash_decode(positions):
  rng = np.random.default_rng(7)
  B, Hq, Hkv, hd, Skv = 2, 8, 4, 64, 128
  q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
  k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
  v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
  pos = np.asarray(positions, np.int32)[:, None]
  want = np.asarray(jpa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), interpret=True))
  got = fa.flash_decode_attention(*_t(q, k, v), torch.from_numpy(pos)).numpy()
  np.testing.assert_allclose(got, want, **TOL)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
  fa.reset_launch_counts()
  q, k, v = _t(*_qkv(Sq=16, Skv=32))
  fa.flash_attention_prefill(q, k, v, q_offset=3)
  fa.flash_decode_attention(q[:, :1].contiguous(), k, v, torch.tensor([[5], [31]], dtype=torch.int32))
  assert fa.LAUNCHES == {"flash_prefill": 0, "flash_decode": 0}


def test_flash_supported_gating(monkeypatch):
  assert fa.flash_supported((1, 128, 32, 64), 4096, "cuda")
  assert fa.flash_supported((1, 100, 32, 64), 200, "cuda")  # no tile-size gate: ragged edges are masked in the kernel
  assert not fa.flash_supported((1, 128, 32, 64), 4096, "cpu")  # CPU tensors take the plain path
  assert not fa.flash_supported((1, 128, 32, 64), 4096, "cuda", torch.float32)  # the kernel is bf16
  assert not fa.flash_supported((1, 128, 32, 63), 4096, "cuda")  # head dim
  assert not fa.flash_supported((1, 1, 32, 64), 4096, "cuda")  # a decode step is not a prefill
  monkeypatch.setenv("XOT_TPU_NO_FLASH", "1")
  assert not fa.flash_supported((1, 128, 32, 64), 4096, "cuda")


def test_flash_decode_gating(monkeypatch):
  assert not fa.flash_decode_supported((1, 1, 32, 64), 16384, "cuda")  # opt-in
  monkeypatch.setenv("XOT_TPU_FLASH_DECODE", "1")
  assert fa.flash_decode_supported((1, 1, 32, 64), 16384, "cuda")
  assert not fa.flash_decode_supported((1, 1, 32, 64), 4096, "cuda")  # below the default threshold
  monkeypatch.setenv("XOT_TPU_FLASH_DECODE_MIN", "4096")
  assert fa.flash_decode_supported((1, 1, 32, 64), 4096, "cuda")
  assert not fa.flash_decode_supported((1, 2, 32, 64), 16384, "cuda")  # not a decode step
  assert not fa.flash_decode_supported((1, 1, 32, 64), 16384, "cpu")
  monkeypatch.setenv("XOT_TPU_NO_FLASH", "1")
  assert not fa.flash_decode_supported((1, 1, 32, 64), 16384, "cuda")


def test_decoder_routes_cuda_prefill_to_the_kernel(monkeypatch):
  """On CUDA tensors the decoder's attention dispatch picks K1 for a
  prefill and K2 for an opted-in decode step; on CPU tensors the plain
  ``gqa_attention`` (as the JAX package does on the CPU)."""
  from xotorch_support_jetson_tpu_torch.models import decoder

  calls = []
  monkeypatch.setattr(fa, "flash_attention_prefill", lambda *a, **kw: calls.append("k1") or fa.flash_attention_prefill_ref(*a, **kw))
  monkeypatch.setattr(fa, "flash_decode_attention", lambda *a, **kw: calls.append("k2") or fa.flash_decode_attention_ref(*a, **kw))
  monkeypatch.setattr(fa, "flash_supported", lambda q_shape, kv_len, device=None, dtype=None: q_shape[1] > 1)
  monkeypatch.setattr(fa, "flash_decode_supported", lambda q_shape, kv_len, device=None, dtype=None: q_shape[1] == 1)
  from xotorch_support_jetson_tpu_torch.models.config import tiny_test_config
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard

  cfg = tiny_test_config(n_layers=2)
  shard = Shard("t", 0, 1, 2)
  params = decoder.init_shard_params(cfg, shard, torch.Generator().manual_seed(0))
  cache = decoder.init_kv_cache(cfg, 2, 1, 32)
  toks = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
  decoder.shard_forward(params, cfg, shard, toks, torch.arange(4, dtype=torch.int32)[None], cache)
  decoder.shard_forward(params, cfg, shard, toks[:, :1], torch.tensor([[4]], dtype=torch.int32), cache)
  assert calls == ["k1", "k1", "k2", "k2"]
