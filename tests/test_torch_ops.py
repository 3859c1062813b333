"""The port's plain ops against the JAX package's, on the same numpy inputs:
rms_norm, rope (plain, llama3-scaled, yarn, partial rotary), gqa_attention
(with int8 KV scales) and sampling. f32 tolerance 2e-5 (single ops; the
reference's kernel-test tolerance). Greedy picks must be identical;
sampled streams cannot match across threefry and Philox, so sampling is
held to the same top-k/top-p support set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.models import config as jconfig
from xotorch_support_jetson_tpu.ops import attention as jattn, norm as jnorm, rope as jrope, sampling as jsampling
from xotorch_support_jetson_tpu_torch.models import config as tconfig
from xotorch_support_jetson_tpu_torch.models.quantize import dequantize_kv, quantize_kv
from xotorch_support_jetson_tpu_torch.ops import attention as tattn, norm as tnorm, rope as trope, sampling as tsampling

TOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.default_rng(0)


def test_rms_norm_matches():
  x = RNG.standard_normal((2, 5, 64)).astype(np.float32)
  w = RNG.standard_normal((64,)).astype(np.float32)
  want = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
  got = tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
  np.testing.assert_allclose(got, want, **TOL)


ROPE_CASES = {
  "plain": dict(),
  "llama3": dict(rope_theta=500000.0, rope_scaling=("RopeScaling", dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0, original_max_position_embeddings=64))),
  "yarn": dict(rope_scaling=("YarnScaling", dict(factor=4.0, original_max_position_embeddings=32, attention_factor=1.2))),
  "partial": dict(partial_rotary_factor=0.5),
}


def _configs(case):
  kw = dict(ROPE_CASES[case])
  scaling = kw.pop("rope_scaling", None)
  jkw, tkw = dict(kw), dict(kw)
  if scaling is not None:
    jkw["rope_scaling"] = getattr(jconfig, scaling[0])(**scaling[1])
    tkw["rope_scaling"] = getattr(tconfig, scaling[0])(**scaling[1])
  return jconfig.tiny_test_config(**jkw), tconfig.tiny_test_config(**tkw)


@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope_matches(case):
  jc, tc = _configs(case)
  jf = np.asarray(jrope.rope_inv_freq(jc))
  tf = trope.rope_inv_freq(tc)
  np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-6, atol=0)
  x = RNG.standard_normal((2, 7, 4, 16)).astype(np.float32)
  pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
  m = jrope.rope_attention_factor(jc)
  assert m == trope.rope_attention_factor(tc)
  want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(jf), m))
  got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tf, m).numpy()
  np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)  # angles up to ~100 rad: f32 sin/cos of large arguments


@pytest.mark.parametrize("int8", [False, True])
def test_gqa_attention_matches(int8):
  B, Sq, Skv, Hq, Hkv, hd = 2, 3, 10, 4, 2, 16
  q = RNG.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
  k = RNG.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
  v = RNG.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
  q_pos = np.asarray([[2, 3, 4], [7, 8, 9]], np.int32)
  kv_pos = np.arange(Skv, dtype=np.int32)
  kw_j, kw_t = {}, {}
  if int8:
    kq, ks = quantize_kv(torch.from_numpy(k))
    vq, vs = quantize_kv(torch.from_numpy(v))
    np.testing.assert_allclose(dequantize_kv(kq, ks, torch.float32).numpy(), k, atol=float(ks.max()) / 2 + 1e-6)
    k, v = kq.numpy(), vq.numpy()
    kw_j = dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    kw_t = dict(k_scale=ks, v_scale=vs)
  want = np.asarray(jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw_j))
  got = tattn.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(q_pos), torch.from_numpy(kv_pos), **kw_t).numpy()
  np.testing.assert_allclose(got, want, **TOL)


def test_greedy_identical():
  logits = RNG.standard_normal((8, 512)).astype(np.float32)
  np.testing.assert_array_equal(tsampling.greedy(torch.from_numpy(logits)).numpy(), np.asarray(jsampling.greedy(jnp.asarray(logits))))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (8, 0.7), (0, 0.6)])
def test_sampling_support_set_matches(top_k, top_p):
  """Both samplers draw from exactly the support set numpy computes."""
  V, N, temp = 16, 20000, 0.8
  row = np.random.default_rng(3).standard_normal(V).astype(np.float32)
  scaled = row / temp
  order = np.argsort(-scaled, kind="stable")
  cand = order[:top_k] if top_k else order
  probs = np.exp(scaled[cand] - scaled[cand].max())
  probs /= probs.sum()
  keep = (np.cumsum(probs) - probs) < top_p
  support = set(cand[keep].tolist())

  logits = np.broadcast_to(row, (N, V)).copy()
  jax_draws = np.asarray(jsampling.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(1), temp=temp, top_k=top_k, top_p=top_p))
  gen = torch.Generator().manual_seed(1)
  torch_draws = tsampling.sample_logits(torch.from_numpy(logits), gen, temp=temp, top_k=top_k, top_p=top_p).numpy()
  assert torch_draws.dtype == np.int32
  assert set(jax_draws.tolist()) == support
  assert set(torch_draws.tolist()) == support


def test_sampling_is_seeded():
  logits = torch.from_numpy(RNG.standard_normal((4, 64)).astype(np.float32))
  a = tsampling.sample_logits(logits, torch.Generator().manual_seed(5), temp=1.0, top_k=20)
  b = tsampling.sample_logits(logits, torch.Generator().manual_seed(5), temp=1.0, top_k=20)
  assert torch.equal(a, b)
