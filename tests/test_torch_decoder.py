"""The port's dense decoder against the JAX package's on identical weights:
JAX ``init_shard_params`` → numpy → ``params_from_jax`` → the port's
``shard_forward``. Logits agree within rtol = atol = 2e-4 (the HF golden
tolerance, tests/test_hf_golden.py) in f32 for llama- and qwen2-shaped tiny
configs; the cached path equals the cache-less one; int8-KV decode and
``fused_generate`` greedy tokens equal the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = {
  "llama": dict(rope_theta=500000.0, vocab_size=256),
  "qwen2": dict(qkv_bias=True, tied_embedding=True, family="qwen2", vocab_size=256),
}


def _pair(family, n_layers=3):
  kw = dict(FAMILIES[family], n_layers=n_layers, max_seq_len=512)
  jc, tc = jconfig.tiny_test_config(**kw), tconfig.tiny_test_config(**kw)
  jshard, tshard = JShard("tiny", 0, n_layers - 1, n_layers), Shard("tiny", 0, n_layers - 1, n_layers)
  jp = jdec.init_shard_params(jax.random.PRNGKey(7), jc, jshard)
  if family == "qwen2":  # non-zero biases so the bias path is exercised
    rng = np.random.default_rng(1)
    jp["layers"] = {**jp["layers"], **{b: jnp.asarray(rng.standard_normal(jp["layers"][b].shape).astype(np.float32) * 0.1) for b in ("bq", "bk", "bv")}}
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, tshard)
  return jc, tc, jshard, tshard, jp, tp


def _tokens(B, S, seed=0):
  return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shard_forward_logits_match_jax(family):
  jc, tc, js, ts, jp, tp = _pair(family)
  toks = _tokens(2, 11)
  pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
  want, _ = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(pos), None)
  got, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(pos), None)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  # The cached prefill computes the same logits (stale slots masked by position).
  jcache = jdec.init_kv_cache(jc, 3, 2, 64)
  want_c, _ = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(pos), jcache)
  got_c, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(pos), tdec.init_kv_cache(tc, 3, 2, 64))
  np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_cached_prefill_then_decode_equals_cacheless(quant):
  _, tc, _, ts, _, tp = _pair("llama")
  toks = torch.from_numpy(_tokens(1, 9, seed=3))
  full, _ = tdec.shard_forward(tp, tc, ts, toks, torch.arange(9, dtype=torch.int32)[None], None)
  cache = tdec.init_kv_cache(tc, 3, 1, 32, quant=quant)
  out, cache = tdec.shard_forward(tp, tc, ts, toks[:, :6], torch.arange(6, dtype=torch.int32)[None], cache)
  steps = [out[:, -1]]
  for p in range(6, 9):
    out, cache = tdec.shard_forward(tp, tc, ts, toks[:, p : p + 1], torch.tensor([[p]], dtype=torch.int32), cache)
    steps.append(out[:, 0])
  got = torch.stack(steps[:-1], dim=1)  # logits at positions 5..7
  tol = TOL if not quant else dict(rtol=5e-2, atol=5e-2)  # int8 codes vs f32 keys
  np.testing.assert_allclose(got.numpy(), full[:, 5:8].numpy(), **tol)


def test_int8_kv_decode_matches_jax():
  jc, tc, js, ts, jp, tp = _pair("llama")
  toks = _tokens(1, 7, seed=5)
  pos = np.arange(7, dtype=np.int32)[None]
  jcache = jdec.init_kv_cache(jc, 3, 1, 48, quant="int8")
  tcache = tdec.init_kv_cache(tc, 3, 1, 48, quant="int8")
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(pos), jcache)
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(pos), tcache)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([7], jnp.int32), 12)
  tt, _ = tdec.fused_decode(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([7], dtype=torch.int32), 12)
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fused_generate_greedy_matches_jax(family):
  jc, tc, js, ts, jp, tp = _pair(family)
  toks = _tokens(1, 5, seed=9)
  pos = np.arange(5, dtype=np.int32)[None]
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(pos), jdec.init_kv_cache(jc, 3, 1, 64))
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(pos), tdec.init_kv_cache(tc, 3, 1, 64))
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  assert first == int(torch.argmax(tl[0, -1]))
  jbuf, _, _ = jdec.fused_generate(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([5], jnp.int32), 20)
  tbuf, n, _ = tdec.fused_generate(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([5], dtype=torch.int32), 20)
  assert n == 20
  np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))


def test_fused_generate_stops_at_eos():
  """Every row at EOS ends the loop at the next check; the kept tokens are
  the same as without an EOS set."""
  _, tc, _, ts, _, tp = _pair("llama")
  toks = torch.from_numpy(_tokens(1, 4, seed=2))
  _, cache = tdec.shard_forward(tp, tc, ts, toks, torch.arange(4, dtype=torch.int32)[None], tdec.init_kv_cache(tc, 3, 1, 128))
  start = torch.full((1, 1), 1, dtype=torch.int32)
  free, _, _ = tdec.fused_generate(tp, tc, ts, start, {k: v.clone() for k, v in cache.items()}, torch.tensor([4], dtype=torch.int32), 40)
  eos = int(free[0, 2])
  buf, n, _ = tdec.fused_generate(tp, tc, ts, start, cache, torch.tensor([4], dtype=torch.int32), 40, eos_ids=(eos,))
  assert n == tdec.EOS_CHECK_EVERY
  np.testing.assert_array_equal(buf[0, :3].numpy(), free[0, :3].numpy())


def test_unported_configs_refuse_at_load():
  with pytest.raises(NotImplementedError, match="mixture-of-experts"):
    tconfig.config_from_hf({"model_type": "mixtral", "vocab_size": 8, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 8, "num_local_experts": 4})
  with pytest.raises(NotImplementedError, match="latent attention"):
    tconfig.config_from_hf({"model_type": "deepseek_v2", "vocab_size": 8, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 8, "kv_lora_rank": 4})
  with pytest.raises(NotImplementedError, match="gemma2"):
    tconfig.config_from_hf({"model_type": "gemma2", "vocab_size": 8, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 8})
  with pytest.raises(NotImplementedError, match="vision"):
    tconfig.config_from_hf({"model_type": "llava", "text_config": {}, "vision_config": {}})
