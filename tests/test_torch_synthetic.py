"""The port's ``utils/synthetic.py`` against the reference's, on the CPU, on
identical weights (JAX ``full_model_params`` → numpy → ``params_from_jax``;
quantized trees from the reference's ``quantize_params``):

- ``peaked_echo_params`` on f32, bf16, int8 and packed-int4 trees: the same
  leaves damped to the same values (a quantized leaf's scale, its codes
  untouched) and a
  prompt's prefill logits on the echo weights within rtol = atol = 2e-4
  of the reference's (f32 activations) or 2e-2 (bf16: a few roundings of
  2^-8 each), with the same greedy tokens;
- ``spec_agreement_bitmap``: the same bits for an int8 self-draft of a
  random and of an echo target and for an unrelated draft, along the
  reference's greedy trajectory;
- ``simulate_spec_acceptance``: equal values on the same bitmaps, at every
  depth 0–5 and several limits.

No acceptance floor is asserted here (the reference's own echo test that
pins one is red on this build)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquant
from xotorch_support_jetson_tpu.utils import synthetic as jsyn
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquant
from xotorch_support_jetson_tpu_torch.utils import synthetic as tsyn

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

PROMPT = np.array([[5, 9, 2, 71, 33, 5, 9, 2]], dtype=np.int32)
TOL = {"f32": 2e-4, "bf16": 2e-2, "int8": 2e-4, "int4": 2e-4}


def _pair(tree: str, seed: int = 3, **cfg_kw):
  """(jax cfg, torch cfg, jax shard, torch shard, jax params, torch params)."""
  bf16 = tree == "bf16"
  kw = dict(n_layers=2, tied_embedding=True, max_seq_len=32, **cfg_kw)
  jc = jconfig.tiny_test_config(**kw, dtype=jnp.bfloat16 if bf16 else jnp.float32)
  tc = tconfig.tiny_test_config(**kw, dtype=torch.bfloat16 if bf16 else torch.float32)
  jp, js = jdec.full_model_params(jax.random.PRNGKey(seed), jc, "m")
  if tree in ("int8", "int4"):
    jp = jquant(jp, tree)
  ts = Shard("m", 0, jc.n_layers - 1, jc.n_layers)
  return jc, tc, js, ts, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, ts)


def _logits(pkg, cfg, shard, params, prompt=PROMPT):
  S = prompt.shape[1]
  if pkg == "jax":
    cache = jdec.init_kv_cache(cfg, shard.n_shard_layers, 1, cfg.max_seq_len)
    out, _ = jdec.shard_forward(params, cfg, shard, jnp.asarray(prompt), jnp.arange(S, dtype=jnp.int32)[None], cache)
    return np.asarray(out.astype(jnp.float32))[0]
  cache = tdec.init_kv_cache(cfg, shard.n_shard_layers, 1, cfg.max_seq_len)
  out, _ = tdec.shard_forward(params, cfg, shard, torch.from_numpy(prompt), torch.arange(S, dtype=torch.int32)[None], cache)
  return out.float().numpy()[0]


def _np(x) -> np.ndarray:
  return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("tree", ["f32", "bf16", "int8", "int4"])
def test_peaked_echo_params_matches_the_reference(tree):
  jc, tc, js, ts, jp, tp = _pair(tree)
  je, te = jsyn.peaked_echo_params(jp), tsyn.peaked_echo_params(tp)
  assert set(te["layers"]) == set(je["layers"]) and te["embed"] is tp["embed"]
  for k, leaf in te["layers"].items():
    damped = k in (("wo_scale", "w_down_scale") if "wo_scale" in te["layers"] else ("wo", "w_down"))
    assert (leaf is tp["layers"][k]) != damped, k  # only the residual writes (or their scales) change
    np.testing.assert_array_equal(_np(leaf), _np(je["layers"][k]), err_msg=k)
  want, got = _logits("jax", jc, js, je), _logits("torch", tc, ts, te)
  np.testing.assert_allclose(got, want, rtol=TOL[tree], atol=TOL[tree])
  assert (got.argmax(-1) == want.argmax(-1)).all()


def _trajectory(cfg, shard, params, prompt, n):
  """The reference's greedy continuation of ``prompt``: n tokens."""
  S = prompt.shape[1]
  cache = jdec.init_kv_cache(cfg, shard.n_shard_layers, 1, cfg.max_seq_len)
  logits, cache = jdec.shard_forward(params, cfg, shard, jnp.asarray(prompt), jnp.arange(S, dtype=jnp.int32)[None], cache)
  out = [int(np.argmax(np.asarray(logits)[0, -1]))]
  for i in range(n - 1):
    logits, cache = jdec.shard_forward(params, cfg, shard, jnp.asarray([[out[-1]]], dtype=jnp.int32), jnp.full((1, 1), S + i, jnp.int32), cache)
    out.append(int(np.argmax(np.asarray(logits)[0, 0])))
  return out


def _bitmaps(draft: str):
  jc, tc, js, ts, jp, tp = _pair("f32")
  if draft == "echo_int8":
    jp = jsyn.peaked_echo_params(jp)
    tp = tsyn.peaked_echo_params(tp)
  if draft == "other":
    jcd, tcd, jsd, tsd, jpd, tpd = _pair("f32", seed=42, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=1)
  else:
    jcd, tcd, jsd, tsd = jc, tc, js, ts
    jpd, tpd = jquant(jp, "int8"), tquant(tp, "int8")
  traj = _trajectory(jc, js, jp, PROMPT, 12)
  want = jsyn.spec_agreement_bitmap(jp, jc, js, jpd, jcd, jsd, PROMPT, traj)
  got = tsyn.spec_agreement_bitmap(tp, tc, ts, tpd, tcd, tsd, PROMPT, traj)
  return want, got


@pytest.mark.parametrize("draft", ["int8", "echo_int8", "other"])
def test_spec_agreement_bitmap_matches_the_reference(draft):
  want, got = _bitmaps(draft)
  assert got == want and len(got) == 12


@pytest.mark.parametrize("gamma", [0, 1, 2, 3, 4, 5])
def test_simulate_spec_acceptance_matches_the_reference(gamma):
  rng = np.random.default_rng(gamma)
  bitmaps = [[True] * 30, [False] * 30, [True, False] * 15, [True, True, False] * 10, list(rng.random(40) < 0.7), list(rng.random(12) < 0.5), []]
  for bits in bitmaps:
    for max_steps in (1, 7, 24):
      assert tsyn.simulate_spec_acceptance(bits, gamma, max_steps) == jsyn.simulate_spec_acceptance(bits, gamma, max_steps), (bits, max_steps)
