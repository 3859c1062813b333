"""Multi-head latent attention (deepseek-v2/v3) in the port against the JAX
package, on the CPU at f32.

- The ops on the same seeded numpy inputs: ``apply_rope_interleaved``
  (with and without yarn's factor), ``mla_absorbed_attention`` (also
  against the naive per-head form), ``paged_mla_attention_ref``,
  ``_mla_latents`` with and without ``q_lora_rank``, the cache geometry and
  the page pool's.
- Tiny HF checkpoints built locally with ``transformers`` (3 layers, layer
  0 dense, 8 experts, top-2; weights redrawn from a seed): the four
  deepseek configs of ``tests/test_hf_golden.py`` and a deepseek-v3 with
  yarn and ``mscale_all_dim``. Both packages load each from disk; logits
  within rtol = atol = 2e-4 and greedy ids identical on the cache-less
  forward (also against HF where HF scales as the reference does), cached
  solo decode, int8 and int4 weights, a two-shard ring split (the decoder,
  and two ring nodes' engines on ``ShardPrograms``), the scoring forward,
  the captured programs, solo n-gram speculation, paged decode, the
  batched server at its defaults (the same dispatches: no mixed tick, no
  speculation), a spill and restore through the host KV tier,
  ``XOT_TPU_KV_QUANT=int8`` ignored, ``params_from_jax`` on an MLA tree;
  the KV and weight bytes as the reference counts them, and a ring too
  small for DeepSeek-Coder-V2-Lite answers 507.
- The MoE path table's DeepSeek-V2-Lite row, and ``chip_smoke.py``'s MLA
  references on the CPU: its naive f32 forward equals the port's, its
  V3-width layer check holds at narrow widths.
"""

import asyncio
import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_engine import DirDownloader
from test_torch_kv_tier import _sessions_run
from test_torch_ring import _as_np, _chain, _http, _stop, port_ring, tiny_dir  # noqa: F401 — tiny_dir is a fixture
from xotorch_support_jetson_tpu import registry as jregistry
from xotorch_support_jetson_tpu.inference import paging as jpaging
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec, loader as jloader
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquant
from xotorch_support_jetson_tpu.ops import attention as jattn, paged as jpaged, rope as jrope
from xotorch_support_jetson_tpu.parallel import hbm_planner as jplanner
from xotorch_support_jetson_tpu_torch import registry as tregistry
from xotorch_support_jetson_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_support_jetson_tpu_torch.inference import paging as tpaging
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec, loader as tloader
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquant
from xotorch_support_jetson_tpu_torch.ops import attention as tattn, paged, rope as trope
from xotorch_support_jetson_tpu_torch.parallel import hbm_planner as tplanner
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
LAYERS = 3
PS = 8  # page size: the prompts below cross a page boundary
PROMPT = "hello world how are you today the quick brown fox "
TOKENS = np.array([[5, 17, 92, 3, 44, 61, 8, 120, 33, 7, 99], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]], np.int32)
UNSET = ("XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM", "XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_SLO", "XOT_TPU_KV_QUANT", "XOT_TPU_PAGED_KERNEL", "XOT_TPU_QUANT", "XOT_TPU_MOE_GATHER")
YARN = {"type": "yarn", "factor": 4.0, "beta_fast": 32, "beta_slow": 1, "original_max_position_embeddings": 64}
COMMON = dict(
  vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=48, num_hidden_layers=LAYERS, num_attention_heads=4, num_key_value_heads=4,
  n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1, moe_layer_freq=1, kv_lora_rank=16, qk_nope_head_dim=16,
  qk_rope_head_dim=8, v_head_dim=16, max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False, torch_dtype="float32",
  eos_token_id=2, bos_token_id=1,
)
V2 = dict(norm_topk_prob=False, routed_scaling_factor=1.0)
V3 = dict(q_lora_rank=32, head_dim=8, n_group=4, topk_group=2, norm_topk_prob=True, routed_scaling_factor=2.5)
# The four deepseek configs of tests/test_hf_golden.py, and a deepseek-v3
# with yarn and mscale_all_dim (whose score scale the reference leaves out).
FAMILIES = {
  "deepseek-v2-lite": ("deepseek_v2", dict(V2, q_lora_rank=None, head_dim=24, topk_method="greedy")),
  "deepseek-v2": ("deepseek_v2", dict(V2, q_lora_rank=32, head_dim=24, topk_method="group_limited_greedy", n_group=4, topk_group=2)),
  "deepseek-v2-yarn": ("deepseek_v2", dict(V2, q_lora_rank=32, head_dim=8, topk_method="greedy", rope_scaling=dict(YARN, mscale=0.707, mscale_all_dim=1.0))),
  "deepseek-v3": ("deepseek_v3", V3),
  "deepseek-v3-yarn": ("deepseek_v3", dict(V3, rope_scaling=dict(YARN, mscale=0.707, mscale_all_dim=0.707))),
}
FAMS = list(FAMILIES)
PAIR = ["deepseek-v2-lite", "deepseek-v3"]  # direct wq and the q LoRA, softmax and sigmoid routing
DEEPSEEK_CODER_V2_LITE = chip_smoke.DEEPSEEK_CODER_V2_LITE  # the published config.json of the chip phase's model


def make_tiny_mla(path: Path, family: str) -> np.ndarray:
  """Write the tiny ``family`` checkpoint (with a BPE tokenizer) to
  ``path``; returns HF's own logits on ``TOKENS``. The weights are redrawn
  (norms kept at 1): routers wide enough that the top-2 is well separated."""
  from tokenizers import Tokenizer, models, pre_tokenizers, trainers
  from transformers import AutoConfig, AutoModelForCausalLM, PreTrainedTokenizerFast

  model_type, kw = FAMILIES[family]
  torch.manual_seed(0)
  model = AutoModelForCausalLM.from_config(AutoConfig.for_model(model_type, **COMMON, **kw)).to(torch.float32).eval()
  gen = torch.Generator().manual_seed(1)
  with torch.no_grad():
    for name, p in model.named_parameters():
      if "norm" in name:
        continue
      std = 1.0 if name.endswith("gate.weight") or "embed" in name else p.shape[-1] ** -0.5
      p.copy_(torch.randn(p.shape, generator=gen) * std)
  model.save_pretrained(path, safe_serialization=True)
  tm = Tokenizer(models.BPE(unk_token="<unk>"))
  tm.pre_tokenizer = pre_tokenizers.Whitespace()
  tm.train_from_iterator(["hello world how are you today", "the quick brown fox"] * 50, trainers.BpeTrainer(vocab_size=128, special_tokens=["<pad>", "<s>", "</s>", "<unk>"]))
  tok = PreTrainedTokenizerFast(tokenizer_object=tm, unk_token="<unk>", bos_token="<s>", eos_token="</s>", pad_token="<pad>")
  tok.chat_template = "{% for m in messages %}{{ m['content'] }} {% endfor %}"
  tok.save_pretrained(path)
  with torch.no_grad():
    return model(torch.from_numpy(TOKENS).long()).logits.numpy()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
  out = {}
  for family in FAMS:
    path = tmp_path_factory.mktemp(f"tiny_{family}")
    out[family] = (path, make_tiny_mla(path, family))
  return out


@pytest.fixture(scope="module")
def models(ckpts):
  """family → (jc, tc, js, ts, jp, tp): both packages' config and params,
  each loaded from the checkpoint by its own loader."""
  out = {}
  for family, (path, _) in ckpts.items():
    jc, tc = jconfig.load_model_config(path, dtype=jnp.float32), tconfig.load_model_config(path, dtype=torch.float32)
    js, ts = JShard("tiny", 0, LAYERS - 1, LAYERS), Shard("tiny", 0, LAYERS - 1, LAYERS)
    out[family] = (jc, tc, js, ts, jloader.load_shard_weights(path, jc, js), tloader.load_shard_weights(path, tc, ts))
  return out


@pytest.fixture
def defaults(monkeypatch):
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  monkeypatch.setenv("XOT_TPU_PAGE_SIZE", str(PS))
  return monkeypatch


def _pos(B, S, start=0):
  return np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (B, S)).copy()


def _np(t):
  return t.detach().numpy()


def _rand(rng, *shape, scale=1.0):
  return (rng.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------ ops


@pytest.mark.parametrize("attn_factor", [1.0, 1.3], ids=["plain", "yarn_factor"])
def test_apply_rope_interleaved_matches_jax(attn_factor):
  rng = np.random.default_rng(11)
  x, pos = _rand(rng, 2, 7, 3, 8), np.array([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46]], np.int32)
  inv = (1.0 / 10000 ** (np.arange(4) / 4)).astype(np.float32)
  want = jrope.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv), attn_factor)
  got = trope.apply_rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv), attn_factor)
  np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _mla_inputs(rng, B=2, Sq=3, Skv=12, H=4, nope=16, rope=8, rank=16, v=16):
  return dict(
    q_nope=_rand(rng, B, Sq, H, nope), q_pe=_rand(rng, B, Sq, H, rope), ckv=_rand(rng, B, Skv, rank), kpe=_rand(rng, B, Skv, rope),
    w_kv_b=_rand(rng, rank, H * (nope + v), scale=rank**-0.5), q_positions=np.array([[5, 6, 7], [9, 10, 11]], np.int32), kv_positions=np.arange(Skv, dtype=np.int32),
  )


def test_mla_absorbed_attention_matches_jax_and_the_naive_form():
  """The absorbed op equals the reference's, and both equal the naive form
  (per-head K/V from the latent through ``gqa_attention`` at the same
  1/sqrt(nope + rope) scale)."""
  a = _mla_inputs(np.random.default_rng(12))
  want = jattn.mla_absorbed_attention(*(jnp.asarray(a[k]) for k in ("q_nope", "q_pe", "ckv", "kpe", "w_kv_b", "q_positions", "kv_positions")), 16)
  got = tattn.mla_absorbed_attention(*(torch.from_numpy(a[k]) for k in ("q_nope", "q_pe", "ckv", "kpe", "w_kv_b", "q_positions", "kv_positions")), 16)
  np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
  B, Skv, H = 2, 12, 4
  kv = torch.from_numpy(a["ckv"] @ a["w_kv_b"]).reshape(B, Skv, H, 32)
  q = torch.cat([torch.from_numpy(a["q_nope"]), torch.from_numpy(a["q_pe"])], dim=-1)
  k = torch.cat([kv[..., :16], torch.from_numpy(a["kpe"])[:, :, None, :].expand(B, Skv, H, 8)], dim=-1)
  naive = tattn.gqa_attention(q, k, kv[..., 16:], torch.from_numpy(a["q_positions"]), torch.from_numpy(a["kv_positions"]))
  np.testing.assert_allclose(_np(got), _np(naive), **TOL)


def test_paged_mla_attention_ref_matches_jax():
  rng = np.random.default_rng(13)
  a = _mla_inputs(rng, Sq=1)
  P, H = 9, 4
  k_pool, v_pool = _rand(rng, P, 1, PS, 16), _rand(rng, P, 1, PS, 8)
  bt, lens = np.array([[3, 7, 1], [2, 5, 0]], np.int32), np.array([19, 11], np.int32)
  args = (a["q_nope"], a["q_pe"], k_pool, v_pool, bt, lens, a["w_kv_b"])
  want = jpaged.paged_mla_attention_ref(*map(jnp.asarray, args), 16, PS)
  got = paged.paged_mla_attention_ref(*map(torch.from_numpy, args), 16, PS)
  np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
  assert tuple(got.shape) == (2, 1, H, 16)


@pytest.mark.parametrize("family", ["deepseek-v2-lite", "deepseek-v2-yarn"], ids=["direct_wq", "q_lora_yarn"])
def test_mla_latents_match_jax(models, family):
  """q_nope, q_pe, c_kv and k_pe of layer 0 on the same hidden states, with
  a direct wq and with the q LoRA (yarn's attention factor in the rope)."""
  jc, tc, js, ts, jp, tp = models[family]
  x = _rand(np.random.default_rng(14), 2, 5, 64)
  pos = _pos(2, 5, 3)
  jl = {k: v[0] for k, v in jp["layers"].items()}
  tl = {k: v[0] for k, v in tp["layers"].items()}
  assert ("wq_a" in tl) == (family != "deepseek-v2-lite") and ("wq" in tl) == (family == "deepseek-v2-lite")
  want = jdec._mla_latents(jnp.asarray(x), jl, jc, jnp.asarray(pos), jrope.rope_inv_freq(jc))
  got = tdec._mla_latents(torch.from_numpy(x), tl, tc, torch.from_numpy(pos), trope.rope_inv_freq(tc))
  for g, w in zip(got, want):
    np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("family", FAMS)
def test_cache_geometry_matches_jax(models, family):
  """The config's MLA fields and cache geometry, the rope's rotary width,
  the dense cache and the page pool (shapes and dtypes) equal the
  reference's; int8 KV is ignored for MLA in both."""
  jc, tc = models[family][:2]
  for f in ("is_mla", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "qk_head_dim", "cache_kv_heads", "cache_k_dim", "cache_v_dim", "head_dim"):
    assert getattr(tc, f) == getattr(jc, f), f
  assert (tc.cache_kv_heads, tc.cache_k_dim, tc.cache_v_dim) == (1, 16, 8)
  np.testing.assert_allclose(_np(trope.rope_inv_freq(tc)), np.asarray(jrope.rope_inv_freq(jc)), **TOL)
  assert trope.rope_attention_factor(tc) == pytest.approx(jrope.rope_attention_factor(jc))
  for quant in ("", "int8", "int4"):
    assert tdec.kv_quant_mode(tc, quant) == jdec.kv_quant_mode(jc, quant) == ""
    tcache, jcache = tdec.init_kv_cache(tc, LAYERS, 2, 32, quant=quant), jdec.init_kv_cache(jc, LAYERS, 2, 32, quant=quant)
    tpool, jpool = paged.init_paged_pool(tc, LAYERS, 9, PS, quant=quant), jpaged.init_paged_pool(jc, LAYERS, 9, PS, quant=quant)
    for t, j in ((tcache, jcache), (tpool, jpool)):
      assert sorted(t) == sorted(j) == ["k", "v"]
      assert {k: tuple(v.shape) for k, v in t.items()} == {k: tuple(v.shape) for k, v in j.items()}
      assert all(v.dtype == torch.float32 for v in t.values())
  assert not paged.paged_kernel_supported(tc) and tdec.pool_kv_quant(tpool, tc) == ""
  paged.check_paged_kernel(tc, "cuda")  # an MLA pool is never refused for its head dim


# ------------------------------------------------------------ config, weights


def test_published_deepseek_coder_v2_lite_config_matches_jax():
  jc, tc = jconfig.config_from_hf(DEEPSEEK_CODER_V2_LITE), tconfig.config_from_hf(DEEPSEEK_CODER_V2_LITE)
  for f in dataclasses.fields(tc):
    if f.name not in ("dtype", "rope_scaling"):
      assert getattr(tc, f.name) == getattr(jc, f.name), f.name
  assert dataclasses.asdict(tc.rope_scaling) == dataclasses.asdict(jc.rope_scaling)
  assert (tc.kv_lora_rank, tc.q_lora_rank, tc.qk_head_dim, tc.n_experts, tc.n_active_experts, tc.moe_hidden_dim, tc.shared_expert_dim, tc.first_k_dense) == (512, 0, 192, 64, 6, 1408, 2816, 1)


@pytest.mark.parametrize("family", FAMS)
def test_loaded_leaves_match_jax(models, family):
  """Every leaf of both stacks equals the reference's loader's; converting
  the JAX tree (and its int8 and int4 trees) gives the same tensors."""
  jc, tc, js, ts, jp, tp = models[family]
  assert sorted(tp) == sorted(jp)
  for group in ("layers", "moe_layers"):
    assert sorted(tp[group]) == sorted(jp[group])
    for key, val in jp[group].items():
      np.testing.assert_array_equal(_np(tp[group][key]), np.asarray(val), err_msg=f"{group}/{key}")
  for mode in (None, "int8", "int4"):
    jq = jp if mode is None else jquant(jp, mode)
    conv = params_from_jax(jax.tree.map(np.asarray, jq), tc, ts)
    tq = tp if mode is None else tquant(tp, mode)
    for group in ("layers", "moe_layers"):
      assert sorted(conv[group]) == sorted(tq[group])
      for key, val in tq[group].items():
        assert torch.equal(conv[group][key], val), (mode, group, key)
  assert "wkv_b_scale" in tquant(tp, "int4")["moe_layers"]


def test_params_from_jax_refuses_unknown_mla_leaves(models):
  jc, tc, js, ts, jp, tp = models["deepseek-v3"]
  tree = jax.tree.map(np.asarray, jp)
  tree["layers"]["wkv_b_lora_a"] = tree["layers"]["wkv_b"]
  with pytest.raises(NotImplementedError, match="layers/wkv_b_lora_a"):
    params_from_jax(tree, tc, ts)


@pytest.mark.parametrize("weights,want", [("bf16", 4), ("int8", 8), ("int4", 8)])
def test_h100_path_table_holds_deepseek_v2_lite_row(monkeypatch, weights, want):
  """DeepSeek-V2-Lite's (64 experts, top-6) row of the MoE path table (the
  medians of four scripts/moe_paths.py runs on the H100), read on a card
  when XOT_TPU_MOE_GATHER is unset; the CPU keeps the reference's einsum
  path."""
  from xotorch_support_jetson_tpu_torch.ops import moe as tmoe

  monkeypatch.delenv("XOT_TPU_MOE_GATHER", raising=False)
  assert tmoe.gather_max("cuda", 64, 6, weights) == tmoe.H100_GATHER_MAX[(64, 6, weights)] == want
  assert tmoe.gather_max("cpu", 64, 6, weights) == 0


def test_registry_deepseek_cards_equal_the_reference():
  for model_id in ("deepseek-coder-v2-lite", "deepseek-v3", "deepseek-r1"):
    t, j = tregistry.model_cards[model_id], jregistry.model_cards[model_id]
    assert (t.layers, t.pretty, t.family) == (j.layers, j.pretty, j.family)
    assert tregistry.get_repo(model_id, tregistry.TORCH_ENGINE) == next(iter(j.repo.values()))


# ------------------------------------------------------------ solo forward


@pytest.mark.parametrize("family", FAMS)
def test_cacheless_logits_match_jax_and_hf(ckpts, models, family):
  """The cache-less forward (naive per-head K/V) equals the reference's,
  and HF's where HF scales the scores as the reference does. HF's
  deepseek-v3 multiplies them by yarn's mscale(mscale_all_dim)² and the
  reference does not: the port follows the reference there."""
  _, hf_logits = ckpts[family]
  jc, tc, js, ts, jp, tp = models[family]
  pos = _pos(*TOKENS.shape)
  want, _ = jdec.shard_forward(jp, jc, js, jnp.asarray(TOKENS), jnp.asarray(pos), None)
  got, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(TOKENS), torch.from_numpy(pos), None)
  np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
  if family == "deepseek-v3-yarn":
    assert np.abs(_np(got) - hf_logits).max() > 1e-2
  else:
    np.testing.assert_allclose(_np(got), hf_logits, **TOL)


@pytest.mark.parametrize("family", FAMS)
def test_cached_prefill_and_decode_match_jax(models, family):
  """Prefill 7 tokens into the latent cache, then 12 greedy steps: logits
  and ids equal the reference's, the prefill's logits the cache-less
  forward's."""
  jc, tc, js, ts, jp, tp = models[family]
  toks = TOKENS[:1, :7]
  jcache, tcache = jdec.init_kv_cache(jc, LAYERS, 1, 32), tdec.init_kv_cache(tc, LAYERS, 1, 32)
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(_pos(1, 7)), jcache)
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(_pos(1, 7)), tcache)
  np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
  free, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(_pos(1, 7)), None)
  np.testing.assert_allclose(_np(tl), _np(free), **TOL)
  np.testing.assert_allclose(_np(tcache["k"]), np.asarray(jcache["k"]), **TOL)
  np.testing.assert_allclose(_np(tcache["v"]), np.asarray(jcache["v"]), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([7], jnp.int32), 12)
  tt, _ = tdec.fused_decode(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([7], dtype=torch.int32), 12)
  np.testing.assert_array_equal(_np(tt), np.asarray(jt))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", PAIR)
def test_quantized_weights_match_jax(models, family, mode):
  """Weight-quantized MLA (q, the latent projection, o, the dense MLP, the
  shared expert, the experts and the head; wkv_b dequantized whole for
  the absorbed op): prefill logits and 10 greedy steps equal the
  reference's."""
  jc, tc, js, ts, jp, tp = models[family]
  jq, tq = jquant(jp, mode), tquant(tp, mode)
  assert {"wkv_a_scale", "wkv_b_scale", "wo_scale"} <= set(tq["moe_layers"]) and ("wq_b_scale" in tq["layers"]) == (family == "deepseek-v3")
  toks = TOKENS[1:, :9]
  jl, jcache = jdec.shard_forward(jq, jc, js, jnp.asarray(toks), jnp.asarray(_pos(1, 9)), jdec.init_kv_cache(jc, LAYERS, 1, 32))
  tl, tcache = tdec.shard_forward(tq, tc, ts, torch.from_numpy(toks), torch.from_numpy(_pos(1, 9)), tdec.init_kv_cache(tc, LAYERS, 1, 32))
  np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jq, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([9], jnp.int32), 10)
  tt, _ = tdec.fused_decode(tq, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([9], dtype=torch.int32), 10)
  np.testing.assert_array_equal(_np(tt), np.asarray(jt))


@pytest.mark.parametrize("family", PAIR)
def test_ring_split_matches_jax(ckpts, models, family):
  """Shards [0] (the dense layer) and [1-2] (the MoE stack) loaded from
  disk by both packages: the head's hidden state and the tail's logits
  equal the reference's and the whole model's, cache-less and through the
  latent caches (a prefill and one cached step)."""
  path = ckpts[family][0]
  jc, tc, js, ts, jp, tp = models[family]
  full, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(TOKENS[:1]), torch.from_numpy(_pos(1, 11)), None)
  h = {"jax": TOKENS[:1], "torch": torch.from_numpy(TOKENS[:1])}
  step = {"jax": None, "torch": None}
  for a, b in [(0, 0), (1, LAYERS - 1)]:
    jsh, tsh = JShard("tiny", a, b, LAYERS), Shard("tiny", a, b, LAYERS)
    jps, tps = jloader.load_shard_weights(path, jc, jsh), tloader.load_shard_weights(path, tc, tsh)
    jout, _ = jdec.shard_forward(jps, jc, jsh, jnp.asarray(h["jax"]), jnp.asarray(_pos(1, 11)), None)
    tout, _ = tdec.shard_forward(tps, tc, tsh, h["torch"], torch.from_numpy(_pos(1, 11)), None)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    jcache, tcache = jdec.init_kv_cache(jc, b - a + 1, 1, 32), tdec.init_kv_cache(tc, b - a + 1, 1, 32)
    jx = h["jax"][:, :10] if a == 0 else step["jax"]
    tx = h["torch"][:, :10] if a == 0 else step["torch"]
    jpre, jcache = jdec.shard_forward(jps, jc, jsh, jnp.asarray(jx), jnp.asarray(_pos(1, 10)), jcache)
    tpre, tcache = tdec.shard_forward(tps, tc, tsh, tx, torch.from_numpy(_pos(1, 10)), tcache)
    np.testing.assert_allclose(_np(tpre), np.asarray(jpre), **TOL)
    step = {"jax": np.asarray(jpre), "torch": tpre}
    h = {"jax": np.asarray(jout), "torch": tout}
  np.testing.assert_allclose(_np(h["torch"]), _np(full), **TOL)
  np.testing.assert_allclose(_np(step["torch"][:, -1]), _np(full[:, 9]), **TOL)


@pytest.mark.asyncio
async def test_partial_shard_engines_equal_the_jax_engines(ckpts):
  """Two ring nodes' engines per package on the deepseek-v3 checkpoint,
  shards [0] and [1-2] (each a partial shard's captured programs,
  ``ShardPrograms``, on its own latent cache): every hop's output of the
  prefill and of 6 greedy steps equals the reference engine's, the ids
  too."""
  from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
  from xotorch_support_jetson_tpu_torch.models.decoder import ShardPrograms

  path = ckpts["deepseek-v3"][0]
  split = [(0, 0), (1, LAYERS - 1)]
  tshards, jshards = [Shard("tiny-mla", a, b, LAYERS) for a, b in split], [JShard("tiny-mla", a, b, LAYERS) for a, b in split]
  tes = [TorchShardedInferenceEngine(DirDownloader(path), device="cpu") for _ in split]
  jes = [JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False) for _ in split]
  tokens = np.asarray(await tes[0].encode(tshards[0], PROMPT), np.int32).reshape(1, -1)
  x_t, x_j, t_state, j_state, ids = tokens, tokens, None, None, []
  for step in range(7):
    t_outs, t_state = await _chain(tes, tshards, "r", x_t, t_state)
    j_outs, j_state = await _chain(jes, jshards, "r", x_j, j_state)
    for i, (t, j) in enumerate(zip(t_outs, j_outs)):
      np.testing.assert_allclose(_as_np(t), _as_np(j), **TOL, err_msg=f"step {step} hop {i}")
    ids.append((int(np.argmax(t_outs[-1][0])), int(np.argmax(j_outs[-1][0]))))
    x_t, x_j = np.asarray([[ids[-1][0]]], np.int32), np.asarray([[ids[-1][1]]], np.int32)
  assert all(t == j for t, j in ids)
  assert all(isinstance(e.sessions["r"].programs, ShardPrograms) for e in tes)
  for e in tes:
    e.end_request("r")


@pytest.mark.parametrize("family", FAMS)
def test_score_last_tokens_matches_jax(models, family):
  jc, tc, js, ts, jp, tp = models[family]
  toks = np.zeros((1, 16), np.int32)
  toks[0, :11] = TOKENS[0]
  want = [np.asarray(x) for x in jdec.score_last_tokens(jp, jc, js, jnp.asarray(toks), jnp.int32(11), 6, 4)]
  got = [_np(x) for x in tdec.score_last_tokens(tp, tc, ts, torch.from_numpy(toks), 11, 6, 4)]
  np.testing.assert_allclose(got[0], want[0], **TOL)
  np.testing.assert_array_equal(got[1], want[1])
  np.testing.assert_allclose(got[2], want[2], **TOL)


def test_programs_equal_eager(models):
  """The solo programs on a latent cache (captured on a card, eager through
  the same buffers here) equal the functions: a prefill bucket and 10
  decode steps."""
  _, tc, _, ts, _, tp = models["deepseek-v3"]
  cache = tdec.init_kv_cache(tc, LAYERS, 1, 32)
  progs = tdec.SoloPrograms(tp, tc, ts, cache)
  x = np.zeros((1, 16), np.int32)
  x[0, :9] = TOKENS[1, :9]
  logits = progs.prefill(x, 9)
  want, ecache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(x), torch.from_numpy(_pos(1, 16)), tdec.init_kv_cache(tc, LAYERS, 1, 32))
  np.testing.assert_allclose(_np(logits), _np(want[:, 8]), **TOL)
  first = int(logits[0].argmax())
  got = tdec.fused_decode(tp, tc, ts, first, cache, 9, 10, programs=progs)[0]
  eager = tdec.fused_decode(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), ecache, torch.tensor([9], dtype=torch.int32), 10)[0]
  np.testing.assert_array_equal(_np(got), _np(eager))


@pytest.mark.parametrize("family", PAIR)
def test_solo_ngram_chunk_matches_jax(models, family):
  """The solo n-gram chunk (``fused_spec_batch_decode`` at B=1, 3 rounds at
  depth 4, proposals from the plain greedy stream) over the latent cache:
  tokens, counts and positions equal the reference's; the stream accepts
  in full."""
  jc, tc, js, ts, jp, tp = models[family]
  prompt = TOKENS[1:, :9]
  jcache = jdec.init_kv_cache(jc, LAYERS, 1, 64)
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(prompt), jnp.asarray(_pos(1, 9)), jcache)
  tcache = tdec.init_kv_cache(tc, LAYERS, 1, 64)
  tdec.shard_forward(tp, tc, ts, torch.from_numpy(prompt), torch.from_numpy(_pos(1, 9)), tcache)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  R, G = 3, 4
  plain, _ = jdec.fused_decode(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jax.tree.map(jnp.copy, jcache), jnp.asarray([9], jnp.int32), R * (G + 1) + G)
  kw = dict(props=np.array(plain), prop_counts=np.array([R * (G + 1) + G], np.int32))
  j = jdec.fused_spec_batch_decode(
    jp, jc, js, None, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, None, jnp.full((1,), 9, jnp.int32), jnp.ones((1,), bool), jnp.full((1,), G, jnp.int32),
    jnp.zeros((1,), jnp.float32), R, G, **{k: jnp.asarray(v) for k, v in kw.items()},
  )
  t = tdec.fused_spec_batch_decode(
    tp, tc, ts, None, None, None, torch.full((1, 1), first, dtype=torch.int32), tcache, None, torch.full((1,), 9, dtype=torch.int32), torch.ones((1,), dtype=torch.bool),
    torch.full((1,), G, dtype=torch.int32), torch.zeros((1,)), R, G, **{k: torch.from_numpy(v) for k, v in kw.items()},
  )
  n = int(np.asarray(j[1])[0])
  assert int(t[1][0]) == n == R * (G + 1) and t[0][0, :n].tolist() == np.asarray(j[0])[0, :n].tolist()
  assert int(t[4][0]) == int(np.asarray(j[4])[0]) and int(t[3][0, 0]) == int(np.asarray(j[3])[0, 0])


# ------------------------------------------------------------ paged serving


BT = np.array([[3, 7, 1, 9, 12, 0], [2, 11, 5, 10, 13, 0], [4, 6, 8, 14, 15, 0]], np.int32)
LENS = np.array([11, 6, 19], np.int32)


def _pools(model, bt, lens, seed=5):
  """Both packages' latent page pools with each row's prompt of
  ``lens[i]`` tokens prefilled through ``bt``'s first three pages in one
  forward; (jpool, tpool, greedy first tokens [B, 1])."""
  jc, tc, js, ts, jp, tp = model
  n_pages = int(bt.max()) + 1
  jpool, tpool = jpaged.init_paged_pool(jc, LAYERS, n_pages, PS), paged.init_paged_pool(tc, LAYERS, n_pages, PS)
  B = bt.shape[0]
  toks = np.random.default_rng(seed).integers(0, 128, (B, 3 * PS)).astype(np.int32)
  z = np.zeros(B, np.int32)
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(toks), jpool, jnp.asarray(bt[:, :3]), jnp.asarray(z), jnp.asarray(lens), PS)
  tl, tpool = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(toks), tpool, torch.from_numpy(bt[:, :3]), torch.from_numpy(z), torch.from_numpy(lens), PS)
  np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
  for key in ("k", "v"):  # page 0 is the trash page: padding writes land there
    np.testing.assert_allclose(_np(tpool[key][:, 1:]), np.asarray(jpool[key])[:, 1:], **TOL)
  return jpool, tpool, np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("family", PAIR)
def test_paged_decode_matches_jax(models, family):
  """Latent pages prefilled for three rows, then 8 greedy paged steps
  (``paged_mla_attention_ref`` in every layer): ids equal the reference's,
  and the port's forced ``use_kernel=True`` takes the same route."""
  jc, tc, js, ts, jp, tp = models[family]
  jpool, tpool, first = _pools(models[family], BT, LENS)
  args = (BT, LENS, np.ones(3, bool), np.zeros(3, np.float32))
  jt = jdec.fused_paged_batch_decode(jp, jc, js, jnp.asarray(first), jpool, *map(jnp.asarray, args), 8, page_size=PS)[0]
  kpool = {k: v.clone() for k, v in tpool.items()}
  tt = tdec.fused_paged_batch_decode(tp, tc, ts, torch.from_numpy(first), tpool, *map(torch.from_numpy, args), 8, page_size=PS)[0]
  np.testing.assert_array_equal(_np(tt), np.asarray(jt))
  forced = tdec.fused_paged_batch_decode(tp, tc, ts, torch.from_numpy(first), kpool, *map(torch.from_numpy, args), 8, page_size=PS, use_kernel=True)[0]
  np.testing.assert_array_equal(_np(forced), np.asarray(jt))


@pytest.mark.parametrize("program", ["mixed", "window", "spec"])
def test_mixed_window_and_spec_programs_refuse_mla_as_the_reference(models, program):
  jc, tc, js, ts, jp, tp = models["deepseek-v2-lite"]
  jpool, tpool, first = _pools(models["deepseek-v2-lite"], BT, LENS)
  rows = (BT, LENS, np.ones(3, bool))
  temps = np.zeros(3, np.float32)
  for pkg, dec, params, cfg, shard, pool, conv in (("jax", jdec, jp, jc, js, jpool, jnp.asarray), ("port", tdec, tp, tc, ts, tpool, torch.from_numpy)):
    with pytest.raises(ValueError, match="MLA"):
      if program == "mixed":
        pf = (np.zeros((1, 8), np.int32), BT[2:, :3], np.array([0], np.int32), np.array([5], np.int32))
        dec.fused_mixed_paged_batch_decode(params, cfg, shard, conv(first), pool, *map(conv, rows), conv(temps), *map(conv, pf), 2, page_size=PS)
      elif program == "window":
        dec.paged_window_forward(params, cfg, shard, conv(np.tile(first, (1, 3))), conv(_pos(3, 3, 20)), pool, conv(BT), PS, False)
      else:
        gam = np.full(3, 2, np.int32)
        empty = (None, cfg, shard) if pkg == "jax" else (None, None, None)
        dec.fused_spec_paged_batch_decode(params, cfg, shard, *empty, conv(first), pool, None, *map(conv, rows), conv(gam), conv(temps), 2, 2, page_size=PS)


def _spy(server, log):
  """Record every batched dispatch by kind, in order."""
  for name in ("spec_paged_batch_decode", "paged_batch_decode", "mixed_paged_batch_decode", "prefill_into_pages_many_sampled"):
    orig = getattr(server.ops, name)

    def spy(*args, _orig=orig, _name=name, **kw):
      log.append(_name)
      return _orig(*args, **kw)

    setattr(server.ops, name, spy)


def _serve(server, prompts, max_tokens=20):
  log: list = []
  _spy(server, log)

  async def run():
    return await asyncio.gather(*(server.submit(f"r{i}", p, max_tokens=max_tokens, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None) for i, p in enumerate(prompts)))

  out = asyncio.run(run())
  flags = (server.spec, server.ops.mixed_tick_supported())
  server.shutdown()
  return [[int(x) for x in o] for o in out], log, flags


def _engines(model):
  jc, tc, js, ts, jp, tp = model
  je = JaxShardedInferenceEngine(use_local_mesh=False)
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(device="cpu")
  te.load_test_model(ts, tc, tp)
  return je, te


@pytest.mark.parametrize("family", PAIR)
def test_batched_server_at_defaults_answers_like_jax(models, defaults, family):
  """Three greedy requests (repetitive prompts, which would propose) through
  each package's batched server at the defaults: the same tokens and the
  same dispatches in order — prefills and plain chunks only, as the
  reference's MLA server runs (no mixed tick, no speculation)."""
  prompts = [np.array([9, 9, 31, 9, 9, 31, 9, 9, 31, 9, 9, 31, 7], np.int32), np.array([40, 41, 42, 40, 41, 42, 40, 41], np.int32), np.arange(50, 80, dtype=np.int32)]
  je, te = _engines(models[family])
  got, want = _serve(BatchedServer(te, n_slots=2, chunk=4), prompts), _serve(JaxBatchedServer(je, n_slots=2, chunk=4), prompts)
  assert got == want
  assert set(got[1]) == {"prefill_into_pages_many_sampled", "paged_batch_decode"} and got[2] == (False, False)


def test_kv_quant_int8_is_ignored_like_the_reference(models, defaults):
  """``XOT_TPU_KV_QUANT=int8`` on an MLA model: the engine's caches and the
  batched server's pool stay in the model dtype, the answers equal the
  reference's under the same setting, and the server's tier and gauges
  read no quantization."""
  defaults.setenv("XOT_TPU_KV_QUANT", "int8")
  je, te = _engines(models["deepseek-v3"])
  programs, _ = te._take_programs(1, 32)
  assert sorted(programs.cache) == ["k", "v"] and programs.cache["k"].dtype == torch.float32
  prompts = [np.arange(20, 33, dtype=np.int32), np.array([7, 1, 88, 42, 5], np.int32)]
  server = BatchedServer(te, n_slots=2, chunk=4)
  got, want = _serve(server, prompts, 12), _serve(JaxBatchedServer(je, n_slots=2, chunk=4), prompts, 12)
  assert got == want and server.tier.kv_quant == ""


def test_host_tier_spill_and_restore_match_jax(models, defaults):
  """Six three-turn conversations on two slots and 12 usable pages: latent
  pages (k 16 wide, v 8 wide) park on the host between turns and come back
  by restore; tokens and tier counters equal the reference's."""
  defaults.setenv("XOT_TPU_BATCH_PAGES", "13")
  defaults.setenv("XOT_TPU_PAGE_SIZE", "4")
  got, want = _sessions_run(models["deepseek-v2-lite"], "port"), _sessions_run(models["deepseek-v2-lite"], "jax")
  assert got == want
  results, deltas = got
  assert len(results) == 18 and deltas["kv_tier_spilled_pages_total"] > 0 and deltas["kv_tier_restored_pages_total"] > 0


def test_engine_answers_like_jax(ckpts):
  """Both engines load the deepseek-v2-lite checkpoint from disk: prefill
  logits within TOL, a greedy oneshot and chained chunks identical."""
  path = ckpts["deepseek-v2-lite"][0]
  shard, jshard = Shard("tiny-mla", 0, LAYERS - 1, LAYERS), JShard("tiny-mla", 0, LAYERS - 1, LAYERS)

  async def run(engine, s):
    logits, _ = await engine.infer_prompt("r", s, PROMPT)
    first = int(np.argmax(logits[0]))
    one = await engine.generate_oneshot("r", s, first, 12, eos_ids=(), temp=0.0)
    engine.end_request("r")
    await engine.infer_prompt("c", s, PROMPT)
    chunks = await engine.read_chunk(await engine.dispatch_chunk("c", s, 6, 0.0, 35, first_token=first))
    chunks += await engine.read_chunk(await engine.dispatch_chunk("c", s, 6, 0.0, 35))
    return np.asarray(logits), list(one), chunks

  jl, jone, jchunks = asyncio.run(run(JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False), jshard))
  tl, tone, tchunks = asyncio.run(run(TorchShardedInferenceEngine(DirDownloader(path), device="cpu"), shard))
  np.testing.assert_allclose(tl, jl, **TOL)
  assert [int(x) for x in tone] == [int(x) for x in jone] and tchunks == jchunks == [int(x) for x in jone]


# ------------------------------------------------------------ bytes, ring budget


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_kv_cache_bytes_match_jax(models, quant):
  """The page-pool block math (latent and rope channel, one head entry)
  and the planner's dense cache bytes equal the reference's."""
  jc, tc = models["deepseek-v3"][:2]
  per_token = {"": (16 + 8) * 4, "int8": 16 + 8 + 2 * 4, "int4": (16 + 8) // 2 + 2 * 4}[quant]  # one head entry: latent + rope channel
  assert tpaging.kv_cache_bytes(tc, LAYERS, 64, quant) == jpaging.kv_cache_bytes(jc, LAYERS, 64, quant) == LAYERS * 64 * per_token
  assert tplanner.kv_cache_bytes(tc, 2, 32) == LAYERS * 2 * 32 * (16 + 8) * 4


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("span", [(0, LAYERS - 1), (1, 2)])
def test_planner_counts_mla_bytes_as_the_reference(models, span, quant):
  for family in PAIR:
    jc, tc = models[family][:2]
    got = tplanner.model_bytes(tc, Shard("m", *span, LAYERS), quant)
    assert got == jplanner.model_bytes(jc, JShard("m", *span, LAYERS), quant), family


@pytest.mark.asyncio
async def test_mla_ring_too_small_answers_507(tiny_dir, monkeypatch, tmp_path):  # noqa: F811 — tiny_dir is the fixture
  """Two port nodes of 6000 MB each against DeepSeek-Coder-V2-Lite's
  published shapes (about 31 GB of bf16 weights): the same problems as
  the reference's planner, and the API answers 507 before loading
  anything."""
  (tmp_path / "config.json").write_text(json.dumps(DEEPSEEK_CODER_V2_LITE))
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tmp_path))
  nodes = await port_ring([TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in range(2)], [6000, 6000])
  try:
    from xotorch_support_jetson_tpu_torch.topology.partitioning import map_partitions_to_shards

    problems = nodes[0]._ring_budget_problems(Shard("deepseek-coder-v2-lite", 0, 0, 27))
    spans = [(s.start_layer, s.end_layer) for s in map_partitions_to_shards(nodes[0].partitioning_strategy.partition(nodes[0].topology), 27, "deepseek-coder-v2-lite")]
    want = jplanner.ring_partition_fits(jconfig.config_from_hf(DEEPSEEK_CODER_V2_LITE), [JShard("deepseek-coder-v2-lite", a, b, 27) for a, b in spans], [6000 * 1024**2] * 2)
    assert len(problems) == 2 and problems == want
    api = ChatGPTAPI(nodes[0], "TorchShardedInferenceEngine", response_timeout=30, default_model="deepseek-coder-v2-lite")
    port = find_available_port("127.0.0.1")
    server = await api.run(host="127.0.0.1", port=port)
    try:
      st, raw = await asyncio.to_thread(_http, port, "/v1/chat/completions", {"model": "deepseek-coder-v2-lite", "messages": [{"role": "user", "content": "hi"}]})
    finally:
      server.close()
    assert st == 507 and json.loads(raw)["error"]["type"] == "insufficient_resources" and problems[0] in raw
    assert nodes[0].inference_engine.shard is None
  finally:
    await _stop(nodes)


def test_chip_smoke_naive_forward_equals_the_port():
  """``chip_smoke.mla_plain_f32`` (the card run's independent reference:
  naive per-head K/V, its own yarn and routing) equals the port's
  cache-less forward at f32 on a narrow DeepSeek-Coder-V2-Lite (its
  published yarn, mscale and routing; 3 layers, 8 experts, top-3)."""
  hf = dict(
    DEEPSEEK_CODER_V2_LITE, vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3, kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
  )
  cfg, shard = tconfig.config_from_hf(hf, dtype=torch.float32), Shard("t", 0, 2, 3)
  g = torch.Generator().manual_seed(3)
  params = tdec.init_shard_params(cfg, shard, generator=g)
  params["moe_layers"]["w_router"] *= 3.0
  for stack in ("layers", "moe_layers"):
    for key in ("attn_norm", "mlp_norm", "kv_a_norm"):
      params[stack][key] = params[stack][key] + 0.1 * torch.randn(params[stack][key].shape, generator=g)
  ids = TOKENS[0].tolist()
  want, _ = tdec.shard_forward(params, cfg, shard, torch.tensor([ids]), torch.from_numpy(_pos(1, len(ids))), None)
  got, _, decisions = chip_smoke.mla_plain_f32(torch, params, cfg, ids, n_last=3, hf=hf)
  np.testing.assert_allclose(_np(got), _np(want[0, -3:]), **TOL)
  assert decisions == 2 * len(ids)


def test_chip_smoke_v3_layer_check_runs_on_the_cpu():
  """``chip_smoke.mla_v3_attention_check`` at narrow widths on the CPU:
  the port's bf16 absorbed op against its naive f32 form, within the
  card run's 5e-2."""
  hf = dict(chip_smoke.DEEPSEEK_V3, hidden_size=64, num_attention_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16)
  res = chip_smoke.mla_v3_attention_check(torch, "cpu", hf=hf, slots=64, dev="cpu")
  assert res["rel_err"] < 1e-2 and res["absorbed_ms"] is None


def test_full_width_bytes_are_deepseek_coder_v2_lite_s():
  """The published config's weight bytes at bf16 (the chip phase's sizing):
  about 31.4 GB at 27 layers and 9.2 GB at 8."""
  cfg = tconfig.config_from_hf(DEEPSEEK_CODER_V2_LITE)
  full = tplanner.model_bytes(cfg)
  eight = tplanner.model_bytes(dataclasses.replace(cfg, n_layers=8))
  assert math.isclose(full / 1e9, 31.4, abs_tol=0.1) and math.isclose(eight / 1e9, 9.2, abs_tol=0.1)
  assert full == jplanner.model_bytes(jconfig.config_from_hf(DEEPSEEK_CODER_V2_LITE))
