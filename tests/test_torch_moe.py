"""Mixture-of-experts serving in the port against the JAX package, on the CPU
at f32.

- ``ops/moe.py`` against ``xotorch_support_jetson_tpu.ops.moe`` on the same
  seeded numpy inputs: ``router_topk`` (softmax, sigmoid with a selection
  bias, ``max`` and ``top2sum`` groups, ``norm_topk``, scale),
  ``dispatch_combine_masks`` (exact, and capacity 1 with drops), ``moe_ffn``
  on the einsum path, the gather path and the chunked path (T > 256), with
  bf16-layout, int8 and int4 experts, and ``load_balancing_loss``; the path
  table's reading of ``XOT_TPU_MOE_GATHER``.
- Tiny HF checkpoints built locally with ``transformers`` (3 layers, 8
  experts, top-2; weights redrawn from a seed so routing matters): mixtral,
  qwen2-moe (a shared expert with its sigmoid gate, qkv bias) and qwen3-moe
  (qk-norm, ``norm_topk_prob``). Both packages load each from disk; logits
  within rtol = atol = 2e-4 and greedy ids identical on the cache-less
  forward (also against HF), cached solo decode on each MoE path, int8 and
  int4 weights, a two-shard ring split inside the MoE stack, the scoring
  forward, paged decode, a mixed tick, the batched verify window, solo
  n-gram speculation and the batched server at its defaults (tokens and
  dispatches equal the JAX server's); ``params_from_jax`` on an MoE tree.
- The ring budget counts the expert stacks as the reference's planner does,
  and a ring too small for an MoE model answers 507.
- Vision checkpoints are still refused at load (an MLA checkpoint parses).
"""

import asyncio
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import DirDownloader
from test_torch_ring import _http, _stop, port_ring, tiny_dir  # noqa: F401 — tiny_dir is a fixture
from xotorch_support_jetson_tpu import registry as jregistry
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec, loader as jloader
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquant
from xotorch_support_jetson_tpu.ops import moe as jmoe, paged as jpaged
from xotorch_support_jetson_tpu.parallel import hbm_planner as jplanner
from xotorch_support_jetson_tpu_torch import registry as tregistry
from xotorch_support_jetson_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec, loader as tloader
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquant
from xotorch_support_jetson_tpu_torch.ops import moe as tmoe, paged
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
COMMON = dict(vocab_size=128, hidden_size=64, num_hidden_layers=LAYERS, num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, tie_word_embeddings=False, torch_dtype="float32", eos_token_id=2, bos_token_id=1)
FAMILIES = {
  "mixtral": ("mixtral", dict(intermediate_size=48, num_local_experts=8, num_experts_per_tok=2, rope_theta=10000.0)),
  "qwen2-moe": ("qwen2_moe", dict(intermediate_size=96, moe_intermediate_size=48, shared_expert_intermediate_size=96, num_experts=8, num_experts_per_tok=2, decoder_sparse_step=1, norm_topk_prob=False, rope_theta=10000.0)),
  "qwen3-moe": ("qwen3_moe", dict(intermediate_size=96, moe_intermediate_size=48, head_dim=16, num_experts=8, num_experts_per_tok=2, decoder_sparse_step=1, norm_topk_prob=True, mlp_only_layers=[], rope_theta=1e6)),
}
FAMS = list(FAMILIES)
# Qwen/Qwen3-30B-A3B's published config.json (the chip phase's model).
QWEN3_30B_A3B = {
  "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
  "moe_intermediate_size": 768, "num_hidden_layers": 48, "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128,
  "num_experts_per_tok": 8, "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [], "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
  "max_position_embeddings": 40960, "tie_word_embeddings": False, "torch_dtype": "bfloat16", "bos_token_id": 151643, "eos_token_id": 151645,
}


def make_tiny_moe(path: Path, family: str) -> np.ndarray:
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
      std = 1.0 if name.endswith("gate.weight") else 1.0 if "embed" in name else p.shape[-1] ** -0.5
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
    out[family] = (path, make_tiny_moe(path, family))
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
def moe_path(monkeypatch, request):
  """Pin both packages to one MoE path: the port through
  XOT_TPU_MOE_GATHER, the reference through its import-time bound."""
  gather = request.param == "gather"
  monkeypatch.setenv("XOT_TPU_MOE_GATHER", "1" if gather else "0")
  monkeypatch.setattr(jmoe, "MOE_GATHER_MAX", 32 if gather else 0)
  tmoe.reset_path_counts()
  return request.param


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


# ------------------------------------------------------------ ops/moe.py


ROUTES = {
  "softmax": dict(k=2),
  "softmax_norm_scale": dict(k=3, norm_topk=True, scale=2.5),
  "sigmoid_bias": dict(k=2, scoring="sigmoid", bias=True),
  "groups_max": dict(k=2, n_group=4, topk_group=2, group_mode="max"),
  "groups_top2sum": dict(k=4, scoring="sigmoid", bias=True, norm_topk=True, scale=2.0, n_group=4, topk_group=2, group_mode="top2sum"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_router_topk_matches_jax(case):
  kw = dict(ROUTES[case])
  rng = np.random.default_rng(3)
  logits = rng.normal(size=(24, 16)).astype(np.float32)
  bias = rng.normal(size=(16,)).astype(np.float32) * 0.5 if kw.pop("bias", False) else None
  jw, ji = jmoe.router_topk(jnp.asarray(logits), selection_bias=None if bias is None else jnp.asarray(bias), **kw)
  tw, ti = tmoe.router_topk(torch.from_numpy(logits), selection_bias=None if bias is None else torch.from_numpy(bias), **kw)
  np.testing.assert_array_equal(_np(ti), np.asarray(ji))
  np.testing.assert_allclose(_np(tw), np.asarray(jw), **TOL)
  assert ti.dtype == torch.int32 and tw.dtype == torch.float32


@pytest.mark.parametrize("capacity_factor", [None, 0.25], ids=["exact", "capacity-1"])
def test_dispatch_combine_masks_match_jax(capacity_factor):
  rng = np.random.default_rng(4)
  T, E, k = 12, 6, 2
  idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
  weights = rng.random((T, k)).astype(np.float32)
  C = tmoe.expert_capacity(T, k, E, capacity_factor)
  assert C == jmoe.expert_capacity(T, k, E, capacity_factor) == (T if capacity_factor is None else 1)
  jd, jcomb = jmoe.dispatch_combine_masks(jnp.asarray(idx), jnp.asarray(weights), E, C)
  td, tcomb = tmoe.dispatch_combine_masks(torch.from_numpy(idx), torch.from_numpy(weights), E, C)
  np.testing.assert_array_equal(_np(td), np.asarray(jd))
  np.testing.assert_allclose(_np(tcomb), np.asarray(jcomb), **TOL)
  if capacity_factor is not None:
    assert _np(td).sum() < T * k  # assignments past the capacity dropped


def _expert_weights(E=8, D=32, F=24, seed=5):
  rng = np.random.default_rng(seed)
  return (
    rng.normal(size=(D, E)).astype(np.float32),
    *(rng.normal(size=shape).astype(np.float32) * shape[-2] ** -0.5 for shape in ((E, D, F), (E, D, F), (E, F, D))),
  )


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
@pytest.mark.parametrize("path,T", [("einsum", 7), ("gather", 7), ("chunked", 300)])
def test_moe_ffn_matches_jax(monkeypatch, path, T, quant):
  """One routed FFN on each path: the port's output and aux loss equal the
  reference's, quantized experts against the reference's dequantize-first
  product; PATHS records the path taken."""
  router, g, u, d = _expert_weights()
  x = np.random.default_rng(6).normal(size=(T, 32)).astype(np.float32)
  gather = path == "gather"
  monkeypatch.setenv("XOT_TPU_MOE_GATHER", "1" if gather else "0")
  monkeypatch.setattr(jmoe, "MOE_GATHER_MAX", 32 if gather else 0)
  kw = dict(k=2, norm_topk=True, return_aux=True)
  tw = {"w_gate": torch.from_numpy(g), "w_up": torch.from_numpy(u), "w_down": torch.from_numpy(d)}
  scales = {}
  if quant:
    q = tquant({"moe_layers": {f"w_experts_{k[2:]}": v[None] for k, v in tw.items()}}, quant)["moe_layers"]
    tw = {k: q[f"w_experts_{k[2:]}"][0] for k in tw}
    scales = {f"{k[2:]}_scale": q[f"w_experts_{k[2:]}_scale"][0] for k in tw}
    from xotorch_support_jetson_tpu_torch.models.quantize import dequantize_leaf

    g, u, d = (_np(dequantize_leaf(tw[k], scales[s], in_dim, torch.float32)) for k, s, in_dim in (("w_gate", "gate_scale", 32), ("w_up", "up_scale", 32), ("w_down", "down_scale", 24)))
  jout, jaux = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(router), jnp.asarray(g), jnp.asarray(u), jnp.asarray(d), **kw)
  tmoe.reset_path_counts()
  tout, taux = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(router), tw["w_gate"], tw["w_up"], tw["w_down"], **kw, **scales, hidden_dim=24)
  np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
  np.testing.assert_allclose(float(taux), float(jaux), **TOL)
  assert dict(tmoe.PATHS) == {f"{path}@{T}": 1}


def test_load_balancing_loss_matches_jax():
  rng = np.random.default_rng(7)
  logits = rng.normal(size=(20, 8)).astype(np.float32)
  idx = np.stack([rng.choice(8, 3, replace=False) for _ in range(20)]).astype(np.int32)
  np.testing.assert_allclose(float(tmoe.load_balancing_loss(torch.from_numpy(logits), torch.from_numpy(idx), 8)), float(jmoe.load_balancing_loss(jnp.asarray(logits), jnp.asarray(idx), 8)), **TOL)


@pytest.mark.parametrize("env,device,want", [(None, "cpu", 0), ("1", "cpu", 32), ("0", "cpu", 0), (None, "cuda", "table"), ("1", "cuda", 32), ("0", "cuda", 0)])
def test_gather_max_reads_the_knob_and_the_h100_table(monkeypatch, env, device, want):
  """XOT_TPU_MOE_GATHER keeps the reference's meaning wherever it is set;
  unset, the CPU takes the reference's default (einsum) and a card the
  H100 table (the bytes rule for a shape it lacks)."""
  if env is None:
    monkeypatch.delenv("XOT_TPU_MOE_GATHER", raising=False)
  else:
    monkeypatch.setenv("XOT_TPU_MOE_GATHER", env)
  if want == "table":
    for weights in ("bf16", "int8", "int4"):
      assert tmoe.gather_max(device, 128, 8, weights) == tmoe.H100_GATHER_MAX[(128, 8, weights)]
    assert tmoe.gather_max(device, 60, 4) == 60 // 12
  else:
    assert tmoe.gather_max(device, 128, 8) == want


# ------------------------------------------------------------ config, weights


@pytest.mark.parametrize("family", FAMS)
def test_config_fields_match_jax(models, family):
  jc, tc = models[family][:2]
  for f in ("family", "n_experts", "n_active_experts", "moe_hidden_dim", "shared_expert_dim", "shared_expert_gate", "first_k_dense", "router_scoring", "norm_topk_prob", "routed_scaling_factor", "moe_capacity_factor", "moe_aux_loss_coef", "n_group", "topk_group", "group_mode", "qkv_bias", "qk_norm", "head_dim", "hidden_dim"):
    assert getattr(tc, f) == getattr(jc, f), f
  assert tc.family == family and tc.n_experts == 8 and tc.n_active_experts == 2


def test_published_qwen3_30b_a3b_config_matches_jax():
  jc, tc = jconfig.config_from_hf(QWEN3_30B_A3B), tconfig.config_from_hf(QWEN3_30B_A3B)
  for f in ("n_experts", "n_active_experts", "moe_hidden_dim", "norm_topk_prob", "qk_norm", "qkv_bias", "head_dim", "n_heads", "n_kv_heads", "tied_embedding", "rope_theta", "norm_eps"):
    assert getattr(tc, f) == getattr(jc, f), f
  assert (tc.n_experts, tc.n_active_experts, tc.moe_hidden_dim, tc.norm_topk_prob, tc.qk_norm) == (128, 8, 768, True, True)


@pytest.mark.parametrize("family", FAMS)
def test_loaded_leaves_match_jax(models, family):
  """Every leaf of both stacks equal the reference's loader's; converting
  the JAX tree (and its int4 tree) gives the same tensors."""
  jc, tc, js, ts, jp, tp = models[family]
  assert sorted(tp) == sorted(jp) and "layers" not in tp
  assert sorted(tp["moe_layers"]) == sorted(jp["moe_layers"])
  for key, val in jp["moe_layers"].items():
    np.testing.assert_array_equal(_np(tp["moe_layers"][key]), np.asarray(val), err_msg=key)
  for key in ("embed", "final_norm", "lm_head"):
    np.testing.assert_array_equal(_np(tp[key]), np.asarray(jp[key]), err_msg=key)
  conv = params_from_jax(jax.tree.map(np.asarray, jp), tc, ts)
  for key, val in conv["moe_layers"].items():
    assert torch.equal(val, tp["moe_layers"][key]), key
  jq = jquant(jp, "int4")
  cq = params_from_jax(jax.tree.map(np.asarray, jq), tc, ts)
  tq = tquant(tp, "int4")
  assert sorted(cq["moe_layers"]) == sorted(tq["moe_layers"])
  for key, val in tq["moe_layers"].items():
    assert torch.equal(cq["moe_layers"][key], val), key


def test_params_from_jax_refuses_unknown_moe_leaves(models):
  jc, tc, js, ts, jp, tp = models["qwen3-moe"]
  tree = jax.tree.map(np.asarray, jp)
  tree["moe_layers"]["wq_lora_a"] = tree["moe_layers"]["wq"]  # a LoRA leaf: not ported (MLA's wkv_a is known since it was)
  with pytest.raises(NotImplementedError, match="moe_layers/wq_lora_a"):
    params_from_jax(tree, tc, ts)


def test_registry_moe_cards_equal_the_reference():
  for model_id in ("qwen-3-30b-a3b", "qwen-3-235b-a22b"):
    t, j = tregistry.model_cards[model_id], jregistry.model_cards[model_id]
    assert (t.layers, t.pretty, t.family) == (j.layers, j.pretty, j.family)
    assert tregistry.get_repo(model_id, tregistry.TORCH_ENGINE) == next(iter(j.repo.values()))


def test_mla_and_vision_checkpoints_still_refused():
  # An MLA MoE checkpoint now parses with its MLA fields (tests/test_torch_mla.py),
  # and a llava checkpoint with its tower's (tests/test_torch_vision.py).
  mla = tconfig.config_from_hf({
    "model_type": "deepseek_v2", "vocab_size": 8, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 8, "kv_lora_rank": 4,
    "n_routed_experts": 4, "qk_nope_head_dim": 4, "qk_rope_head_dim": 2, "v_head_dim": 4,
  })
  assert (mla.is_mla, mla.n_experts, mla.kv_lora_rank, mla.qk_rope_head_dim, mla.v_head_dim, mla.cache_kv_heads) == (True, 4, 4, 2, 4, 1)
  llava = tconfig.config_from_hf({"model_type": "llava", "image_token_index": 32000, "text_config": {"model_type": "llama", "vocab_size": 8, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 8}, "vision_config": {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2, "image_size": 28, "patch_size": 14}})
  assert llava.vision is not None and llava.vision.n_run == 1 and llava.n_experts == 0


# ------------------------------------------------------------ solo forward


@pytest.mark.parametrize("family", FAMS)
def test_cacheless_logits_match_jax_and_hf(ckpts, models, family):
  _, hf_logits = ckpts[family]
  jc, tc, js, ts, jp, tp = models[family]
  pos = _pos(*TOKENS.shape)
  want, _ = jdec.shard_forward(jp, jc, js, jnp.asarray(TOKENS), jnp.asarray(pos), None)
  got, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(TOKENS), torch.from_numpy(pos), None)
  np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
  np.testing.assert_allclose(_np(got), hf_logits, **TOL)


@pytest.mark.parametrize("moe_path", ["einsum", "gather"], indirect=True)
@pytest.mark.parametrize("family", FAMS)
def test_cached_prefill_and_decode_match_jax(models, family, moe_path):
  """Prefill 7 tokens, then 12 greedy steps on the pinned MoE path: logits
  and ids equal the reference's (prefill T = 7, decode T = 1)."""
  jc, tc, js, ts, jp, tp = models[family]
  toks = TOKENS[:1, :7]
  jcache, tcache = jdec.init_kv_cache(jc, LAYERS, 1, 32), tdec.init_kv_cache(tc, LAYERS, 1, 32)
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(_pos(1, 7)), jcache)
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(_pos(1, 7)), tcache)
  np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([7], jnp.int32), 12)
  tt, _ = tdec.fused_decode(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([7], dtype=torch.int32), 12)
  np.testing.assert_array_equal(_np(tt), np.asarray(jt))
  assert tmoe.PATHS[f"{moe_path}@1"] == 12 * LAYERS and tmoe.PATHS[f"{moe_path}@7"] == LAYERS


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", FAMS)
def test_quantized_weights_match_jax(models, monkeypatch, family, mode):
  """Weight-quantized MoE (experts, attention, shared expert and head; the
  router and norms untouched): prefill logits and 10 greedy steps equal the
  reference's, the experts dequantized next to their product: the whole
  stacks on the einsum path (the prefill, T = 9), the routed slabs only on
  the gather path (the decode steps, T = 1)."""
  jc, tc, js, ts, jp, tp = models[family]
  jq, tq = jquant(jp, mode), tquant(tp, mode)
  assert tq["moe_layers"]["w_router"] is tp["moe_layers"]["w_router"] and "w_experts_down_scale" in tq["moe_layers"]
  monkeypatch.setenv("XOT_TPU_MOE_GATHER", "1")
  monkeypatch.setattr(tmoe, "REFERENCE_GATHER_MAX", 1)
  monkeypatch.setattr(jmoe, "MOE_GATHER_MAX", 1)
  toks = TOKENS[1:, :9]
  tmoe.reset_path_counts()
  jl, jcache = jdec.shard_forward(jq, jc, js, jnp.asarray(toks), jnp.asarray(_pos(1, 9)), jdec.init_kv_cache(jc, LAYERS, 1, 32))
  tl, tcache = tdec.shard_forward(tq, tc, ts, torch.from_numpy(toks), torch.from_numpy(_pos(1, 9)), tdec.init_kv_cache(tc, LAYERS, 1, 32))
  np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jq, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([9], jnp.int32), 10)
  tt, _ = tdec.fused_decode(tq, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([9], dtype=torch.int32), 10)
  np.testing.assert_array_equal(_np(tt), np.asarray(jt))
  assert dict(tmoe.PATHS) == {"einsum@9": LAYERS, "gather@1": 10 * LAYERS}


@pytest.mark.parametrize("family", FAMS)
def test_ring_split_inside_the_moe_stack_matches_jax(ckpts, models, family):
  """Shards [0] and [1-2] loaded from disk by both packages (the split
  falls inside the MoE stack): the head's hidden state and the tail's
  logits equal the reference's and the whole model's, over a prefill and
  one cached step."""
  path = ckpts[family][0]
  jc, tc, js, ts, jp, tp = models[family]
  full, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(TOKENS[:1]), torch.from_numpy(_pos(1, 11)), None)
  spans = [(0, 0), (1, LAYERS - 1)]
  h = {"jax": TOKENS[:1], "torch": torch.from_numpy(TOKENS[:1])}
  for a, b in spans:
    jsh, tsh = JShard("tiny", a, b, LAYERS), Shard("tiny", a, b, LAYERS)
    jps, tps = jloader.load_shard_weights(path, jc, jsh), tloader.load_shard_weights(path, tc, tsh)
    assert sorted(tps["moe_layers"]) == sorted(jps["moe_layers"]) and tps["moe_layers"]["wq"].shape[0] == b - a + 1
    jout, _ = jdec.shard_forward(jps, jc, jsh, jnp.asarray(h["jax"]), jnp.asarray(_pos(1, 11)), None)
    tout, _ = tdec.shard_forward(tps, tc, tsh, h["torch"], torch.from_numpy(_pos(1, 11)), None)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    h = {"jax": np.asarray(jout), "torch": tout}
  np.testing.assert_allclose(_np(h["torch"]), _np(full), **TOL)


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
  """The solo programs (captured on a card, eager through the same
  buffers here) equal the functions: a prefill bucket and 10 decode steps."""
  _, tc, _, ts, _, tp = models["qwen3-moe"]
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


@pytest.mark.parametrize("family", FAMS)
def test_solo_ngram_chunk_matches_jax(models, family):
  """The solo n-gram chunk (``fused_spec_batch_decode`` at B=1, 3 rounds at
  depth 4, proposals from the plain greedy stream): tokens, counts and
  positions equal the reference's; the stream accepts in full."""
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


def _pools(model, quant, bt, lens, seed=5):
  """Both packages' pools with each row's prompt of ``lens[i]`` tokens
  prefilled through ``bt``'s first three pages (K = 3 rows of 24 tokens in
  one forward: T = 72); (jpool, tpool, greedy first tokens [B, 1])."""
  jc, tc, js, ts, jp, tp = model
  n_pages = int(bt.max()) + 1
  jpool, tpool = jpaged.init_paged_pool(jc, LAYERS, n_pages, PS, quant=quant), paged.init_paged_pool(tc, LAYERS, n_pages, PS, quant=quant)
  B = bt.shape[0]
  toks = np.random.default_rng(seed).integers(0, 128, (B, 3 * PS)).astype(np.int32)
  z = np.zeros(B, np.int32)
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(toks), jpool, jnp.asarray(bt[:, :3]), jnp.asarray(z), jnp.asarray(lens), PS)
  tl, tpool = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(toks), tpool, torch.from_numpy(bt[:, :3]), torch.from_numpy(z), torch.from_numpy(lens), PS)
  np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
  return jpool, tpool, np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("moe_path", ["einsum", "gather"], indirect=True)
@pytest.mark.parametrize("family", FAMS)
def test_paged_decode_matches_jax(models, family, moe_path):
  """8 greedy paged steps for three rows (T = 3 per step): ids equal the
  reference's on the pinned MoE path."""
  jc, tc, js, ts, jp, tp = models[family]
  jpool, tpool, first = _pools(models[family], "", BT, LENS)
  args = (BT, LENS, np.ones(3, bool), np.zeros(3, np.float32))
  jt = jdec.fused_paged_batch_decode(jp, jc, js, jnp.asarray(first), jpool, *map(jnp.asarray, args), 8, page_size=PS)[0]
  tt = tdec.fused_paged_batch_decode(tp, tc, ts, torch.from_numpy(first), tpool, *map(torch.from_numpy, args), 8, page_size=PS)[0]
  np.testing.assert_array_equal(_np(tt), np.asarray(jt))
  assert tmoe.PATHS[f"{moe_path}@3"] == 8 * LAYERS


def test_mixed_tick_matches_jax(models):
  """Two decode rows and an admission's 13-token slice from offset 8: ids
  equal the reference's, and the final slice over the port's pool gives
  the reference's logits."""
  jc, tc, js, ts, jp, tp = models["qwen2-moe"]
  bt = np.array([[3, 7, 1, 9], [2, 11, 5, 10], [4, 6, 8, 14]], np.int32)
  lens = np.array([11, 6, 8], np.int32)
  jpool, tpool, first = _pools(models["qwen2-moe"], "", bt, lens, seed=7)
  rng = np.random.default_rng(8)
  pf = np.zeros((1, 16), np.int32)
  pf[0, :13] = rng.integers(0, 128, 13)
  pf_bt, pf_prefix, pf_end = bt[2:, :3], np.array([8], np.int32), np.array([21], np.int32)
  dec = (bt[:2], lens[:2], np.ones(2, bool), np.zeros(2, np.float32))
  jt = jdec.fused_mixed_paged_batch_decode(jp, jc, js, jnp.asarray(first[:2]), jpool, *map(jnp.asarray, dec), *map(jnp.asarray, (pf, pf_bt, pf_prefix, pf_end)), 5, page_size=PS)
  tt = tdec.fused_mixed_paged_batch_decode(tp, tc, ts, torch.from_numpy(first[:2]), tpool, *map(torch.from_numpy, dec), *map(torch.from_numpy, (pf, pf_bt, pf_prefix, pf_end)), 5, page_size=PS)
  np.testing.assert_array_equal(_np(tt[0]), np.asarray(jt[0]))
  last = np.zeros((1, 8), np.int32)
  last[0, :3] = rng.integers(0, 128, 3)
  bt_row, pre, end = bt[2:, :4], np.array([21], np.int32), np.array([24], np.int32)
  jl, _ = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(last), jt[3], jnp.asarray(bt_row), jnp.asarray(pre), jnp.asarray(end), PS)
  tl, _ = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(last), tt[3], torch.from_numpy(bt_row), torch.from_numpy(pre), torch.from_numpy(end), PS)
  np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_batched_verify_window_matches_jax(models, quant):
  """A batched spec chunk (4 rounds, depth cap 3: T = 12 per window) over
  the three rows, proposals from the plain greedy streams: tokens, counts
  and positions equal the reference's, and it accepts in full."""
  jc, tc, js, ts, jp, tp = models["qwen3-moe"]
  bt = np.zeros((3, 8), np.int32)
  bt[:, :6] = BT
  bt[:, 5:] = np.array([[16, 17, 18], [19, 20, 21], [22, 23, 24]])
  jpool, tpool, first = _pools(models["qwen3-moe"], quant, bt, LENS, seed=9)
  R, G = 4, 3
  rows = (bt, LENS, np.ones(3, bool), np.array([3, 2, 3], np.int32), np.zeros(3, np.float32))
  width = R * (G + 1) + G
  plain = jdec.fused_paged_batch_decode(jp, jc, js, jnp.asarray(first), jax.tree.map(jnp.copy, jpool), *map(jnp.asarray, (bt, LENS, np.ones(3, bool), np.zeros(3, np.float32))), width, page_size=PS)[0]
  kw = dict(props=np.array(plain), prop_counts=np.full(3, width, np.int32))
  j = jdec.fused_spec_paged_batch_decode(jp, jc, js, None, jc, js, jnp.asarray(first), jpool, None, *map(jnp.asarray, rows), R, G, page_size=PS, **{k: jnp.asarray(v) for k, v in kw.items()})
  t = tdec.fused_spec_paged_batch_decode(tp, tc, ts, None, None, None, torch.from_numpy(first), tpool, None, *map(torch.from_numpy, rows), R, G, page_size=PS, **{k: torch.from_numpy(v) for k, v in kw.items()})
  counts = np.asarray(j[1])
  np.testing.assert_array_equal(_np(t[1]), counts)
  np.testing.assert_array_equal(_np(t[4]), np.asarray(j[4]))
  for i in range(3):
    assert t[0][i, : counts[i]].tolist() == np.asarray(j[0])[i, : counts[i]].tolist()
  assert counts[0] == R * (G + 1)


def _spy(server, log):
  """Record every batched dispatch by kind, in order."""
  for name in ("spec_paged_batch_decode", "paged_batch_decode", "mixed_paged_batch_decode", "prefill_into_pages_many_sampled"):
    orig = getattr(server.ops, name)

    def spy(*args, _orig=orig, _name=name, **kw):
      log.append(_name)
      return _orig(*args, **kw)

    setattr(server.ops, name, spy)


@pytest.mark.parametrize("family", FAMS)
def test_batched_server_at_defaults_answers_like_jax(models, defaults, family):
  """Three greedy requests (repetitive prompts, so rows propose) through
  each package's batched server at the defaults (n-gram speculation, mixed
  ticks, QoS): the same tokens and the same dispatches, in order."""
  jc, tc, js, ts, jp, tp = models[family]
  prompts = [np.array([9, 9, 31, 9, 9, 31, 9, 9, 31, 9, 9, 31, 7], np.int32), np.array([40, 41, 42, 40, 41, 42, 40, 41], np.int32), np.arange(50, 80, dtype=np.int32)]

  def serve(server):
    log: list = []
    _spy(server, log)

    async def run():
      return await asyncio.gather(*(server.submit(f"r{i}", p, max_tokens=20, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None) for i, p in enumerate(prompts)))

    out = asyncio.run(run())
    server.shutdown()
    return [[int(x) for x in o] for o in out], log

  je = JaxShardedInferenceEngine(use_local_mesh=False)
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(device="cpu")
  te.load_test_model(ts, tc, tp)
  got, want = serve(BatchedServer(te, n_slots=2, chunk=4)), serve(JaxBatchedServer(je, n_slots=2, chunk=4))
  assert got == want
  assert "spec_paged_batch_decode" in got[1]


def test_engine_answers_like_jax(ckpts):
  """Both engines load the qwen3-moe checkpoint from disk: prefill logits
  within TOL, a greedy oneshot and chained chunks identical."""
  path = ckpts["qwen3-moe"][0]
  shard, jshard = Shard("tiny-moe", 0, LAYERS - 1, LAYERS), JShard("tiny-moe", 0, LAYERS - 1, LAYERS)

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


# ------------------------------------------------------------ ring budget


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("span", [(0, LAYERS - 1), (1, 2)])
def test_planner_counts_expert_bytes_as_the_reference(models, span, quant):
  jc, tc = models["qwen2-moe"][:2]
  got = tplanner.model_bytes(tc, Shard("m", *span, LAYERS), quant)
  assert got == jplanner.model_bytes(jc, JShard("m", *span, LAYERS), quant)
  dense = tplanner.model_bytes(dataclasses.replace(tc, n_experts=0), Shard("m", *span, LAYERS), quant)
  assert got > dense  # the expert stacks are counted


@pytest.mark.asyncio
async def test_moe_ring_too_small_answers_507(tiny_dir, monkeypatch, tmp_path):  # noqa: F811 — tiny_dir is the fixture
  """Two port nodes of 8000 MB each against Qwen3-30B-A3B's published
  shapes (about 61 GB of bf16 weights): the same problems as the
  reference's planner, and the API answers 507 before loading anything."""
  (tmp_path / "config.json").write_text(json.dumps(QWEN3_30B_A3B))
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tmp_path))
  nodes = await port_ring([TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu") for _ in range(2)], [8000, 8000])
  try:
    from xotorch_support_jetson_tpu_torch.topology.partitioning import map_partitions_to_shards

    problems = nodes[0]._ring_budget_problems(Shard("qwen-3-30b-a3b", 0, 0, 48))
    spans = [(s.start_layer, s.end_layer) for s in map_partitions_to_shards(nodes[0].partitioning_strategy.partition(nodes[0].topology), 48, "qwen-3-30b-a3b")]
    want = jplanner.ring_partition_fits(jconfig.config_from_hf(QWEN3_30B_A3B), [JShard("qwen-3-30b-a3b", a, b, 48) for a, b in spans], [8000 * 1024**2] * 2)
    assert len(problems) == 2 and problems == want
    api = ChatGPTAPI(nodes[0], "TorchShardedInferenceEngine", response_timeout=30, default_model="qwen-3-30b-a3b")
    port = find_available_port("127.0.0.1")
    server = await api.run(host="127.0.0.1", port=port)
    try:
      st, raw = await asyncio.to_thread(_http, port, "/v1/chat/completions", {"model": "qwen-3-30b-a3b", "messages": [{"role": "user", "content": "hi"}]})
    finally:
      server.close()
    assert st == 507 and json.loads(raw)["error"]["type"] == "insufficient_resources" and problems[0] in raw
    assert nodes[0].inference_engine.shard is None
  finally:
    await _stop(nodes)
