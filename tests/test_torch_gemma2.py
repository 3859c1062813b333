"""gemma2 in the port against the JAX package, on one tiny gemma2 HF
checkpoint built locally with ``transformers`` (eager attention) as
tests/test_hf_golden.py builds it: 3 layers (0 and 2 slide, 1 is global),
head_dim 16, ``query_pre_attn_scalar`` 24 (not the head dim), softcaps 50 /
30, ``sliding_window`` 4 (shorter than the prompts), tied embeddings, f32
throughout; its weights are redrawn from a seed so that the zero-centred
norm gains, the score softcap and the final softcap all matter.

Both packages load the checkpoint from disk. Logits agree within rtol =
atol = 2e-4 (the HF golden tolerance) and greedy ids are identical on every
path the port serves: the cache-less forward (also against HF), a cached
prefill and decode (bf16-layout, int8 and int4 KV), int8 and int4 weights
(K4's plain version), paged decode, a mixed tick and the batched n-gram
verify window on the gather route (prompts crossing the window and a page
boundary), solo n-gram and int8 self-draft speculation, the logprobs
scorer, and the engine and the batched server on one request each. The
paged kernel gate stays shut for gemma2 even when forced."""

import asyncio
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import DirDownloader
from xotorch_support_jetson_tpu import registry as jregistry
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec, loader as jloader
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquant
from xotorch_support_jetson_tpu.ops import paged as jpaged
from xotorch_support_jetson_tpu_torch import registry as tregistry
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec, loader as tloader
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquant
from xotorch_support_jetson_tpu_torch.ops import paged

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
PS = 8  # page size: the prompts below cross a page boundary
WINDOW = 4
LAYERS = 3
PROMPT = "hello world how are you today the quick brown fox "
TOKENS = np.array([[5, 17, 92, 3, 44, 61, 8, 120, 33, 7, 99], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]], np.int32)
UNSET = ("XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM", "XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_SLO", "XOT_TPU_KV_QUANT", "XOT_TPU_PAGED_KERNEL", "XOT_TPU_QUANT")


def make_tiny_gemma2(path: Path) -> np.ndarray:
  """Write the tiny gemma2 checkpoint (with a BPE tokenizer) to ``path``;
  returns HF's own logits on ``TOKENS``."""
  from tokenizers import Tokenizer, models, pre_tokenizers, trainers
  from transformers import AutoConfig, AutoModelForCausalLM, PreTrainedTokenizerFast

  torch.manual_seed(0)
  cfg = AutoConfig.for_model(
    "gemma2", vocab_size=128, hidden_size=64, intermediate_size=160, num_hidden_layers=LAYERS, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, query_pre_attn_scalar=24.0, attn_logit_softcapping=50.0, final_logit_softcapping=30.0, sliding_window=WINDOW,
    rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=True, torch_dtype="float32", attn_implementation="eager",
    eos_token_id=2, bos_token_id=1, pad_token_id=0,
  )
  model = AutoModelForCausalLM.from_config(cfg, attn_implementation="eager").to(torch.float32).eval()
  gen = torch.Generator().manual_seed(1)
  with torch.no_grad():
    for name, p in model.named_parameters():
      # Norm gains zero-centred but not zero; q/k wide enough that the 50
      # softcap bends the scores; the tied table wide enough that the 30
      # softcap bends the logits.
      std = 0.3 if "norm" in name else 0.6 if ("q_proj" in name or "k_proj" in name) else 2.0 if "embed" in name else 0.2
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
def ckpt(tmp_path_factory):
  path = tmp_path_factory.mktemp("tiny_gemma2")
  return path, make_tiny_gemma2(path)


@pytest.fixture(scope="module")
def model(ckpt):
  """(jc, tc, js, ts, jp, tp): both packages' config and params, each
  loaded from the checkpoint by its own loader."""
  path, _ = ckpt
  jc, tc = jconfig.load_model_config(path, dtype=jnp.float32), tconfig.load_model_config(path, dtype=torch.float32)
  js, ts = JShard("tiny", 0, LAYERS - 1, LAYERS), Shard("tiny", 0, LAYERS - 1, LAYERS)
  return jc, tc, js, ts, jloader.load_shard_weights(path, jc, js), tloader.load_shard_weights(path, tc, ts)


@pytest.fixture
def defaults(monkeypatch):
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  monkeypatch.setenv("XOT_TPU_PAGE_SIZE", str(PS))
  return monkeypatch


def _pos(B, S, start=0):
  return np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (B, S)).copy()


# ------------------------------------------------------------ config, weights


def test_config_fields_match_jax(model):
  jc, tc = model[0], model[1]
  for f in ("family", "post_norms", "mlp_act", "attn_logit_softcap", "final_logit_softcap", "query_pre_attn_scalar", "sliding_window", "embed_scale", "tied_embedding", "head_dim", "max_seq_len", "eos_token_ids"):
    assert getattr(tc, f) == getattr(jc, f), f
  assert tc.family == "gemma2" and tc.post_norms and tc.sliding_window == WINDOW and tc.query_pre_attn_scalar == 24.0
  assert tc.plain_attention is False and jc.plain_attention is False
  assert [tc.layer_is_sliding(i) for i in range(4)] == [jc.layer_is_sliding(i) for i in range(4)] == [True, False, True, False]


def test_loaded_leaves_match_jax(model):
  """Every leaf equal; the zero-centred norm gains loaded as 1 + w in f32,
  ``is_sliding`` f32 from the global layer indices; converting the JAX
  tree gives the same tensors."""
  jc, tc, js, ts, jp, tp = model
  assert sorted(tp["layers"]) == sorted(jp["layers"]) and sorted(tp) == sorted(jp)
  for key, val in jp["layers"].items():
    np.testing.assert_array_equal(tp["layers"][key].numpy(), np.asarray(val), err_msg=key)
  for key in ("embed", "final_norm"):
    np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]), err_msg=key)
  for key in ("attn_norm", "post_attn_norm", "mlp_norm", "post_mlp_norm"):
    assert tp["layers"][key].dtype == torch.float32
    assert abs(float(tp["layers"][key].mean()) - 1.0) < 0.1  # 1 + w, w ~ N(0, 0.3²)
  assert tp["layers"]["is_sliding"].tolist() == [1.0, 0.0, 1.0]
  converted = params_from_jax(jax.tree.map(np.asarray, jp), dataclasses.replace(tc, dtype=torch.bfloat16), ts)
  assert converted["layers"]["post_mlp_norm"].dtype == torch.float32 and converted["final_norm"].dtype == torch.float32
  assert converted["layers"]["is_sliding"].dtype == torch.float32 and converted["layers"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("start", [0, 1])
def test_partial_shard_keeps_global_sliding_flags(ckpt, start):
  """A shard from layer ``start`` carries the flags of its global layer
  indices, in both loaders and in ``init_shard_params``."""
  path, _ = ckpt
  jc, tc = jconfig.load_model_config(path, dtype=jnp.float32), tconfig.load_model_config(path, dtype=torch.float32)
  js, ts = JShard("tiny", start, LAYERS - 1, LAYERS), Shard("tiny", start, LAYERS - 1, LAYERS)
  want = np.asarray(jloader.load_shard_weights(path, jc, js)["layers"]["is_sliding"])
  assert tloader.load_shard_weights(path, tc, ts)["layers"]["is_sliding"].numpy().tolist() == want.tolist()
  assert tdec.init_shard_params(tc, ts)["layers"]["is_sliding"].numpy().tolist() == want.tolist() == [1.0, 0.0, 1.0][start:]


def test_registry_gemma2_cards_equal_the_reference():
  for model_id in ("gemma2-9b", "gemma2-27b"):
    t, j = tregistry.model_cards[model_id], jregistry.model_cards[model_id]
    assert (t.layers, t.pretty, t.family) == (j.layers, j.pretty, j.family)
    assert tregistry.get_repo(model_id, tregistry.TORCH_ENGINE) == next(iter(j.repo.values()))


@pytest.mark.parametrize("forced", [None, "1"])
def test_paged_kernel_gate_stays_shut(model, monkeypatch, forced):
  tc = model[1]
  if forced is None:
    monkeypatch.delenv("XOT_TPU_PAGED_KERNEL", raising=False)
  else:
    monkeypatch.setenv("XOT_TPU_PAGED_KERNEL", forced)
  assert paged.paged_kernel_supported(tc) is False
  paged.check_paged_kernel(tc, "cuda")  # the gather route needs no K3 variant: no refusal


# ------------------------------------------------------------ solo forward


def test_cacheless_logits_match_jax_and_hf(ckpt, model):
  _, hf_logits = ckpt
  jc, tc, js, ts, jp, tp = model
  pos = _pos(*TOKENS.shape)
  want, _ = jdec.shard_forward(jp, jc, js, jnp.asarray(TOKENS), jnp.asarray(pos), None)
  got, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(TOKENS), torch.from_numpy(pos), None)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  np.testing.assert_allclose(got.numpy(), hf_logits, **TOL)
  # The window masks: without it the logits past position WINDOW differ.
  wide, _ = tdec.shard_forward(tp, dataclasses.replace(tc, sliding_window=1 << 20), ts, torch.from_numpy(TOKENS), torch.from_numpy(pos), None)
  assert not np.allclose(wide[:, WINDOW + 1 :].numpy(), got[:, WINDOW + 1 :].numpy(), **TOL)
  np.testing.assert_allclose(wide[:, :WINDOW].numpy(), got[:, :WINDOW].numpy(), **TOL)


@pytest.mark.parametrize("kv", ["", "int8", "int4"])
def test_cached_prefill_and_decode_match_jax(model, kv):
  """Prefill 7 tokens, then greedy decode 12 steps (past the window and
  the prompt): logits and ids equal the reference's; in the bf16-layout
  cache the decode logits equal the cache-less forward's."""
  jc, tc, js, ts, jp, tp = model
  toks = TOKENS[:1, :7]
  jcache, tcache = jdec.init_kv_cache(jc, LAYERS, 1, 32, quant=kv), tdec.init_kv_cache(tc, LAYERS, 1, 32, quant=kv)
  jl, jcache = jdec.shard_forward(jp, jc, js, jnp.asarray(toks), jnp.asarray(_pos(1, 7)), jcache)
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(_pos(1, 7)), tcache)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([7], jnp.int32), 12)
  tt, _ = tdec.fused_decode(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([7], dtype=torch.int32), 12)
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
  if not kv:
    seq = np.concatenate([toks, [[first]], tt.numpy()[:, :-1]], axis=1)
    full, _ = tdec.shard_forward(tp, tc, ts, torch.from_numpy(seq), torch.from_numpy(_pos(1, seq.shape[1])), None)
    assert (full[0, 7:].argmax(-1).numpy() == tt.numpy()[0]).all()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_weights_match_jax(model, mode):
  """Weight-quantized gemma2 (the tied head's quantized copy included;
  norms and flags untouched): prefill logits and 10 greedy steps equal the
  reference's (int4 through K4's plain version on the CPU)."""
  jc, tc, js, ts, jp, tp = model
  jq, tq = jquant(jp, mode), tquant(tp, mode)
  assert "lm_head_scale" in tq and tq["layers"]["is_sliding"] is tp["layers"]["is_sliding"] and tq["layers"]["post_attn_norm"].dtype == torch.float32
  toks = TOKENS[1:, :9]
  jl, jcache = jdec.shard_forward(jq, jc, js, jnp.asarray(toks), jnp.asarray(_pos(1, 9)), jdec.init_kv_cache(jc, LAYERS, 1, 32))
  tl, tcache = tdec.shard_forward(tq, tc, ts, torch.from_numpy(toks), torch.from_numpy(_pos(1, 9)), tdec.init_kv_cache(tc, LAYERS, 1, 32))
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  first = int(np.argmax(np.asarray(jl)[0, -1]))
  jt, _ = jdec.fused_decode(jq, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, jnp.asarray([9], jnp.int32), 10)
  tt, _ = tdec.fused_decode(tq, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tcache, torch.tensor([9], dtype=torch.int32), 10)
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_programs_equal_eager(model):
  """The solo programs (captured on a card, eager through the same
  buffers here) equal the functions: a prefill bucket and 10 decode steps."""
  _, tc, _, ts, _, tp = model
  cache = tdec.init_kv_cache(tc, LAYERS, 1, 32)
  progs = tdec.SoloPrograms(tp, tc, ts, cache)
  x = np.zeros((1, 16), np.int32)
  x[0, :9] = TOKENS[1, :9]
  logits = progs.prefill(x, 9)
  want, ecache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(x), torch.from_numpy(_pos(1, 16)), tdec.init_kv_cache(tc, LAYERS, 1, 32))
  np.testing.assert_allclose(logits.numpy(), want[:, 8].numpy(), **TOL)
  first = int(logits[0].argmax())
  got = tdec.fused_decode(tp, tc, ts, first, cache, 9, 10, programs=progs)[0]
  eager = tdec.fused_decode(tp, tc, ts, torch.full((1, 1), first, dtype=torch.int32), ecache, torch.tensor([9], dtype=torch.int32), 10)[0]
  np.testing.assert_array_equal(got.numpy(), eager.numpy())


def test_score_last_tokens_matches_jax(model):
  jc, tc, js, ts, jp, tp = model
  toks = np.zeros((1, 16), np.int32)
  toks[0, :11] = TOKENS[0]
  want = [np.asarray(x) for x in jdec.score_last_tokens(jp, jc, js, jnp.asarray(toks), jnp.int32(11), 6, 4)]
  got = [x.numpy() for x in tdec.score_last_tokens(tp, tc, ts, torch.from_numpy(toks), 11, 6, 4)]
  np.testing.assert_allclose(got[0], want[0], **TOL)
  np.testing.assert_array_equal(got[1], want[1])
  np.testing.assert_allclose(got[2], want[2], **TOL)


# ------------------------------------------------------------ speculation


def _prefilled(pkg, model, params, prompt, max_seq=64):
  jc, tc, js, ts = model[:4]
  S = prompt.shape[1]
  if pkg == "jax":
    cache = jdec.init_kv_cache(jc, LAYERS, 1, max_seq)
    logits, cache = jdec.shard_forward(params, jc, js, jnp.asarray(prompt), jnp.asarray(_pos(1, S)), cache)
    return cache, int(np.argmax(np.asarray(logits)[0, -1]))
  cache = tdec.init_kv_cache(tc, LAYERS, 1, max_seq)
  logits, cache = tdec.shard_forward(params, tc, ts, torch.from_numpy(prompt), torch.from_numpy(_pos(1, S)), cache)
  return cache, int(logits[0, -1].argmax())


@pytest.mark.parametrize("gamma", [2, 4])
def test_int8_self_draft_matches_jax(model, gamma):
  jc, tc, js, ts, jp, tp = model
  prompt = TOKENS[:1, :9]
  jpd, tpd = jquant(jp, "int8"), tquant(tp, "int8")
  jct, first = _prefilled("jax", model, jp, prompt)
  jcd, _ = _prefilled("jax", model, jpd, prompt)
  tct, tfirst = _prefilled("torch", model, tp, prompt)
  tcd, _ = _prefilled("torch", model, tpd, prompt)
  assert first == tfirst
  jbuf, jn, jr, _, _ = jdec.fused_speculative_generate(jp, jc, js, jpd, jc, js, jnp.full((1, 1), first, jnp.int32), jct, jcd, jnp.int32(9), 24, gamma=gamma)
  tbuf, tn, tr, _, _ = tdec.fused_speculative_generate(tp, tc, ts, tpd, tc, ts, torch.full((1, 1), first, dtype=torch.int32), tct, tcd, 9, 24, gamma=gamma)
  assert (tbuf[:tn].tolist(), tn, tr) == (np.asarray(jbuf)[: int(jn)].tolist(), int(jn), int(jr))


@pytest.mark.parametrize("with_props", [True, False], ids=["props", "no-props"])
def test_solo_ngram_chunk_matches_jax(model, with_props):
  """The solo n-gram chunk (``fused_spec_batch_decode`` at B=1, 3 rounds at
  depth 4): tokens, counts and positions equal the reference's."""
  jc, tc, js, ts, jp, tp = model
  prompt = TOKENS[1:, :9]
  jcache, first = _prefilled("jax", model, jp, prompt)
  tcache, _ = _prefilled("torch", model, tp, prompt)
  R, G = 3, 4
  kw = {}
  if with_props:
    plain, _ = jdec.fused_decode(jp, jc, js, jnp.full((1, 1), first, jnp.int32), jax.tree.map(jnp.copy, jcache), jnp.asarray([9], jnp.int32), R * (G + 1) + G)
    kw = dict(props=np.array(plain)[:, 1:], prop_counts=np.array([R * (G + 1) + G - 1], np.int32))
  j = jdec.fused_spec_batch_decode(
    jp, jc, js, None, jc, js, jnp.full((1, 1), first, jnp.int32), jcache, None, jnp.full((1,), 9, jnp.int32), jnp.ones((1,), bool), jnp.full((1,), G, jnp.int32),
    jnp.zeros((1,), jnp.float32), R, G, **{k: jnp.asarray(v) for k, v in kw.items()},
  )
  t = tdec.fused_spec_batch_decode(
    tp, tc, ts, None, None, None, torch.full((1, 1), first, dtype=torch.int32), tcache, None, torch.full((1,), 9, dtype=torch.int32), torch.ones((1,), dtype=torch.bool),
    torch.full((1,), G, dtype=torch.int32), torch.zeros((1,)), R, G, **{k: torch.from_numpy(v) for k, v in kw.items()},
  )
  n = int(np.asarray(j[1])[0])
  assert int(t[1][0]) == n and t[0][0, :n].tolist() == np.asarray(j[0])[0, :n].tolist()
  assert int(t[4][0]) == int(np.asarray(j[4])[0]) and int(t[3][0, 0]) == int(np.asarray(j[3])[0, 0])
  if with_props:
    assert n == R * (G + 1)  # the plain stream accepts in full


# ------------------------------------------------------------ paged serving


def _pools(model, quant, bt, lens, seed=5):
  """Both packages' pools with each row's prompt of ``lens[i]`` tokens
  prefilled through ``bt``'s first three pages; (jpool, tpool, greedy first
  tokens [B, 1], torch logits)."""
  jc, tc, js, ts, jp, tp = model
  n_pages = int(bt.max()) + 1
  jpool, tpool = jpaged.init_paged_pool(jc, LAYERS, n_pages, PS, quant=quant), paged.init_paged_pool(tc, LAYERS, n_pages, PS, quant=quant)
  B = bt.shape[0]
  toks = np.random.default_rng(seed).integers(0, 128, (B, 3 * PS)).astype(np.int32)
  z = np.zeros(B, np.int32)
  jl, jpool = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(toks), jpool, jnp.asarray(bt[:, :3]), jnp.asarray(z), jnp.asarray(lens), PS)
  tl, tpool = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(toks), tpool, torch.from_numpy(bt[:, :3]), torch.from_numpy(z), torch.from_numpy(lens), PS)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  return jpool, tpool, np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]


BT = np.array([[3, 7, 1, 9, 12, 0], [2, 11, 5, 10, 13, 0], [4, 6, 8, 14, 15, 0]], np.int32)
LENS = np.array([11, 6, 19], np.int32)  # past the window; rows 0 and 2 past a page


@pytest.mark.parametrize("use_kernel", [None, True], ids=["resolved", "forced"])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_paged_decode_matches_jax(model, quant, use_kernel):
  """8 greedy paged steps for three rows: ids equal the reference's; a
  forced ``use_kernel=True`` still attends on the gather route."""
  jc, tc, js, ts, jp, tp = model
  jpool, tpool, first = _pools(model, quant, BT, LENS)
  args = (BT, LENS, np.ones(3, bool), np.zeros(3, np.float32))
  jt = jdec.fused_paged_batch_decode(jp, jc, js, jnp.asarray(first), jpool, *map(jnp.asarray, args), 8, page_size=PS)[0]
  before = paged.LAUNCHES["paged_decode"]
  tt = tdec.fused_paged_batch_decode(tp, tc, ts, torch.from_numpy(first), tpool, *map(torch.from_numpy, args), 8, page_size=PS, use_kernel=use_kernel)[0]
  assert paged.LAUNCHES["paged_decode"] == before
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_mixed_tick_matches_jax(model):
  """Two decode rows and an admission's 13-token slice from offset 8 (the
  slice crosses the window and a page): ids equal the reference's, and the
  final slice over the port's pool gives the reference's logits."""
  jc, tc, js, ts, jp, tp = model
  bt = np.array([[3, 7, 1, 9], [2, 11, 5, 10], [4, 6, 8, 14]], np.int32)
  lens = np.array([11, 6, 8], np.int32)
  jpool, tpool, first = _pools(model, "", bt, lens, seed=7)
  rng = np.random.default_rng(8)
  pf = np.zeros((1, 16), np.int32)
  pf[0, :13] = rng.integers(0, 128, 13)
  pf_bt, pf_prefix, pf_end = bt[2:, :3], np.array([8], np.int32), np.array([21], np.int32)
  dec = (bt[:2], lens[:2], np.ones(2, bool), np.zeros(2, np.float32))
  jt = jdec.fused_mixed_paged_batch_decode(jp, jc, js, jnp.asarray(first[:2]), jpool, *map(jnp.asarray, dec), *map(jnp.asarray, (pf, pf_bt, pf_prefix, pf_end)), 5, page_size=PS)
  tt = tdec.fused_mixed_paged_batch_decode(tp, tc, ts, torch.from_numpy(first[:2]), tpool, *map(torch.from_numpy, dec), *map(torch.from_numpy, (pf, pf_bt, pf_prefix, pf_end)), 5, page_size=PS)
  np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
  last = np.zeros((1, 8), np.int32)
  last[0, :3] = rng.integers(0, 128, 3)
  bt_row, pre, end = bt[2:, :4], np.array([21], np.int32), np.array([24], np.int32)
  jl, _ = jdec.prefill_into_pages_many(jp, jc, js, jnp.asarray(last), jt[3], jnp.asarray(bt_row), jnp.asarray(pre), jnp.asarray(end), PS)
  tl, _ = tdec.prefill_into_pages_many(tp, tc, ts, torch.from_numpy(last), tt[3], torch.from_numpy(bt_row), torch.from_numpy(pre), torch.from_numpy(end), PS)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("with_props", [True, False], ids=["props", "no-props"])
@pytest.mark.parametrize("quant", ["", "int8"])
def test_batched_verify_window_matches_jax(model, quant, with_props):
  """A batched spec chunk (4 rounds, depth cap 3) over the three rows,
  proposals from the plain greedy streams or none: tokens, counts and
  positions equal the reference's; with proposals it accepts in full."""
  jc, tc, js, ts, jp, tp = model
  bt = np.zeros((3, 8), np.int32)
  bt[:, :6] = BT
  bt[:, 5:] = np.array([[16, 17, 18], [19, 20, 21], [22, 23, 24]])
  jpool, tpool, first = _pools(model, quant, bt, LENS, seed=9)
  R, G = 4, 3
  rows = (bt, LENS, np.ones(3, bool), np.array([3, 2, 3], np.int32), np.zeros(3, np.float32))
  kw = {}
  if with_props:
    width = R * (G + 1) + G
    plain = jdec.fused_paged_batch_decode(jp, jc, js, jnp.asarray(first), jax.tree.map(jnp.copy, jpool), *map(jnp.asarray, (bt, LENS, np.ones(3, bool), np.zeros(3, np.float32))), width, page_size=PS)[0]
    kw = dict(props=np.array(plain), prop_counts=np.full(3, width, np.int32))
  j = jdec.fused_spec_paged_batch_decode(jp, jc, js, None, jc, js, jnp.asarray(first), jpool, None, *map(jnp.asarray, rows), R, G, page_size=PS, **{k: jnp.asarray(v) for k, v in kw.items()})
  t = tdec.fused_spec_paged_batch_decode(tp, tc, ts, None, None, None, torch.from_numpy(first), tpool, None, *map(torch.from_numpy, rows), R, G, page_size=PS, **{k: torch.from_numpy(v) for k, v in kw.items()})
  counts = np.asarray(j[1])
  np.testing.assert_array_equal(t[1].numpy(), counts)
  np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]))
  for i in range(3):
    assert t[0][i, : counts[i]].tolist() == np.asarray(j[0])[i, : counts[i]].tolist()
  if with_props:
    assert counts[0] == R * (G + 1)


# ------------------------------------------------------------ engine, server


def test_engine_answers_like_jax(ckpt):
  """Both engines load the checkpoint from disk: prefill logits within TOL,
  a greedy oneshot and chained chunks identical."""
  path, _ = ckpt
  shard = Shard("tiny-gemma2", 0, LAYERS - 1, LAYERS)
  jshard = JShard("tiny-gemma2", 0, LAYERS - 1, LAYERS)

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


def test_batched_server_answers_like_jax(model, defaults):
  """One greedy request through each package's batched server at the
  defaults (n-gram speculation, mixed ticks, QoS): the same tokens."""
  jc, tc, js, ts, jp, tp = model
  prompt = np.array([9, 9, 31, 9, 9, 31, 9, 9, 31, 9, 9, 31, 7], np.int32)

  def serve(server):
    out = asyncio.run(server.submit("r", prompt, max_tokens=24, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None))
    server.shutdown()
    return [int(x) for x in out]

  je = JaxShardedInferenceEngine(use_local_mesh=False)
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(device="cpu")
  te.load_test_model(ts, tc, tp)
  jserver, tserver = JaxBatchedServer(je, n_slots=2, chunk=4), BatchedServer(te, n_slots=2, chunk=4)
  assert serve(tserver) == serve(jserver)
  assert tserver.decode_path == jserver.decode_path == "gather"  # resolved with the pool
