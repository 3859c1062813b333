"""llava in the port against the JAX package, on the CPU at f32: a tiny
llava-1.5 and a tiny llava-next (any-res, one 56×56 pinpoint) checkpoint,
each with its processor, built locally with ``transformers`` as
tests/test_vision.py builds them (a 2-layer llama decoder, a 3-layer CLIP
tower at 28×28 with 14×14 patches: 4 features an image, 5 tiles a
llava-next image).

Seeded numpy inputs go through both packages' ``models/vision.py``
functions (the tower, the merge, the any-res packing on a square and a
wide image, the pinpoint choice); both loaders read the same checkpoints
(``convert`` carries the JAX tree across); the cache-less logits of a
merged prompt agree with the JAX package's and HF's within rtol = atol =
2e-4. Both engines serve image requests (one and two images, llava-1.5 and
llava-next): prefill logits within that tolerance, greedy ids identical
(a blocking oneshot and streaming chunks), the recorded prompt ids too;
also a text-only request and a text-only batched request on the llava
model, int8 weights, an adapter, two partial shards against the whole
model, the placeholder-count error, the API's ``image_url`` remap, the
400 without Pillow, image requests kept off the batched server, and the
program ledger's ``vision.encode`` / ``prefill.embeds`` families."""

import asyncio
import base64
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import DirDownloader
from xotorch_support_jetson_tpu import registry as jregistry
from xotorch_support_jetson_tpu.api import chatgpt_api as japi
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.inference.state import InferenceState as JState
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec, loader as jloader, vision as jvision
from xotorch_support_jetson_tpu.models.quantize import quantize_params as jquant
from xotorch_support_jetson_tpu_torch import registry as tregistry
from xotorch_support_jetson_tpu_torch.api import chatgpt_api as tapi
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.engine import ImageInputError
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.state import InferenceState
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec, loader as tloader, vision as tvision
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params as tquant
from xotorch_support_jetson_tpu_torch.utils.programs import ledger

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
LAYERS = 2
KINDS = ("llava", "llava-next")
PROMPTS = {0: "describe the images please", 1: "describe <image> please", 2: "compare <image> and <image> please"}
# (width, height) of each image of a request: llava-next's are of other aspects.
SIZES = {1: [(28, 28)], 2: [(56, 28), (28, 56)]}
COLORS = [(200, 40, 40), (40, 40, 200)]
UNSET = ("XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM", "XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_SLO", "XOT_TPU_KV_QUANT", "XOT_TPU_PAGED_KERNEL", "XOT_TPU_QUANT", "XOT_TPU_SPEC_DECODE")


def make_tiny_llava(path, kind: str) -> int:
  """Write a tiny llava (``kind`` "llava") or llava-next checkpoint with its
  processor (a BPE tokenizer with an ``<image>`` token, a CLIP or any-res
  image processor at 28×28) to ``path``; returns the image token id."""
  from tokenizers import Tokenizer, models, pre_tokenizers, trainers
  from transformers import (
    CLIPImageProcessor, CLIPVisionConfig, LlamaConfig, LlavaConfig, LlavaForConditionalGeneration, LlavaNextConfig,
    LlavaNextForConditionalGeneration, LlavaNextImageProcessor, LlavaNextProcessor, LlavaProcessor, PreTrainedTokenizerFast,
  )

  torch.manual_seed(0)
  tm = Tokenizer(models.BPE(unk_token="<unk>"))
  tm.pre_tokenizer = pre_tokenizers.Whitespace()
  tm.train_from_iterator(["describe compare the images please and", "hello world how are you today"] * 30, trainers.BpeTrainer(vocab_size=110, special_tokens=["<unk>", "<s>", "</s>"]))
  tok = PreTrainedTokenizerFast(tokenizer_object=tm, unk_token="<unk>", bos_token="<s>", eos_token="</s>")
  tok.add_special_tokens({"additional_special_tokens": ["<image>"]})
  tok.chat_template = "{% for m in messages %}{{ m['content'] }} {% endfor %}"
  img_id = tok.convert_tokens_to_ids("<image>")
  vc = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4, image_size=28, patch_size=14)
  tc = LlamaConfig(vocab_size=128, hidden_size=48, intermediate_size=96, num_hidden_layers=LAYERS, num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False, eos_token_id=2, bos_token_id=1, torch_dtype="float32")
  common = dict(patch_size=14, vision_feature_select_strategy="default", image_token="<image>")
  if kind == "llava":
    model = LlavaForConditionalGeneration(LlavaConfig(vision_config=vc, text_config=tc, image_token_index=img_id))
    proc = LlavaProcessor(image_processor=CLIPImageProcessor(size={"shortest_edge": 28}, crop_size={"height": 28, "width": 28}), tokenizer=tok, num_additional_image_tokens=1, **common)
  else:
    model = LlavaNextForConditionalGeneration(LlavaNextConfig(vision_config=vc, text_config=tc, image_token_index=img_id, image_grid_pinpoints=[[56, 56]]))
    ip = LlavaNextImageProcessor(size={"shortest_edge": 28}, crop_size={"height": 28, "width": 28}, image_grid_pinpoints=[[56, 56]])
    proc = LlavaNextProcessor(image_processor=ip, tokenizer=tok, num_additional_image_tokens=1, **common)
  gen = torch.Generator().manual_seed(1)
  with torch.no_grad():
    for name, p in model.named_parameters():
      if "layer_norm" not in name and "layernorm" not in name and "norm.weight" not in name:
        p.copy_(torch.randn(p.shape, generator=gen) * 0.15)  # wide enough that the image features move the logits
  model.to(torch.float32).eval().save_pretrained(path, safe_serialization=True)
  proc.save_pretrained(path)
  return img_id


def _png_b64(color, size) -> str:
  from PIL import Image

  buf = io.BytesIO()
  Image.new("RGB", size, color).save(buf, format="PNG")
  return base64.b64encode(buf.getvalue()).decode()


def _images(n: int) -> list[str]:
  return [_png_b64(c, s) for c, s in zip(COLORS, SIZES[n])]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
  out = {}
  for kind in KINDS:
    path = tmp_path_factory.mktemp(kind.replace("-", "_"))
    out[kind] = (path, make_tiny_llava(path, kind))
  return out


@pytest.fixture(scope="module")
def models(ckpts):
  """kind → (jc, tc, js, ts, jp, tp): each package's config and params,
  loaded from the checkpoint by its own loader."""
  out = {}
  for kind, (path, _) in ckpts.items():
    jc, tc = jconfig.load_model_config(path, dtype=jnp.float32), tconfig.load_model_config(path, dtype=torch.float32)
    js, ts = JShard("tiny-llava", 0, LAYERS - 1, LAYERS), Shard("tiny-llava", 0, LAYERS - 1, LAYERS)
    out[kind] = (jc, tc, js, ts, jloader.load_shard_weights(path, jc, js), tloader.load_shard_weights(path, tc, ts))
  return out


def _processed(path, n: int):
  """The checkpoint processor's input_ids, pixel_values and image_sizes of
  an ``n``-image request (HF's own front end)."""
  from PIL import Image
  from transformers import AutoProcessor

  proc = AutoProcessor.from_pretrained(path)
  imgs = [Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB") for b in _images(n)]
  return proc(text=PROMPTS[n], images=imgs, return_tensors="np")


def _np(x):
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ the functions


def test_config_leaves_and_convert_match_jax(models):
  """Both loaders give the same config, tower, projector and decoder
  leaves; ``params_from_jax`` carries the JAX tree to the port's."""
  for kind, (jc, tc, js, ts, jp, tp) in models.items():
    assert tc.vision == tvision.VisionConfig(**jc.vision.__dict__)
    assert (tc.image_token_id, tc.dim, tc.vocab_size, tc.n_layers) == (jc.image_token_id, jc.dim, jc.vocab_size, jc.n_layers)
    assert tc.vision.anyres == (kind == "llava-next") and tc.vision.n_run == 2
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert set(map(str, flat_j)) == set(map(str, flat_t))
    conv = dict(jax.tree_util.tree_flatten_with_path(params_from_jax(jax.tree.map(np.asarray, jp), tc, ts))[0])
    for k, v in flat_j.items():
      np.testing.assert_array_equal(_np(flat_t[k]), np.asarray(v), err_msg=str(k))
      np.testing.assert_array_equal(_np(conv[k]), np.asarray(v), err_msg=str(k))
    assert ("image_newline" in tp["projector"]) == (kind == "llava-next")


def test_encode_images_matches_jax(models):
  """The tower and projector on seeded pixels (3 images), and the
  hidden-state feature layer's choice: -1 runs every layer."""
  jc, tc, _, _, jp, tp = models["llava"]
  px = np.random.default_rng(0).normal(size=(3, 3, 28, 28)).astype(np.float32)
  want = np.asarray(jvision.encode_images(jp["vision"], jp["projector"], jc.vision, jnp.asarray(px)))
  got = tvision.encode_images(tp["vision"], tp["projector"], tc.vision, torch.from_numpy(px))
  assert got.shape == (3, 4, tc.dim)
  np.testing.assert_allclose(_np(got), want, **TOL)
  last = jc.vision.__class__(**{**jc.vision.__dict__, "feature_layer": -1, "drop_cls": False})
  want = np.asarray(jvision.encode_images(jp["vision"], jp["projector"], last, jnp.asarray(px)))
  got = tvision.encode_images(tp["vision"], tp["projector"], tvision.VisionConfig(**last.__dict__), torch.from_numpy(px))
  assert got.shape == (3, 5, tc.dim)
  np.testing.assert_allclose(_np(got), want, **TOL)


def test_merge_image_embeddings_matches_jax():
  rng = np.random.default_rng(1)
  emb = rng.normal(size=(2, 12, 8)).astype(np.float32)
  toks = rng.integers(0, 5, size=(2, 12)).astype(np.int32)
  toks[0, 2:6] = 9
  toks[1, [0, 4, 5, 11]] = 9
  feats = rng.normal(size=(2, 4, 8)).astype(np.float32)
  want = np.asarray(jvision.merge_image_embeddings(jnp.asarray(emb), jnp.asarray(toks), jnp.asarray(feats), 9))
  got = tvision.merge_image_embeddings(torch.from_numpy(emb), torch.from_numpy(toks), torch.from_numpy(feats), 9)
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(got.numpy()[0, 2:6], feats[0])


@pytest.mark.parametrize("size", [(56, 56), (28, 56), (56, 28), (100, 37), (37, 100), (336, 672)])
def test_best_resolution_and_grid_match_jax(size):
  pins = ((336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008), (56, 56))
  assert tvision.select_best_resolution(size, pins) == jvision.select_best_resolution(size, pins)
  assert tvision.anyres_grid_shape(size, pins, 336) == jvision.anyres_grid_shape(size, pins, 336)


@pytest.mark.parametrize("size", [(56, 56), (28, 56), (56, 28)], ids=["square", "wide", "tall"])
def test_anyres_packing_matches_jax(models, size):
  """Seeded tile features packed for an image of (h, w) ``size``: the
  base tile, the unpadded grid and a newline per row, as the JAX package
  packs them."""
  jc, tc, _, _, jp, tp = models["llava-next"]
  tiles = np.random.default_rng(2).normal(size=(5, 4, tc.dim)).astype(np.float32)
  want = np.asarray(jvision.pack_anyres_features(jnp.asarray(tiles), size, jc.vision, jp["projector"]["image_newline"]))
  got = tvision.pack_anyres_features(torch.from_numpy(tiles), size, tc.vision, tp["projector"]["image_newline"])
  assert got.shape == want.shape
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,n", [("llava", 1), ("llava", 2), ("llava-next", 2)])
def test_cacheless_logits_match_jax_and_hf(ckpts, models, kind, n):
  """The processor's ids and pixels → tower, packing, merge, cache-less
  forward: logits within TOL of the JAX package's and of HF's
  ``Llava[Next]ForConditionalGeneration``."""
  from transformers import AutoModelForImageTextToText

  path, _ = ckpts[kind]
  jc, tc, js, ts, jp, tp = models[kind]
  out = _processed(path, n)
  ids, px = out["input_ids"].astype(np.int32), out["pixel_values"].astype(np.float32)
  sizes = out.get("image_sizes")
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(ts, tc, tp)
  feats = engine.image_features(px, sizes)
  tids = torch.from_numpy(ids)
  merged = tvision.merge_image_embeddings(engine.params["embed"][tids], tids, feats, tc.image_token_id)
  pos = torch.arange(ids.shape[1], dtype=torch.int32)[None]
  got, _ = tdec.shard_forward(engine.params, tc, ts, merged, pos, None)
  if sizes is None:
    jfeats = jvision.encode_images(jp["vision"], jp["projector"], jc.vision, jnp.asarray(px))
  else:
    packed = []
    for i in range(px.shape[0]):
      osize = (int(sizes[i][0]), int(sizes[i][1]))
      gh, gw = jvision.anyres_grid_shape(osize, jc.vision.grid_pinpoints, jc.vision.image_size)
      tf = jvision.encode_images(jp["vision"], jp["projector"], jc.vision, jnp.asarray(px[i, : 1 + gh * gw]))
      packed.append(jvision.pack_anyres_features(tf, osize, jc.vision, jp["projector"]["image_newline"]))
    jfeats = jnp.concatenate(packed, axis=0)[None]
  jmerged = jvision.merge_image_embeddings(jnp.take(jp["embed"], jnp.asarray(ids), axis=0), jnp.asarray(ids), jfeats, jc.image_token_id)
  want, _ = jdec.shard_forward(jp, jc, js, jmerged, jnp.asarray(_np(pos)), None)
  np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
  hf = AutoModelForImageTextToText.from_pretrained(path, torch_dtype=torch.float32).eval()
  with torch.no_grad():
    kw = {"image_sizes": torch.from_numpy(sizes)} if sizes is not None else {}
    ref = hf(input_ids=torch.from_numpy(ids).long(), pixel_values=torch.from_numpy(px), **kw).logits.numpy()
  np.testing.assert_allclose(_np(got), ref, **TOL)
  assert int((ids == tc.image_token_id).sum()) == feats.shape[0] * feats.shape[1]


# ------------------------------------------------------------ the engines


async def _image_request(engine, shard, rid, n, steps=8, state_cls=InferenceState):
  """Prefill (with ``n`` images; 0: a text prompt), then a greedy oneshot
  on one session and two chained chunks on another: (prefill logits,
  state's ids, prompt_len, oneshot ids, chunk ids)."""
  images = n > 0
  state = state_cls(extras={"images": _images(n)}) if images else state_cls()
  logits, state = await engine.infer_prompt(rid, shard, PROMPTS[n], state)
  first = int(np.argmax(logits[0]))
  one = await engine.generate_oneshot(rid, shard, first, steps, eos_ids=(), temp=0.0)
  engine.end_request(rid)
  state2 = state_cls(extras={"images": _images(n)}) if images else state_cls()
  await engine.infer_prompt(rid + "c", shard, PROMPTS[n], state2)
  chunks = await engine.read_chunk(await engine.dispatch_chunk(rid + "c", shard, steps // 2, 0.0, 35, first_token=first))
  chunks += await engine.read_chunk(await engine.dispatch_chunk(rid + "c", shard, steps // 2, 0.0, 35))
  engine.end_request(rid + "c")
  return np.asarray(logits), np.asarray(state.tokens), state.prompt_len, [int(t) for t in one], [int(t) for t in chunks]


@pytest.fixture(scope="module")
def jax_answers(ckpts):
  """The JAX engine's answers, each computed once: (kind, images) → what
  ``_image_request`` returns; images 0 is the text-only request."""
  out = {}

  async def run():
    for kind, (path, _) in ckpts.items():
      engine = JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False)
      shard = JShard(f"tiny-{kind}", 0, LAYERS - 1, LAYERS)
      for n in (0, 1, 2) if kind == "llava" else (2,):
        out[(kind, n)] = await _image_request(engine, shard, f"{kind}-{n}", n, state_cls=JState)

  asyncio.run(run())
  return out


@pytest.mark.parametrize("kind,n", [("llava", 1), ("llava", 2), ("llava-next", 2), ("llava", 0)], ids=["llava-1-image", "llava-2-images", "llava-next-2-images", "llava-text-only"])
def test_engine_requests_match_jax(ckpts, jax_answers, kind, n):
  """Each engine loads the checkpoint and its processor from disk and
  serves the request: prefill logits within TOL, the recorded prompt ids,
  the greedy oneshot and the chained chunks identical; the image session
  took the embeddings prefill, the text one the token prefill."""
  path, img_id = ckpts[kind]
  engine = TorchShardedInferenceEngine(DirDownloader(path), device="cpu")
  shard = Shard(f"tiny-{kind}", 0, LAYERS - 1, LAYERS)
  before = ledger.snapshot()["families"].get("prefill.embeds", {}).get("dispatches", 0)
  got = asyncio.run(_image_request(engine, shard, "r", n))
  want = jax_answers[(kind, n)]
  np.testing.assert_allclose(got[0], want[0], **TOL)
  np.testing.assert_array_equal(got[1], want[1])
  assert got[2:] == want[2:] and got[3] == got[4]
  after = ledger.snapshot()["families"].get("prefill.embeds", {}).get("dispatches", 0)
  assert after - before == (2 if n else 0)
  assert (img_id in got[1][0]) == (n > 0)
  assert engine._vision_params is not None and "vision" not in engine.params  # the tower rides apart from the decoder


def test_image_requests_build_nothing_the_second_time(ckpts):
  """``vision.encode`` and ``prefill.embeds`` are ledger families of their
  own; a repeated request at the same shapes builds nothing."""
  path, _ = ckpts["llava"]
  engine = TorchShardedInferenceEngine(DirDownloader(path), device="cpu")
  shard = Shard("tiny-llava", 0, LAYERS - 1, LAYERS)

  async def one(rid):
    logits, _ = await engine.infer_prompt(rid, shard, PROMPTS[1], InferenceState(extras={"images": _images(1)}))
    engine.end_request(rid)
    return logits

  first = asyncio.run(one("a"))
  fam0 = ledger.snapshot()["families"]
  again = asyncio.run(one("b"))
  fam1 = ledger.snapshot()["families"]
  for f in ("vision.encode", "prefill.embeds"):
    assert fam1[f]["dispatches"] == fam0[f]["dispatches"] + 1 and fam1[f]["compiles"] == fam0[f]["compiles"] >= 1
  np.testing.assert_array_equal(first, again)


def test_text_only_batched_request_on_llava_matches_jax(models, monkeypatch):
  """A text request to a llava model through each package's batched server
  at the defaults: the same tokens (the tower stays out of the pool)."""
  for k in UNSET:
    monkeypatch.delenv(k, raising=False)
  jc, tc, js, ts, jp, tp = models["llava"]
  prompt = np.array([1, 9, 31, 9, 40, 31, 9, 9, 31, 7, 12, 5], np.int32)

  def serve(server):
    out = asyncio.run(server.submit("r", prompt, max_tokens=12, temp=0.0, top_k=35, eos_ids=(), emit=lambda *a: None))
    server.shutdown()
    return [int(x) for x in out]

  je = JaxShardedInferenceEngine(use_local_mesh=False)
  je.load_test_model(js, jc, jp)
  te = TorchShardedInferenceEngine(device="cpu")
  te.load_test_model(ts, tc, tp)
  assert serve(BatchedServer(te, n_slots=2, chunk=4)) == serve(JBatchedServer(je, n_slots=2, chunk=4))


def _load(engine, shard, cfg, params, path):
  from transformers import AutoProcessor

  engine.load_test_model(shard, cfg, params, tokenizer=AutoProcessor.from_pretrained(path))
  proc = engine.tokenizer
  proc.encode, proc.decode, proc.eos_token_id = proc.tokenizer.encode, proc.tokenizer.decode, proc.tokenizer.eos_token_id


@pytest.mark.parametrize("variant", ["int8", "adapter"])
def test_int8_weights_and_adapter_image_requests_match_jax(ckpts, models, variant):
  """An image request on int8 weights (the tower stays full precision in
  both packages), and one through a multi-LoRA adapter (the reference
  serves it: the embeddings prefill applies the session's slot): prefill
  logits within TOL, the greedy oneshot identical."""
  path, _ = ckpts["llava"]
  jc, tc, js, ts, jp, tp = models["llava"]
  je, te = JaxShardedInferenceEngine(use_local_mesh=False), TorchShardedInferenceEngine(device="cpu")
  if variant == "int8":
    jp, tp = jquant(jp, "int8"), tquant(tp, "int8")
    assert tp["vision"] is models["llava"][5]["vision"]
  _load(je, js, jc, jp, path)
  _load(te, ts, tc, tp, path)
  if variant == "adapter":
    rng = np.random.default_rng(3)
    ad = {"layers": {t: (rng.normal(0, 0.3, (LAYERS, tc.dim, 2)).astype(np.float32), rng.normal(0, 0.3, (2, tc.q_dim if t == "wq" else tc.kv_dim)).astype(np.float32)[None].repeat(LAYERS, 0)) for t in ("wq", "wv")}}
    for e in (je, te):
      e.enable_multi_lora(capacity=2, rank=2).register("a1", ad)
      e.set_request_adapter("r", "a1")

  async def run(engine, shard, state_cls):
    logits, _ = await engine.infer_prompt("r", shard, PROMPTS[1], state_cls(extras={"images": _images(1)}))
    one = await engine.generate_oneshot("r", shard, int(np.argmax(logits[0])), 8, eos_ids=(), temp=0.0)
    engine.end_request("r")
    return np.asarray(logits), [int(t) for t in one]

  want = asyncio.run(run(je, js, JState))
  got = asyncio.run(run(te, ts, InferenceState))
  np.testing.assert_allclose(got[0], want[0], **TOL)
  assert got[1] == want[1]


def test_two_partial_shards_match_the_whole_model(ckpts):
  """A ring of two port engines (layers 0 / 1): the head runs the tower
  and the embeddings prefill and hands on its hidden state; the tail's
  logits and 4 greedy steps equal the whole model's, and the JAX ring's."""
  path, _ = ckpts["llava"]

  async def ring(engines, shards, state_cls):
    state = state_cls(extras={"images": _images(1)})
    h, state = await engines[0].infer_prompt("r", shards[0], PROMPTS[1], state)
    assert "images" not in state.extras  # the images stay with the head
    logits, state = await engines[1].infer_tensor("r", shards[1], h, state)
    outs = [np.asarray(logits)]
    for _ in range(4):
      x = np.asarray([[int(np.argmax(outs[-1][0]))]], np.int32)
      h, state = await engines[0].infer_tensor("r", shards[0], x, state)
      logits, state = await engines[1].infer_tensor("r", shards[1], h, state)
      outs.append(np.asarray(logits))
    return outs, state

  tshards = [Shard("tiny-llava", 0, 0, LAYERS), Shard("tiny-llava", 1, 1, LAYERS)]
  jshards = [JShard("tiny-llava", 0, 0, LAYERS), JShard("tiny-llava", 1, 1, LAYERS)]
  got, state = asyncio.run(ring([TorchShardedInferenceEngine(DirDownloader(path), device="cpu") for _ in tshards], tshards, InferenceState))
  want, _ = asyncio.run(ring([JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False) for _ in jshards], jshards, JState))
  whole = TorchShardedInferenceEngine(DirDownloader(path), device="cpu")
  full = Shard("tiny-llava", 0, LAYERS - 1, LAYERS)

  async def solo():
    logits, _ = await whole.infer_prompt("w", full, PROMPTS[1], InferenceState(extras={"images": _images(1)}))
    outs = [np.asarray(logits)]
    for _ in range(4):
      logits, _ = await whole.infer_tensor("w", full, np.asarray([[int(np.argmax(outs[-1][0]))]], np.int32), None)
      outs.append(np.asarray(logits))
    return outs

  ref = asyncio.run(solo())
  for i, (g, w, r) in enumerate(zip(got, want, ref)):
    np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {i} vs the JAX ring")
    np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {i} vs the whole model")
    assert int(np.argmax(g[0])) == int(np.argmax(r[0]))
  assert state.prompt_len == state.tokens.shape[1] - 4


# ------------------------------------------------------------ refusals, API


@pytest.mark.parametrize("prompt,n", [(PROMPTS[2], 1), (PROMPTS[1], 2), ("describe this please", 1)], ids=["more", "fewer", "none"])
def test_placeholder_count_error(ckpts, prompt, n):
  """``<image>`` placeholders that do not match the images one for one: the
  reference merges what it gets (the processor of this transformers
  version checks nothing), the port refuses with a 400 before any session
  exists, through the front end and through the device half alike."""
  path, _ = ckpts["llava"]
  engine = TorchShardedInferenceEngine(DirDownloader(path), device="cpu")
  shard = Shard("tiny-llava", 0, LAYERS - 1, LAYERS)
  word = "more" if prompt.count("<image>") > n else "fewer"
  with pytest.raises(ImageInputError, match=f"{word} <image> placeholders than attached images") as err:
    asyncio.run(engine.infer_prompt("r", shard, prompt, InferenceState(extras={"images": _images(1) if n == 1 else _images(2)})))
  assert tapi.ChatGPTAPI._error_response(None, err.value).status == 400 and not engine.sessions
  out = _processed(path, 1)
  ids = np.concatenate([out["input_ids"], out["input_ids"][:, 1:3]], axis=1)  # two placeholders too many
  with pytest.raises(ImageInputError, match="more <image> placeholders"):
    asyncio.run(engine.infer_image_tokens("d", shard, ids, out["pixel_values"]))
  assert not engine.sessions


def test_missing_pillow_answers_400(ckpts, monkeypatch):
  """Without Pillow an image request is refused with a 400 naming it; it
  is never served without its image. Text requests still serve."""
  path, _ = ckpts["llava"]
  engine = TorchShardedInferenceEngine(DirDownloader(path), device="cpu")
  shard = Shard("tiny-llava", 0, LAYERS - 1, LAYERS)
  images = _images(1)
  monkeypatch.setitem(sys.modules, "PIL", None)
  with pytest.raises(ImageInputError, match="Pillow") as err:
    asyncio.run(engine.infer_prompt("r", shard, PROMPTS[1], InferenceState(extras={"images": images})))
  resp = tapi.ChatGPTAPI._error_response(None, err.value)
  assert resp.status == 400 and "Pillow" in resp.body["error"]["message"] and resp.body["error"]["code"] == "invalid_image"
  assert "r" not in engine.sessions
  logits, _ = asyncio.run(engine.infer_prompt("t", shard, "hello world"))
  assert np.isfinite(logits).all()


@pytest.mark.parametrize("vision", [True, False])
def test_image_url_remap_matches_jax(vision):
  msgs = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": [
      {"type": "text", "text": "compare"}, {"type": "image_url", "image_url": {"url": "data:image/png;base64,QUJD"}},
      {"type": "text", "text": "and"}, {"type": "image_url", "image_url": {"url": "https://example.invalid/x.png"}},
      {"type": "image_url", "image_url": {"url": "data:image/jpeg;base64,REVG"}}, "junk",
    ]},
  ]
  want_m, want_i = japi.remap_messages([japi.parse_message(m) for m in msgs], vision=vision)
  got_m, got_i = tapi.remap_messages(tapi.parse_chat_request({"messages": msgs}, "m").messages, vision=vision)
  assert got_i == want_i == (["QUJD", "REVG"] if vision else [])
  assert [m.to_dict() for m in got_m] == [{"role": m.role, "content": m.content} for m in want_m]


def test_image_requests_stay_off_the_batched_server(monkeypatch):
  """With ``XOT_TPU_BATCHED=1`` a request carrying images takes the solo
  path (the tower), a text request the batched server, as the reference
  routes them; the API hands the payloads to the node in the state."""
  from xotorch_support_jetson_tpu_torch.orchestration.node import Node

  monkeypatch.setenv("XOT_TPU_BATCHED", "1")
  routes = []

  class Engine:
    def supports_batched(self):
      return True

    async def infer_prompt(self, request_id, shard, prompt, state):
      routes.append(("solo", state.extras.get("images") if state else None))
      raise ImageInputError("stop here")

  node = Node.__new__(Node)
  node.inference_engine, node.request_options, node.outstanding_requests = Engine(), {}, {}

  async def batched(*a, **k):
    routes.append(("batched", None))

  monkeypatch.setattr(node, "_batched_serve", batched, raising=False)
  monkeypatch.setattr(node, "check_ring_budget", lambda s: None, raising=False)
  monkeypatch.setattr(node, "get_current_shard", lambda s: s, raising=False)
  monkeypatch.setattr(node, "_adopt_options", lambda *a: None, raising=False)
  monkeypatch.setattr(node, "_finish_request", lambda rid: None, raising=False)
  shard = Shard("tiny-llava", 0, LAYERS - 1, LAYERS)
  asyncio.run(node._process_prompt(shard, "text", "t", None, False))
  with pytest.raises(ImageInputError):
    asyncio.run(node._process_prompt(shard, "<image>", "i", InferenceState(extras={"images": ["QUJD"]}), False))
  assert routes == [("batched", None), ("solo", ["QUJD"])]


def test_registry_llava_cards_equal_the_reference():
  for model_id in ("llava-1.5-7b-hf", "llava-1.6-vicuna-7b", "llava-1.6-mistral-7b"):
    t, j = tregistry.model_cards[model_id], jregistry.model_cards[model_id]
    assert (t.layers, t.pretty, t.family) == (j.layers, j.pretty, j.family) == (32, j.pretty, "llava")
    assert tregistry.get_repo(model_id, tregistry.TORCH_ENGINE) == next(iter(j.repo.values()))
