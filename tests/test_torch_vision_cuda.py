"""llava's vision path on the card: the CLIP tower and projector at
llava-1.5-7b's widths (ViT-L/14-336: 24 layers of which 23 run, 576
patches; projector 1024 → 4096) in bf16 against the same tower in f32,
and a small llava model's captured embeddings prefill (K1 in every layer)
and decode against the uncaptured functions.

Needs an NVIDIA GPU; every test here is marked ``cuda`` and skips without a
card. This file imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_vision_cuda.py``. Tolerances: the bf16 tower rounds every
product and residual to bf16 across 23 layers, against f32 throughout:
relative L2 of the features within 5e-2 (``chip_smoke.py``'s
``LLAVA_CHECK_TOL``); a bf16 model's captured and uncaptured logits within
5e-2 relative L2 and its greedy ids identical, as the other card tests
hold them.
"""

import dataclasses

import pytest
import torch

from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import decoder as tdec, vision
from xotorch_support_jetson_tpu_torch.models.config import tiny_test_config
from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa
from xotorch_support_jetson_tpu_torch.utils import programs

pytestmark = pytest.mark.cuda
TOL = 5e-2
CLIP_L_336 = vision.VisionConfig(hidden_size=1024, intermediate_size=4096, n_layers=24, n_heads=16, image_size=336, patch_size=14, projector_dim=4096)


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU")
  return torch.device("cuda")


def _rel(a, b):
  return float((a.float() - b.float()).norm() / b.float().norm())


def _f32(tree):
  return {k: _f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def test_tower_bf16_against_f32_at_llava_widths(dev):
  """Two images through the bf16 tower and projector against the same
  weights in f32: features [2, 576, 4096], relative L2 within TOL."""
  gen = torch.Generator().manual_seed(0)
  tower, proj = vision.init_vision_params(gen, CLIP_L_336, dtype=torch.bfloat16, device=dev)
  px = torch.randn((2, 3, 336, 336), generator=gen).to(dev)
  got = vision.encode_images(tower, proj, CLIP_L_336, px)
  tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # a true f32 reference
  try:
    want = vision.encode_images(_f32(tower), _f32(proj), CLIP_L_336, px)
  finally:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
  assert got.shape == (2, 576, 4096) and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
  assert _rel(got, want) < TOL


def test_embeddings_prefill_captured_against_eager(dev):
  """A small bf16 llava decoder: the captured embeddings prefill
  (``prefill_embeds``, one graph of the 128 bucket) launches K1 once per
  layer in a replay and equals the eager forward of the same merged
  embeddings; 8 greedy captured steps after it equal the eager steps."""
  cfg = tiny_test_config(n_layers=3, dim=256, n_heads=4, n_kv_heads=2, hidden_dim=512, vocab_size=512, max_seq_len=512, dtype=torch.bfloat16)
  vcfg = vision.VisionConfig(hidden_size=64, intermediate_size=128, n_layers=2, n_heads=4, image_size=56, patch_size=14, projector_dim=cfg.dim)
  cfg = dataclasses.replace(cfg, vision=vcfg, image_token_id=500)
  shard = Shard("tiny-llava", 0, 2, 3)
  gen = torch.Generator(device=dev).manual_seed(1)
  params = tdec.init_shard_params(cfg, shard, generator=gen, device=dev)
  tower, proj = vision.init_vision_params(torch.Generator().manual_seed(2), vcfg, dtype=torch.bfloat16, device=dev)
  S = 40
  ids = torch.randint(0, 256, (1, 128), generator=gen, device=dev, dtype=torch.int32)
  ids[0, 3 : 3 + vcfg.n_patches] = 500
  ids[0, S:] = 0
  feats = vision.encode_images(tower, proj, vcfg, torch.randn((1, 3, 56, 56), generator=gen, device=dev))
  merged = vision.merge_image_embeddings(params["embed"][ids].to(cfg.dtype), ids, feats, 500)

  cache_e = tdec.init_kv_cache(cfg, 3, 1, 512, device=dev)
  pos = torch.arange(128, dtype=torch.int32, device=dev)[None]
  want, _ = tdec.shard_forward(params, cfg, shard, merged, pos, cache_e, head_pos=torch.tensor([S - 1], device=dev))
  first = int(want[0, 0].argmax())
  want_ids, _ = tdec.fused_decode(params, cfg, shard, torch.tensor([[first]], dtype=torch.int32, device=dev), cache_e, torch.tensor([S], dtype=torch.int32, device=dev), 8)

  progs = tdec.SoloPrograms(params, cfg, shard, tdec.init_kv_cache(cfg, 3, 1, 512, device=dev))
  progs.prefill_embeds(merged, S)  # the capture
  fa.reset_launch_counts()
  programs.reset_replayed()
  got = progs.prefill_embeds(merged, S)  # a replay
  assert fa.LAUNCHES["flash_prefill"] == 0 and programs.REPLAYED.get("flash_prefill", 0) == 3
  assert _rel(got[0], want[0, 0]) < TOL and int(got[0].argmax()) == first
  got_ids, _ = tdec.fused_decode(params, cfg, shard, first, progs.cache, S, 8, programs=progs)
  assert got_ids.tolist() == want_ids.tolist()
