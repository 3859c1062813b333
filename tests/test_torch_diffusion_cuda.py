"""Stable diffusion on the card: a narrow UNet, CLIP text encoder and VAE
(SD's topology at a quarter of SD-2.1-base's widths: UNet 80 / 160 / 320 /
320 with 5 / 10 / 20 / 20 heads, CLIP 256 wide with 4 layers, VAE 32 / 64 /
128 / 128; 64 × 64 latents, 512 px) in bf16 against the same weights in
plain f32, and the engine's pipeline living on the card.

Needs an NVIDIA GPU; every test here is marked ``cuda`` and skips without a
card. This file imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_diffusion_cuda.py``. Tolerance: relative L2 within 5e-2
(``chip_smoke.py``'s ``DIFFUSION_CHECK_TOL``): bf16 rounds every product,
convolution and residual across the network against f32 throughout (TF32
off).
"""

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch.inference.diffusion_pipeline import DiffusionPipeline
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import diffusion as d, diffusion_loader as dl

pytestmark = pytest.mark.cuda
TOL = 5e-2
NARROW = d.DiffusionConfig(
  clip=d.ClipTextConfig(vocab_size=49408, hidden_size=256, intermediate_size=1024, n_layers=4, n_heads=4, max_positions=77),
  unet=d.UNetConfig(block_out_channels=(80, 160, 320, 320), cross_attention_dim=256, attn_heads=(5, 10, 20, 20), norm_groups=16),
  vae=d.VaeConfig(block_out_channels=(32, 64, 128, 128), norm_groups=16),
  sample_size=64, steps_offset=1,
)


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU")
  return torch.device("cuda")


def _rel(a, b):
  return float((a.float() - b.float()).norm() / b.float().norm())


def _f32(tree):
  if isinstance(tree, dict):
    return {k: _f32(v) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_f32(v) for v in tree]
  return tree.float()


@pytest.fixture
def narrow(dev):
  gen = torch.Generator(device=dev).manual_seed(0)
  return dl.init_diffusion_params(gen, NARROW, dtype=torch.bfloat16, device=dev), gen


def _plain_f32(fn):
  tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
  try:
    return fn()
  finally:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def test_components_bf16_against_f32(dev, narrow):
  """CLIP on a prompt pair, one UNet call (t = 500, the guidance batch of
  2) and both VAE halves, each on the same inputs."""
  params, gen = narrow
  f32 = _f32(params)
  tokens = torch.randint(0, 49408, (2, 77), generator=gen, device=dev)
  x = torch.randn((2, 4, 64, 64), generator=gen, device=dev)
  t = torch.full((2,), 500, dtype=torch.int32, device=dev)
  img = torch.rand((1, 3, 512, 512), generator=gen, device=dev) * 2 - 1
  z = torch.randn((1, 4, 64, 64), generator=gen, device=dev)
  with torch.no_grad():
    ctx = _plain_f32(lambda: d.clip_text_encode(f32["clip"], NARROW.clip, tokens))
    want = {
      "clip": ctx,
      "unet": _plain_f32(lambda: d.unet_apply(f32["unet"], NARROW.unet, x, t, ctx)),
      "vae_encode": _plain_f32(lambda: d.vae_encode(f32["vae"], NARROW.vae, img)),
      "vae_decode": _plain_f32(lambda: d.vae_decode(f32["vae"], NARROW.vae, z)),
    }
    got = {
      "clip": d.clip_text_encode(params["clip"], NARROW.clip, tokens),
      "unet": d.unet_apply(params["unet"], NARROW.unet, x.bfloat16(), t, ctx.bfloat16()),
      "vae_encode": d.vae_encode(params["vae"], NARROW.vae, img.bfloat16()),
      "vae_decode": d.vae_decode(params["vae"], NARROW.vae, z.bfloat16()),
    }
  for k in want:
    assert got[k].dtype == torch.bfloat16 and got[k].shape == want[k].shape, k
    assert torch.isfinite(got[k].float()).all(), k
    assert _rel(got[k], want[k]) <= TOL, (k, _rel(got[k], want[k]))
  assert want["unet"].shape == (2, 4, 64, 64) and want["vae_decode"].shape == (1, 3, 512, 512) and want["vae_encode"].shape == (1, 8, 64, 64)


def test_engine_pipeline_lives_on_the_card(dev, narrow, tmp_path):
  """A diffusers directory loads into a bf16 pipeline whose every tensor
  is on the card; a generation there is seeded (the same seed, the same
  pixels) and 512 px."""
  params, _ = narrow
  dl.export_diffusers_checkpoint(tmp_path, NARROW, params)
  engine = TorchShardedInferenceEngine(device=dev)
  try:
    engine._load_shard_sync(Shard("stable-diffusion-2-1-base", 0, 30, 31), tmp_path)
    pipe = engine.diffusion
    assert isinstance(pipe, DiffusionPipeline) and pipe.dtype == torch.bfloat16 and engine.params is None

    def leaves(tree):
      if isinstance(tree, dict):
        for v in tree.values():
          yield from leaves(v)
      elif isinstance(tree, list):
        for v in tree:
          yield from leaves(v)
      else:
        yield tree

    assert all(t.device.type == "cuda" and t.dtype == torch.bfloat16 for t in leaves(pipe.params))
    assert torch.equal(pipe.params["unet"]["conv_in_w"], params["unet"]["conv_in_w"])
    a = pipe.generate("a cube", steps=3, seed=5)
    assert a.shape == (512, 512, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, pipe.generate("a cube", steps=3, seed=5))
  finally:
    engine.executor.shutdown(wait=True)
