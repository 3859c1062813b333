"""Stable diffusion in the port against the JAX package, on the CPU at f32,
on ``tiny_diffusion_config()`` (a 2-layer CLIP at width 32, a 2-level UNet
16 / 32, a 2-level VAE 8 / 16, 16 px images).

The reference's weights are drawn with numpy from a seed onto the
``jax.eval_shape`` skeleton of its own init (unit-scale fan-in weights,
norm gains and biases away from 1 and 0 so they count) and carried across
by ``diffusion_params_from_jax``; every JAX function is jitted once per
module with its config bound. Components (CLIP with gelu and quick_gelu,
the UNet, both VAE halves, the DDIM and Euler steps under epsilon and
v-prediction, the schedule, ``sample_chunk``) agree within rtol = atol =
2e-4; whole generations (text-to-image, img2img from an image the grid
shrinks and one it grows, two Euler candidates at an off-grid size) give
images within one uint8 level of the JAX pipeline's in every pixel and
the same progress sequence, the JAX draws injected through the pipeline's
``_normal``. Also cancellation, the SD1-style geometry, the download
patterns, both loaders on each other's exports, and the config files of
the three registry cards' shapes.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.download import hf_utils as jhf
from xotorch_support_jetson_tpu.inference.diffusion_pipeline import DiffusionPipeline as JPipeline
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import diffusion as jd, diffusion_loader as jdl
from xotorch_support_jetson_tpu_torch.download import downloader as tdown, hf_utils as thf
from xotorch_support_jetson_tpu_torch.inference.diffusion_pipeline import DiffusionPipeline, GenerationCancelled
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import diffusion as td, diffusion_loader as tdl
from xotorch_support_jetson_tpu_torch.models.convert import diffusion_params_from_jax

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
JCFG = jd.tiny_diffusion_config()
TCFG = td.tiny_diffusion_config()
STEPS = 4
CHUNK = 2  # every chunk of every generation here is 2 steps: one scan per latent shape


def _reference_tree(cfg, seed: int):
  """numpy leaves on the reference init's skeleton: fan-in normal weights,
  embeddings at the reference's scales, gains 1 + 0.1·N and biases 0.1·N."""
  skeleton = jax.eval_shape(lambda k: jdl.init_diffusion_params(k, cfg), jax.random.PRNGKey(0))
  rng = np.random.default_rng(seed)

  def leaf(path, sd):
    names = [getattr(k, "key", None) for k in path]
    name, shape = names[-1], sd.shape
    vector = len(shape) == 1 or (len(shape) == 2 and "layers" in names)
    if name in ("tok_emb", "pos_emb"):
      z = rng.standard_normal(shape) * (0.02 if name == "tok_emb" else 0.01)
    elif vector:
      z = rng.standard_normal(shape) * 0.1 + (1.0 if name.endswith("_s") else 0.0)
    else:
      fan_in = int(np.prod(shape[:3])) if len(shape) == 4 else shape[-2]
      z = rng.standard_normal(shape) / np.sqrt(fan_in)
    return z.astype(np.float32)

  return jax.tree_util.tree_map_with_path(leaf, skeleton)


@pytest.fixture(scope="module")
def ref():
  """(numpy reference tree, port tree, the jitted JAX functions)."""
  tree = _reference_tree(JCFG, seed=0)
  jit = {
    "clip": jax.jit(functools.partial(jd.clip_text_encode, cfg=JCFG.clip)),
    "clip_quick": jax.jit(functools.partial(jd.clip_text_encode, cfg=dataclasses.replace(JCFG.clip, act="quick_gelu"))),
    "unet": jax.jit(functools.partial(jd.unet_apply, cfg=JCFG.unet)),
    "vae_encode": jax.jit(functools.partial(jd.vae_encode, cfg=JCFG.vae)),
    "vae_decode": jax.jit(functools.partial(jd.vae_decode, cfg=JCFG.vae)),
  }
  return tree, diffusion_params_from_jax(tree, TCFG), jit


@pytest.fixture(scope="module")
def pipes(ref):
  """The JAX pipeline and the port's, on the same weights, in f32."""
  tree, tparams, _ = ref
  return JPipeline(JCFG, tree, dtype=jnp.float32, progress_chunk=CHUNK), DiffusionPipeline(TCFG, tparams, dtype=torch.float32, progress_chunk=CHUNK)


def _nchw(x) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
  return x.permute(0, 2, 3, 1).numpy()


class _JaxDraws:
  """The reference pipeline's draws, in its order (a split, then a normal
  of the subkey), each of the port's NCHW shape drawn NHWC and moved."""

  def __init__(self, seed: int) -> None:
    self.rng = jax.random.PRNGKey(seed)

  def __call__(self, _gen, shape) -> torch.Tensor:
    self.rng, sub = jax.random.split(self.rng)
    n, c, h, w = shape
    return _nchw(jax.random.normal(sub, (n, h, w, c), jnp.float32))


# ------------------------------------------------------------- components


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_encode_matches_jax(ref, act):
  tree, tparams, jit = ref
  tokens = np.random.default_rng(1).integers(0, JCFG.clip.vocab_size, (2, JCFG.clip.max_positions)).astype(np.int32)
  want = np.asarray(jit["clip" if act == "gelu" else "clip_quick"](tree["clip"], tokens=jnp.asarray(tokens)))
  got = td.clip_text_encode(tparams["clip"], dataclasses.replace(TCFG.clip, act=act), torch.from_numpy(tokens).long())
  np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unet_apply_matches_jax(ref):
  tree, tparams, jit = ref
  rng = np.random.default_rng(2)
  x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
  t = np.asarray([10, 500], np.int32)
  ctx = rng.standard_normal((2, 7, JCFG.unet.cross_attention_dim)).astype(np.float32)
  want = np.asarray(jit["unet"](tree["unet"], latents=jnp.asarray(x), t=jnp.asarray(t), ctx=jnp.asarray(ctx)))
  got = td.unet_apply(tparams["unet"], TCFG.unet, _nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
  np.testing.assert_allclose(_nhwc(got), want, **TOL)


def test_vae_encode_decode_and_sample_match_jax(ref):
  """The encoder (with its asymmetric pad before each stride-2 conv) on a
  16 × 24 image, the latent sample on the same noise, the decoder."""
  tree, tparams, jit = ref
  rng = np.random.default_rng(3)
  img = rng.uniform(-1, 1, (1, 16, 24, 3)).astype(np.float32)
  moments = np.asarray(jit["vae_encode"](tree["vae"], images=jnp.asarray(img)))
  got = td.vae_encode(tparams["vae"], TCFG.vae, _nchw(img))
  np.testing.assert_allclose(_nhwc(got), moments, **TOL)
  key = jax.random.PRNGKey(4)
  z = np.asarray(jd.vae_sample_latents(jnp.asarray(moments), key, JCFG.vae.scaling_factor))
  noise = _nchw(jax.random.normal(key, (1, 8, 12, 4), jnp.float32))
  np.testing.assert_allclose(_nhwc(td.vae_sample_latents(_nchw(moments), noise, TCFG.vae.scaling_factor)), z, **TOL)
  want = np.asarray(jit["vae_decode"](tree["vae"], latents=jnp.asarray(z)))
  np.testing.assert_allclose(_nhwc(td.vae_decode(tparams["vae"], TCFG.vae, _nchw(z))), want, **TOL)


@pytest.mark.parametrize("method", ["ddim", "euler"])
@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_scheduler_steps_match_jax(method, prediction):
  rng = np.random.default_rng(5)
  x, out = (rng.standard_normal((2, 3, 3, 4)).astype(np.float32) for _ in range(2))
  a_t, a_prev = np.float32(0.5), np.float32(0.8)
  jstep, tstep = (jd.ddim_step, td.ddim_step) if method == "ddim" else (jd.euler_step, td.euler_step)
  want = np.asarray(jstep(jnp.asarray(x), jnp.asarray(out), jnp.asarray(a_t), jnp.asarray(a_prev), prediction))
  got = tstep(torch.from_numpy(x), torch.from_numpy(out), torch.tensor(a_t), torch.tensor(a_prev), prediction)
  np.testing.assert_allclose(got.numpy(), want, **TOL)
  a0 = np.asarray(jd.add_noise(jnp.asarray(x), jnp.asarray(out), jnp.asarray(a_t)))
  np.testing.assert_allclose(td.add_noise(torch.from_numpy(x), torch.from_numpy(out), a_t).numpy(), a0, **TOL)


@pytest.mark.parametrize("offset", [0, 1])
def test_alphas_and_timesteps_match_jax(offset):
  jcfg, tcfg = dataclasses.replace(JCFG, steps_offset=offset), dataclasses.replace(TCFG, steps_offset=offset)
  np.testing.assert_allclose(td.alphas_cumprod(tcfg).numpy(), np.asarray(jd.alphas_cumprod(jcfg)), rtol=1e-6, atol=1e-7)
  for steps in (1, 7, 10, 50):
    np.testing.assert_array_equal(td.ddim_timesteps(tcfg, steps).numpy(), np.asarray(jd.ddim_timesteps(jcfg, steps)))
  assert int(td.ddim_timesteps(tcfg, 10)[-1]) == offset


@pytest.mark.parametrize("method,shape", [("ddim", (1, 8, 8, 4)), ("euler", (2, 10, 8, 4))])
def test_sample_chunk_matches_jax(ref, pipes, method, shape):
  """One chunk (2 steps, guidance 4.5) through the JAX pipeline's jitted
  scan and the port's loop."""
  _, tparams, _ = ref
  jpipe, tpipe = pipes
  rng = np.random.default_rng(6)
  x = rng.standard_normal(shape).astype(np.float32)
  ctx = rng.standard_normal((2 * shape[0], JCFG.clip.max_positions, JCFG.clip.hidden_size)).astype(np.float32)
  ts, a_ts, a_prevs = (v[:CHUNK] for v in tpipe._schedule(10))
  want = np.asarray(jpipe._chunk_fn(method)(
    jpipe.params["unet"], latents=jnp.asarray(x), ctx_pair=jnp.asarray(ctx), ts=jnp.asarray(ts),
    a_ts=jnp.asarray(a_ts), a_prevs=jnp.asarray(a_prevs), guidance=jnp.asarray(4.5, jnp.float32),
  ))
  got = td.sample_chunk(tparams["unet"], TCFG, _nchw(x), torch.from_numpy(ctx), ts, torch.from_numpy(a_ts), torch.from_numpy(a_prevs), 4.5, method)
  np.testing.assert_allclose(_nhwc(got), want, **TOL)


# ---------------------------------------------------------------- generate


def _image(h: int, w: int) -> np.ndarray:
  return np.random.default_rng(h * 100 + w).integers(0, 256, (h, w, 3)).astype(np.uint8)


GENERATIONS = {
  "txt2img": dict(prompt="a red cube", seed=1),
  "img2img_shrink": dict(prompt="bluer", seed=2, init_image=(17, 17), strength=0.5),  # 17 px snaps to 16
  "img2img_grow": dict(prompt="bluer", seed=3, init_image=(15, 15), strength=0.5),  # 15 px snaps to 16
  "n2_euler_offgrid": dict(prompt="two cubes", seed=4, n=2, size=(18, 14), method="euler"),  # 20 × 16 px
}


@pytest.mark.parametrize("case", list(GENERATIONS))
def test_generate_matches_jax(pipes, case):
  jpipe, tpipe = pipes
  kw = dict(GENERATIONS[case])
  if "init_image" in kw:
    kw["init_image"] = _image(*kw["init_image"])
  jprog, tprog = [], []
  want = jpipe.generate(steps=STEPS, guidance=4.0, progress_cb=lambda d, t: jprog.append((d, t)), **kw)
  tpipe._normal = _JaxDraws(kw["seed"])
  try:
    got = tpipe.generate(steps=STEPS, guidance=4.0, progress_cb=lambda d, t: tprog.append((d, t)), **kw)
  finally:
    del tpipe._normal
  assert got.dtype == np.uint8 and got.shape == want.shape
  assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
  assert 0 < want.mean() < 255 and want.std() > 1  # an image, not a saturated field
  assert tprog == jprog


def test_generate_is_seeded_and_prompt_sensitive(pipes):
  """The port's own draws: the same seed gives the same pixels, another
  prompt other pixels."""
  _, tpipe = pipes
  a = tpipe.generate("a red cube", steps=STEPS, seed=7)
  np.testing.assert_array_equal(a, tpipe.generate("a red cube", steps=STEPS, seed=7))
  assert not np.array_equal(a, tpipe.generate("a blue sphere", steps=STEPS, seed=7))


def test_cancellation(pipes):
  """``should_cancel`` is polled between chunks: after the first chunk it
  aborts the denoise (tests/test_diffusion.py's case)."""
  _, tpipe = pipes
  seen = []
  with pytest.raises(GenerationCancelled):
    tpipe.generate("cube", steps=8, seed=1, progress_cb=lambda d, t: seen.append(d), should_cancel=lambda: len(seen) >= 2)
  assert seen == [0, CHUNK]


def test_sd1_style_geometry_matches_jax(ref):
  """The SD1 axes (per-level head counts over attention_head_dim,
  quick_gelu, v-prediction): the UNet against the JAX package's at the
  head counts, and a whole generation (tests/test_diffusion.py's case)."""
  tree, tparams, _ = ref
  jcfg = dataclasses.replace(JCFG, clip=dataclasses.replace(JCFG.clip, act="quick_gelu"), unet=dataclasses.replace(JCFG.unet, attn_heads=(2, 2), attention_head_dim=999), prediction_type="v_prediction")
  tcfg = dataclasses.replace(TCFG, clip=dataclasses.replace(TCFG.clip, act="quick_gelu"), unet=dataclasses.replace(TCFG.unet, attn_heads=(2, 2), attention_head_dim=999), prediction_type="v_prediction")
  assert tcfg.unet.heads_at(0) == tcfg.unet.heads_at(1) == 2
  rng = np.random.default_rng(8)
  x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
  ctx = rng.standard_normal((1, 5, 32)).astype(np.float32)
  want = np.asarray(jax.jit(functools.partial(jd.unet_apply, cfg=jcfg.unet))(tree["unet"], latents=jnp.asarray(x), t=jnp.asarray([3]), ctx=jnp.asarray(ctx)))
  got = td.unet_apply(tparams["unet"], tcfg.unet, _nchw(x), torch.tensor([3]), torch.from_numpy(ctx))
  np.testing.assert_allclose(_nhwc(got), want, **TOL)
  img = DiffusionPipeline(tcfg, tparams, dtype=torch.float32).generate("a cube", steps=STEPS, seed=2)
  assert img.shape == (16, 16, 3) and img.dtype == np.uint8


def test_init_matches_the_reference_tree(ref):
  """The port's seeded init draws the reference's tree: the same leaves
  at the same (port-layout) shapes, gains 1, biases 0."""
  _, tparams, _ = ref
  got = tdl.init_diffusion_params(torch.Generator().manual_seed(0), TCFG)
  flat_want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tparams)[0]}
  flat_got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
  assert flat_got.keys() == flat_want.keys()
  for k, v in flat_got.items():
    assert v.shape == flat_want[k].shape, k
  assert torch.equal(got["unet"]["norm_out_s"], torch.ones(16)) and not got["unet"]["conv_out_b"].any()
  assert DiffusionPipeline(TCFG, got, dtype=torch.float32).generate("x", steps=2).shape == (16, 16, 3)


# ------------------------------------------------------------- checkpoints


def _assert_trees_equal(got, want, where=""):
  if isinstance(want, dict):
    assert set(got) == set(want), where
    for k in want:
      _assert_trees_equal(got[k], want[k], f"{where}/{k}")
  elif isinstance(want, (list, tuple)):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
      _assert_trees_equal(g, w, f"{where}/{i}")
  else:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=where)


def test_jax_export_loads_in_the_port(ref, tmp_path):
  """A checkpoint the JAX package exports loads in the port equal to
  ``diffusion_params_from_jax`` of the same tree, with the same config."""
  tree, tparams, _ = ref
  jdl.export_diffusers_checkpoint(tmp_path, JCFG, tree)
  cfg = tdl.diffusion_config_from_dir(tmp_path)
  assert dataclasses.asdict(cfg) == dataclasses.asdict(jdl.diffusion_config_from_dir(tmp_path))
  _assert_trees_equal(tdl.load_diffusion_params(tmp_path, cfg), tparams)


def test_port_export_loads_in_jax(ref, tmp_path):
  """A checkpoint the port exports loads in the JAX package equal to the
  tree the port's was carried from."""
  tree, tparams, _ = ref
  tdl.export_diffusers_checkpoint(tmp_path, TCFG, tparams)
  cfg = jdl.diffusion_config_from_dir(tmp_path)
  assert [cfg.unet.heads_at(i) for i in range(2)] == [JCFG.unet.heads_at(i) for i in range(2)]
  _assert_trees_equal(jdl.load_diffusion_params(tmp_path, cfg), tree)


CONFIGS = {
  # stable-diffusion-v1-5: CLIP ViT-L (quick_gelu), a scalar head count, scheduler offset 1
  "sd1": ({"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12, "num_attention_heads": 12, "hidden_act": "quick_gelu", "max_position_embeddings": 77, "vocab_size": 49408},
          {"attention_head_dim": 8, "block_out_channels": [320, 640, 1280, 1280], "cross_attention_dim": 768, "sample_size": 64,
           "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"]},
          {"scaling_factor": 0.18215, "block_out_channels": [128, 256, 512, 512]},
          {"prediction_type": "epsilon", "steps_offset": 1, "set_alpha_to_one": False, "beta_schedule": "scaled_linear"}),
  # stable-diffusion-2-1-base: OpenCLIP-H, per-level head counts
  "sd2": ({"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 23, "num_attention_heads": 16, "hidden_act": "gelu"},
          {"attention_head_dim": [5, 10, 20, 20], "cross_attention_dim": 1024, "sample_size": 64},
          {"latent_channels": 4},
          {"steps_offset": 1}),
  # stable-diffusion-2-1 (768 px): v-prediction, 96 × 96 latents, num_attention_heads given
  "vpred": ({"hidden_size": 1024, "num_hidden_layers": 23, "hidden_act": "gelu"},
            {"num_attention_heads": [5, 10, 20, 20], "attention_head_dim": 64, "sample_size": 96, "norm_num_groups": 32},
            {},
            {"prediction_type": "v_prediction", "steps_offset": 1, "set_alpha_to_one": True}),
}


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_config_from_dir_matches_jax(tmp_path, kind):
  for sub, body in zip(("text_encoder/config.json", "unet/config.json", "vae/config.json", "scheduler/scheduler_config.json"), CONFIGS[kind]):
    (tmp_path / sub).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / sub).write_text(json.dumps(body))
  got, want = tdl.diffusion_config_from_dir(tmp_path), jdl.diffusion_config_from_dir(tmp_path)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert [got.unet.heads_at(i) for i in range(4)] == [want.unet.heads_at(i) for i in range(4)]


def test_download_patterns_and_local_checkpoint(tmp_path):
  """The diffusers layout fetches only the three component weights (no
  root checkpoints, no .fp16 copies), as the reference's patterns; a
  directory holding them resolves locally."""
  repo_files = [
    "model_index.json", "v2-1_512-ema-pruned.safetensors", "v2-1_512-nonema-pruned.safetensors",
    "text_encoder/config.json", "text_encoder/model.safetensors", "text_encoder/model.fp16.safetensors",
    "unet/config.json", "unet/diffusion_pytorch_model.safetensors", "unet/diffusion_pytorch_model.fp16.safetensors",
    "vae/config.json", "vae/diffusion_pytorch_model.safetensors", "vae/diffusion_pytorch_model.fp16.safetensors",
    "scheduler/scheduler_config.json", "tokenizer/vocab.json", "tokenizer/merges.txt",
  ]
  for model in ("stable-diffusion-2-1-base", "stable-diffusion-1-5", "stable-diffusion-2-1"):
    got = set(thf.filter_repo_objects(repo_files, allow_patterns=thf.get_allow_patterns(None, Shard(model, 0, 30, 31))))
    assert got == set(jhf.filter_repo_objects(repo_files, allow_patterns=jhf.get_allow_patterns(None, JShard(model, 0, 30, 31))))
    assert {"unet/diffusion_pytorch_model.safetensors", "text_encoder/model.safetensors", "scheduler/scheduler_config.json", "tokenizer/merges.txt"} <= got
    assert not any("fp16" in f or f.startswith("v2-1_512") for f in got), got
  assert "*.safetensors" in thf.get_allow_patterns(None, Shard("llama-3.2-1b", 0, 15, 16))
  shard = Shard("stable-diffusion-2-1-base", 0, 30, 31)
  (tmp_path / "model_index.json").write_text("{}")
  for p in thf.DIFFUSERS_WEIGHTS[:2]:
    (tmp_path / p).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / p).write_bytes(b"x")
  assert not tdown._local_complete(tmp_path, shard)
  (tmp_path / thf.DIFFUSERS_WEIGHTS[2]).parent.mkdir(parents=True, exist_ok=True)
  (tmp_path / thf.DIFFUSERS_WEIGHTS[2]).write_bytes(b"x")
  assert tdown._local_complete(tmp_path, shard)
  (tmp_path / "unet" / "diffusion_pytorch_model.safetensors.partial").write_bytes(b"")
  assert not tdown._local_complete(tmp_path, shard)
