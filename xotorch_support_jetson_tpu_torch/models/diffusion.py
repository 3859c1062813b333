"""Stable diffusion: the CLIP text encoder, UNet2DCondition, the VAE and
the DDIM / Euler samplers with classifier-free guidance.

Counterpart of the reference's ``models/diffusion.py``, in plain PyTorch
(the reference runs this family as XLA einsums and convolutions, with no
Pallas kernel, and the port writes none):

- activations are NCHW and convolution weights OIHW, linear weights
  ``[out, in]`` (``F.linear``): the layouts diffusers and transformers
  store, so a checkpoint loads with no transposes (models/diffusion_loader.py);
- the CLIP text layers are stacked ``[L, ...]`` and run one after another;
  the UNet's down, mid and up blocks follow the static plan of the config,
  with the skip concatenations of the reference;
- group norm, layer norm and the attention softmax compute in f32 and cast
  back; the attention products are plain matmuls (non-causal in the UNet and
  the VAE, causal in CLIP);
- ``sample_chunk`` runs a chunk of denoising steps as an eager loop (the
  reference's ``lax.scan``), classifier-free guidance as 2B rows through one
  UNet call a step, the scheduler arithmetic in f32.

Parameters are nested dicts (and lists) of tensors: ``clip``, ``unet`` and
``vae`` with the reference's leaf names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

Params = dict

# ----------------------------------------------------------------- configs


@dataclass(frozen=True)
class ClipTextConfig:
  vocab_size: int = 49408
  hidden_size: int = 1024
  intermediate_size: int = 4096
  n_layers: int = 23
  n_heads: int = 16
  max_positions: int = 77
  layer_norm_eps: float = 1e-5
  act: str = "gelu"  # SD2 (OpenCLIP-H) "gelu"; SD1 (CLIP ViT-L) "quick_gelu"


@dataclass(frozen=True)
class UNetConfig:
  in_channels: int = 4
  out_channels: int = 4
  block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
  layers_per_block: int = 2
  cross_attention_dim: int = 1024
  attention_head_dim: int = 64  # per-head width: heads = channels // this
  # Per-level head counts, which win over attention_head_dim when set (the
  # loader maps diffusers' head-count "attention_head_dim" here).
  attn_heads: tuple[int, ...] | None = None
  norm_groups: int = 32
  norm_eps: float = 1e-5
  # which levels carry cross-attention transformers (SD: all but the last)
  cross_levels: tuple[bool, ...] = (True, True, True, False)

  def heads_at(self, level: int) -> int:
    if self.attn_heads is not None:
      return self.attn_heads[level]
    return max(1, self.block_out_channels[level] // self.attention_head_dim)


@dataclass(frozen=True)
class VaeConfig:
  in_channels: int = 3
  latent_channels: int = 4
  block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
  layers_per_block: int = 2
  norm_groups: int = 32
  norm_eps: float = 1e-6
  scaling_factor: float = 0.18215


@dataclass(frozen=True)
class DiffusionConfig:
  """The three submodels and the scheduler's constants."""

  clip: ClipTextConfig = field(default_factory=ClipTextConfig)
  unet: UNetConfig = field(default_factory=UNetConfig)
  vae: VaeConfig = field(default_factory=VaeConfig)
  sample_size: int = 64  # latent H = W at 512 px
  prediction_type: str = "epsilon"  # or "v_prediction"
  num_train_timesteps: int = 1000
  beta_start: float = 0.00085
  beta_end: float = 0.012
  beta_schedule: str = "scaled_linear"
  # diffusers' DDIMScheduler: SD ships set_alpha_to_one=False, so the step
  # past t = 0 uses alphas_cumprod[0] instead of 1.0
  set_alpha_to_one: bool = False
  # diffusers' leading spacing adds steps_offset to every timestep (SD ships 1)
  steps_offset: int = 0


def tiny_diffusion_config(**over) -> DiffusionConfig:
  """A miniature geometry for tests: the full topology at toy widths."""
  cfg = DiffusionConfig(
    clip=ClipTextConfig(vocab_size=128, hidden_size=32, intermediate_size=64, n_layers=2, n_heads=4, max_positions=16),
    unet=UNetConfig(
      block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=32,
      attention_head_dim=8, norm_groups=4, cross_levels=(True, False),
    ),
    vae=VaeConfig(block_out_channels=(8, 16), layers_per_block=1, norm_groups=4),
    sample_size=8,
  )
  return cfg if not over else DiffusionConfig(**{**cfg.__dict__, **over})


# ------------------------------------------------------------- primitives


def _gelu(x: torch.Tensor, act: str) -> torch.Tensor:
  if act == "quick_gelu":
    return x * torch.sigmoid(1.702 * x)
  return F.gelu(x)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
  """GroupNorm over NCHW, statistics in f32 per sample and group."""
  return F.group_norm(x.float(), groups, scale.float(), bias.float(), eps).to(x.dtype)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
  return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps).to(x.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1, pad: int = 1) -> torch.Tensor:
  """NCHW convolution, OIHW kernel."""
  return F.conv2d(x, w, b, stride=stride, padding=pad)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int, mask: torch.Tensor | None = None) -> torch.Tensor:
  """Multi-head attention over token axes, [B, S, D] × [B, T, D] → [B, S, D]:
  the scores in the inputs' dtype, the softmax in f32. ``mask`` [S, T]
  (True: attend) fills the rest with -1e9, as CLIP's causal mask."""
  b, s, _d = q.shape
  t = k.shape[1]
  qh = q.reshape(b, s, n_heads, -1).transpose(1, 2)
  kh = k.reshape(b, t, n_heads, -1).transpose(1, 2)
  vh = v.reshape(b, t, n_heads, -1).transpose(1, 2)
  scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
  if mask is not None:
    scores = scores.masked_fill(~mask, -1e9)
  probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
  return (probs @ vh).transpose(1, 2).reshape(b, s, -1)


def _tokens(x: torch.Tensor) -> torch.Tensor:
  """NCHW → [N, H·W, C]."""
  n, c, h, w = x.shape
  return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def _image(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """[N, H·W, C] → NCHW."""
  n, _, c = y.shape
  return y.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _upsample(x: torch.Tensor) -> torch.Tensor:
  return F.interpolate(x, scale_factor=2, mode="nearest")


# ----------------------------------------------------------- CLIP text


def clip_text_encode(params: Params, cfg: ClipTextConfig, tokens: torch.Tensor) -> torch.Tensor:
  """tokens [B, S] → the last hidden state [B, S, D] after the final layer
  norm: learned positions, pre-LN layers, a causal mask."""
  b, s = tokens.shape
  x = params["tok_emb"][tokens] + params["pos_emb"][:s]
  causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device))
  layers = params["layers"]
  for i in range(cfg.n_layers):
    lp = {k: v[i] for k, v in layers.items()}
    r = _layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.layer_norm_eps)
    attn = _attention(F.linear(r, lp["wq"], lp["bq"]), F.linear(r, lp["wk"], lp["bk"]), F.linear(r, lp["wv"], lp["bv"]), cfg.n_heads, causal)
    x = x + F.linear(attn, lp["wo"], lp["bo"])
    r = _layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.layer_norm_eps)
    x = x + F.linear(_gelu(F.linear(r, lp["w_fc1"], lp["b_fc1"]), cfg.act), lp["w_fc2"], lp["b_fc2"])
  return _layer_norm(x, params["final_ln_s"], params["final_ln_b"], cfg.layer_norm_eps)


# ----------------------------------------------------------------- UNet


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
  """Sinusoidal embedding, diffusers' convention (flip_sin_to_cos=True,
  downscale_freq_shift=0): [cos | sin] of t · exp(-ln(1e4) · i / half)."""
  half = dim // 2
  freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
  ang = t.float()[:, None] * freqs[None, :]
  return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _resnet(x: torch.Tensor, temb: torch.Tensor | None, p: Params, groups: int, eps: float) -> torch.Tensor:
  """A ResnetBlock2D; ``temb`` None for the VAE's (no time projection)."""
  h = _conv(F.silu(_group_norm(x, p["norm1_s"], p["norm1_b"], groups, eps)), p["conv1_w"], p["conv1_b"])
  if temb is not None:
    h = h + F.linear(F.silu(temb), p["time_w"], p["time_b"])[:, :, None, None]
  h = _conv(F.silu(_group_norm(h, p["norm2_s"], p["norm2_b"], groups, eps)), p["conv2_w"], p["conv2_b"])
  if "skip_w" in p:
    x = _conv(x, p["skip_w"], p["skip_b"], pad=0)
  return x + h


def _transformer_block(x: torch.Tensor, ctx: torch.Tensor, p: Params, n_heads: int, groups: int) -> torch.Tensor:
  """Transformer2DModel of depth 1: group norm, linear projection in,
  self-attention, cross-attention over the text, a GEGLU feed-forward,
  linear projection out, residual (no biases on q / k / v)."""
  _n, _c, h, w = x.shape
  y = F.linear(_tokens(_group_norm(x, p["norm_s"], p["norm_b"], groups, 1e-6)), p["proj_in_w"], p["proj_in_b"])
  r = _layer_norm(y, p["ln1_s"], p["ln1_b"], 1e-5)
  y = y + F.linear(_attention(F.linear(r, p["attn1_wq"]), F.linear(r, p["attn1_wk"]), F.linear(r, p["attn1_wv"]), n_heads), p["attn1_wo"], p["attn1_bo"])
  r = _layer_norm(y, p["ln2_s"], p["ln2_b"], 1e-5)
  y = y + F.linear(_attention(F.linear(r, p["attn2_wq"]), F.linear(ctx, p["attn2_wk"]), F.linear(ctx, p["attn2_wv"]), n_heads), p["attn2_wo"], p["attn2_bo"])
  r = _layer_norm(y, p["ln3_s"], p["ln3_b"], 1e-5)
  a, g = F.linear(r, p["ff_w1"], p["ff_b1"]).chunk(2, dim=-1)
  y = y + F.linear(a * F.gelu(g), p["ff_w2"], p["ff_b2"])
  return x + _image(F.linear(y, p["proj_out_w"], p["proj_out_b"]), h, w)


def unet_apply(params: Params, cfg: UNetConfig, latents: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
  """latents [B, Cin, H, W], t [B], ctx [B, S, cross_dim] → the prediction
  [B, Cout, H, W]: the down, mid and up blocks with their skip concats."""
  temb = _timestep_embedding(t, cfg.block_out_channels[0]).to(latents.dtype)
  temb = F.linear(F.silu(F.linear(temb, params["time_w1"], params["time_b1"])), params["time_w2"], params["time_b2"])

  x = _conv(latents, params["conv_in_w"], params["conv_in_b"])
  skips = [x]
  for li, blk in enumerate(params["down"]):
    heads = cfg.heads_at(li)
    for ri, rp in enumerate(blk["resnets"]):
      x = _resnet(x, temb, rp, cfg.norm_groups, cfg.norm_eps)
      if cfg.cross_levels[li]:
        x = _transformer_block(x, ctx, blk["attns"][ri], heads, cfg.norm_groups)
      skips.append(x)
    if "down_w" in blk:  # every level but the last downsamples (a stride-2 conv)
      x = _conv(x, blk["down_w"], blk["down_b"], stride=2)
      skips.append(x)

  mid = params["mid"]
  x = _resnet(x, temb, mid["resnet1"], cfg.norm_groups, cfg.norm_eps)
  if "attn" in mid:
    x = _transformer_block(x, ctx, mid["attn"], cfg.heads_at(len(cfg.block_out_channels) - 1), cfg.norm_groups)
  x = _resnet(x, temb, mid["resnet2"], cfg.norm_groups, cfg.norm_eps)

  n_levels = len(cfg.block_out_channels)
  for ui, blk in enumerate(params["up"]):
    li = n_levels - 1 - ui
    heads = cfg.heads_at(li)
    for ri, rp in enumerate(blk["resnets"]):
      x = _resnet(torch.cat([x, skips.pop()], dim=1), temb, rp, cfg.norm_groups, cfg.norm_eps)
      if cfg.cross_levels[li]:
        x = _transformer_block(x, ctx, blk["attns"][ri], heads, cfg.norm_groups)
    if "up_w" in blk:  # every level but level 0 upsamples (nearest 2x, then a conv)
      x = _conv(_upsample(x), blk["up_w"], blk["up_b"])

  x = _group_norm(x, params["norm_out_s"], params["norm_out_b"], cfg.norm_groups, cfg.norm_eps)
  return _conv(F.silu(x), params["conv_out_w"], params["conv_out_b"])


# ------------------------------------------------------------------ VAE


def _vae_attn(x: torch.Tensor, p: Params, groups: int, eps: float) -> torch.Tensor:
  """Single-head attention at the VAE's mid block."""
  _n, _c, h, w = x.shape
  y = _tokens(_group_norm(x, p["norm_s"], p["norm_b"], groups, eps))
  out = _attention(F.linear(y, p["wq"], p["bq"]), F.linear(y, p["wk"], p["bk"]), F.linear(y, p["wv"], p["bv"]), 1)
  return x + _image(F.linear(out, p["wo"], p["bo"]), h, w)


def _vae_mid(x: torch.Tensor, p: Params, cfg: VaeConfig) -> torch.Tensor:
  x = _resnet(x, None, p["mid_resnet1"], cfg.norm_groups, cfg.norm_eps)
  x = _vae_attn(x, p["mid_attn"], cfg.norm_groups, cfg.norm_eps)
  return _resnet(x, None, p["mid_resnet2"], cfg.norm_groups, cfg.norm_eps)


def vae_encode(params: Params, cfg: VaeConfig, images: torch.Tensor) -> torch.Tensor:
  """images [B, 3, H, W] in [-1, 1] → the latent distribution's moments
  [B, 2·Cz, h, w]."""
  p = params["encoder"]
  x = _conv(images, p["conv_in_w"], p["conv_in_b"])
  for blk in p["down"]:
    for rp in blk["resnets"]:
      x = _resnet(x, None, rp, cfg.norm_groups, cfg.norm_eps)
    if "down_w" in blk:
      # diffusers' VAE downsample pads asymmetrically (right and bottom only)
      x = _conv(F.pad(x, (0, 1, 0, 1)), blk["down_w"], blk["down_b"], stride=2, pad=0)
  x = _vae_mid(x, p, cfg)
  x = _group_norm(x, p["norm_out_s"], p["norm_out_b"], cfg.norm_groups, cfg.norm_eps)
  x = _conv(F.silu(x), p["conv_out_w"], p["conv_out_b"])
  return _conv(x, params["quant_w"], params["quant_b"], pad=0)


def vae_sample_latents(moments: torch.Tensor, noise: torch.Tensor, scaling: float) -> torch.Tensor:
  """A draw of the latent distribution, scaled: ``noise`` is a standard
  normal of the mean's shape."""
  mean, logvar = moments.chunk(2, dim=1)
  return (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise) * scaling


def vae_decode(params: Params, cfg: VaeConfig, latents: torch.Tensor) -> torch.Tensor:
  """Scaled latents [B, Cz, h, w] → images [B, 3, H, W] in [-1, 1]."""
  p = params["decoder"]
  x = _conv(latents / cfg.scaling_factor, params["post_quant_w"], params["post_quant_b"], pad=0)
  x = _conv(x, p["conv_in_w"], p["conv_in_b"])
  x = _vae_mid(x, p, cfg)
  for blk in p["up"]:
    for rp in blk["resnets"]:
      x = _resnet(x, None, rp, cfg.norm_groups, cfg.norm_eps)
    if "up_w" in blk:
      x = _conv(_upsample(x), blk["up_w"], blk["up_b"])
  x = _group_norm(x, p["norm_out_s"], p["norm_out_b"], cfg.norm_groups, cfg.norm_eps)
  return _conv(F.silu(x), p["conv_out_w"], p["conv_out_b"])


# ------------------------------------------------------------- scheduler


def alphas_cumprod(cfg: DiffusionConfig) -> torch.Tensor:
  """The cumulative products of 1 - beta, f32 on the CPU."""
  if cfg.beta_schedule == "scaled_linear":
    betas = torch.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps, dtype=torch.float32) ** 2
  else:
    betas = torch.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps, dtype=torch.float32)
  return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(cfg: DiffusionConfig, steps: int) -> torch.Tensor:
  """Descending timesteps, diffusers' DDIM leading spacing:
  arange(steps) · stride + steps_offset."""
  stride = cfg.num_train_timesteps // steps
  ts = torch.arange(steps) * stride + cfg.steps_offset
  return ts.clamp(0, cfg.num_train_timesteps - 1).flip(0)


def _predict_x0_eps(x, model_out, a_t, prediction_type: str):
  """(x0, eps) from the model output under either parameterization."""
  sqrt_a = torch.sqrt(a_t)
  sqrt_1ma = torch.sqrt(1.0 - a_t)
  if prediction_type == "v_prediction":
    return sqrt_a * x - sqrt_1ma * model_out, sqrt_a * model_out + sqrt_1ma * x
  return (x - sqrt_1ma * model_out) / sqrt_a, model_out


def _f32(a, x: torch.Tensor) -> torch.Tensor:
  return torch.as_tensor(a, dtype=torch.float32, device=x.device)


def ddim_step(x, model_out, a_t, a_prev, prediction_type: str):
  """Deterministic DDIM (eta = 0), t → t_prev."""
  a_t, a_prev = _f32(a_t, x), _f32(a_prev, x)
  x0, eps = _predict_x0_eps(x, model_out, a_t, prediction_type)
  return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def euler_step(x, model_out, a_t, a_prev, prediction_type: str):
  """Euler in sigma space (discrete Euler, no churn): with x_t = sqrt(a_t) ·
  (x0 + sigma_t · eps) and sigma_t = sqrt(1 / a_t - 1), the probability-flow
  derivative in the scaled frame xs = x / sqrt(a_t) is (xs - x0) / sigma."""
  a_t, a_prev = _f32(a_t, x), _f32(a_prev, x)
  x0, _eps = _predict_x0_eps(x, model_out, a_t, prediction_type)
  sigma_t = torch.sqrt(1.0 / a_t - 1.0)
  sigma_prev = torch.sqrt(1.0 / a_prev - 1.0)
  xs = x / torch.sqrt(a_t)
  xs = xs + (sigma_prev - sigma_t) * ((xs - x0) / sigma_t)
  return xs * torch.sqrt(a_prev)


def sample_chunk(
  unet_params: Params,
  cfg: DiffusionConfig,
  latents: torch.Tensor,
  ctx_pair: torch.Tensor,
  ts: torch.Tensor,
  a_ts: torch.Tensor,
  a_prevs: torch.Tensor,
  guidance: float,
  method: str = "ddim",
) -> torch.Tensor:
  """A chunk of denoising steps. ``ctx_pair`` [2B, S, D] is the
  unconditional rows, then the conditional ones; each step runs both
  through one UNet call and combines them with classifier-free guidance.
  ``ts`` (ints), ``a_ts`` and ``a_prevs`` (f32) are the chunk's slice of the
  schedule; the step's arithmetic is f32 and the latents keep their dtype."""
  b = latents.shape[0]
  step_fn = euler_step if method == "euler" else ddim_step
  a_ts = torch.as_tensor(a_ts, dtype=torch.float32, device=latents.device)
  a_prevs = torch.as_tensor(a_prevs, dtype=torch.float32, device=latents.device)
  for i, t in enumerate(torch.as_tensor(ts).tolist()):
    out = unet_apply(unet_params, cfg.unet, torch.cat([latents, latents], dim=0), torch.full((2 * b,), int(t), dtype=torch.int32, device=latents.device), ctx_pair)
    out_u, out_c = out.chunk(2, dim=0)
    out = out_u.float() + guidance * (out_c - out_u).float()
    latents = step_fn(latents.float(), out, a_ts[i], a_prevs[i], cfg.prediction_type).to(latents.dtype)
  return latents


def add_noise(x0: torch.Tensor, noise: torch.Tensor, a_t) -> torch.Tensor:
  a_t = _f32(a_t, x0)
  return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * noise
