"""Stable-diffusion parameters: seeded random init, the diffusers-format
checkpoint loader and its inverse, the exporter.

Counterpart of the reference's ``models/diffusion_loader.py``. The on-disk
layout is diffusers' (``model_index.json``, then ``text_encoder/``,
``unet/``, ``vae/`` and ``scheduler/``), read and written with the port's
own safetensors codec (models/loader.py), so neither direction needs the
``safetensors`` package. The port's tree keeps the checkpoint's layouts
(models/diffusion.py: OIHW convolutions, ``[out, in]`` linears), so a load
is a rename plus, for the CLIP text layers, a stack into ``[L, ...]``
leaves; an SD1-style 1x1-convolution projection (``proj_in`` / ``proj_out``,
legacy VAE attention) is reshaped to its matrix. ``export_diffusers_checkpoint``
walks the same name map the other way.

``init_diffusion_params`` draws the tree from a ``torch.Generator`` at the
reference's scales: N(0, 1/fan_in) linears and convolutions, N(0, 0.02)
token and N(0, 0.01) position embeddings, 0.02 for each transformer's
output projection, unit norm gains, zero biases.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .diffusion import ClipTextConfig, DiffusionConfig, Params, UNetConfig, VaeConfig
from .loader import iter_safetensors, save_safetensors

# ---------------------------------------------------------------- topology


def _unet_down_plan(cfg: UNetConfig) -> list[dict]:
  """Per level: the resnets' (cin, cout) pairs and whether it downsamples."""
  plan = []
  prev = cfg.block_out_channels[0]
  for li, ch in enumerate(cfg.block_out_channels):
    resnets = [(prev if ri == 0 else ch, ch) for ri in range(cfg.layers_per_block)]
    plan.append({"resnets": resnets, "down": li < len(cfg.block_out_channels) - 1, "ch": ch})
    prev = ch
  return plan


def _unet_up_plan(cfg: UNetConfig) -> list[dict]:
  """Per up block: the resnets' (cin, cout) pairs with the skip concats'
  widths, whether it upsamples, and the level it mirrors."""
  skips = [cfg.block_out_channels[0]]
  for li, ch in enumerate(cfg.block_out_channels):
    skips += [ch] * cfg.layers_per_block
    if li < len(cfg.block_out_channels) - 1:
      skips.append(ch)
  plan = []
  x_ch = cfg.block_out_channels[-1]
  n = len(cfg.block_out_channels)
  for ui in range(n):
    li = n - 1 - ui
    ch = cfg.block_out_channels[li]
    resnets = []
    for _ in range(cfg.layers_per_block + 1):
      resnets.append((x_ch + skips.pop(), ch))
      x_ch = ch
    plan.append({"resnets": resnets, "up": ui < n - 1, "ch": ch, "level": li})
  return plan


# -------------------------------------------------------------- random init


class _Init:
  def __init__(self, gen: torch.Generator, dtype, device) -> None:
    self.gen, self.dtype, self.device = gen, dtype, device

  def normal(self, shape, std: float) -> torch.Tensor:
    return (torch.randn(shape, generator=self.gen, device=self.gen.device) * std).to(device=self.device, dtype=self.dtype)

  def dense(self, cin: int, cout: int, scale: float | None = None) -> torch.Tensor:
    return self.normal((cout, cin), scale if scale is not None else cin**-0.5)

  def conv(self, cin: int, cout: int, k: int = 3) -> torch.Tensor:
    return self.normal((cout, cin, k, k), (cin * k * k) ** -0.5)

  def ones(self, *shape) -> torch.Tensor:
    return torch.ones(shape, dtype=self.dtype, device=self.device)

  def zeros(self, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=self.dtype, device=self.device)


def _init_resnet(r: _Init, cin: int, cout: int, t_dim: int | None) -> Params:
  p = {
    "norm1_s": r.ones(cin), "norm1_b": r.zeros(cin), "conv1_w": r.conv(cin, cout), "conv1_b": r.zeros(cout),
    "norm2_s": r.ones(cout), "norm2_b": r.zeros(cout), "conv2_w": r.conv(cout, cout), "conv2_b": r.zeros(cout),
  }
  if t_dim is not None:
    p["time_w"], p["time_b"] = r.dense(t_dim, cout), r.zeros(cout)
  if cin != cout:
    p["skip_w"], p["skip_b"] = r.conv(cin, cout, k=1), r.zeros(cout)
  return p


def _init_tx_block(r: _Init, ch: int, cross_dim: int) -> Params:
  inner = 4 * ch
  p = {"norm_s": r.ones(ch), "norm_b": r.zeros(ch), "proj_in_w": r.dense(ch, ch), "proj_in_b": r.zeros(ch)}
  for i, kv_dim in (("1", ch), ("2", cross_dim)):
    p[f"ln{i}_s"], p[f"ln{i}_b"] = r.ones(ch), r.zeros(ch)
    p[f"attn{i}_wq"] = r.dense(ch, ch)
    p[f"attn{i}_wk"] = r.dense(kv_dim, ch)
    p[f"attn{i}_wv"] = r.dense(kv_dim, ch)
    p[f"attn{i}_wo"] = r.dense(ch, ch)
    p[f"attn{i}_bo"] = r.zeros(ch)
  p.update({
    "ln3_s": r.ones(ch), "ln3_b": r.zeros(ch),
    "ff_w1": r.dense(ch, 2 * inner), "ff_b1": r.zeros(2 * inner),
    "ff_w2": r.dense(inner, ch), "ff_b2": r.zeros(ch),
    "proj_out_w": r.dense(ch, ch, scale=0.02), "proj_out_b": r.zeros(ch),
  })
  return p


def _init_unet(r: _Init, cfg: UNetConfig) -> Params:
  c0 = cfg.block_out_channels[0]
  t_dim = 4 * c0
  params: Params = {
    "conv_in_w": r.conv(cfg.in_channels, c0), "conv_in_b": r.zeros(c0),
    "time_w1": r.dense(c0, t_dim), "time_b1": r.zeros(t_dim),
    "time_w2": r.dense(t_dim, t_dim), "time_b2": r.zeros(t_dim),
  }

  def block(lvl: dict, level: int, sampler: str) -> Params:
    blk: Params = {"resnets": [], "attns": []}
    for cin, cout in lvl["resnets"]:
      blk["resnets"].append(_init_resnet(r, cin, cout, t_dim))
      if cfg.cross_levels[level]:
        blk["attns"].append(_init_tx_block(r, cout, cfg.cross_attention_dim))
    if not cfg.cross_levels[level]:
      del blk["attns"]
    if lvl[sampler]:
      blk[f"{sampler}_w"], blk[f"{sampler}_b"] = r.conv(lvl["ch"], lvl["ch"]), r.zeros(lvl["ch"])
    return blk

  params["down"] = [block(lvl, li, "down") for li, lvl in enumerate(_unet_down_plan(cfg))]
  cm = cfg.block_out_channels[-1]
  params["mid"] = {
    "resnet1": _init_resnet(r, cm, cm, t_dim),
    "attn": _init_tx_block(r, cm, cfg.cross_attention_dim),
    "resnet2": _init_resnet(r, cm, cm, t_dim),
  }
  params["up"] = [block(lvl, lvl["level"], "up") for lvl in _unet_up_plan(cfg)]
  params["norm_out_s"], params["norm_out_b"] = r.ones(c0), r.zeros(c0)
  params["conv_out_w"], params["conv_out_b"] = r.conv(c0, cfg.out_channels), r.zeros(cfg.out_channels)
  return params


def _init_vae_attn(r: _Init, ch: int) -> Params:
  p = {"norm_s": r.ones(ch), "norm_b": r.zeros(ch)}
  for w in "qkvo":
    p[f"w{w}"], p[f"b{w}"] = r.dense(ch, ch), r.zeros(ch)
  return p


def _init_vae_half(r: _Init, cfg: VaeConfig, encoder: bool) -> Params:
  chans = cfg.block_out_channels
  c_last = chans[-1]
  n_res = cfg.layers_per_block if encoder else cfg.layers_per_block + 1
  first = chans[0] if encoder else c_last
  p: Params = {"conv_in_w": r.conv(cfg.in_channels if encoder else cfg.latent_channels, first), "conv_in_b": r.zeros(first)}
  blocks = []
  if encoder:
    order, key = list(chans), "down"
  else:
    # the decoder draws its mid block before its up blocks, as the reference
    p["mid_resnet1"] = _init_resnet(r, c_last, c_last, None)
    p["mid_attn"] = _init_vae_attn(r, c_last)
    p["mid_resnet2"] = _init_resnet(r, c_last, c_last, None)
    order, key = list(reversed(chans)), "up"
  prev = first
  for i, ch in enumerate(order):
    blk = {"resnets": [_init_resnet(r, prev if ri == 0 else ch, ch, None) for ri in range(n_res)]}
    if i < len(order) - 1:
      blk[f"{key}_w"], blk[f"{key}_b"] = r.conv(ch, ch), r.zeros(ch)
    blocks.append(blk)
    prev = ch
  p[key] = blocks
  if encoder:
    p["mid_resnet1"] = _init_resnet(r, c_last, c_last, None)
    p["mid_attn"] = _init_vae_attn(r, c_last)
    p["mid_resnet2"] = _init_resnet(r, c_last, c_last, None)
  out_ch = 2 * cfg.latent_channels if encoder else cfg.in_channels
  last = c_last if encoder else chans[0]
  p["norm_out_s"], p["norm_out_b"] = r.ones(last), r.zeros(last)
  p["conv_out_w"], p["conv_out_b"] = r.conv(last, out_ch), r.zeros(out_ch)
  return p


def _init_vae(r: _Init, cfg: VaeConfig) -> Params:
  zc = cfg.latent_channels
  return {
    "encoder": _init_vae_half(r, cfg, encoder=True),
    "decoder": _init_vae_half(r, cfg, encoder=False),
    "quant_w": r.conv(2 * zc, 2 * zc, k=1), "quant_b": r.zeros(2 * zc),
    "post_quant_w": r.conv(zc, zc, k=1), "post_quant_b": r.zeros(zc),
  }


def _init_clip(r: _Init, cfg: ClipTextConfig) -> Params:
  d, ff, L = cfg.hidden_size, cfg.intermediate_size, cfg.n_layers

  def stack(cin: int, cout: int) -> torch.Tensor:
    return torch.stack([r.dense(cin, cout) for _ in range(L)])

  return {
    "tok_emb": r.normal((cfg.vocab_size, d), 0.02),
    "pos_emb": r.normal((cfg.max_positions, d), 0.01),
    "layers": {
      "ln1_s": r.ones(L, d), "ln1_b": r.zeros(L, d), "ln2_s": r.ones(L, d), "ln2_b": r.zeros(L, d),
      "wq": stack(d, d), "bq": r.zeros(L, d), "wk": stack(d, d), "bk": r.zeros(L, d),
      "wv": stack(d, d), "bv": r.zeros(L, d), "wo": stack(d, d), "bo": r.zeros(L, d),
      "w_fc1": stack(d, ff), "b_fc1": r.zeros(L, ff), "w_fc2": stack(ff, d), "b_fc2": r.zeros(L, d),
    },
    "final_ln_s": r.ones(d), "final_ln_b": r.zeros(d),
  }


def init_diffusion_params(gen: torch.Generator, cfg: DiffusionConfig, dtype=torch.float32, device=None) -> Params:
  """Random ``clip``, ``unet`` and ``vae`` trees, drawn on ``gen``'s device
  and stored in ``dtype`` on ``device``."""
  r = _Init(gen, dtype, device if device is not None else gen.device)
  return {"clip": _init_clip(r, cfg.clip), "unet": _init_unet(r, cfg.unet), "vae": _init_vae(r, cfg.vae)}


# --------------------------------------------------------- checkpoint load


def _read_dir(subdir: Path) -> dict[str, torch.Tensor]:
  files = sorted(Path(subdir).glob("*.safetensors"))
  if not files:
    raise FileNotFoundError(f"no safetensors under {subdir}")
  return {name: t for f in files for name, t in iter_safetensors(f)}


class _Raw:
  """A component's tensors by name, moved to ``device`` in ``dtype`` as they
  are taken; a 1x1-convolution projection comes out as its matrix."""

  def __init__(self, raw: dict[str, torch.Tensor], dtype, device) -> None:
    self.raw, self.dtype, self.device = raw, dtype, device

  def __contains__(self, name: str) -> bool:
    return name in self.raw

  def t(self, name: str) -> torch.Tensor:
    return self.raw[name].to(device=self.device, dtype=self.dtype)

  def lin(self, name: str) -> torch.Tensor:
    t = self.t(name)
    return t[:, :, 0, 0] if t.ndim == 4 else t


def load_clip_text(subdir: Path, cfg: ClipTextConfig, dtype=torch.float32, device=None) -> Params:
  r = _Raw(_read_dir(subdir), dtype, device)
  prefix = "" if "embeddings.token_embedding.weight" in r else "text_model."
  names = {
    "ln1_s": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
    "wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
    "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
    "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
    "wo": "self_attn.out_proj.weight", "bo": "self_attn.out_proj.bias",
    "ln2_s": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
    "w_fc1": "mlp.fc1.weight", "b_fc1": "mlp.fc1.bias",
    "w_fc2": "mlp.fc2.weight", "b_fc2": "mlp.fc2.bias",
  }
  return {
    "tok_emb": r.t(f"{prefix}embeddings.token_embedding.weight"),
    "pos_emb": r.t(f"{prefix}embeddings.position_embedding.weight"),
    "layers": {key: torch.stack([r.t(f"{prefix}encoder.layers.{i}.{hf}") for i in range(cfg.n_layers)]) for key, hf in names.items()},
    "final_ln_s": r.t(f"{prefix}final_layer_norm.weight"),
    "final_ln_b": r.t(f"{prefix}final_layer_norm.bias"),
  }


def _resnet_from(r: _Raw, prefix: str, with_time: bool = True) -> Params:
  p = {
    "norm1_s": r.t(f"{prefix}.norm1.weight"), "norm1_b": r.t(f"{prefix}.norm1.bias"),
    "conv1_w": r.t(f"{prefix}.conv1.weight"), "conv1_b": r.t(f"{prefix}.conv1.bias"),
    "norm2_s": r.t(f"{prefix}.norm2.weight"), "norm2_b": r.t(f"{prefix}.norm2.bias"),
    "conv2_w": r.t(f"{prefix}.conv2.weight"), "conv2_b": r.t(f"{prefix}.conv2.bias"),
  }
  if with_time:
    p["time_w"], p["time_b"] = r.t(f"{prefix}.time_emb_proj.weight"), r.t(f"{prefix}.time_emb_proj.bias")
  if f"{prefix}.conv_shortcut.weight" in r:
    p["skip_w"], p["skip_b"] = r.t(f"{prefix}.conv_shortcut.weight"), r.t(f"{prefix}.conv_shortcut.bias")
  return p


def _tx_from(r: _Raw, prefix: str) -> Params:
  tb = f"{prefix}.transformer_blocks.0"
  p = {
    "norm_s": r.t(f"{prefix}.norm.weight"), "norm_b": r.t(f"{prefix}.norm.bias"),
    "proj_in_w": r.lin(f"{prefix}.proj_in.weight"), "proj_in_b": r.t(f"{prefix}.proj_in.bias"),
    "proj_out_w": r.lin(f"{prefix}.proj_out.weight"), "proj_out_b": r.t(f"{prefix}.proj_out.bias"),
    "ff_w1": r.t(f"{tb}.ff.net.0.proj.weight"), "ff_b1": r.t(f"{tb}.ff.net.0.proj.bias"),
    "ff_w2": r.t(f"{tb}.ff.net.2.weight"), "ff_b2": r.t(f"{tb}.ff.net.2.bias"),
  }
  for i in "123":
    p[f"ln{i}_s"], p[f"ln{i}_b"] = r.t(f"{tb}.norm{i}.weight"), r.t(f"{tb}.norm{i}.bias")
  for i in "12":
    for w, hf in (("wq", "to_q"), ("wk", "to_k"), ("wv", "to_v"), ("wo", "to_out.0")):
      p[f"attn{i}_{w}"] = r.t(f"{tb}.attn{i}.{hf}.weight")
    p[f"attn{i}_bo"] = r.t(f"{tb}.attn{i}.to_out.0.bias")
  return p


def load_unet(subdir: Path, cfg: UNetConfig, dtype=torch.float32, device=None) -> Params:
  r = _Raw(_read_dir(subdir), dtype, device)
  params: Params = {
    "conv_in_w": r.t("conv_in.weight"), "conv_in_b": r.t("conv_in.bias"),
    "time_w1": r.t("time_embedding.linear_1.weight"), "time_b1": r.t("time_embedding.linear_1.bias"),
    "time_w2": r.t("time_embedding.linear_2.weight"), "time_b2": r.t("time_embedding.linear_2.bias"),
    "norm_out_s": r.t("conv_norm_out.weight"), "norm_out_b": r.t("conv_norm_out.bias"),
    "conv_out_w": r.t("conv_out.weight"), "conv_out_b": r.t("conv_out.bias"),
  }

  def block(pre: str, level: int, n_res: int, sampler: str, key: str) -> Params:
    blk: Params = {"resnets": [_resnet_from(r, f"{pre}.resnets.{ri}") for ri in range(n_res)]}
    if cfg.cross_levels[level]:
      blk["attns"] = [_tx_from(r, f"{pre}.attentions.{ri}") for ri in range(n_res)]
    if f"{pre}.{sampler}.0.conv.weight" in r:
      blk[f"{key}_w"], blk[f"{key}_b"] = r.t(f"{pre}.{sampler}.0.conv.weight"), r.t(f"{pre}.{sampler}.0.conv.bias")
    return blk

  n = len(cfg.block_out_channels)
  params["down"] = [block(f"down_blocks.{li}", li, cfg.layers_per_block, "downsamplers", "down") for li in range(n)]
  params["mid"] = {
    "resnet1": _resnet_from(r, "mid_block.resnets.0"),
    "attn": _tx_from(r, "mid_block.attentions.0"),
    "resnet2": _resnet_from(r, "mid_block.resnets.1"),
  }
  params["up"] = [block(f"up_blocks.{ui}", n - 1 - ui, cfg.layers_per_block + 1, "upsamplers", "up") for ui in range(n)]
  return params


def _vae_attn_from(r: _Raw, prefix: str) -> Params:
  # newer diffusers: group_norm + to_q/to_k/to_v/to_out.0; older: norm + query/key/value/proj_attn
  if f"{prefix}.group_norm.weight" in r:
    names = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v", "o": "to_out.0"}
  else:
    names = {"norm": "norm", "q": "query", "k": "key", "v": "value", "o": "proj_attn"}
  p = {"norm_s": r.t(f"{prefix}.{names['norm']}.weight"), "norm_b": r.t(f"{prefix}.{names['norm']}.bias")}
  for w in "qkvo":
    p[f"w{w}"], p[f"b{w}"] = r.lin(f"{prefix}.{names[w]}.weight"), r.t(f"{prefix}.{names[w]}.bias")
  return p


def load_vae(subdir: Path, cfg: VaeConfig, dtype=torch.float32, device=None) -> Params:
  r = _Raw(_read_dir(subdir), dtype, device)

  def half(side: str, n_res: int, blocks_key: str, sampler: str, key: str) -> Params:
    p: Params = {
      "conv_in_w": r.t(f"{side}.conv_in.weight"), "conv_in_b": r.t(f"{side}.conv_in.bias"),
      "mid_resnet1": _resnet_from(r, f"{side}.mid_block.resnets.0", with_time=False),
      "mid_attn": _vae_attn_from(r, f"{side}.mid_block.attentions.0"),
      "mid_resnet2": _resnet_from(r, f"{side}.mid_block.resnets.1", with_time=False),
      "norm_out_s": r.t(f"{side}.conv_norm_out.weight"), "norm_out_b": r.t(f"{side}.conv_norm_out.bias"),
      "conv_out_w": r.t(f"{side}.conv_out.weight"), "conv_out_b": r.t(f"{side}.conv_out.bias"),
    }
    blocks = []
    for li in range(len(cfg.block_out_channels)):
      pre = f"{side}.{blocks_key}.{li}"
      blk = {"resnets": [_resnet_from(r, f"{pre}.resnets.{ri}", with_time=False) for ri in range(n_res)]}
      if f"{pre}.{sampler}.0.conv.weight" in r:
        blk[f"{key}_w"], blk[f"{key}_b"] = r.t(f"{pre}.{sampler}.0.conv.weight"), r.t(f"{pre}.{sampler}.0.conv.bias")
      blocks.append(blk)
    p[key] = blocks
    return p

  return {
    "encoder": half("encoder", cfg.layers_per_block, "down_blocks", "downsamplers", "down"),
    "decoder": half("decoder", cfg.layers_per_block + 1, "up_blocks", "upsamplers", "up"),
    "quant_w": r.t("quant_conv.weight"), "quant_b": r.t("quant_conv.bias"),
    "post_quant_w": r.t("post_quant_conv.weight"), "post_quant_b": r.t("post_quant_conv.bias"),
  }


def diffusion_config_from_dir(model_dir: Path) -> DiffusionConfig:
  """A DiffusionConfig from a diffusers model directory's config files."""
  model_dir = Path(model_dir)

  def read(name: str) -> dict:
    p = model_dir / name
    return json.loads(p.read_text()) if p.exists() else {}

  te = read("text_encoder/config.json")
  un = read("unet/config.json")
  va = read("vae/config.json")
  sc = read("scheduler/scheduler_config.json")

  chans = tuple(un.get("block_out_channels", (320, 640, 1280, 1280)))
  n_levels = len(chans)
  down_types = un.get("down_block_types", ["CrossAttnDownBlock2D"] * (n_levels - 1) + ["DownBlock2D"])
  # diffusers' rule: num_attention_heads wins; otherwise the misnamed
  # attention_head_dim is the head count (a scalar 8 on SD1: 8 heads at every
  # level; [5, 10, 20, 20] on SD2: 64-wide heads), 8 when neither is given.
  heads = un.get("num_attention_heads") or un.get("attention_head_dim", 8)
  attn_heads = tuple(int(h) for h in heads) if isinstance(heads, (list, tuple)) else (int(heads),) * n_levels
  return DiffusionConfig(
    clip=ClipTextConfig(
      vocab_size=te.get("vocab_size", 49408),
      hidden_size=te.get("hidden_size", 1024),
      intermediate_size=te.get("intermediate_size", 4096),
      n_layers=te.get("num_hidden_layers", 23),
      n_heads=te.get("num_attention_heads", 16),
      max_positions=te.get("max_position_embeddings", 77),
      layer_norm_eps=te.get("layer_norm_eps", 1e-5),
      act=te.get("hidden_act", "gelu"),
    ),
    unet=UNetConfig(
      in_channels=un.get("in_channels", 4),
      out_channels=un.get("out_channels", 4),
      block_out_channels=chans,
      layers_per_block=un.get("layers_per_block", 2),
      cross_attention_dim=un.get("cross_attention_dim", 1024),
      attn_heads=attn_heads,
      norm_groups=un.get("norm_num_groups", 32),
      norm_eps=un.get("norm_eps", 1e-5),
      cross_levels=tuple(t != "DownBlock2D" for t in down_types),
    ),
    vae=VaeConfig(
      in_channels=va.get("in_channels", 3),
      latent_channels=va.get("latent_channels", 4),
      block_out_channels=tuple(va.get("block_out_channels", (128, 256, 512, 512))),
      layers_per_block=va.get("layers_per_block", 2),
      norm_groups=va.get("norm_num_groups", 32),
      scaling_factor=va.get("scaling_factor", 0.18215),
    ),
    sample_size=un.get("sample_size", 64),
    prediction_type=sc.get("prediction_type", "epsilon"),
    num_train_timesteps=sc.get("num_train_timesteps", 1000),
    beta_start=sc.get("beta_start", 0.00085),
    beta_end=sc.get("beta_end", 0.012),
    beta_schedule=sc.get("beta_schedule", "scaled_linear"),
    set_alpha_to_one=bool(sc.get("set_alpha_to_one", False)),
    steps_offset=int(sc.get("steps_offset", 0)),
  )


def load_diffusion_params(model_dir: Path, cfg: DiffusionConfig, dtype=torch.float32, device=None) -> Params:
  model_dir = Path(model_dir)
  return {
    "clip": load_clip_text(model_dir / "text_encoder", cfg.clip, dtype, device),
    "unet": load_unet(model_dir / "unet", cfg.unet, dtype, device),
    "vae": load_vae(model_dir / "vae", cfg.vae, dtype, device),
  }


# ------------------------------------------------- diffusers-format export
# The loader's name map the other way: a params tree written out as a
# diffusers directory, each tensor in the tree's dtype.


def _export_resnet(sd: dict, prefix: str, p: Params) -> None:
  names = {"norm1_s": "norm1.weight", "norm1_b": "norm1.bias", "conv1_w": "conv1.weight", "conv1_b": "conv1.bias",
           "norm2_s": "norm2.weight", "norm2_b": "norm2.bias", "conv2_w": "conv2.weight", "conv2_b": "conv2.bias",
           "time_w": "time_emb_proj.weight", "time_b": "time_emb_proj.bias", "skip_w": "conv_shortcut.weight", "skip_b": "conv_shortcut.bias"}
  for key, hf in names.items():
    if key in p:
      sd[f"{prefix}.{hf}"] = p[key]


def _export_tx(sd: dict, prefix: str, p: Params) -> None:
  tb = f"{prefix}.transformer_blocks.0"
  sd.update({
    f"{prefix}.norm.weight": p["norm_s"], f"{prefix}.norm.bias": p["norm_b"],
    f"{prefix}.proj_in.weight": p["proj_in_w"], f"{prefix}.proj_in.bias": p["proj_in_b"],
    f"{prefix}.proj_out.weight": p["proj_out_w"], f"{prefix}.proj_out.bias": p["proj_out_b"],
    f"{tb}.ff.net.0.proj.weight": p["ff_w1"], f"{tb}.ff.net.0.proj.bias": p["ff_b1"],
    f"{tb}.ff.net.2.weight": p["ff_w2"], f"{tb}.ff.net.2.bias": p["ff_b2"],
  })
  for i in "123":
    sd[f"{tb}.norm{i}.weight"], sd[f"{tb}.norm{i}.bias"] = p[f"ln{i}_s"], p[f"ln{i}_b"]
  for i in "12":
    for w, hf in (("wq", "to_q"), ("wk", "to_k"), ("wv", "to_v"), ("wo", "to_out.0")):
      sd[f"{tb}.attn{i}.{hf}.weight"] = p[f"attn{i}_{w}"]
    sd[f"{tb}.attn{i}.to_out.0.bias"] = p[f"attn{i}_bo"]


def _export_blocks(sd: dict, prefix: str, blocks: list, sampler: str, key: str, tx: bool) -> None:
  for li, blk in enumerate(blocks):
    for ri, rp in enumerate(blk["resnets"]):
      _export_resnet(sd, f"{prefix}.{li}.resnets.{ri}", rp)
    for ri, ap in enumerate(blk.get("attns", []) if tx else []):
      _export_tx(sd, f"{prefix}.{li}.attentions.{ri}", ap)
    if f"{key}_w" in blk:
      sd[f"{prefix}.{li}.{sampler}.0.conv.weight"], sd[f"{prefix}.{li}.{sampler}.0.conv.bias"] = blk[f"{key}_w"], blk[f"{key}_b"]


def export_diffusers_checkpoint(out_dir: Path, cfg: DiffusionConfig, params: Params) -> None:
  out_dir = Path(out_dir)
  out_dir.mkdir(parents=True, exist_ok=True)
  (out_dir / "model_index.json").write_text(json.dumps({"_class_name": "StableDiffusionPipeline"}))

  # the text encoder, under transformers' CLIPTextModel names
  clip = params["clip"]
  sd = {
    "text_model.embeddings.token_embedding.weight": clip["tok_emb"],
    "text_model.embeddings.position_embedding.weight": clip["pos_emb"],
    "text_model.final_layer_norm.weight": clip["final_ln_s"],
    "text_model.final_layer_norm.bias": clip["final_ln_b"],
  }
  names = [
    ("layer_norm1.weight", "ln1_s"), ("layer_norm1.bias", "ln1_b"),
    ("self_attn.q_proj.weight", "wq"), ("self_attn.q_proj.bias", "bq"),
    ("self_attn.k_proj.weight", "wk"), ("self_attn.k_proj.bias", "bk"),
    ("self_attn.v_proj.weight", "wv"), ("self_attn.v_proj.bias", "bv"),
    ("self_attn.out_proj.weight", "wo"), ("self_attn.out_proj.bias", "bo"),
    ("layer_norm2.weight", "ln2_s"), ("layer_norm2.bias", "ln2_b"),
    ("mlp.fc1.weight", "w_fc1"), ("mlp.fc1.bias", "b_fc1"),
    ("mlp.fc2.weight", "w_fc2"), ("mlp.fc2.bias", "b_fc2"),
  ]
  for i in range(cfg.clip.n_layers):
    for hf, key in names:
      sd[f"text_model.encoder.layers.{i}.{hf}"] = clip["layers"][key][i]
  (out_dir / "text_encoder").mkdir(exist_ok=True)
  save_safetensors(out_dir / "text_encoder" / "model.safetensors", sd)
  (out_dir / "text_encoder" / "config.json").write_text(json.dumps({
    "vocab_size": cfg.clip.vocab_size, "hidden_size": cfg.clip.hidden_size,
    "intermediate_size": cfg.clip.intermediate_size, "num_hidden_layers": cfg.clip.n_layers,
    "num_attention_heads": cfg.clip.n_heads, "max_position_embeddings": cfg.clip.max_positions,
    "layer_norm_eps": cfg.clip.layer_norm_eps, "hidden_act": cfg.clip.act,
  }))

  unet = params["unet"]
  sd = {
    "conv_in.weight": unet["conv_in_w"], "conv_in.bias": unet["conv_in_b"],
    "time_embedding.linear_1.weight": unet["time_w1"], "time_embedding.linear_1.bias": unet["time_b1"],
    "time_embedding.linear_2.weight": unet["time_w2"], "time_embedding.linear_2.bias": unet["time_b2"],
    "conv_norm_out.weight": unet["norm_out_s"], "conv_norm_out.bias": unet["norm_out_b"],
    "conv_out.weight": unet["conv_out_w"], "conv_out.bias": unet["conv_out_b"],
  }
  _export_blocks(sd, "down_blocks", unet["down"], "downsamplers", "down", tx=True)
  _export_resnet(sd, "mid_block.resnets.0", unet["mid"]["resnet1"])
  _export_tx(sd, "mid_block.attentions.0", unet["mid"]["attn"])
  _export_resnet(sd, "mid_block.resnets.1", unet["mid"]["resnet2"])
  _export_blocks(sd, "up_blocks", unet["up"], "upsamplers", "up", tx=True)
  (out_dir / "unet").mkdir(exist_ok=True)
  save_safetensors(out_dir / "unet" / "diffusion_pytorch_model.safetensors", sd)
  (out_dir / "unet" / "config.json").write_text(json.dumps({
    "in_channels": cfg.unet.in_channels, "out_channels": cfg.unet.out_channels,
    "block_out_channels": list(cfg.unet.block_out_channels),
    "layers_per_block": cfg.unet.layers_per_block,
    "cross_attention_dim": cfg.unet.cross_attention_dim,
    # per-level head counts under the key diffusers accepts: its
    # UNet2DConditionModel refuses num_attention_heads and reads the
    # misnamed attention_head_dim as head counts
    "attention_head_dim": [cfg.unet.heads_at(i) for i in range(len(cfg.unet.block_out_channels))],
    "norm_num_groups": cfg.unet.norm_groups, "norm_eps": cfg.unet.norm_eps,
    "down_block_types": ["CrossAttnDownBlock2D" if c else "DownBlock2D" for c in cfg.unet.cross_levels],
    "sample_size": cfg.sample_size,
  }))

  vae = params["vae"]
  sd = {
    "quant_conv.weight": vae["quant_w"], "quant_conv.bias": vae["quant_b"],
    "post_quant_conv.weight": vae["post_quant_w"], "post_quant_conv.bias": vae["post_quant_b"],
  }
  for side, key, sampler in (("encoder", "down", "downsamplers"), ("decoder", "up", "upsamplers")):
    half = vae[side]
    sd[f"{side}.conv_in.weight"], sd[f"{side}.conv_in.bias"] = half["conv_in_w"], half["conv_in_b"]
    _export_resnet(sd, f"{side}.mid_block.resnets.0", half["mid_resnet1"])
    attn, ap = half["mid_attn"], f"{side}.mid_block.attentions.0"
    sd[f"{ap}.group_norm.weight"], sd[f"{ap}.group_norm.bias"] = attn["norm_s"], attn["norm_b"]
    for hf, w in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out.0", "o")):
      sd[f"{ap}.{hf}.weight"], sd[f"{ap}.{hf}.bias"] = attn[f"w{w}"], attn[f"b{w}"]
    _export_resnet(sd, f"{side}.mid_block.resnets.1", half["mid_resnet2"])
    sd[f"{side}.conv_norm_out.weight"], sd[f"{side}.conv_norm_out.bias"] = half["norm_out_s"], half["norm_out_b"]
    sd[f"{side}.conv_out.weight"], sd[f"{side}.conv_out.bias"] = half["conv_out_w"], half["conv_out_b"]
    _export_blocks(sd, f"{side}.{key}_blocks", half[key], sampler, key, tx=False)
  (out_dir / "vae").mkdir(exist_ok=True)
  save_safetensors(out_dir / "vae" / "diffusion_pytorch_model.safetensors", sd)
  (out_dir / "vae" / "config.json").write_text(json.dumps({
    "in_channels": cfg.vae.in_channels, "latent_channels": cfg.vae.latent_channels,
    "block_out_channels": list(cfg.vae.block_out_channels),
    "layers_per_block": cfg.vae.layers_per_block,
    "norm_num_groups": cfg.vae.norm_groups, "scaling_factor": cfg.vae.scaling_factor,
  }))

  (out_dir / "scheduler").mkdir(exist_ok=True)
  (out_dir / "scheduler" / "scheduler_config.json").write_text(json.dumps({
    "prediction_type": cfg.prediction_type, "num_train_timesteps": cfg.num_train_timesteps,
    "beta_start": cfg.beta_start, "beta_end": cfg.beta_end,
    "beta_schedule": cfg.beta_schedule, "set_alpha_to_one": cfg.set_alpha_to_one,
    "steps_offset": cfg.steps_offset,
  }))
