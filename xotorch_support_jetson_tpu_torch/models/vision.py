"""llava's vision path: the CLIP ViT tower, the multi-modal projector, the
merge of image features into the prompt's embeddings, and llava-next's
any-res packing.

Counterpart of the reference's ``models/vision.py``, in plain PyTorch:

- the patch embedding is one strided convolution;
- pre-norm CLIP layers (bidirectional multi-head attention, quick-GELU
  MLP), run one after another from the stacked ``[L, ...]`` leaves; the
  attention is two f32 einsums around an f32 softmax, as the reference's
  (it has no Pallas kernel there, and the port writes none);
- the features are the hidden state entering layer ``feature_layer`` (HF
  ``vision_feature_layer``, -2: every layer but the last runs), with the
  CLS position dropped under the "default" select strategy;
- the projector is linear, exact GELU, linear.

Layer norm, softmax, quick-GELU and the projector's GELU compute in f32
and cast back, as the reference's do. Parameters are two plain dicts of
tensors in the reference's layout (``x @ w``): ``vision`` (``patch_embed``
[D, 3, p, p], ``class_embed`` [D], ``pos_embed`` [n_patches + 1, D], the
pre-norm and the ``layers`` stack) and ``projector`` (``w1``, ``b1``,
``w2``, ``b2``, and llava-next's ``image_newline``).

``merge_image_embeddings`` keeps the reference's fixed-shape rank gather (no
boolean indexing), so the merge is one set of shapes per prompt bucket.
The any-res helpers (``select_best_resolution``, ``anyres_grid_shape``,
``_unpad_grid``, ``pack_anyres_features``) follow HF's
``LlavaNextForConditionalGeneration.pack_image_features``; the tiles
themselves go through ``encode_images`` as one batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

Params = dict


@dataclass(frozen=True)
class VisionConfig:
  hidden_size: int
  intermediate_size: int
  n_layers: int
  n_heads: int
  image_size: int
  patch_size: int
  layer_norm_eps: float = 1e-5
  feature_layer: int = -2  # HF vision_feature_layer
  drop_cls: bool = True  # vision_feature_select_strategy == "default"
  projector_dim: int = 0  # the text embedding width
  # llava-next (1.6) any-res tiling: the image is resized onto the best
  # grid pinpoint and split into image_size tiles; the tiles' features are
  # re-assembled spatially, unpadded, with a learned newline per row.
  anyres: bool = False
  grid_pinpoints: tuple[tuple[int, int], ...] = ()

  @property
  def n_patches(self) -> int:
    return (self.image_size // self.patch_size) ** 2

  @property
  def n_run(self) -> int:
    """The tower layers that run: those before ``feature_layer``."""
    return self.n_layers + 1 + self.feature_layer if self.feature_layer < 0 else self.feature_layer


def vision_config_from_hf(vision_hf: dict, text_dim: int, top: dict | None = None) -> VisionConfig:
  top = top or {}
  return VisionConfig(
    hidden_size=int(vision_hf["hidden_size"]),
    intermediate_size=int(vision_hf["intermediate_size"]),
    n_layers=int(vision_hf["num_hidden_layers"]),
    n_heads=int(vision_hf["num_attention_heads"]),
    image_size=int(vision_hf.get("image_size", 336)),
    patch_size=int(vision_hf.get("patch_size", 14)),
    layer_norm_eps=float(vision_hf.get("layer_norm_eps", 1e-5)),
    feature_layer=int(top.get("vision_feature_layer", -2)),
    drop_cls=top.get("vision_feature_select_strategy", "default") == "default",
    projector_dim=text_dim,
    anyres=top.get("model_type") == "llava_next" or bool(top.get("image_grid_pinpoints")),
    grid_pinpoints=tuple(tuple(int(v) for v in p) for p in top.get("image_grid_pinpoints") or ()),
  )


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
  xf = x.float()
  mean = xf.mean(dim=-1, keepdim=True)
  var = xf.var(dim=-1, keepdim=True, unbiased=False)
  return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
  xf = x.float()
  return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def _vit_layer(h: torch.Tensor, p: Params, vcfg: VisionConfig) -> torch.Tensor:
  """One pre-norm CLIP encoder layer (bidirectional MHA + quick-GELU MLP)."""
  B, S, D = h.shape
  H = vcfg.n_heads
  hd = D // H
  x = _layer_norm(h, p["ln1_scale"], p["ln1_bias"], vcfg.layer_norm_eps)
  q = (x @ p["wq"] + p["bq"]).reshape(B, S, H, hd)
  k = (x @ p["wk"] + p["bk"]).reshape(B, S, H, hd)
  v = (x @ p["wv"] + p["bv"]).reshape(B, S, H, hd)
  scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
  probs = torch.softmax(scores, dim=-1)
  attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(h.dtype)
  h = h + (attn.reshape(B, S, D) @ p["wo"] + p["bo"])
  x = _layer_norm(h, p["ln2_scale"], p["ln2_bias"], vcfg.layer_norm_eps)
  return h + (_quick_gelu(x @ p["fc1"] + p["bfc1"]) @ p["fc2"] + p["bfc2"])


def encode_images(vision: Params, projector: Params, vcfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
  """pixel_values [B, 3, H, W] (the HF processor's layout) → image features
  [B, n_patches, text_dim] in the tower's dtype: the tower up to
  ``feature_layer``, CLS dropped, projected into the text space."""
  B = pixel_values.shape[0]
  dtype = vision["patch_embed"].dtype
  patches = torch.nn.functional.conv2d(pixel_values.to(device=vision["patch_embed"].device, dtype=dtype), vision["patch_embed"], stride=vcfg.patch_size)
  patches = patches.reshape(B, vcfg.hidden_size, -1).transpose(1, 2)  # [B, n_patches, D]
  cls = vision["class_embed"].to(dtype).expand(B, 1, vcfg.hidden_size)
  h = torch.cat([cls, patches], dim=1) + vision["pos_embed"].to(dtype)[None]
  h = _layer_norm(h, vision["pre_ln_scale"], vision["pre_ln_bias"], vcfg.layer_norm_eps)
  layers = vision["layers"]
  for i in range(vcfg.n_run):
    h = _vit_layer(h, {k: v[i] for k, v in layers.items()}, vcfg)
  if vcfg.drop_cls:
    h = h[:, 1:, :]
  h = torch.nn.functional.gelu((h @ projector["w1"] + projector["b1"]).float()).to(h.dtype)
  return h @ projector["w2"] + projector["b2"]


def merge_image_embeddings(embeds: torch.Tensor, tokens: torch.Tensor, image_features: torch.Tensor, image_token_id: int) -> torch.Tensor:
  """Image features into the token embeddings [B, S, D] at every
  ``image_token_id`` position of ``tokens`` [B, S], in order: each
  position's rank among the image positions indexes the flattened features
  (fixed shapes, no boolean indexing)."""
  D = embeds.shape[-1]
  is_img = tokens == image_token_id
  rank = torch.cumsum(is_img.to(torch.int32), dim=1) - 1
  flat = image_features.reshape(-1, D)
  idx = rank.clamp(0, flat.shape[0] - 1).long()
  gathered = flat[idx].to(embeds.dtype)  # [B, S, D]
  return torch.where(is_img[..., None], gathered, embeds)


def init_vision_params(generator: torch.Generator, vcfg: VisionConfig, dtype=torch.float32, device=None) -> tuple[Params, Params]:
  """Random tower and projector (tests): N(0, 0.02) weights, unit norm
  gains, zero biases."""
  D, F, L = vcfg.hidden_size, vcfg.intermediate_size, vcfg.n_layers

  def w(*shape):
    return (torch.randn(shape, generator=generator) * 0.02).to(device=device, dtype=dtype)

  def ones(*shape):
    return torch.ones(shape, dtype=dtype, device=device)

  def zeros(*shape):
    return torch.zeros(shape, dtype=dtype, device=device)

  vision = {
    "patch_embed": w(D, 3, vcfg.patch_size, vcfg.patch_size),
    "class_embed": w(D),
    "pos_embed": w(vcfg.n_patches + 1, D),
    "pre_ln_scale": ones(D),
    "pre_ln_bias": zeros(D),
    "layers": {
      "ln1_scale": ones(L, D), "ln1_bias": zeros(L, D),
      "wq": w(L, D, D), "bq": zeros(L, D), "wk": w(L, D, D), "bk": zeros(L, D), "wv": w(L, D, D), "bv": zeros(L, D), "wo": w(L, D, D), "bo": zeros(L, D),
      "ln2_scale": ones(L, D), "ln2_bias": zeros(L, D),
      "fc1": w(L, D, F), "bfc1": zeros(L, F), "fc2": w(L, F, D), "bfc2": zeros(L, D),
    },
  }
  P = vcfg.projector_dim
  projector = {"w1": w(D, P), "b1": zeros(P), "w2": w(P, P), "b2": zeros(P)}
  return vision, projector


# ------------------------------------------------------- llava-next any-res
# Small host-side bookkeeping: the tile batch through the tower
# (encode_images) is the device work.


def select_best_resolution(original_size: tuple[int, int], pinpoints) -> tuple[int, int]:
  """(h, w) → the grid pinpoint with the most effective, then the fewest
  wasted, pixels."""
  oh, ow = original_size
  best, best_fit, min_waste = None, -1, None
  for height, width in pinpoints:
    scale = min(width / ow, height / oh)
    dw, dh = int(ow * scale), int(oh * scale)
    effective = min(dw * dh, ow * oh)
    wasted = width * height - effective
    if effective > best_fit or (effective == best_fit and (min_waste is None or wasted < min_waste)):
      best, best_fit, min_waste = (height, width), effective, wasted
  return best


def anyres_grid_shape(original_size: tuple[int, int], pinpoints, tile_size: int) -> tuple[int, int]:
  """→ (tiles_h, tiles_w) of the selected pinpoint canvas."""
  bh, bw = select_best_resolution(original_size, pinpoints)
  return bh // tile_size, bw // tile_size


def _unpad_grid(grid: torch.Tensor, original_size: tuple[int, int]) -> torch.Tensor:
  """grid [H, W, D]: crop the padding the aspect-preserving resize added."""
  oh, ow = original_size
  ch, cw = grid.shape[0], grid.shape[1]
  if ow / oh > cw / ch:
    new_h = int(round(oh * (cw / ow), 7))
    pad = (ch - new_h) // 2
    return grid[pad : ch - pad, :, :]
  new_w = int(round(ow * (ch / oh), 7))
  pad = (cw - new_w) // 2
  return grid[:, pad : cw - pad, :]


def pack_anyres_features(tile_feats: torch.Tensor, original_size: tuple[int, int], vcfg: VisionConfig, image_newline: torch.Tensor) -> torch.Tensor:
  """tile_feats [T, P, D] (1 base tile + the grid's tiles, P patches a
  tile) → packed [n, D]: the base tile's features, then the unpadded
  spatial grid with a newline feature closing each row."""
  p = vcfg.image_size // vcfg.patch_size
  d = tile_feats.shape[-1]
  gh, gw = anyres_grid_shape(original_size, vcfg.grid_pinpoints, vcfg.image_size)
  grid = tile_feats[1 : 1 + gh * gw].reshape(gh, gw, p, p, d).permute(0, 2, 1, 3, 4).reshape(gh * p, gw * p, d)
  grid = _unpad_grid(grid, original_size)
  newline = image_newline.to(grid.dtype).expand(grid.shape[0], 1, d)
  grid = torch.cat([grid, newline], dim=1)
  return torch.cat([tile_feats[0], grid.reshape(-1, d)], dim=0)
