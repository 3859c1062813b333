"""The JAX package's parameter tree → the port's parameters.

``params_from_jax`` takes the reference decoder's params as numpy arrays
(stacked ``[L, ...]`` layer leaves, ``x @ w`` orientation — the two layouts
already agree) and returns torch tensors in ``cfg.dtype`` on ``device``, so
the tests run both packages on identical weights. A weight-quantized tree
(``quantize_params``) carries across as it is: int8 codes (packed int4
too) stay int8 and the ``<name>_scale`` leaves stay f32. An MoE tree's
``moe_layers`` stack comes across with its router, experts and shared
experts; ``router_bias`` stays f32. An MLA (deepseek) stack carries its
latent projections (``wq`` or ``wq_a`` / ``q_a_norm`` / ``wq_b``,
``wkv_a``, ``kv_a_norm``, ``wkv_b``) and their scales. The stacked
multi-LoRA slots a serving engine adds (``{wq,wv}_alora_{a,b}`` [L,
n_slots, ...], inference/adapters.py) come across in ``cfg.dtype``, never
quantized, so a test builds the port's adapter state from the reference
engine's. A llava tree's ``vision`` (its nested ``layers`` stack) and
``projector`` groups come across leaf for leaf in ``cfg.dtype``; weight
quantization leaves them alone in both packages.
``diffusion_params_from_jax`` carries a stable-diffusion tree across
(models/diffusion.py's layouts). The input is plain numpy
(bf16 arrives as an ``ml_dtypes`` array and is reinterpreted bit for bit),
so this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inference.shard import Shard
from .config import ModelConfig
from .decoder import Params
from .loader import check_shard_params

_QUANT_LAYER_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
_QUANT_MOE_KEYS = {"w_experts_gate", "w_experts_up", "w_experts_down", "w_shared_gate", "w_shared_up", "w_shared_down"}
_NORM_KEYS = {"attn_norm", "post_attn_norm", "mlp_norm", "post_mlp_norm", "final_norm"}
_MLA_KEYS = {"wq_a", "wq_b", "wkv_a", "wkv_b"}
_ADAPTER_KEYS = {f"{t}_alora_{f}" for t in ("wq", "wv") for f in "ab"}
_ATTN_KEYS = {
  *_NORM_KEYS - {"final_norm"}, "bq", "bk", "bv", "q_norm", "k_norm", "is_sliding", "q_a_norm", "kv_a_norm", *_MLA_KEYS,
  *(f"{k}_scale" for k in ("wq", "wk", "wv", "wo", *_MLA_KEYS)), *_ADAPTER_KEYS,
}
_STACK_KEYS = {
  "layers": {*_ATTN_KEYS, *_QUANT_LAYER_KEYS, *(f"{k}_scale" for k in _QUANT_LAYER_KEYS)},
  "moe_layers": {*_ATTN_KEYS, "wq", "wk", "wv", "wo", "w_router", "router_bias", "w_shared_expert_gate", *_QUANT_MOE_KEYS, *(f"{k}_scale" for k in _QUANT_MOE_KEYS)},
}
_TOP_KEYS = {"embed", "final_norm", "lm_head", "lm_head_scale"}
_VISION_GROUPS = ("vision", "projector")


def _leaf(key: str, arr, cfg: ModelConfig, device) -> torch.Tensor:
  """Quantization codes stay int8; scales, gemma2's sliding flags and its
  norm gains (``1 + w``, held in f32 as the loaders hold them) and the
  router's selection bias stay f32; every other leaf goes to
  ``cfg.dtype``."""
  if np.asarray(arr).dtype == np.int8:
    return _tensor(arr, torch.int8, device)
  f32 = key.endswith("_scale") or key in ("is_sliding", "router_bias") or (cfg.post_norms and key in _NORM_KEYS)
  return _tensor(arr, torch.float32 if f32 else cfg.dtype, device)


def _tensor(arr, dtype, device) -> torch.Tensor:
  arr = np.array(arr, copy=True, order="C")  # writable and contiguous
  if arr.dtype.name == "bfloat16":
    t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
  else:
    t = torch.from_numpy(arr)
  return t.to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg: ModelConfig, shard: Shard, device=None) -> Params:
  unknown = set(np_params) - _TOP_KEYS - set(_STACK_KEYS) - set(_VISION_GROUPS)
  for name, keys in _STACK_KEYS.items():
    unknown |= {f"{name}/{k}" for k in set(np_params.get(name, {})) - keys}
  if unknown:
    raise NotImplementedError(f"the PyTorch port has no counterpart for these parameter leaves yet: {sorted(unknown)}")
  params: Params = {name: {k: _leaf(k, v, cfg, device) for k, v in np_params[name].items()} for name in _STACK_KEYS if name in np_params}
  for key in _TOP_KEYS & set(np_params):
    params[key] = _leaf(key, np_params[key], cfg, device)

  def tree(group: dict) -> dict:
    return {k: tree(v) if isinstance(v, dict) else _tensor(v, cfg.dtype, device) for k, v in group.items()}

  for name in _VISION_GROUPS:
    if name in np_params:
      params[name] = tree(np_params[name])
  check_shard_params(params, cfg, shard)
  return params


def diffusion_params_from_jax(np_params: dict, cfg, device=None, dtype=torch.float32) -> dict:
  """The reference's stable-diffusion tree (``clip``, ``unet``, ``vae``) →
  the port's (models/diffusion.py): HWIO convolutions become OIHW, ``[in,
  out]`` linears ``[out, in]`` (the stacked CLIP layers' ``[L, in, out]``
  become ``[L, out, in]``); vectors, norm gains and the CLIP embeddings
  keep their shape. ``cfg`` is the model's DiffusionConfig (the leaves
  carry their own shapes; it is checked against the token embedding)."""

  def leaf(arr, clip: bool) -> torch.Tensor:
    t = _tensor(arr, dtype, device)
    if t.ndim == 4:
      return t.permute(3, 2, 0, 1).contiguous()
    if (t.ndim == 2 and not clip) or t.ndim == 3:
      return t.transpose(-1, -2).contiguous()
    return t

  def tree(node, clip: bool):
    if isinstance(node, dict):
      return {k: tree(v, clip) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
      return [tree(v, clip) for v in node]
    return leaf(node, clip)

  clip = {k: (tree(v, clip=True) if k == "layers" else _tensor(v, dtype, device)) for k, v in np_params["clip"].items()}
  if tuple(clip["tok_emb"].shape) != (cfg.clip.vocab_size, cfg.clip.hidden_size):
    raise ValueError(f"token embedding {tuple(clip['tok_emb'].shape)} does not match the config's {(cfg.clip.vocab_size, cfg.clip.hidden_size)}")
  return {"clip": clip, "unet": tree(np_params["unet"], clip=False), "vae": tree(np_params["vae"], clip=False)}
