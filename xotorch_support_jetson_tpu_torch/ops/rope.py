"""Rotary position embeddings with llama3 / yarn / longrope frequency
scaling, HF half-rotation pairing (channel i pairs with i + rot/2), as pure
functions of positions. Counterpart of the reference's ``ops/rope.py``."""

from __future__ import annotations

import functools
import math

import torch

from ..models.config import LongRopeScaling, ModelConfig, RopeScaling, YarnScaling


def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
  """[rot_dim/2] f32 inverse frequencies, with optional llama3/yarn/longrope
  scaling. Cached per (config, device): the forward asks for it on every
  step, and a fresh host→device copy each time would be wasted work. Callers
  must not modify the returned tensor."""
  return _inv_freq(cfg, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=32)
def _inv_freq(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
  rot_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
  half = rot_dim // 2
  if isinstance(cfg.rope_scaling, YarnScaling):
    return _yarn_inv_freq(rot_dim, cfg.rope_theta, cfg.rope_scaling).to(device)
  inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32) / half))
  if isinstance(cfg.rope_scaling, LongRopeScaling):
    s = cfg.rope_scaling
    ext = s.short_factor if cfg.max_seq_len <= s.original_max_position_embeddings else s.long_factor
    inv_freq = inv_freq / torch.tensor(ext, dtype=torch.float32)
  elif isinstance(cfg.rope_scaling, RopeScaling):
    inv_freq = _llama3_scale(inv_freq, cfg.rope_scaling)
  return inv_freq.to(device)


def rope_attention_factor(cfg: ModelConfig) -> float:
  """Yarn/longrope post-scaling of cos/sin; 1.0 otherwise."""
  return cfg.rope_scaling.attention_factor if isinstance(cfg.rope_scaling, (YarnScaling, LongRopeScaling)) else 1.0


def _yarn_inv_freq(dim: int, base: float, s: YarnScaling) -> torch.Tensor:
  def correction_dim(num_rotations: float) -> float:
    return (dim * math.log(s.original_max_position_embeddings / (num_rotations * 2 * math.pi))) / (2 * math.log(base))

  low = correction_dim(s.beta_fast)
  high = correction_dim(s.beta_slow)
  if s.truncate:
    low, high = math.floor(low), math.ceil(high)
  low, high = max(low, 0), min(high, dim - 1)
  if low == high:
    high += 0.001  # prevent singularity
  pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
  inv_extrapolation = 1.0 / pos_freqs
  inv_interpolation = 1.0 / (s.factor * pos_freqs)
  ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0.0, 1.0)
  extrapolation_factor = 1.0 - ramp
  return inv_interpolation * (1.0 - extrapolation_factor) + inv_extrapolation * extrapolation_factor


def _llama3_scale(inv_freq: torch.Tensor, s: RopeScaling) -> torch.Tensor:
  wavelen = 2.0 * math.pi / inv_freq
  low_wavelen = s.original_max_position_embeddings / s.low_freq_factor
  high_wavelen = s.original_max_position_embeddings / s.high_freq_factor
  smooth = (s.original_max_position_embeddings / wavelen - s.low_freq_factor) / (s.high_freq_factor - s.low_freq_factor)
  scaled_mid = (1.0 - smooth) * inv_freq / s.factor + smooth * inv_freq
  out = torch.where(wavelen > low_wavelen, inv_freq / s.factor, inv_freq)
  is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
  return torch.where(is_mid, scaled_mid, out)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor, attn_factor: float = 1.0) -> torch.Tensor:
  """Rotate ``x`` [..., S, H, head_dim] by angles from ``positions`` [..., S].

  (x1, x2) = split(x, 2); out = (x1·cos − x2·sin, x2·cos + x1·sin). When
  ``inv_freq`` covers fewer than head_dim/2 frequencies only the leading
  2·|inv_freq| channels rotate; the tail passes through.
  """
  rot = 2 * inv_freq.shape[-1]
  tail = None
  if rot < x.shape[-1]:
    x, tail = x[..., :rot], x[..., rot:]
  angles = positions[..., :, None].float() * inv_freq[None, :]  # [..., S, half]
  cos = (torch.cos(angles) * attn_factor).unsqueeze(-2)  # [..., S, 1, half]
  sin = (torch.sin(angles) * attn_factor).unsqueeze(-2)
  x1, x2 = x.float().chunk(2, dim=-1)
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
  return out if tail is None else torch.cat([out, tail], dim=-1)
