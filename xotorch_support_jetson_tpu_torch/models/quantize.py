"""KV-cache quantization, int8 and packed int4 (counterparts of ``quantize_kv`` /
``dequantize_kv`` in the reference's ``models/quantize.py``).

K/V vectors quantize at cache-write time, symmetric int8 per (token, head);
the scale rides as a sibling cache leaf with a trailing [..., 1] axis. The
attention read keeps the codes and applies the scales outside the
contraction (ops/attention.py gqa_attention, the K1 kernel's int8 variant).
"""

from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """x [..., hd] → (codes int8 [..., hd], scale f32 [..., 1])."""
  xf = x.float()
  absmax = xf.abs().amax(dim=-1, keepdim=True)
  scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
  return torch.round(xf / scale).to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
  """codes [..., hd] × scale [..., 1] → [..., hd] in ``dtype``."""
  return (codes.float() * scale).to(dtype)


# int4 KV: two 4-bit codes per int8 byte along the head dim (channel 2i in
# the low nibble, 2i+1 in the high), one f32 scale per (token, head) — the
# int8 scale machinery consumes the codes once they are unpacked to int8
# values in [-8, 7] (counterpart of the reference's quantize_kv_int4 /
# unpack_int4_kv).


def quantize_kv_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """x [..., hd] → (packed int8 [..., hd/2], scale f32 [..., 1])."""
  if x.shape[-1] % 2:
    raise ValueError(f"int4 KV packing needs an even head dim; got {tuple(x.shape)}")
  xf = x.float()
  absmax = xf.abs().amax(dim=-1, keepdim=True)
  scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
  q = torch.clamp(torch.round(xf / scale), -8, 7).to(torch.int8)
  lo = q[..., 0::2] & 0x0F
  hi = (q[..., 1::2] & 0x0F) << 4
  return (lo | hi).to(torch.int8), scale


def unpack_int4_kv(packed: torch.Tensor) -> torch.Tensor:
  """packed int8 [..., hd/2] → int8 codes [..., hd] (sign-extended, channel
  order restored)."""
  lo = (packed << 4) >> 4  # arithmetic shifts on int8 sign-extend the nibble
  hi = packed >> 4
  return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)
