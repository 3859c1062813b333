"""int8 KV-cache quantization (counterpart of ``quantize_kv`` /
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
