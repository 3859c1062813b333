"""RMSNorm in fp32 accumulation (the llama-family norm)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  x32 = x.float()
  rms = torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
  return ((x32 / rms) * weight.float()).to(x.dtype)
