"""Token sampling: temperature + top-k + top-p, and greedy. Counterpart of
the reference's ``ops/sampling.py``; the random stream comes from an
explicit ``torch.Generator`` (Philox on the card), so sampled streams match
the reference's support set, not its bits."""

from __future__ import annotations

import torch

DEFAULT_TEMP = 0.6
DEFAULT_TOP_K = 35
NEG_INF = -1e30


def sample_logits(
  logits: torch.Tensor,  # [B, V]
  generator: torch.Generator | None = None,
  temp: float = DEFAULT_TEMP,
  top_k: int = DEFAULT_TOP_K,
  top_p: float = 1.0,
) -> torch.Tensor:
  """Returns sampled token ids [B] (int32); callers route temp<=0 to ``greedy``."""
  logits = logits.float() / max(float(temp), 1e-6)
  if top_k and top_k > 0:
    k = min(int(top_k), logits.shape[-1])
    vals, idxs = torch.topk(logits, k, dim=-1)  # [B, k] descending
    vals = _apply_top_p(vals, top_p)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=generator)  # [B, 1]
    return torch.gather(idxs, -1, choice)[:, 0].to(torch.int32)
  masked = _apply_top_p_full(logits, top_p)
  return torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)[:, 0].to(torch.int32)


def _apply_top_p(sorted_vals: torch.Tensor, top_p: float) -> torch.Tensor:
  """Mask the tail of descending-sorted logits whose cumulative prob exceeds top_p."""
  probs = torch.softmax(sorted_vals, dim=-1)
  cum = torch.cumsum(probs, dim=-1)
  keep = (cum - probs) < top_p  # always keeps the first token
  return torch.where(keep, sorted_vals, torch.full_like(sorted_vals, NEG_INF))


def _apply_top_p_full(logits: torch.Tensor, top_p: float) -> torch.Tensor:
  sorted_vals, sort_idx = torch.sort(logits, dim=-1, descending=True)
  masked = _apply_top_p(sorted_vals, top_p)
  return torch.empty_like(masked).scatter_(-1, sort_idx, masked)


def greedy(logits: torch.Tensor) -> torch.Tensor:
  return torch.argmax(logits, dim=-1).to(torch.int32)
