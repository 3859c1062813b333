"""Token sampling: temperature + top-k + top-p, per-row temperature and
top-k for batched serving, and greedy. Counterpart of the reference's
``ops/sampling.py``; the random stream comes from an explicit
``torch.Generator`` (Philox on the card), so sampled streams match the
reference's support set, not its bits.

As in the reference, ``temp`` may live on the device (a 0-dim tensor) while
``top_k`` is static: the captured decode step (models/decoder.py
``SoloPrograms``) reads the temperature from a buffer filled before each
replay, so one graph serves every temperature, and ``top_k`` and greedy
pick the graph. Nothing here reads a device value on the host."""

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
  """Returns sampled token ids [B] (int32); callers route temp<=0 to
  ``greedy``. ``temp`` is a float or a 0-dim f32 tensor on the logits'
  device."""
  t = temp.clamp(min=1e-6) if isinstance(temp, torch.Tensor) else max(float(temp), 1e-6)
  logits = logits.float() / t
  if top_k and top_k > 0:
    k = min(int(top_k), logits.shape[-1])
    vals, idxs = torch.topk(logits, k, dim=-1)  # [B, k] descending
    vals = _apply_top_p(vals, top_p)
    return torch.gather(idxs, -1, _draw(vals, generator))[:, 0].to(torch.int32)
  return _draw(_apply_top_p_full(logits, top_p), generator)[:, 0].to(torch.int32)


def _draw(logits: torch.Tensor, generator) -> torch.Tensor:
  """One index per row from softmax(logits), [B, 1]: the argmax of p / q
  with q ~ Exp(1), which is how ``torch.multinomial`` draws one sample
  (same generator use), written out because multinomial checks its input
  with a host read, which a CUDA-graph capture does not allow."""
  probs = torch.softmax(logits, dim=-1)
  q = torch.empty_like(probs).exponential_(generator=generator)
  return torch.argmax(probs / q, dim=-1, keepdim=True)


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


def sample_logits_per_row(
  logits: torch.Tensor,  # [B, V]
  generator: torch.Generator | None,
  temps: torch.Tensor,  # [B] f32, caller guarantees > 0
  top_ks: torch.Tensor,  # [B] int, clipped to [1, k_max]
  k_max: int = 64,
) -> torch.Tensor:
  """Per-row temperature AND top-k over a batch of heterogeneous requests.
  The static ``k_max`` caps the candidate set; each row's ``top_ks`` masks
  ranks beyond its own k. The draw is Gumbel-max over the kept candidates
  (what ``jax.random.categorical`` computes), so nothing here syncs with
  the host."""
  x = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
  k_cap = min(int(k_max), x.shape[-1])
  vals, idxs = torch.topk(x, k_cap, dim=-1)  # [B, k_cap] descending
  rank = torch.arange(k_cap, device=x.device)[None, :]
  keep = rank < torch.clamp(top_ks.to(torch.int64), 1, k_cap)[:, None]
  vals = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
  u = torch.rand(vals.shape, generator=generator, device=vals.device, dtype=torch.float32)
  gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20, max=1.0 - 1e-7)))
  choice = torch.argmax(vals + gumbel, dim=-1, keepdim=True)
  return torch.gather(idxs, -1, choice)[:, 0].to(torch.int32)
