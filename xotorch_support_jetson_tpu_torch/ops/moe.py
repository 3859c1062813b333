"""Mixture-of-experts routed FFN: top-k routing, capacity dispatch and the
weight-gather decode path. Own copy of the reference's ``ops/moe.py``.

- ``router_topk``: softmax or sigmoid scoring, a selection-only bias
  (deepseek-v3's e_score_correction_bias), group-limited routing ("max",
  deepseek-v2; "top2sum", deepseek-v3), optional renormalisation and scale.
- ``dispatch_combine_masks``: each assignment's rank in its expert's buffer
  (token-major, slot-minor); rank ≥ capacity drops it. The default
  ``capacity_factor=None`` is exact (capacity = T, nothing drops).
- The einsum path runs every expert over its capacity block as batched
  products ``[E, C, D] x [E, D, F]``; the gather path gathers the k routed
  experts' weight slabs per token and reads k·T of the E experts' bytes.
  Both have fixed shapes for a given T (no host read, no data-dependent
  shape), so either runs inside a captured CUDA graph.
- ``moe_ffn`` picks the path: the gather path for T ≤ ``gather_max`` with
  the exact capacity, the einsum path up to ``chunk`` tokens, and chunks of
  ``chunk`` tokens beyond (routing is per token, so chunking is exact).

Quantized experts (models/quantize.py: int8, or packed int4 with a halved
in-axis, beside an f32 ``[.., E, out]`` scale) are dequantized next to
their product, as the reference does: the einsum path dequantizes each
whole stack, the gather path only the gathered slabs (the same values:
dequantization is elementwise). The expert products are library products,
as in the reference, which has no Pallas kernel here.

Path choice (``gather_max``). ``XOT_TPU_MOE_GATHER`` keeps the reference's
meaning wherever it is set: on, the gather path up to 32 tokens; off, the
einsum path always. Unset, a CPU tensor takes the reference's default (the
einsum path) and a CUDA tensor the H100 table ``H100_GATHER_MAX``, measured
by ``scripts/moe_paths.py`` on Qwen3-30B-A3B's and DeepSeek-V2-Lite's
shapes. ``PATHS`` counts the
path of each call by token count (``"gather@1"``, ``"einsum@128"``,
``"chunked@600"``); a call recorded into a CUDA graph is counted at each
replay (ops/kernels.py ``count_launch``).
"""

from __future__ import annotations

import math
import os
from collections import Counter

import torch

from ..utils.helpers import env_flag

# The reference's opt-in bound (XOT_TPU_MOE_GATHER=1).
REFERENCE_GATHER_MAX = 32

# H100 80GB HBM3 (SXM, 700 W): the largest token count up to which the
# gather path's median device time over four runs was below the einsum
# path's for one layer's routed FFN, by (experts, active experts, expert
# weights); scripts/moe_paths.py measures both paths at T = 1, 2, 4, 8, 16,
# 32, 72, 128 (PERF.md §6): Qwen3-30B-A3B's 128 experts of 768, top-8, and
# DeepSeek-V2-Lite's 64 of 1408, top-6.
H100_GATHER_MAX = {
  (128, 8, "bf16"): 8, (128, 8, "int8"): 8, (128, 8, "int4"): 8,
  (64, 6, "bf16"): 4, (64, 6, "int8"): 8, (64, 6, "int4"): 8,
}

PATHS: Counter = Counter()  # "<path>@<T>" → calls (replays included on a card)


def reset_path_counts() -> None:
  PATHS.clear()


def gather_max(device, n_experts: int, k: int, weights: str = "bf16") -> int:
  """Largest token count that takes the gather path (module docstring);
  ``weights`` is the experts' layout ("bf16" for the model's dtype, "int8",
  "int4"). A shape the table lacks takes a bytes estimate: the gather path
  moves its k·T slabs about three times (the gather's read, its copy's
  write, the product's read), the einsum path reads the E experts once (5
  for 128 experts at top-8, where the measured entry is 8)."""
  if os.getenv("XOT_TPU_MOE_GATHER") is not None:
    return REFERENCE_GATHER_MAX if env_flag("XOT_TPU_MOE_GATHER") else 0
  if getattr(device, "type", device) != "cuda":
    return 0
  return H100_GATHER_MAX.get((n_experts, k, weights), max(n_experts // (3 * k), 0))


def _note(path: str, T: int, device) -> None:
  key = f"{path}@{T}"
  if getattr(device, "type", device) == "cuda":
    from .kernels import count_launch

    count_launch(PATHS, key)
  else:
    PATHS[key] += 1


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
  """(values, indices) of the k largest along the last axis, equal values
  in index order, as the reference's ``lax.top_k`` breaks ties (a padding
  row's uniform scores route as there)."""
  vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
  return vals[..., :k], idx[..., :k]


def router_topk(
  logits: torch.Tensor,  # [T, E] router logits
  k: int,
  scoring: str = "softmax",  # "softmax" | "sigmoid"
  norm_topk: bool = False,
  selection_bias: torch.Tensor | None = None,  # [E], added for selection only
  scale: float = 1.0,
  n_group: int = 1,
  topk_group: int = 1,
  group_mode: str = "none",  # "none" | "max" | "top2sum"
) -> tuple[torch.Tensor, torch.Tensor]:
  """Top-k experts per token: (weights [T, k] f32, idx [T, k] int32).

  The combine weights are the unbiased scores at the chosen experts;
  ``selection_bias`` only reorders the choice. With ``group_mode`` set and
  ``n_group`` > 1, only experts of the top ``topk_group`` groups (by max or
  top-2 sum of member scores) are eligible."""
  logits = logits.float()
  scores = torch.sigmoid(logits) if scoring == "sigmoid" else torch.softmax(logits, dim=-1)
  sel = scores if selection_bias is None else scores + selection_bias.float()
  if group_mode != "none" and n_group > 1:
    T, E = sel.shape
    grouped = sel.reshape(T, n_group, E // n_group)
    if group_mode == "top2sum":
      group_scores = _topk(grouped, 2)[0].sum(-1)
    else:
      group_scores = grouped.amax(-1)
    gidx = _topk(group_scores, topk_group)[1]  # [T, topk_group]
    gmask = torch.zeros((T, n_group), dtype=torch.bool, device=sel.device).scatter_(1, gidx, True)
    sel = torch.where(gmask.repeat_interleave(E // n_group, dim=-1), sel, torch.zeros_like(sel))
  idx = _topk(sel, k)[1]
  weights = torch.gather(scores, 1, idx)
  if norm_topk:
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
  return weights * scale, idx.to(torch.int32)


def expert_capacity(n_tokens: int, k: int, n_experts: int, capacity_factor: float | None) -> int:
  """Tokens each expert can hold. None ⇒ exact (capacity = T, no drops)."""
  if capacity_factor is None:
    return n_tokens
  return min(n_tokens, max(1, math.ceil(n_tokens * k / n_experts * capacity_factor)))


def dispatch_combine_masks(idx: torch.Tensor, weights: torch.Tensor, n_experts: int, capacity: int):
  """Dispatch [T, E, C] (0/1) and combine [T, E, C] (weighted), f32.

  An assignment's position inside its expert is its rank (token-major,
  slot-minor) among all assignments to that expert; rank ≥ capacity drops
  it."""
  T, k = idx.shape
  onehot = torch.nn.functional.one_hot(idx.long(), n_experts).float()  # [T, k, E]
  flat = onehot.transpose(0, 1).reshape(k * T, n_experts)  # slot-major blocks of token-major rows
  ranks = torch.cumsum(flat, dim=0) - flat
  ranks = ranks.reshape(k, T, n_experts).transpose(0, 1)  # [T, k, E]
  pos = (ranks * onehot).sum(-1)  # [T, k]
  keep = (pos < capacity).float()
  pos_oh = torch.nn.functional.one_hot(pos.long().clamp(max=capacity - 1), capacity).float() * keep[..., None]  # [T, k, C]
  dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)
  combine = torch.einsum("tke,tkc,tk->tec", onehot, pos_oh, weights.float())
  return dispatch, combine


def load_balancing_loss(router_logits: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
  """Switch/GShard auxiliary loss: E · Σ_e (share of tokens to e) · (mean prob to e)."""
  probs = torch.softmax(router_logits.float(), dim=-1)  # [T, E]
  onehot = torch.nn.functional.one_hot(idx.long(), n_experts).float()  # [T, k, E]
  frac_tokens = onehot.sum(1).mean(0)
  mean_prob = probs.mean(0)
  return n_experts * (frac_tokens / idx.shape[1] * mean_prob).sum()


def _dequant(w: torch.Tensor, scale: torch.Tensor | None, in_dim: int, dtype) -> torch.Tensor:
  """An expert leaf in ``dtype``: as it is, or dequantized (int8, or
  packed int4 detected by its halved in-axis against ``in_dim``)."""
  if scale is None:
    return w
  from ..models.quantize import dequantize_leaf

  return dequantize_leaf(w, scale, in_dim, dtype)


def _silu(x: torch.Tensor, dtype) -> torch.Tensor:
  return torch.nn.functional.silu(x.float()).to(dtype)


def _route(x, w_router, route: dict):
  logits = x.float() @ w_router.float()
  weights, idx = router_topk(logits, **route)
  return logits, weights, idx


def _moe_ffn_block(x, w_router, w_gate, w_up, w_down, route: dict, capacity_factor):
  """One dispatch / compute / combine block over [T, D] tokens, the
  experts already in x's dtype. Returns (out, aux)."""
  T = x.shape[0]
  E = w_gate.shape[0]
  logits, weights, idx = _route(x, w_router, route)
  dispatch, combine = dispatch_combine_masks(idx, weights, E, expert_capacity(T, route["k"], E, capacity_factor))
  xin = torch.einsum("td,tec->ecd", x, dispatch.to(x.dtype))  # [E, C, D]
  gated = _silu(torch.bmm(xin, w_gate), x.dtype)
  up = torch.bmm(xin, w_up)
  out = torch.bmm(gated * up, w_down)  # [E, C, D]
  out = torch.einsum("ecd,tec->td", out.float(), combine).to(x.dtype)
  return out, load_balancing_loss(logits, idx, E)


def _moe_ffn_gather(x, w_router, w_gate, w_up, w_down, scales, F: int, route: dict):
  """Decode-path MoE: the k routed experts' weight slabs gathered per
  token (quantized slabs gathered as codes and scales, then dequantized),
  each token's k products batched. Same routing as the einsum path, no
  capacity."""
  T, D = x.shape
  E = w_gate.shape[0]
  k = route["k"]
  logits, weights, idx = _route(x, w_router, route)
  flat = idx.reshape(-1).long()  # [T·k]

  def slabs(w, s, in_dim):
    return _dequant(w.index_select(0, flat), None if s is None else s.index_select(0, flat), in_dim, x.dtype)

  xk = x[:, None, :].expand(T, k, D).reshape(T * k, 1, D)
  gated = _silu(torch.bmm(xk, slabs(w_gate, scales[0], D)), x.dtype)
  up = torch.bmm(xk, slabs(w_up, scales[1], D))
  out_e = torch.bmm(gated * up, slabs(w_down, scales[2], F)).reshape(T, k, D)  # [T, k, D]
  out = torch.einsum("tjd,tj->td", out_e.float(), weights).to(x.dtype)
  return out, load_balancing_loss(logits, idx, E)


def moe_ffn(
  x: torch.Tensor,  # [T, D] tokens (flattened batch·seq)
  w_router: torch.Tensor,  # [D, E]
  w_gate: torch.Tensor,  # [E, D, F] (int8 codes, or packed int4 [E, D/2, F], with a scale)
  w_up: torch.Tensor,  # [E, D, F]
  w_down: torch.Tensor,  # [E, F, D]
  k: int,
  scoring: str = "softmax",
  norm_topk: bool = False,
  selection_bias: torch.Tensor | None = None,
  scale: float = 1.0,
  capacity_factor: float | None = None,
  chunk: int = 256,
  return_aux: bool = False,
  n_group: int = 1,
  topk_group: int = 1,
  group_mode: str = "none",
  gate_scale: torch.Tensor | None = None,  # [E, F] f32 when w_gate is quantized
  up_scale: torch.Tensor | None = None,
  down_scale: torch.Tensor | None = None,  # [E, D]
  hidden_dim: int | None = None,  # F, needed to read a packed int4 w_down
):
  """Routed SwiGLU FFN over E experts: [T, D] in x's dtype (or ``(out,
  aux_loss)`` with ``return_aux``). The path follows ``gather_max``; long
  token runs go through the einsum path in sequential chunks of ``chunk``
  tokens, padded (the padding rows' outputs are dropped)."""
  T, D = x.shape
  E = w_gate.shape[0]
  route = dict(k=k, scoring=scoring, norm_topk=norm_topk, selection_bias=selection_bias, scale=scale, n_group=n_group, topk_group=topk_group, group_mode=group_mode)
  F = hidden_dim or w_gate.shape[-1]
  weights = "bf16" if gate_scale is None else "int4" if w_gate.shape[-2] * 2 == D else "int8"
  if T <= gather_max(x.device, E, k, weights) and capacity_factor is None:
    _note("gather", T, x.device)
    out, aux = _moe_ffn_gather(x, w_router, w_gate, w_up, w_down, (gate_scale, up_scale, down_scale), F, route)
    return (out, aux) if return_aux else out
  g, u, d = _dequant(w_gate, gate_scale, D, x.dtype), _dequant(w_up, up_scale, D, x.dtype), _dequant(w_down, down_scale, F, x.dtype)
  if T <= chunk:
    _note("einsum", T, x.device)
    out, aux = _moe_ffn_block(x, w_router, g, u, d, route, capacity_factor)
  else:
    _note("chunked", T, x.device)
    pad = (-T) % chunk
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
    outs, auxs = zip(*(_moe_ffn_block(xc, w_router, g, u, d, route, capacity_factor) for xc in xp.split(chunk)))
    out = torch.cat(outs)[:T]
    aux = torch.stack(auxs).mean()  # padding rows bias aux slightly, as in the reference
  return (out, aux) if return_aux else out
