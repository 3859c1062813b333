"""Grouped-query attention with position-index masking — the plain decode
attention — and MLA's absorbed attention against the latent cache.
Counterpart of the reference's ``ops/attention.py``, which leaves both to
XLA outside any Pallas kernel; here they stay plain PyTorch.

A query at absolute position p attends exactly the KV slots whose slot
index ≤ p, so stale slots beyond a prompt are masked by position.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def kv_scale_to_scores(scale_leaf: torch.Tensor) -> torch.Tensor:
  """Cache scale leaf [B, Skv, Hkv, 1] → broadcastable over scores
  [B, Hkv, group, Sq, Skv]."""
  return scale_leaf[..., 0].permute(0, 2, 1)[:, :, None, None, :]


def gqa_attention(
  q: torch.Tensor,  # [B, Sq, Hq, hd]
  k: torch.Tensor,  # [B, Skv, Hkv, hd] (int8 codes when k_scale is given)
  v: torch.Tensor,  # [B, Skv, Hkv, hd]
  q_positions: torch.Tensor,  # [B, Sq] absolute positions of queries
  kv_positions: torch.Tensor,  # [Skv] absolute positions (slot indices) of keys
  scale: float | None = None,
  logit_softcap: float = 0.0,
  sliding_window=None,
  k_scale: torch.Tensor | None = None,  # [B, Skv, Hkv, 1] int8-KV scales
  v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
  """Returns [B, Sq, Hq, hd_v]; softmax in fp32; output in q.dtype. With
  ``k_scale``/``v_scale`` k/v are int8 codes: k's scale multiplies the
  scores before masking, v's folds into the probabilities."""
  B, Sq, Hq, hd = q.shape
  Hkv = k.shape[2]
  hd_v = v.shape[3]
  group = Hq // Hkv
  if scale is None:
    scale = 1.0 / float(hd) ** 0.5
  qg = q.reshape(B, Sq, Hkv, group, hd).float()
  scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale  # [B, Hkv, group, Sq, Skv]
  if k_scale is not None:
    scores = scores * kv_scale_to_scores(k_scale)
  scores = cap_and_mask_scores(scores, q_positions, kv_positions, logit_softcap, sliding_window)
  probs = torch.softmax(scores, dim=-1)
  if v_scale is not None:
    probs = probs * kv_scale_to_scores(v_scale)
  out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
  return out.reshape(B, Sq, Hq, hd_v).to(q.dtype)


def cap_and_mask_scores(scores, q_positions, kv_positions, logit_softcap: float = 0.0, sliding_window=None):
  """Softcap + causal/window masking for [B,Hkv,g,Sq,Skv] scores (softcap
  applies before masking)."""
  if logit_softcap:
    scores = logit_softcap * torch.tanh(scores / logit_softcap)
  kv = kv_positions[None, None, None, None, :]
  qp = q_positions[:, None, None, :, None]
  mask = kv <= qp
  if sliding_window is not None:
    mask = mask & (kv > qp - sliding_window)
  return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def mla_absorbed_attention(
  q_nope: torch.Tensor,  # [B, Sq, H, nope]
  q_pe: torch.Tensor,  # [B, Sq, H, rope] (rope applied)
  ckv: torch.Tensor,  # [B, Skv, rank] cached kv latent (after kv_a_norm)
  kpe: torch.Tensor,  # [B, Skv, rope] cached rope channel (rope applied)
  w_kv_b: torch.Tensor,  # [rank, H·(nope + v)] up-projection
  q_positions: torch.Tensor,  # [B, Sq]
  kv_positions: torch.Tensor,  # [Skv]
  v_dim: int,
) -> torch.Tensor:
  """MLA attention against the latent cache (weight absorption): the kv_b
  up-projection folds into the query and output sides, so the cache holds
  rank + rope values per token instead of per-head K/V.

    score_h(t) = (q_nope_h · W_k_hᵀ) · ckv(t) + q_pe_h · kpe(t)
    out_h      = (Σ_t p_t ckv(t)) · W_v_h

  In f32, scaled by 1/sqrt(nope + rope) as the reference scales (no yarn
  mscale², which HF's deepseek-v3 adds). Returns [B, Sq, H, v_dim] in
  q_nope's dtype."""
  B, Sq, H, nope = q_nope.shape
  rank = ckv.shape[-1]
  rope = q_pe.shape[-1]
  W = w_kv_b.reshape(rank, H, nope + v_dim)
  w_k = W[..., :nope].float()  # [rank, H, nope]
  w_v = W[..., nope:].float()  # [rank, H, v]
  scale = 1.0 / torch.sqrt(torch.tensor(float(nope + rope), dtype=torch.float32)).item()
  ckv_f = ckv.float()
  q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_k)  # [B, Sq, H, rank]
  scores = torch.einsum("bshr,btr->bhst", q_abs, ckv_f)
  scores = scores + torch.einsum("bshp,btp->bhst", q_pe.float(), kpe.float())
  scores = scores * scale
  mask = kv_positions[None, None, None, :] <= q_positions[:, None, :, None]  # [B, 1, Sq, Skv]
  scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
  probs = torch.softmax(scores, dim=-1)
  ctx = torch.einsum("bhst,btr->bshr", probs, ckv_f)  # [B, Sq, H, rank]
  return torch.einsum("bshr,rhv->bshv", ctx, w_v).to(q_nope.dtype)
