"""The decoder: llama 3.x, qwen-2.5/3, mistral, phi-family, gemma2, the
mixture-of-experts mixtral, qwen2-moe and qwen3-moe checkpoints, and
deepseek-v2/v3 with multi-head latent attention (MLA). Counterpart of the
reference's ``models/decoder.py`` (all but the training LoRA leaves; llava's
vision tower is models/vision.py, and its merged embeddings enter the
first shard's prefill through ``prefill_embeds``). An
MLA layer caches only its kv latent and rope channel and attends through
weight absorption (``ops/attention.py mla_absorbed_attention``); its
cache-less forward runs the naive per-head K/V through ``gqa_attention``,
and K1–K3 never run on it, as in the reference. gemma2's variations ride
on the config (``_attn_opts``: the scale override, the score softcap and
the per-layer sliding window, whose flag is the ``layers/is_sliding``
leaf; the post norms, the GeGLU MLP, the embed scale and the final
softcap); its attention takes the plain route everywhere, as the
reference's does: K1–K3 implement none of them.

Parameters are a plain dict of tensors in the reference's layout: layer
leaves stacked on a leading [L] axis (``layers/wq`` [L, D, Hq·hd], used as
``x @ w``), ``embed`` [V, D], ``final_norm`` [D], ``lm_head`` [D, V]
(absent when tied to ``embed``). An MoE model's layers are a dense prefix
``layers`` (its ``first_k_dense``) and the ``moe_layers`` stack, whose FFN
is the routed one (ops/moe.py: ``w_router`` [L, D, E], ``w_experts_*``
[L, E, D, F] / [L, E, F, D], an optional shared expert and its sigmoid
gate); every path runs both stacks in order with one cache-layer index
across them (``layer_params``). Weight-quantized params
(models/quantize.py) carry int8 or packed-int4 codes beside
``<name>_scale`` leaves; every weight product goes through ``_mm`` /
``qdot``. The reference's ``lax.scan`` over layers and steps becomes a
Python loop. The KV cache is a dict of
[L, B, max_seq, Hkv, hd] buffers (hd/2 for packed int4 codes, +
``k_scale``/``v_scale`` [.., 1] for int8 and int4) that the forward UPDATES
IN PLACE — slot j holds absolute position j. On it run the solo decode
loops (``fused_decode``, ``fused_generate``), greedy speculative decoding
with a draft model (``fused_speculative_generate`` / ``_chunk``) and the
speculative chunk over B rows (``fused_spec_batch_decode``, draft-free or
with a draft model on its own slot cache); with ``SoloPrograms`` each
prefill bucket, decode step, speculative round and draft-free chunk is one
CUDA-graph replay. A ring node's partial shard runs its prefill bucket and
its one-position step as one replay each (``ShardPrograms``).
``score_last_tokens`` (OpenAI ``logprobs``) scores a sequence's last
tokens in one cache-less forward. The batched server's dense layout runs
on such a cache too (``prefill_into_slots[_sampled]``,
``fused_batch_decode``); its paged programs run against a page pool
(ops/paged.py) instead, also updated in place: the admission prefill, the
plain and mixed decode chunks, and the speculative chunk
(``fused_spec_paged_batch_decode``). With ``BatchedPrograms`` each batched
dispatch, in either layout, is one CUDA-graph replay.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..inference.shard import Shard
from ..ops.attention import gqa_attention
from ..ops.norm import rms_norm
from ..ops.rope import apply_rope, apply_rope_interleaved, rope_attention_factor, rope_inv_freq
from ..utils.programs import Graph, ledger, tracked
from .config import ModelConfig
from .quantize import qdot

Params = dict

# Quantized weight matmul mode (models/quantize.py qdot) when the config
# names none: "w8a16" upcasts int8 codes next to the product; "w8a8" also
# quantizes the activations per row for an int8×int8 product.
QUANT_COMPUTE = os.getenv("XOT_TPU_QUANT_COMPUTE", "w8a16")

# fused_generate checks for all-rows-EOS every this many steps: each check is
# a host sync, so checking every step would stall the host on the device.
# Steps past an EOS write only slots beyond the kept tokens (masked later).
EOS_CHECK_EVERY = 16


def _mm(x: torch.Tensor, p: Params, name: str, compute: str = "") -> torch.Tensor:
  """x @ p[name], through ``qdot`` when the leaf is quantized (it has a
  sibling ``<name>_scale``); ``compute`` is normally ``cfg.quant_compute``."""
  if f"{name}_scale" in p:
    return qdot(x, p[name], p[f"{name}_scale"], compute or QUANT_COMPUTE)
  return x @ p[name]


# ---------------------------------------------------------------- KV cache


def kv_quant_mode(cfg: ModelConfig, quant: str | None = None) -> str:
  """KV-cache quantization: explicit arg wins, else ``XOT_TPU_KV_QUANT``
  ("", "int8", or "int4": two code nibbles per byte along the head dim).
  An MLA model's latent cache stays in the model dtype whatever is asked:
  it reconstructs both k and v, so quantizing it is all risk."""
  mode = os.getenv("XOT_TPU_KV_QUANT", "") if quant is None else quant
  if mode not in ("", "int8", "int4"):
    raise ValueError(f"XOT_TPU_KV_QUANT supports '', 'int8' or 'int4'; got {mode!r}")
  return "" if cfg.is_mla else mode


def pool_kv_quant(pool: Params, cfg: ModelConfig) -> str:
  """The KV quant mode a cache or page-pool dict holds ("", "int8",
  "int4"): int4 code leaves carry a halved trailing axis."""
  if "k_scale" not in pool:
    return ""
  return "int4" if pool["k"].shape[-1] * 2 == cfg.cache_k_dim else "int8"


def init_kv_cache(cfg: ModelConfig, n_shard_layers: int, batch: int, max_seq: int, dtype=None, quant: str | None = None, device=None) -> Params:
  """Slot-indexed KV cache: slot j holds the KV of absolute position j.
  Geometry from the config: GQA heads for a dense model; for MLA "k" holds
  the kv latent (``kv_lora_rank`` wide) and "v" the rope channel
  (``qk_rope_head_dim``), one head entry. ``quant="int8"`` stores int8
  codes plus per-(token, head) f32 scales, ``quant="int4"`` packed int4
  codes (halved last axis) with the same scales (dense models only:
  ``kv_quant_mode``)."""
  mode = kv_quant_mode(cfg, quant)
  kd, vd = cfg.cache_k_dim, cfg.cache_v_dim
  if mode == "int4":
    if kd % 2 or vd % 2:
      raise ValueError(f"int4 KV needs even cache dims; got k={kd} v={vd}")
    kd, vd = kd // 2, vd // 2
  k_shape = (n_shard_layers, batch, max_seq, cfg.cache_kv_heads, kd)
  v_shape = (n_shard_layers, batch, max_seq, cfg.cache_kv_heads, vd)
  if mode:
    scale_shape = k_shape[:-1] + (1,)
    return {
      "k": torch.zeros(k_shape, dtype=torch.int8, device=device),
      "v": torch.zeros(v_shape, dtype=torch.int8, device=device),
      "k_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
      "v_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
    }
  dtype = dtype or cfg.dtype
  return {"k": torch.zeros(k_shape, dtype=dtype, device=device), "v": torch.zeros(v_shape, dtype=dtype, device=device)}


def _write_cache(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
  """cache [B,S,H,hd] ← new [B,Sn,H,hd] at per-row slot offsets start [B],
  in place (returns ``cache``)."""
  B, Sn = new.shape[:2]
  rows = torch.arange(B, device=cache.device)[:, None]
  slots = start.to(cache.device)[:, None] + torch.arange(Sn, device=cache.device)[None, :]
  cache[rows, slots] = new.to(cache.dtype)
  return cache


# ---------------------------------------------------------------- init


def sliding_flags(cfg: ModelConfig, global_indices, device=None) -> torch.Tensor:
  """Per-layer sliding-window flags [L] f32 from GLOBAL layer indices: the
  one encoding shared by ``init_shard_params`` and the checkpoint loader."""
  return torch.tensor([1.0 if cfg.layer_is_sliding(i) else 0.0 for i in global_indices], dtype=torch.float32, device=device)


def init_shard_params(cfg: ModelConfig, shard: Shard, generator: torch.Generator | None = None, dtype=None, device=None) -> Params:
  """Random-init params for a shard (tests, smoke runs), the reference's
  layout and scales: N(0, 1/fan_in) projections, N(0, 0.02) embeddings,
  unit norms."""
  dtype = dtype or cfg.dtype
  L = shard.n_shard_layers
  D, F, V = cfg.dim, cfg.hidden_dim, cfg.vocab_size
  Qd, Kd = cfg.q_dim, cfg.kv_dim

  def w(*shape, scale=None):
    scale = scale if scale is not None else 1.0 / (shape[-2] if len(shape) > 1 else shape[-1]) ** 0.5
    return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device) * scale).to(dtype)

  def ones(*shape):
    return torch.ones(shape, dtype=dtype, device=device)

  def attn_leaves(L: int, start: int) -> dict:
    if cfg.is_mla:
      H, qk, vh, rank = cfg.n_heads, cfg.qk_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
      leaves = {
        "attn_norm": ones(L, D), "wkv_a": w(L, D, rank + cfg.qk_rope_head_dim), "kv_a_norm": ones(L, rank),
        "wkv_b": w(L, rank, H * (cfg.qk_nope_head_dim + vh)), "wo": w(L, H * vh, D), "mlp_norm": ones(L, D),
      }
      if cfg.q_lora_rank:
        leaves.update(wq_a=w(L, D, cfg.q_lora_rank), q_a_norm=ones(L, cfg.q_lora_rank), wq_b=w(L, cfg.q_lora_rank, H * qk))
      else:
        leaves["wq"] = w(L, D, H * qk)
      return leaves
    leaves = {"attn_norm": ones(L, D), "wq": w(L, D, Qd), "wk": w(L, D, Kd), "wv": w(L, D, Kd), "wo": w(L, Qd, D), "mlp_norm": ones(L, D)}
    if cfg.qkv_bias:
      leaves.update(bq=torch.zeros(L, Qd, dtype=dtype, device=device), bk=torch.zeros(L, Kd, dtype=dtype, device=device), bv=torch.zeros(L, Kd, dtype=dtype, device=device))
    if cfg.qk_norm:
      leaves.update(q_norm=ones(L, cfg.head_dim), k_norm=ones(L, cfg.head_dim))
    if cfg.post_norms:  # gemma2's post-attention / post-feedforward norms
      leaves.update(post_attn_norm=ones(L, D), post_mlp_norm=ones(L, D))
    if cfg.sliding_window:
      leaves["is_sliding"] = sliding_flags(cfg, range(start, start + L), device)
    return leaves

  params: Params = {}
  # An MoE model: the dense prefix (global layers below first_k_dense), then the MoE stack.
  n_dense = min(max(cfg.first_k_dense - shard.start_layer, 0), L) if cfg.n_experts else L
  if n_dense:
    params["layers"] = {**attn_leaves(n_dense, shard.start_layer), "w_gate": w(n_dense, D, F), "w_up": w(n_dense, D, F), "w_down": w(n_dense, F, D)}
  if n_dense < L:
    Lm, E, Fm, Fs = L - n_dense, cfg.n_experts, cfg.moe_hidden_dim, cfg.shared_expert_dim
    moe = {
      **attn_leaves(Lm, shard.start_layer + n_dense),
      "w_router": w(Lm, D, E),
      "w_experts_gate": w(Lm, E, D, Fm),
      "w_experts_up": w(Lm, E, D, Fm),
      "w_experts_down": w(Lm, E, Fm, D),
    }
    if cfg.router_scoring == "sigmoid":
      moe["router_bias"] = torch.zeros((Lm, E), dtype=torch.float32, device=device)
    if Fs:
      moe.update(w_shared_gate=w(Lm, D, Fs), w_shared_up=w(Lm, D, Fs), w_shared_down=w(Lm, Fs, D))
      if cfg.shared_expert_gate:
        moe["w_shared_expert_gate"] = w(Lm, D, 1)
    params["moe_layers"] = moe
  if shard.is_first_layer:
    params["embed"] = w(V, D, scale=0.02)
  if shard.is_last_layer:
    params["final_norm"] = ones(D)
    if not (cfg.tied_embedding and shard.is_first_layer):
      params["lm_head"] = w(D, V)
  return params


# ---------------------------------------------------------------- forward


# HF deepseek fixes the latent norms' eps at 1e-6 whatever rms_norm_eps says.
_MLA_NORM_EPS = 1e-6


def _mla_latents(x, p, cfg: ModelConfig, positions, inv_freq):
  """MLA projections (deepseek-v2/v3): queries through wq_a → q_a_norm →
  wq_b (or a direct wq when ``q_lora_rank`` is 0), the shared kv latent and
  one MQA rope channel; interleaved rope on the rope parts only. Returns
  (q_nope [B,S,H,nope], q_pe [B,S,H,rope], c_kv [B,S,rank] normed, k_pe
  [B,S,rope])."""
  B, S, _ = x.shape
  H, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
  if "wq_a" in p:
    q = _mm(rms_norm(_mm(x, p, "wq_a", cfg.quant_compute), p["q_a_norm"], _MLA_NORM_EPS), p, "wq_b", cfg.quant_compute)
  else:
    q = _mm(x, p, "wq", cfg.quant_compute)
  q = q.reshape(B, S, H, nope + rope)
  q_nope, q_pe = q[..., :nope], q[..., nope:]
  kv_a = _mm(x, p, "wkv_a", cfg.quant_compute)  # [B, S, rank + rope]
  c_kv = rms_norm(kv_a[..., : cfg.kv_lora_rank], p["kv_a_norm"], _MLA_NORM_EPS)
  m = rope_attention_factor(cfg)
  q_pe = apply_rope_interleaved(q_pe, positions, inv_freq, m)
  k_pe = apply_rope_interleaved(kv_a[..., cfg.kv_lora_rank :][:, :, None, :], positions, inv_freq, m)[:, :, 0, :]
  return q_nope, q_pe, c_kv, k_pe


def _mla_w_kv_b(p, dtype) -> torch.Tensor:
  """The kv_b up-projection [rank, H·(nope + v)], dequantized whole when
  quantized (the absorbed op needs the matrix, not a product)."""
  w = p["wkv_b"]
  if "wkv_b_scale" in p:
    from .quantize import dequantize_leaf

    w = dequantize_leaf(w, p["wkv_b_scale"], p["kv_a_norm"].shape[-1], dtype)
  return w


def _mla_qkv(x, p, cfg: ModelConfig, positions, inv_freq):
  """Naive (non-absorbed) MLA q/k/v for the cache-less forward: q/k
  [B,S,H,nope+rope], v [B,S,H,v_head_dim]."""
  B, S, _ = x.shape
  H, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
  q_nope, q_pe, c_kv, k_pe = _mla_latents(x, p, cfg, positions, inv_freq)
  kv = (c_kv @ _mla_w_kv_b(p, x.dtype)).reshape(B, S, H, nope + cfg.v_head_dim)
  q = torch.cat([q_nope, q_pe], dim=-1)
  k = torch.cat([kv[..., :nope], k_pe[:, :, None, :].expand(B, S, H, rope)], dim=-1)
  return q, k, kv[..., nope:]


def _mla_attention(x, p, kv, positions, kv_positions, inv_freq, cfg: ModelConfig) -> torch.Tensor:
  """MLA against the dense slot cache: write the latent and the rope
  channel (in place), then the absorbed op over every slot, masked by
  position — the reference's cached MLA branch."""
  from ..ops.attention import mla_absorbed_attention

  q_nope, q_pe, c_kv, k_pe = _mla_latents(x, p, cfg, positions, inv_freq)
  start = positions[:, 0]
  _write_cache(kv["k"], c_kv[:, :, None, :], start)
  _write_cache(kv["v"], k_pe[:, :, None, :], start)
  return mla_absorbed_attention(
    q_nope, q_pe, kv["k"][:, :, 0, :].to(x.dtype), kv["v"][:, :, 0, :].to(x.dtype), _mla_w_kv_b(p, x.dtype), positions, kv_positions, cfg.v_head_dim,
  )


def _alora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """Per-row adapter-indexed low-rank delta (the Punica BGMV idea).

  x [B,S,D]; a [n_slots, D, r] / b [n_slots, r, O] are one layer's STACKED
  adapter factors (inference/adapters.py keeps slot 0 all-zero = the base
  model); ids [B] int32 is each row's slot, a device tensor, so the adapter
  mix changes no captured graph. The gather materializes [B, D, r] +
  [B, r, O] per layer (r is small), then two batched products; the scale
  is the reference's fixed alpha = 2·rank ⇒ 2. Plain PyTorch: the
  reference leaves it to XLA too, outside any Pallas kernel."""
  idx = ids.to(device=x.device, dtype=torch.long)
  a_sel = a.index_select(0, idx)  # [B, D, r]
  b_sel = b.index_select(0, idx)  # [B, r, O]
  h = torch.bmm(x, a_sel)
  return (torch.bmm(h, b_sel) * 2.0).to(x.dtype)


def _dense_qkv(x, p, cfg: ModelConfig, positions, inv_freq, adapter_ids=None):
  """x [B,S,D] → q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (qkv bias, qk norm, rope).

  ``adapter_ids`` [B] int32: each row's adapter slot in the stacked
  ``*_alora_a`` / ``*_alora_b`` leaves (the engine's
  ``enable_multi_lora``), its delta added after the base products and
  before the qkv bias, as in the reference. None skips the hook: base
  serving never pays the gather."""
  B, S, _ = x.shape
  q = _mm(x, p, "wq", cfg.quant_compute)
  k = _mm(x, p, "wk", cfg.quant_compute)
  v = _mm(x, p, "wv", cfg.quant_compute)
  if adapter_ids is not None and "wq_alora_a" in p:
    q = q + _alora_delta(x, p["wq_alora_a"], p["wq_alora_b"], adapter_ids)
  if adapter_ids is not None and "wv_alora_a" in p:
    v = v + _alora_delta(x, p["wv_alora_a"], p["wv_alora_b"], adapter_ids)
  if "bq" in p:
    q = q + p["bq"]
    k = k + p["bk"]
    v = v + p["bv"]
  q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
  k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
  v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
  if "q_norm" in p:  # qwen3: per-head RMSNorm on q/k before rope
    q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k = rms_norm(k, p["k_norm"], cfg.norm_eps)
  m = rope_attention_factor(cfg)
  return apply_rope(q, positions, inv_freq, m), apply_rope(k, positions, inv_freq, m), v


def _mlp_act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  """The gate's activation in f32: SiLU, or gemma2's tanh GELU."""
  if cfg.mlp_act == "gelu_tanh":
    return torch.nn.functional.gelu(x.float(), approximate="tanh")
  return torch.nn.functional.silu(x.float())


def _attn_opts(cfg: ModelConfig, layer_sliding=None) -> dict:
  """The attention options a config implies (gemma2's scale override,
  score softcap and sliding window). The window is read from the layer's
  ``is_sliding`` flag on the device, huge (no mask) on a global layer, so
  no layer bakes another's window into a captured graph."""
  opts: dict = {}
  if cfg.query_pre_attn_scalar:
    opts["scale"] = 1.0 / cfg.query_pre_attn_scalar**0.5
  if cfg.attn_logit_softcap:
    opts["logit_softcap"] = cfg.attn_logit_softcap
  if cfg.sliding_window and layer_sliding is not None:
    opts["sliding_window"] = torch.where(layer_sliding > 0, cfg.sliding_window, 2**30)
  return opts


def _attn_out(attn: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
  """The output projection of attention [B, S, Hq, hd], then gemma2's
  post-attention norm."""
  B, S = attn.shape[:2]
  out = _mm(attn.reshape(B, S, -1), p, "wo", cfg.quant_compute)
  if "post_attn_norm" in p:
    out = rms_norm(out, p["post_attn_norm"], cfg.norm_eps)
  return out


def _moe_block(x, p, cfg: ModelConfig) -> torch.Tensor:
  """The routed FFN (ops/moe.py; quantized experts are dequantized next to
  their product there) plus the shared expert, sigmoid-gated on qwen2-moe:
  x [B, S, D] normed → [B, S, D]."""
  from ..ops.moe import moe_ffn

  B, S, D = x.shape
  xt = x.reshape(B * S, D)
  out = moe_ffn(
    xt, p["w_router"], p["w_experts_gate"], p["w_experts_up"], p["w_experts_down"],
    k=cfg.n_active_experts, scoring=cfg.router_scoring, norm_topk=cfg.norm_topk_prob, selection_bias=p.get("router_bias"),
    scale=cfg.routed_scaling_factor, capacity_factor=cfg.moe_capacity_factor, n_group=cfg.n_group, topk_group=cfg.topk_group, group_mode=cfg.group_mode,
    gate_scale=p.get("w_experts_gate_scale"), up_scale=p.get("w_experts_up_scale"), down_scale=p.get("w_experts_down_scale"), hidden_dim=cfg.moe_hidden_dim,
  )
  if "w_shared_gate" in p:
    shared = torch.nn.functional.silu(_mm(xt, p, "w_shared_gate", cfg.quant_compute).float()).to(x.dtype) * _mm(xt, p, "w_shared_up", cfg.quant_compute)
    shared = _mm(shared, p, "w_shared_down", cfg.quant_compute)
    if "w_shared_expert_gate" in p:  # qwen2-moe's sigmoid-gated shared expert
      shared = shared * torch.sigmoid((xt @ p["w_shared_expert_gate"]).float()).to(x.dtype)
    out = out + shared
  return out.reshape(B, S, D)


def _mlp_block(h, p, cfg: ModelConfig):
  """Pre-MLP norm + FFN (the routed one on an MoE layer), then gemma2's
  post-MLP norm."""
  x = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
  if "w_experts_gate" in p:
    return h + _moe_block(x, p, cfg)
  gated = _mlp_act(_mm(x, p, "w_gate", cfg.quant_compute), cfg).to(h.dtype) * _mm(x, p, "w_up", cfg.quant_compute)
  out = _mm(gated, p, "w_down", cfg.quant_compute)
  if "post_mlp_norm" in p:
    out = rms_norm(out, p["post_mlp_norm"], cfg.norm_eps)
  return h + out


def _attention(q, k, v, kv, positions, kv_positions, cfg: ModelConfig, opts: dict):
  """Write this layer's k/v into its cache slice ``kv`` (in place) and
  attend. The dispatch mirrors the reference: K1 for prefill (and int8-KV
  prefill; int4 codes take the plain path), K2 for an opted-in long-cache
  decode step, else the plain ``gqa_attention`` with the config's
  ``opts`` (``_attn_opts``)."""
  from ..ops.flash_attention import flash_attention_prefill, flash_decode_attention, flash_decode_supported, flash_supported

  S = q.shape[1]
  start = positions[:, 0]
  if "k_scale" in kv:  # int8 / int4 KV (models/quantize.py)
    from .quantize import quantize_kv, quantize_kv_int4, unpack_int4_kv

    packed = kv["k"].shape[-1] * 2 == k.shape[-1]  # int4: halved code axis
    quant_fn = quantize_kv_int4 if packed else quantize_kv
    kq, ks = quant_fn(k)
    vq, vs = quant_fn(v)
    for name, new in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
      _write_cache(kv[name], new, start)
    if cfg.plain_attention and S > 1 and not packed and flash_supported(q.shape, kv["k"].shape[1], q.device, q.dtype):
      # Prefill: codes + scales stream straight through K1 (in-kernel dequant).
      return flash_attention_prefill(q, kv["k"], kv["v"], q_offset=start, k_scale=kv["k_scale"], v_scale=kv["v_scale"])
    k_codes = unpack_int4_kv(kv["k"]) if packed else kv["k"]
    v_codes = unpack_int4_kv(kv["v"]) if packed else kv["v"]
    return gqa_attention(q, k_codes, v_codes, positions, kv_positions, k_scale=kv["k_scale"], v_scale=kv["v_scale"], **opts)
  _write_cache(kv["k"], k, start)
  _write_cache(kv["v"], v, start)
  k_cache, v_cache = kv["k"].to(q.dtype), kv["v"].to(q.dtype)
  if cfg.plain_attention and S > 1 and flash_supported(q.shape, k_cache.shape[1], q.device, q.dtype):
    # Prefill against the full cache: stale slots beyond the prompt are
    # masked by position (slot index > position).
    return flash_attention_prefill(q, k_cache, v_cache, q_offset=start)
  if cfg.plain_attention and S == 1 and flash_decode_supported(q.shape, k_cache.shape[1], q.device, q.dtype):
    return flash_decode_attention(q, k_cache, v_cache, positions)
  return gqa_attention(q, k_cache, v_cache, positions, kv_positions, **opts)


def _causal_attention(q, k, v, positions, cfg: ModelConfig, opts: dict):
  """Cache-less causal attention over the call's own k/v: K1 on the card
  with ``q_offset`` 0 (a cache-less forward runs its sequence from position
  0, so k/v row j is position j), else the plain ``gqa_attention`` — the
  reference's cache-less branch."""
  from ..ops.flash_attention import flash_attention_prefill, flash_supported

  if cfg.plain_attention and flash_supported(q.shape, k.shape[1], q.device, q.dtype):
    return flash_attention_prefill(q, k.contiguous(), v.contiguous(), q_offset=0)
  return gqa_attention(q, k, v, positions, positions[0], **opts)


def _layer_step(h, p, kv, positions, kv_positions, inv_freq, cfg: ModelConfig, adapter_ids=None):
  """One decoder layer. h [B,S,D] → h. ``kv`` is this layer's cache dict
  (views into the session cache, updated in place) or None (cache-less).
  MLA: the absorbed op against the latent cache, or, cache-less, the naive
  per-head K/V through the plain ``gqa_attention`` (never K1); it takes no
  adapters (``enable_multi_lora`` refuses MLA). ``adapter_ids`` as in
  ``_dense_qkv``."""
  x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
  if "wkv_a" in p:
    if kv is not None:
      attn = _mla_attention(x, p, kv, positions, kv_positions, inv_freq, cfg)
    else:
      q, k, v = _mla_qkv(x, p, cfg, positions, inv_freq)
      attn = gqa_attention(q, k, v, positions, positions[0])
    return _mlp_block(h + _attn_out(attn, p, cfg), p, cfg)
  q, k, v = _dense_qkv(x, p, cfg, positions, inv_freq, adapter_ids)
  opts = _attn_opts(cfg, p.get("is_sliding"))
  if kv is not None:
    attn = _attention(q, k, v, kv, positions, kv_positions, cfg, opts)
  else:
    attn = _causal_attention(q, k, v, positions, cfg, opts)
  return _mlp_block(h + _attn_out(attn, p, cfg), p, cfg)


def embed_tokens(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
  """Token ids [B,S] → embeddings [B,S,D] in model dtype; gemma2 scales
  them by sqrt(dim) cast to the model dtype first, as HF does (in bf16
  sqrt(3584) is 60.0)."""
  h = params["embed"][x].to(cfg.dtype)
  if cfg.embed_scale != 1.0:
    h = h * torch.tensor(cfg.embed_scale, dtype=cfg.dtype).item()
  return h


def head_logits(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
  """Final norm + LM head: hidden [B,S,D] → fp32 logits [B,S,V]. The head
  product runs in model dtype (a fp32 copy of the [D,V] head would double
  its bytes on every decode step), or through ``qdot`` for a quantized
  head."""
  h = rms_norm(h, params["final_norm"], cfg.norm_eps)
  if "lm_head_scale" in params:
    logits = qdot(h, params["lm_head"], params["lm_head_scale"], cfg.quant_compute or QUANT_COMPUTE).float()
  else:
    w_out = params.get("lm_head")
    if w_out is None:
      w_out = params["embed"].T  # tied embeddings, single-params case
    logits = (h @ w_out.to(h.dtype)).float()
  if cfg.final_logit_softcap:  # gemma2
    logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
  return logits


STACKS = ("layers", "moe_layers")


def layer_params(params: Params):
  """Each layer's leaves (views), in order: the dense stack, then the MoE
  stack. The i-th layer yielded is cache layer i of the shard."""
  for name in STACKS:
    stack = params.get(name)
    if stack:
      for i in range(stack["attn_norm"].shape[0]):
        yield {key: val[i] for key, val in stack.items()}


def _forward_layers(params: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, kv_cache: Params | None, adapter_ids=None) -> torch.Tensor:
  """Embed (token ids) and run every layer of ``params``: hidden [B,S,D]."""
  h = embed_tokens(params, cfg, x) if x.dim() == 2 else x.to(cfg.dtype)
  inv_freq = rope_inv_freq(cfg, device=h.device)
  kv_positions = torch.arange(kv_cache["k"].shape[2], dtype=torch.int32, device=h.device) if kv_cache is not None else None
  for i, lp in enumerate(layer_params(params)):
    kv = None if kv_cache is None else {key: val[i] for key, val in kv_cache.items()}
    h = _layer_step(h, lp, kv, positions, kv_positions, inv_freq, cfg, adapter_ids)
  return h


def shard_forward(
  params: Params,
  cfg: ModelConfig,
  shard: Shard,
  x: torch.Tensor,  # [B,S] int tokens (first shard) | [B,S,D] hidden
  positions: torch.Tensor,  # [B,S] int32 absolute positions
  kv_cache: Params | None = None,
  head_pos: torch.Tensor | None = None,  # [B] per-row S-axis index for the head
  adapter_ids: torch.Tensor | None = None,  # [B] per-row adapter slot
) -> tuple[torch.Tensor, Params | None]:
  """Run the shard's layers. Returns (hidden | logits, cache).

  With a cache (updated in place): queries attend to every cache slot ≤
  their absolute position. Without: causal attention within the call, the
  sequence starting at position 0 (K1 on the card). ``head_pos`` (last
  shard only) gathers one row per batch entry before the LM head, returning
  logits [B, 1, V]. ``adapter_ids`` applies each row's adapter
  (``_dense_qkv``); None is the base model.
  """
  h = _forward_layers(params, cfg, x, positions, kv_cache, adapter_ids)
  if not shard.is_last_layer:
    return h, kv_cache
  if head_pos is not None:
    h = h[torch.arange(h.shape[0], device=h.device), head_pos.to(h.device)][:, None, :]
  return head_logits(params, cfg, h), kv_cache


# ---------------------------------------------------------------- scoring
# (OpenAI ``logprobs``): the serving paths return token ids only, so
# logprobs are recomputed after the fact in one forward over prompt and
# completion, only when a client asks. The head runs on the scored rows
# alone: full-sequence logits would be [S, V] f32, ~2 GB at 4K tokens.


@tracked("prefill.score_last", ("cfg", "shard", "n_scored", "top_n"))
def score_last_tokens(params, cfg: ModelConfig, shard: Shard, tokens, seq_len, n_scored: int, top_n: int):
  """Logprobs of the last ``n_scored`` tokens of a [1, S_pad] sequence.

  One cache-less forward (K1 in every layer on the card, at Sq = Skv =
  S_pad from position 0); ``seq_len`` (an int or an int32 scalar tensor)
  is the real length, and the padding past it is inert under causal
  attention. The hidden states at positions
  ``seq_len - n_scored - 1 …`` predict the scored tokens; the indices are
  clipped into range, so an ``n_scored`` bucketed past the sequence gives
  junk leading rows that the caller slices off. Returns (chosen_logprob
  [n], top_ids [n, top_n], top_logprobs [n, top_n]), log_softmax in f32.
  Full-model shards only."""
  _full_model(shard, "score_last_tokens")
  S = tokens.shape[1]
  positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(tokens.shape[0], S)
  h = _forward_layers(params, cfg, tokens, positions, None)
  idx = (seq_len - n_scored - 1 + torch.arange(n_scored, device=tokens.device)).clamp(0, S - 2)
  logp = torch.log_softmax(head_logits(params, cfg, h[:, idx])[0].float(), dim=-1)  # [n, V]
  chosen_lp = logp.gather(1, tokens[0, idx + 1].long()[:, None])[:, 0]
  top_lp, top_ids = torch.topk(logp, top_n, dim=-1)
  return chosen_lp, top_ids, top_lp


# ---------------------------------------------------------------- decoding


def _next_token(row: torch.Tensor, generator, greedy: bool, temp: float, top_k: int) -> torch.Tensor:
  from ..ops.sampling import greedy as greedy_pick, sample_logits

  if greedy:
    return greedy_pick(row)
  return sample_logits(row, generator, temp=temp, top_k=top_k)


def _full_model(shard: Shard, what: str) -> None:
  if not (shard.is_first_layer and shard.is_last_layer):
    raise ValueError(f"{what} requires a full-model shard")


class _Like:
  """Stands in for a tensor in a ledger signature (an int the caller passes
  where the reference passes an array: the same program either way)."""

  def __init__(self, dtype, shape, device) -> None:
    self.dtype, self.shape, self.device = dtype, tuple(shape), torch.device(device)


def _like(x, shape, device, dtype=torch.int32):
  return x if isinstance(x, torch.Tensor) else _Like(dtype, shape, device)


def routing_knobs() -> tuple:
  """The env knobs the forward reads at call time to pick a route (K1 or
  not, K2 or not, K4 or not, the MoE gather or einsum path). A captured
  graph holds the route it was captured with, so graphs are keyed on these
  too."""
  return tuple(os.getenv(k) for k in ("XOT_TPU_NO_FLASH", "XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN", "XOT_TPU_INT4_KERNEL", "XOT_TPU_MOE_GATHER"))


_SOLO_STATIC = ("cfg", "shard", "n_steps", "max_steps", "top_k", "greedy", "eos_ids")


def _solo_sig(params, cfg, shard, token, cache, start_pos, temp, adapter_ids=None, **static) -> dict:
  """The ledger signature of a solo decode program: the reference's
  arguments (token [B,1] and start_pos [B] int32, temp a device f32
  scalar, and with an adapter its [B] int32 slots), its static ones by
  value."""
  B, dev = cache["k"].shape[1], cache["k"].device
  sig = dict(
    params=params, cfg=cfg, shard=shard, token=_like(token, (B, 1), dev), cache=cache,
    start_pos=_like(start_pos, (B,), dev), temp=_Like(torch.float32, (), dev), **static,
  )
  if adapter_ids is not None:
    sig["adapter_ids"] = _like(adapter_ids, (B,), dev)
  return sig


def _adapter_rows(adapter_ids, B: int, dev):
  """``adapter_ids`` (None, an int slot for every row, or [B] slots) as an
  int32 [B] device tensor, or None."""
  if adapter_ids is None or isinstance(adapter_ids, torch.Tensor):
    return adapter_ids
  return torch.full((B,), int(adapter_ids), dtype=torch.int32, device=dev)


def fused_decode(params, cfg: ModelConfig, shard: Shard, token, cache, start_pos, n_steps: int, temp: float = 0.0, top_k: int = 35, generator=None, programs=None, adapter_ids=None):
  """Generate ``n_steps`` tokens on the device with no host round trip.

  token [B,1] int32; start_pos [B] int32. Each step's token feeds the next
  on the device; the cache updates in place. Returns (tokens [B, n_steps],
  cache). One dispatch of the ``decode.fused`` family. With ``programs``
  (the ``SoloPrograms`` of ``cache``; token and start_pos may then be
  ints) each step is one replay of its captured decode step; without, the
  steps run eagerly, op by op. ``adapter_ids`` (an int slot or [B]) applies
  each row's adapter (``_dense_qkv``).
  """
  _full_model(shard, "fused_decode")
  greedy = temp is None or float(temp) <= 0.0
  n_steps, top_k = int(n_steps), int(top_k)
  sig = _solo_sig(params, cfg, shard, token, cache, start_pos, temp, adapter_ids, n_steps=n_steps, top_k=top_k, greedy=greedy)
  if programs is not None:
    run = lambda: programs.decode(token, start_pos, n_steps, temp, top_k, greedy, adapter_ids)  # noqa: E731
  else:
    run = lambda: _decode_eager(params, cfg, shard, token, cache, start_pos, n_steps, temp, top_k, greedy, generator, adapter_ids)  # noqa: E731
  return ledger.dispatch("decode.fused", sig, _SOLO_STATIC, run), cache


def _decode_eager(params, cfg, shard, token, cache, start_pos, n_steps, temp, top_k, greedy, generator, adapter_ids=None):
  pos = start_pos.to(torch.int32)
  aid = _adapter_rows(adapter_ids, token.shape[0], token.device)
  out = []
  for _ in range(n_steps):
    logits, cache = shard_forward(params, cfg, shard, token, pos[:, None], cache, adapter_ids=aid)
    nxt = _next_token(logits[:, 0, :], generator, greedy, temp, top_k)
    out.append(nxt)
    token, pos = nxt[:, None], pos + 1
  return torch.stack(out, dim=1)


def fused_generate(
  params,
  cfg: ModelConfig,
  shard: Shard,
  token,  # [B,1] int32 — the token that seeds generation
  cache,
  start_pos,  # [B] int32
  max_steps: int,
  eos_ids: tuple = (),
  temp: float = 0.0,
  top_k: int = 35,
  generator=None,
  n_limit: int | None = None,
  programs=None,
  adapter_ids=None,
):
  """Generate until every row has sampled an EOS id or ``n_limit`` steps
  (default ``max_steps``). Returns (tokens [B, max_steps] int32, steps run,
  cache). Rows keep their EOS token; positions past a row's EOS hold what
  was sampled before every row finished (callers trim at the first EOS).
  All rows' EOS is read on the host every ``EOS_CHECK_EVERY`` steps. One
  dispatch of ``decode.fused_generate``; ``programs`` as in ``fused_decode``
  (``max_steps`` sizes the buffer and keys the program, ``n_limit`` caps
  the steps, as in the reference; ``adapter_ids`` as in ``fused_decode``).
  """
  _full_model(shard, "fused_generate")
  greedy = temp is None or float(temp) <= 0.0
  max_steps, top_k, eos_ids = int(max_steps), int(top_k), tuple(eos_ids)
  limit = min(int(max_steps if n_limit is None else n_limit), max_steps)
  sig = _solo_sig(params, cfg, shard, token, cache, start_pos, temp, adapter_ids, max_steps=max_steps, eos_ids=eos_ids, top_k=top_k, greedy=greedy, n_limit=limit)
  if programs is not None:
    run = lambda: programs.generate(token, start_pos, max_steps, eos_ids, temp, top_k, greedy, limit, adapter_ids)  # noqa: E731
  else:
    run = lambda: _generate_eager(params, cfg, shard, token, cache, start_pos, max_steps, eos_ids, temp, top_k, greedy, generator, limit, adapter_ids)  # noqa: E731
  buf, n = ledger.dispatch("decode.fused_generate", sig, _SOLO_STATIC, run)
  return buf, n, cache


def _generate_eager(params, cfg, shard, token, cache, start_pos, max_steps, eos_ids, temp, top_k, greedy, generator, limit, adapter_ids=None):
  B = token.shape[0]
  aid = _adapter_rows(adapter_ids, B, token.device)
  buf = torch.zeros((B, max_steps), dtype=torch.int32, device=token.device)
  eos = torch.tensor(sorted(eos_ids), dtype=torch.int32, device=token.device) if eos_ids else None
  done = torch.zeros((B,), dtype=torch.bool, device=token.device)
  pos = start_pos.to(torch.int32)
  n = 0
  while n < limit:
    logits, cache = shard_forward(params, cfg, shard, token, pos[:, None], cache, adapter_ids=aid)
    nxt = _next_token(logits[:, 0, :], generator, greedy, temp, top_k)
    buf[:, n] = nxt
    n += 1
    token, pos = nxt[:, None], pos + 1
    if eos is not None:
      done |= torch.isin(nxt, eos)
      if n % EOS_CHECK_EVERY == 0 and bool(done.all()):
        break
  return buf, n


class SoloPrograms:
  """The captured solo programs of one dense slot cache: the reference's
  one-program-per-dispatch execution on a CUDA device.

  - ``prefill`` — one prompt padded to its ``PREFILL_BUCKET`` bucket, from
    position 0 (family ``decode.shard_forward``): one graph per bucket;
  - ``prefill_embeds`` — the same prefill entered with embeddings instead
    of token ids (llava: the prompt's embeddings with the image features
    merged in, models/vision.py), family ``prefill.embeds``: one graph per
    bucket, the embeddings copied into its input buffer;
  - ``forward`` — one token's logits at a position (``decode.shard_forward``);
  - ``decode`` / ``generate`` (``fused_decode`` / ``fused_generate`` with
    ``programs=``): one graph per sampling variant (greedy, or sampled at one
    ``top_k``), one replay per token. The step reads its token and position
    from device buffers and writes the next ones back, so the chunk's
    replays go out back to back with no host read; the temperature is a
    device scalar filled before the replays, so one graph serves every
    temperature. Each step stores its token at ``hist[row, position]``, and
    a chunk's tokens are gathered from there once its replays are queued.

  Inputs live in buffers filled in place (``tok``, ``pos``, ``temp``, the
  bucket's tokens and ``head_pos``, and ``aid``, each row's adapter slot);
  outputs are copied into buffers allocated outside the captures. A graph
  is keyed on what its body depends on besides those buffers: the bucket
  or sampling variant, whether the adapter hook runs (a session with an
  adapter, ``adapter_ids`` given: its slot is data, so one graph serves
  every adapter), and the routing knobs (``routing_knobs``). The engine keeps one instance per
  pooled cache (inference/torch_engine.py), so a graph's addresses stay
  valid across requests; stale slots of a reused cache lie beyond every
  query's position and are masked as a fresh cache's zeros are. The
  ``generator`` is registered with every graph that samples, so a
  replayed step draws what the eager step would. On the CPU every program
  runs its body eagerly through the same buffers.

  Solo speculation, with ``draft`` (the draft's own ``SoloPrograms`` over
  its dense cache, pooled with this one; its ``prefill`` is the draft's
  prompt prefill, one graph per bucket):

  - ``spec_rounds`` — the draft chain's rounds (``spec.chunk`` /
    ``spec.generate``): one graph per depth G holds one round (G draft
    steps, the verify window, the catch-up, a chunk's outputs) on state
    buffers filled in place (``_spec_solo_state``: the limits and the EOS
    row included), the host's schedule and its one read per block
    unchanged;
  - ``spec_batch`` — the n-gram chain's chunk (``spec.batch``,
    ``fused_spec_batch_decode`` with ``params_d=None``): one graph per
    (rounds, G, ``k_max``, with or without proposals), the proposals in a
    buffer at their largest length ``rounds·(G+1)+G``.

  Every output is copied out of the graph's buffers after the run: a
  chained chunk's replays overwrite them before the host reads the one
  before."""

  def __init__(self, params, cfg: ModelConfig, shard: Shard, cache, generator=None, pool=None, draft: SoloPrograms | None = None) -> None:
    _full_model(shard, "SoloPrograms")
    self.params, self.cfg, self.shard, self.cache = params, cfg, shard, cache
    self.generator, self.pool, self.draft = generator, pool, draft
    k = cache["k"]
    B, S, dev = k.shape[1], k.shape[2], k.device
    self.B, self.max_seq, self.device = B, S, dev
    self.tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    self.temp = torch.ones((), dtype=torch.float32, device=dev)
    self.aid = torch.zeros((B,), dtype=torch.int32, device=dev)  # each row's adapter slot
    self.hist = torch.zeros((B, S), dtype=torch.int32, device=dev)  # hist[b, p]: the token sampled at position p
    self.offsets = torch.arange(S, dtype=torch.int64, device=dev)
    self.logits = torch.zeros((B, 1, cfg.vocab_size), dtype=torch.float32, device=dev)
    self._buckets: dict = {}  # by bucket width (token ids) or ("embeds", width)
    self._eos: dict[tuple, torch.Tensor] = {}
    self._graphs: dict[tuple, Graph] = {}
    self._spec: dict[tuple, dict] = {}  # speculation's buffers, by graph key
    self._spec_gen = None  # the n-gram chunk's sampling generator (its rows are greedy)

  def _graph(self, key: tuple, family: str, body, generators: tuple = ()) -> Graph:
    key = key + routing_knobs()
    g = self._graphs.get(key)
    if g is None:
      g = self._graphs[key] = Graph(family, body, generators=generators, pool=self.pool)
    return g

  def graphs(self) -> list[Graph]:
    return list(self._graphs.values())

  def _adapter(self, adapter_ids) -> bool:
    """Fill ``aid`` with ``adapter_ids`` (an int slot for every row, or
    [B]); whether the hook runs (False for None)."""
    if adapter_ids is None:
      return False
    if isinstance(adapter_ids, torch.Tensor):
      self.aid.copy_(adapter_ids.reshape(self.aid.shape))
    else:
      self.aid.fill_(int(adapter_ids))
    return True

  def _sig(self, x_shape: tuple, scalar: str, adapter_ids) -> dict:
    sig = {"params": self.params, "cfg": self.cfg, "shard": self.shard, "x": _Like(torch.int32, x_shape, self.device), "kv_cache": self.cache, scalar: _Like(torch.int32, (self.B,), self.device)}
    if adapter_ids is not None:
      sig["adapter_ids"] = _Like(torch.int32, (self.B,), self.device)
    return sig

  # ------------------------------------------------------- shard_forward

  def prefill(self, x: np.ndarray, prompt_len: int, adapter_ids=None) -> torch.Tensor:
    """Logits [B, V] of token ``prompt_len - 1`` of ``x`` [B, S] (int, a
    bucket's width, from position 0); the cache is written in place.
    ``adapter_ids``: an int slot for every row, or [B], or None."""
    return ledger.dispatch("decode.shard_forward", self._sig(x.shape, "prompt_len", adapter_ids), ("cfg", "shard"), lambda: self._prefill(x, prompt_len, adapter_ids))

  def _prefill(self, x, prompt_len, adapter_ids=None):
    S = x.shape[1]
    bufs = self._buckets.get(S)
    if bufs is None:
      bufs = self._buckets[S] = (
        torch.zeros((self.B, S), dtype=torch.int32, device=self.device),
        torch.zeros((self.B,), dtype=torch.int64, device=self.device),
        torch.arange(S, dtype=torch.int32, device=self.device).expand(self.B, S),
      )
    tokens, head_pos, positions = bufs
    hook = self._adapter(adapter_ids)

    def body():
      logits, _ = shard_forward(self.params, self.cfg, self.shard, tokens, positions, self.cache, head_pos=head_pos, adapter_ids=self.aid if hook else None)
      self.logits.copy_(logits)

    tokens.copy_(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)))
    head_pos.fill_(int(prompt_len) - 1)
    self._graph(("prefill", S, hook), "decode.shard_forward", body).run(self.device)
    return self.logits[:, 0, :].clone()

  def prefill_embeds(self, embeds: torch.Tensor, prompt_len: int, adapter_ids=None) -> torch.Tensor:
    """``prefill`` from embeddings [B, S, D] (model dtype, a bucket's
    width, from position 0) instead of token ids: logits [B, V] of position
    ``prompt_len - 1``; the cache is written in place."""
    sig = {**self._sig(embeds.shape[:2], "prompt_len", adapter_ids), "x": _Like(self.cfg.dtype, embeds.shape, self.device)}
    return ledger.dispatch("prefill.embeds", sig, ("cfg", "shard"), lambda: self._prefill_embeds(embeds, prompt_len, adapter_ids))

  def _prefill_embeds(self, embeds, prompt_len, adapter_ids=None):
    B, S = embeds.shape[:2]
    bufs = self._buckets.get(("embeds", S))
    if bufs is None:
      bufs = self._buckets[("embeds", S)] = (
        torch.zeros((B, S, self.cfg.dim), dtype=self.cfg.dtype, device=self.device),
        torch.zeros((B,), dtype=torch.int64, device=self.device),
        torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S),
      )
    inp, head_pos, positions = bufs
    hook = self._adapter(adapter_ids)

    def body():
      logits, _ = shard_forward(self.params, self.cfg, self.shard, inp, positions, self.cache, head_pos=head_pos, adapter_ids=self.aid if hook else None)
      self.logits.copy_(logits)

    inp.copy_(embeds)
    head_pos.fill_(int(prompt_len) - 1)
    self._graph(("prefill_embeds", S, hook), "prefill.embeds", body).run(self.device)
    return self.logits[:, 0, :].clone()

  def forward(self, x: np.ndarray, pos: int, adapter_ids=None) -> torch.Tensor:
    """Logits [B, V] of one token per row, ``x`` [B, 1] at position ``pos``."""
    return ledger.dispatch("decode.shard_forward", self._sig(x.shape, "pos", adapter_ids), ("cfg", "shard"), lambda: self._forward(x, pos, adapter_ids))

  def _forward(self, x, pos, adapter_ids=None):
    hook = self._adapter(adapter_ids)

    def body():
      logits, _ = shard_forward(self.params, self.cfg, self.shard, self.tok, self.pos[:, None], self.cache, adapter_ids=self.aid if hook else None)
      self.logits.copy_(logits)

    self.tok.copy_(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)))
    self.pos.fill_(int(pos))
    self._graph(("forward", hook), "decode.shard_forward", body).run(self.device)
    return self.logits[:, 0, :].clone()

  # ------------------------------------------------------------ decoding

  def _step(self, family: str, greedy: bool, top_k: int, hook: bool = False) -> Graph:
    def body():
      logits, _ = shard_forward(self.params, self.cfg, self.shard, self.tok, self.pos[:, None], self.cache, adapter_ids=self.aid if hook else None)
      nxt = _next_token(logits[:, 0, :], self.generator, greedy, self.temp, top_k)
      self.hist.scatter_(1, self.pos[:, None].long(), nxt[:, None])
      self.tok.copy_(nxt[:, None])
      self.pos.add_(1)

    return self._graph(("step", greedy, 0 if greedy else top_k, hook), family, body, generators=() if greedy else (self.generator,))

  def _seed(self, token, start_pos, temp, greedy: bool) -> None:
    for buf, val in ((self.tok, token), (self.pos, start_pos)):
      if isinstance(val, torch.Tensor):
        buf.copy_(val.reshape(buf.shape))
      else:
        buf.fill_(int(val))
    if not greedy:
      self.temp.fill_(float(temp))

  def _since(self, n: int) -> torch.Tensor:
    """The last ``n`` steps' tokens [B, n], gathered from ``hist``."""
    idx = (self.pos[:, None] - n).long() + self.offsets[None, :n]
    return torch.gather(self.hist, 1, idx)

  def decode(self, token, start_pos, n_steps: int, temp, top_k: int, greedy: bool, adapter_ids=None) -> torch.Tensor:
    self._seed(token, start_pos, temp, greedy)
    step = self._step("decode.fused", greedy, top_k, self._adapter(adapter_ids))
    for _ in range(n_steps):
      step.run(self.device, "decode.fused")
    return self._since(n_steps)

  def generate(self, token, start_pos, max_steps: int, eos_ids: tuple, temp, top_k: int, greedy: bool, limit: int, adapter_ids=None):
    self._seed(token, start_pos, temp, greedy)
    step = self._step("decode.fused_generate", greedy, top_k, self._adapter(adapter_ids))
    eos = None
    if eos_ids:
      eos = self._eos.get(eos_ids)
      if eos is None:
        eos = self._eos[eos_ids] = torch.tensor(sorted(eos_ids), dtype=torch.int32, device=self.device)
    n = 0
    while n < limit:
      step.run(self.device, "decode.fused_generate")
      n += 1
      if eos is not None and n % EOS_CHECK_EVERY == 0 and bool(torch.isin(self._since(n), eos).any(dim=1).all()):
        break
    buf = torch.zeros((self.B, max_steps), dtype=torch.int32, device=self.device)
    buf[:, :n] = self._since(n)
    return buf, n

  # --------------------------------------------------------- speculation

  def spec_rounds(self, family: str, token, pos, pos_hi: int, max_steps: int, G: int, eos_ids: tuple, limit: int, n_limit: int) -> tuple[dict, int, int]:
    """``_spec_solo_rounds`` on this cache and the draft's: the state kept
    per depth, each round one replay of the depth's captured round
    (counted under ``family``). Returns (state, n, rounds)."""
    d = self.draft
    if max_steps > self.max_seq:
      raise ValueError(f"a speculative dispatch of {max_steps} steps exceeds the {self.max_seq}-slot cache")
    width = max(SPEC_EOS_SLOTS, len(eos_ids))
    key = ("spec_round", G, width)
    st = self._spec.get(key)
    if st is None:
      st = self._spec[key] = _spec_solo_state(self.device, self.max_seq + G + 1, width)
    eos_row = self._spec.get(("eos", eos_ids, width))
    if eos_row is None:
      eos_row = self._spec[("eos", eos_ids, width)] = _spec_eos_row(eos_ids, width, self.device)
    _spec_solo_fill(st, token, pos, eos_row, limit, n_limit)
    graph = self._graph(key, family, lambda: _spec_solo_round(self.params, self.cfg, self.shard, d.params, d.cfg, d.shard, self.cache, d.cache, st, G))
    n, rounds = _spec_solo_schedule(lambda: graph.run(self.device, family), st, limit, G + 1, self.max_seq, pos_hi)
    return st, n, rounds

  def spec_generate(self, token, start: int, max_steps: int, G: int, eos_ids: tuple, limit: int) -> tuple:
    """``fused_speculative_generate``'s rounds: (buf [max_steps+G+1], n,
    rounds), the buffer a fresh tensor."""
    st, n, rounds = self.spec_rounds("spec.generate", token, start, start, max_steps, G, eos_ids, limit, limit)
    return st["buf"][: max_steps + G + 1].clone(), n, rounds

  def spec_batch(self, token, positions, active, gammas, temps, top_ks, n_rounds: int, G: int, k_max: int, props=None, prop_counts=None) -> tuple:
    """``fused_spec_batch_decode`` on this cache without a draft: (tokens
    [B, n_rounds·(G+1)], counts [B], n_prop [B], next_token [B, 1],
    next_positions [B]), fresh tensors. The operands are device tensors of
    the function's (already normalized) dtypes, ``props`` at most
    ``n_rounds·(G+1)+G`` wide; the sampling generator is reseeded with 0
    before each run, as the function seeds a fresh one."""
    B, dev, W = self.B, self.device, G + 1
    key = ("spec_batch", n_rounds, G, k_max, props is not None)
    bufs = self._spec.get(key)
    if bufs is None:
      i32 = dict(dtype=torch.int32, device=dev)
      vec = lambda dtype=torch.int32: torch.zeros((B,), dtype=dtype, device=dev)  # noqa: E731
      bufs = self._spec[key] = dict(
        token=torch.zeros((B, 1), **i32), positions=vec(), active=vec(torch.bool), gammas=vec(), temps=vec(torch.float32), top_ks=vec(),
        props=torch.zeros((B, n_rounds * W + G), **i32), prop_counts=vec(),
        tokens=torch.zeros((B, n_rounds * W), **i32), counts=vec(), n_prop=vec(), next_token=torch.zeros((B, 1), **i32), next_positions=vec(),
      )
    for name, val in (("token", token), ("positions", positions), ("active", active), ("gammas", gammas), ("temps", temps), ("top_ks", top_ks)):
      bufs[name].copy_(val.reshape(bufs[name].shape))
    if props is not None:
      bufs["props"].zero_()
      bufs["props"][:, : props.shape[1]].copy_(props)
      bufs["prop_counts"].copy_(prop_counts)
    if self._spec_gen is None:
      self._spec_gen = torch.Generator(device=dev)
    outs = ("tokens", "counts", "n_prop", "next_token", "next_positions")

    def body():
      p, c = (bufs["props"], bufs["prop_counts"]) if props is not None else (None, None)

      def verify(window, wpos):
        logits, _ = shard_forward(self.params, self.cfg, self.shard, window, wpos, self.cache)
        return logits

      res = _spec_batch_rounds(verify, bufs["token"], bufs["positions"], bufs["active"], torch.clamp(bufs["gammas"], max=G), bufs["temps"], bufs["top_ks"], n_rounds, G, k_max, self._spec_gen, p, c)
      for name, val in zip(outs, res):
        bufs[name].copy_(val)

    self._graph(key, "spec.batch", body, generators=(self._spec_gen,)).run(dev, "spec.batch", seed=0)
    return tuple(bufs[name].clone() for name in outs)


class ShardPrograms:
  """The captured programs of a partial shard's dense slot cache: a ring
  node's counterparts of the reference's jitted ``_prefill`` and
  ``_decode_step`` (inference/jax_engine.py), one CUDA-graph replay per
  dispatch.

  - ``prefill`` — one prompt padded to its bucket, from position 0
    (family ``ring.prefill``): one graph per bucket width;
  - ``prefill_embeds`` — the head's prefill entered with embeddings [B, S,
    D] instead of token ids (llava's merged image and text embeddings;
    family ``prefill.embeds``): one graph per bucket width;
  - ``forward`` — one position per row (family ``ring.step``): one graph.

  The head (layer 0) is entered with token ids, every other shard with the
  hidden state the shard before it sent, already padded to the head's
  bucket; each arrives by a copy into the graph's input buffer. The tail
  (the last layer) returns logits [B, V] in f32: in the prefill those of
  position ``prompt_len - 1``, gathered through ``head_pos``, a device
  buffer filled per call, so no capture bakes a prompt length. Any other
  shard returns its hidden state in the model's dtype: [B, S, D] from the
  prefill, [B, 1, D] from a step. The step reads its position from the
  ``pos`` buffer. Outputs are copied out of the graphs' buffers. On the CPU
  every program runs its body eagerly through the same buffers."""

  def __init__(self, params, cfg: ModelConfig, shard: Shard, cache, pool=None) -> None:
    if shard.is_first_layer and shard.is_last_layer:
      raise ValueError("a full-model shard takes SoloPrograms")
    self.params, self.cfg, self.shard, self.cache, self.pool = params, cfg, shard, cache, pool
    k = cache["k"]
    B, S, dev = k.shape[1], k.shape[2], k.device
    self.B, self.max_seq, self.device = B, S, dev
    self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    self.head_pos = torch.zeros((B,), dtype=torch.int64, device=dev)
    self.step_in = self._input((B, 1))
    self.step_out = torch.zeros((B, 1, cfg.vocab_size if shard.is_last_layer else cfg.dim), dtype=torch.float32 if shard.is_last_layer else cfg.dtype, device=dev)
    self._buckets: dict = {}  # by bucket width (token ids) or ("embeds", width)
    self._graphs: dict[tuple, Graph] = {}

  def _input(self, shape: tuple) -> torch.Tensor:
    if self.shard.is_first_layer:
      return torch.zeros(shape, dtype=torch.int32, device=self.device)
    return torch.zeros((*shape, self.cfg.dim), dtype=self.cfg.dtype, device=self.device)

  def _graph(self, key: tuple, family: str, body) -> Graph:
    key = key + routing_knobs()
    g = self._graphs.get(key)
    if g is None:
      g = self._graphs[key] = Graph(family, body, pool=self.pool)
    return g

  def graphs(self) -> list[Graph]:
    return list(self._graphs.values())

  def _fill(self, buf: torch.Tensor, x) -> None:
    if isinstance(x, torch.Tensor):
      buf.copy_(x.reshape(buf.shape))
    else:
      buf.copy_(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).reshape(buf.shape))

  def _sig(self, x_shape: tuple, scalar: str) -> dict:
    x = _Like(torch.int32, x_shape, self.device) if self.shard.is_first_layer else _Like(self.cfg.dtype, (*x_shape, self.cfg.dim), self.device)
    return {"params": self.params, "cfg": self.cfg, "shard": self.shard, "x": x, "kv_cache": self.cache, scalar: _Like(torch.int32, (self.B,), self.device)}

  def prefill(self, x, prompt_len: int) -> torch.Tensor:
    """``x``: token ids [B, S] (numpy) on the head, a hidden state [B, S, D]
    (torch) elsewhere, S a bucket's width; the cache is written in place."""
    S = x.shape[1]
    return ledger.dispatch("ring.prefill", self._sig((self.B, S), "prompt_len"), ("cfg", "shard"), lambda: self._prefill(x, prompt_len))

  def _prefill(self, x, prompt_len: int) -> torch.Tensor:
    S = x.shape[1]
    bufs = self._buckets.get(S)
    if bufs is None:
      out_shape, out_dtype = ((self.B, 1, self.cfg.vocab_size), torch.float32) if self.shard.is_last_layer else ((self.B, S, self.cfg.dim), self.cfg.dtype)
      out = torch.zeros(out_shape, dtype=out_dtype, device=self.device)
      bufs = self._buckets[S] = (self._input((self.B, S)), torch.arange(S, dtype=torch.int32, device=self.device).expand(self.B, S), out)
    inp, positions, out = bufs
    last = self.shard.is_last_layer

    def body():
      y, _ = shard_forward(self.params, self.cfg, self.shard, inp, positions, self.cache, head_pos=self.head_pos if last else None)
      out.copy_(y)

    self._fill(inp, x)
    self.head_pos.fill_(int(prompt_len) - 1)
    self._graph(("prefill", S), "ring.prefill", body).run(self.device)
    return out[:, 0, :].clone() if last else out.clone()

  def prefill_embeds(self, embeds: torch.Tensor, prompt_len: int) -> torch.Tensor:
    """The head's ``prefill`` from embeddings [B, S, D] (model dtype, a
    bucket's width); returns its hidden state [B, S, D] for the next node."""
    if not self.shard.is_first_layer:
      raise ValueError("only the head shard takes embeddings")
    sig = {**self._sig((self.B, embeds.shape[1]), "prompt_len"), "x": _Like(self.cfg.dtype, embeds.shape, self.device)}
    return ledger.dispatch("prefill.embeds", sig, ("cfg", "shard"), lambda: self._prefill_embeds(embeds, prompt_len))

  def _prefill_embeds(self, embeds, prompt_len: int) -> torch.Tensor:
    S = embeds.shape[1]
    bufs = self._buckets.get(("embeds", S))
    if bufs is None:
      bufs = self._buckets[("embeds", S)] = (
        torch.zeros((self.B, S, self.cfg.dim), dtype=self.cfg.dtype, device=self.device),
        torch.arange(S, dtype=torch.int32, device=self.device).expand(self.B, S),
        torch.zeros((self.B, S, self.cfg.dim), dtype=self.cfg.dtype, device=self.device),
      )
    inp, positions, out = bufs

    def body():
      y, _ = shard_forward(self.params, self.cfg, self.shard, inp, positions, self.cache)
      out.copy_(y)

    inp.copy_(embeds)
    self._graph(("prefill_embeds", S), "prefill.embeds", body).run(self.device)
    return out.clone()

  def forward(self, x, pos: int) -> torch.Tensor:
    """``x``: one token per row [B, 1] on the head, a hidden state [B, 1, D]
    elsewhere, at position ``pos``."""
    return ledger.dispatch("ring.step", self._sig((self.B, 1), "pos"), ("cfg", "shard"), lambda: self._step(x, pos))

  def _step(self, x, pos: int) -> torch.Tensor:
    def body():
      y, _ = shard_forward(self.params, self.cfg, self.shard, self.step_in, self.pos[:, None], self.cache)
      self.step_out.copy_(y)

    self._fill(self.step_in, x)
    self.pos.fill_(int(pos))
    self._graph(("step",), "ring.step", body).run(self.device)
    return self.step_out[:, 0, :].clone() if self.shard.is_last_layer else self.step_out.clone()


# ------------------------------------------------ speculative decoding
# Greedy draft-then-verify for one stream (B=1) on the dense slot cache.
# Each round the draft proposes G tokens in G single-token steps, the target
# scores the window [cur, d_1..d_G] at pos..pos+G in ONE forward (K1 at
# Sq = G+1 on the card), the longest prefix the target agrees with is
# accepted plus the target's own next token, and the draft catches up on
# the same window (K1 again) so its cache covers slot pos+G. Every emitted
# token is the target's greedy choice: the output is plain greedy decoding
# under the verify forward's numerics, for any draft.
#
# The reference runs the rounds in one device while_loop whose condition
# (not done, n < limit, pos + G + 1 <= max_seq) lives on the device. Here
# the host runs rounds in blocks and reads (n, pos, done, rounds) back once
# per block. A round past the stopping point still runs but changes nothing
# the caller sees (its updates are masked by the condition, evaluated on
# the device), and its cache writes land in slots at or past the stream's
# end, which are rewritten before anything reads them. A round advances at
# most G+1 slots, so from a position of at most ``pos_hi`` the host runs
# (max_seq - pos_hi) // (G+1) rounds without a write past the cache, and
# reads the exact position back before any further round.
#
# A round reads and writes its state in device buffers in place
# (``_spec_solo_state``), the limits and the EOS set included, and ends by
# writing a chunk's outputs from the state it leaves, so under
# ``SoloPrograms`` one captured round per depth serves every dispatch.

# The EOS row's width: the ids padded with -1 (no token's id), so one round
# graph serves every EOS set of up to this many ids.
SPEC_EOS_SLOTS = 8


def _spec_block_rounds(limit: int, n_known: int, rounds_known: int, room_rounds: int, W: int) -> int:
  """Rounds to run before the next read-back: EOS_CHECK_EVERY, or fewer
  when the rounds so far (W tokens a round before the first read) predict
  the limit within the block, and never more than the provable room."""
  rate = W if rounds_known == 0 else n_known / rounds_known
  return min(EOS_CHECK_EVERY, room_rounds, max(1, math.ceil((limit - n_known) / rate)))


def _spec_solo_state(dev, buf_len: int, eos_width: int) -> dict:
  """The draft chain's round state on the device: ``cur`` [1,1] (the next
  round's input token), ``pos``, ``n`` (tokens emitted), ``rounds`` and
  the limits ``limit`` / ``n_limit`` [1] int32, ``done`` [1] bool, ``eos``
  [eos_width] (padded with -1), ``buf`` [buf_len] (the emitted tokens), the
  dispatch's input token and position ``tok0`` / ``pos0``, and a chunk's
  outputs as of the last round: ``packed`` [2+buf_len] = [m, rounds,
  buf...] with m = min(n, n_limit), ``seed`` [1,1] (the last of the m
  tokens, or the input token when m = 0) and ``new_pos`` [] = pos0 + m."""
  i32 = dict(dtype=torch.int32, device=dev)
  st = {name: torch.zeros((1,), **i32) for name in ("pos", "n", "rounds", "limit", "n_limit", "pos0")}
  st.update(
    cur=torch.zeros((1, 1), **i32), tok0=torch.zeros((1, 1), **i32), done=torch.zeros((1,), dtype=torch.bool, device=dev),
    eos=torch.full((eos_width,), -1, **i32), buf=torch.zeros((buf_len,), **i32),
    packed=torch.zeros((2 + buf_len,), **i32), seed=torch.zeros((1, 1), **i32), new_pos=torch.zeros((), **i32),
  )
  return st


def _spec_eos_row(eos_ids: tuple, width: int, dev) -> torch.Tensor:
  row = torch.full((width,), -1, dtype=torch.int32)
  row[: len(eos_ids)] = torch.tensor(sorted(eos_ids), dtype=torch.int32)
  return row.to(dev)


def _spec_solo_fill(st: dict, token, pos, eos_row: torch.Tensor, limit: int, n_limit: int) -> None:
  """Seed ``st`` for one dispatch, in place and without a host read:
  ``token`` an int or a [1,1] device tensor, ``pos`` an int or a device
  position (a chained chunk's), ``eos_row`` a device row of the state's
  width."""
  for name, val in (("cur", token), ("pos", pos)):
    if isinstance(val, torch.Tensor):
      st[name].copy_(val.reshape(st[name].shape))
    else:
      st[name].fill_(int(val))
  st["tok0"].copy_(st["cur"])
  st["pos0"].copy_(st["pos"])
  for name in ("n", "rounds", "done", "buf", "packed"):
    st[name].zero_()
  st["seed"].copy_(st["tok0"])
  st["new_pos"].copy_(st["pos0"][0])
  st["limit"].fill_(int(limit))
  st["n_limit"].fill_(int(n_limit))
  st["eos"].copy_(eos_row)


def _spec_solo_round(params_t, cfg_t, shard_t, params_d, cfg_d, shard_d, cache_t, cache_d, st: dict, G: int) -> None:
  """One draft-then-verify round on the state ``st`` (``_spec_solo_state``),
  updated in place; where the loop's condition was already false nothing
  the caller reads changes."""
  cur, pos, n, done, buf = st["cur"], st["pos"], st["n"], st["done"], st["buf"]
  dev = cur.device
  W = G + 1
  idx = torch.arange(W, dtype=torch.int32, device=dev)
  live = ~done & (n < st["limit"])
  # 1) The draft proposes G tokens greedily, one single-token step each.
  tok, p, d = cur, pos, []
  for _ in range(G):
    logits, _ = shard_forward(params_d, cfg_d, shard_d, tok, p[:, None], cache_d)
    nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
    d.append(nxt)
    tok, p = nxt[:, None], p + 1
  d = torch.cat(d) if d else torch.zeros((0,), dtype=torch.int32, device=dev)
  # 2) The target verifies [cur, d_1..d_G] at pos..pos+G in one forward.
  window = torch.cat([cur[0], d])[None, :]
  positions = (pos + idx)[None, :]
  logits_t, _ = shard_forward(params_t, cfg_t, shard_t, window, positions, cache_t)
  t = torch.argmax(logits_t[0], dim=-1).to(torch.int32)  # t[i]: the target's token for position pos+i+1
  # 3) Longest agreeing prefix, then the target's own next token.
  n_acc = torch.cumprod((d == t[:G]).to(torch.int32), dim=0).sum().reshape(1).to(torch.int32)
  corr = torch.gather(t, 0, n_acc.long())
  emitted = torch.where(idx < n_acc, torch.cat([d, torch.zeros((1,), dtype=torch.int32, device=dev)]), corr)
  # Slots past n_acc hold the correction too; the next round's append
  # overwrites them. A masked round writes back what is there.
  slots = torch.clamp(n + idx, max=buf.numel() - 1).long()
  buf.scatter_(0, slots, torch.where(live, emitted, buf[slots]))
  # 4) Draft catch-up over the same window: the sequential proposal never
  # writes the last proposed token's KV.
  shard_forward(params_d, cfg_d, shard_d, window, positions, cache_d)
  k = n_acc + 1
  hit = ((emitted[:, None] == st["eos"][None, :]) & (idx[:, None] < k)).any().reshape(1)
  new = (
    torch.where(live, corr, cur[0]).reshape(1, 1), torch.where(live, pos + k, pos), torch.where(live, n + k, n),
    st["rounds"] + live.to(torch.int32), done | (live & hit),
  )
  for name, val in zip(("cur", "pos", "n", "rounds", "done"), new):
    st[name].copy_(val)
  # A chunk's outputs from the state this round leaves.
  m = torch.minimum(st["n"], st["n_limit"])
  st["packed"].copy_(torch.cat([m, st["rounds"], buf]))
  st["seed"].copy_(torch.where(m > 0, torch.gather(buf, 0, torch.clamp(m - 1, min=0).long()), st["tok0"].reshape(1)).reshape(1, 1))
  st["new_pos"].copy_((st["pos0"] + m)[0])


def _spec_solo_schedule(run_round, st: dict, limit: int, W: int, max_seq: int, pos_hi: int) -> tuple[int, int]:
  """The host's side of the round loop: ``run_round()`` runs one round on
  ``st``, in blocks of ``_spec_block_rounds`` with one read-back after
  each, while n < limit and a round fits below ``max_seq`` from the
  position bound ``pos_hi``. Returns (n, rounds) as last read: the final
  state's."""
  n_known = rounds_known = 0
  while n_known < limit:
    room = (max_seq - pos_hi) // W
    if room <= 0:
      break
    block = _spec_block_rounds(limit, n_known, rounds_known, room, W)
    for _ in range(block):
      run_round()
    n_known, pos_hi, rounds_known, stop = torch.cat([st["n"], st["pos"], st["rounds"], st["done"].to(torch.int32)]).tolist()
    if stop:
      break
  return n_known, rounds_known


def _spec_solo_rounds(params_t, cfg_t, shard_t, params_d, cfg_d, shard_d, cache_t, cache_d, token, pos, pos_hi: int, max_steps: int, G: int, eos_ids: tuple, limit: int, n_limit: int):
  """The round loop of ``fused_speculative_generate``/``_chunk``, eager, on
  fresh state (``buf`` [max_steps+G+1]). Returns (state, n, rounds)."""
  dev = cache_t["k"].device
  width = max(SPEC_EOS_SLOTS, len(eos_ids))
  st = _spec_solo_state(dev, max_steps + G + 1, width)
  _spec_solo_fill(st, token, pos, _spec_eos_row(eos_ids, width, dev), limit, n_limit)
  n, rounds = _spec_solo_schedule(
    lambda: _spec_solo_round(params_t, cfg_t, shard_t, params_d, cfg_d, shard_d, cache_t, cache_d, st, G), st, limit, G + 1, cache_t["k"].shape[2], pos_hi,
  )
  return st, n, rounds


def _spec_shards(shard_t: Shard, shard_d: Shard) -> None:
  if not (shard_t.is_first_layer and shard_t.is_last_layer and shard_d.is_first_layer and shard_d.is_last_layer):
    raise ValueError("speculative decoding requires full-model shards")


def _spec_programs(programs, params_d, cache_t, cache_d) -> None:
  """``programs`` must be ``cache_t``'s, with ``params_d``'s draft on
  ``cache_d``: its graphs hold those addresses."""
  d = programs.draft
  if programs.cache is not cache_t or d is None or d.cache is not cache_d or d.params is not params_d:
    raise ValueError("programs= must be the target cache's SoloPrograms, with this draft on cache_d")


_SPEC_GENERATE_STATIC = ("cfg_t", "cfg_d", "shard_t", "shard_d", "max_steps", "gamma", "eos_ids")
_SPEC_CHUNK_STATIC = ("cfg", "shard", "cfg_d", "shard_d", "steps", "gamma", "eos_ids")


def _spec_generate_sig(params_t, params_d, cfg_t, cfg_d, shard_t, shard_d, cache_t, cache_d, max_steps: int, gamma: int, eos_ids: tuple) -> dict:
  """The ledger signature of ``spec.generate`` as the reference's program
  takes its arguments: token [1,1] and the int32 scalars start_pos and
  n_limit (traced), the static ones by value."""
  dev = cache_t["k"].device
  scalar = _Like(torch.int32, (), dev)
  return dict(
    params_t=params_t, params_d=params_d, cfg_t=cfg_t, cfg_d=cfg_d, shard_t=shard_t, shard_d=shard_d, cache_t=cache_t, cache_d=cache_d,
    token=_Like(torch.int32, (1, 1), dev), start_pos=scalar, max_steps=max_steps, gamma=gamma, eos_ids=eos_ids, n_limit=scalar,
  )


def fused_speculative_generate(params_t, cfg_t: ModelConfig, shard_t: Shard, params_d, cfg_d: ModelConfig, shard_d: Shard, token, cache_t, cache_d, start_pos, max_steps: int, gamma: int = 4, eos_ids: tuple = (), n_limit=None, programs=None):
  """Greedy speculative decoding of one stream: token [1,1] int32 seeds
  it at ``start_pos`` (an int); ``cache_d`` is the draft's own dense slot
  cache, prefilled to the same position. Both caches update in place.

  Returns (buf [max_steps+gamma+1] int32 on the device, n, n_rounds, cache_t,
  cache_d): ``buf[:n]`` are the emitted tokens (trim at the first EOS
  host-side; n may pass ``n_limit`` by up to gamma); acceptance is (n /
  n_rounds - 1) / gamma. Token-identical to ``fused_generate`` at temp 0
  under exact arithmetic, for any draft. One dispatch of ``spec.generate``.
  With ``programs`` (the ``SoloPrograms`` of ``cache_t``, whose draft holds
  ``cache_d``; token may then be an int) each round is one replay of its
  captured round; without, the rounds run eagerly."""
  _spec_shards(shard_t, shard_d)
  if isinstance(token, torch.Tensor) and token.shape[0] != 1:
    raise ValueError("speculative decoding is single-stream (B=1)")
  start, max_steps, G, eos_ids = int(start_pos), int(max_steps), int(gamma), tuple(eos_ids)
  limit = min(int(max_steps if n_limit is None else n_limit), max_steps)
  sig = _spec_generate_sig(params_t, params_d, cfg_t, cfg_d, shard_t, shard_d, cache_t, cache_d, max_steps, G, eos_ids)
  if programs is not None:
    _spec_programs(programs, params_d, cache_t, cache_d)
    run = lambda: programs.spec_generate(token, start, max_steps, G, eos_ids, limit)  # noqa: E731
  else:

    def run():
      st, n, rounds = _spec_solo_rounds(params_t, cfg_t, shard_t, params_d, cfg_d, shard_d, cache_t, cache_d, token, start, start, max_steps, G, eos_ids, limit, limit)
      return st["buf"], n, rounds

  buf, n, rounds = ledger.dispatch("spec.generate", sig, _SPEC_GENERATE_STATIC, run)
  return buf, n, rounds, cache_t, cache_d


def fused_speculative_chunk(params_t, cfg: ModelConfig, shard: Shard, params_d, token, cache_t, cache_d, pos, steps: int, gamma: int = 4, eos_ids: tuple = (), n_limit=None, cfg_d: ModelConfig | None = None, shard_d: Shard | None = None, pos_hi: int | None = None, programs=None):
  """One streaming speculative chunk with a device-resident chain: the math
  of ``fused_speculative_generate`` bounded to ``n_limit`` (default
  ``steps``) emitted tokens. ``pos`` is an int or the previous chunk's
  device position; ``pos_hi`` is an upper bound of it the caller knows
  (needed when ``pos`` is a tensor, else it is read back once).

  Returns (packed [2+steps+gamma+1] int32 = [m, rounds, tokens...], seed
  [1,1], new_pos [], cache_t, cache_d), every tensor on the device and
  fresh: m = min(n, n_limit), the seed is the last of the m tokens and
  new_pos = pos + m, so chunk N+1 dispatches from chunk N's outputs before
  the host reads chunk N. ``cfg_d``/``shard_d`` default to the target's (a
  self-draft). One dispatch of ``spec.chunk``, whose program holds the
  ``spec.generate`` program as the reference's does (a build of it counts,
  not a dispatch); ``programs`` as in ``fused_speculative_generate``."""
  cfg_d, shard_d = cfg_d or cfg, shard_d or shard
  _spec_shards(shard, shard_d)
  if isinstance(pos, torch.Tensor):
    pos_hi = int(pos.reshape(-1)[0]) if pos_hi is None else int(pos_hi)
  else:
    pos_hi = int(pos)
  steps, G, eos_ids = int(steps), int(gamma), tuple(eos_ids)
  n_limit = int(steps if n_limit is None else n_limit)
  limit = min(n_limit, steps)
  dev = cache_t["k"].device
  scalar = _Like(torch.int32, (), dev)
  sig = dict(
    params_t=params_t, params_d=params_d, token=_Like(torch.int32, (1, 1), dev), cache_t=cache_t, cache_d=cache_d, pos=scalar, n_limit=scalar,
    steps=steps, gamma=G, eos_ids=eos_ids, cfg=cfg, shard=shard, cfg_d=cfg_d, shard_d=shard_d,
  )
  inner = _spec_generate_sig(params_t, params_d, cfg, cfg_d, shard, shard_d, cache_t, cache_d, steps, G, eos_ids)
  if programs is not None:
    _spec_programs(programs, params_d, cache_t, cache_d)

  def rounds():
    if programs is not None:
      return programs.spec_rounds("spec.chunk", token, pos, pos_hi, steps, G, eos_ids, limit, n_limit)[0]
    return _spec_solo_rounds(params_t, cfg, shard, params_d, cfg_d, shard_d, cache_t, cache_d, token, pos, pos_hi, steps, G, eos_ids, limit, n_limit)[0]

  def run():
    st = ledger.dispatch("spec.generate", inner, _SPEC_GENERATE_STATIC, rounds)
    return st["packed"][: 2 + steps + G + 1].clone(), st["seed"].clone(), st["new_pos"].clone()

  packed, seed, new_pos = ledger.dispatch("spec.chunk", sig, _SPEC_CHUNK_STATIC, run)
  return packed, seed, new_pos, cache_t, cache_d


# ------------------------------------------------- dense batched serving
# (inference/batch_scheduler.py under XOT_TPU_PAGED=0): one row of the slot
# cache [L, n_slots, max_seq, ...] per batch slot, slot j of a row holding
# its position j. Every family of dense, MoE and MLA stacks, bf16 or
# quantized KV; the batched draft model keeps such a cache too.


def _prefill_into_slots_impl(params, cfg: ModelConfig, shard: Shard, tokens, cache, rows, prompt_lens, adapter_ids=None):
  _dense_full_model(params, shard, "prefill_into_slots")
  K, S = tokens.shape
  positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :].expand(K, S)
  # The forward runs on a scratch cache of the padded prompt's S slots (a
  # prompt attends only below its own positions), then writes those slots
  # of the K rows in place; slots past S keep what they held, as the
  # reference's gathered rows do, masked by position until overwritten.
  temp = {key: torch.zeros((val.shape[0], K, S, *val.shape[3:]), dtype=val.dtype, device=val.device) for key, val in cache.items()}
  logits, temp = shard_forward(params, cfg, shard, tokens, positions, temp, head_pos=(prompt_lens - 1).long(), adapter_ids=adapter_ids)
  idx = rows.to(device=tokens.device, dtype=torch.int64)
  for key, val in cache.items():
    val.narrow(2, 0, S).index_copy_(1, idx, temp[key])
  return logits[:, 0, :], cache


@tracked("prefill.slots", ("cfg", "shard"))
def prefill_into_slots(params, cfg: ModelConfig, shard: Shard, tokens, cache, rows, prompt_lens, adapter_ids=None):
  """Prefill K requests into K rows of the slot cache in one forward.

  tokens [K, S_pad] int32 (each row its own prompt from position 0,
  zero-padded); rows [K] int32 — distinct slot indices, padding rows
  included (index writes between duplicates are undefined; the scheduler
  gives each padding row a spare free slot); prompt_lens [K] int32 (padding
  rows 1). Returns (last-token logits [K, V], cache written in place).

  The reference's "not donated" rule holds: the forward runs on scratch
  slots and writes the K rows only after it returns, so a prefill that
  fails leaves the pooled cache as it was, and the other rows serve on. K1
  on the card at Sq = Skv = S_pad (int8 codes included). ``adapter_ids``
  [K] int32: each row's adapter slot (``_dense_qkv``), None the base
  model."""
  return _prefill_into_slots_impl(params, cfg, shard, tokens, cache, rows, prompt_lens, adapter_ids)


@tracked("prefill.slots_sampled", ("cfg", "shard", "k_max"))
def prefill_into_slots_sampled(params, cfg: ModelConfig, shard: Shard, tokens, cache, rows, prompt_lens, temps, top_ks, generator, k_max: int, adapter_ids=None):
  """``prefill_into_slots`` with the sampling epilogue: returns
  (first_tokens [K] int32, cache)."""
  last, cache = prefill_into_slots(params, cfg, shard, tokens, cache, rows, prompt_lens, adapter_ids)
  return _next_token_batched(last, generator, temps, top_ks, k_max), cache


def _batch_decode_scan(params, cfg: ModelConfig, shard: Shard, token, cache, positions, active, temps, top_ks, n_steps: int, k_max: int, generator, adapter_ids=None):
  """The dense chunk's loop: ``n_steps`` steps over every row of the slot
  cache, each step's token feeding the next on the device. Inactive rows
  hold their token and position (they rewrite their own held slot)."""
  tok, pos = token, positions
  out = []
  for _ in range(int(n_steps)):
    logits, cache = shard_forward(params, cfg, shard, tok, pos[:, None], cache, adapter_ids=adapter_ids)
    nxt = _next_token_batched(logits[:, 0, :], generator, temps, top_ks, k_max)
    nxt = torch.where(active, nxt, tok[:, 0])
    pos = torch.where(active, pos + 1, pos)
    out.append(nxt)
    tok = nxt[:, None]
  return torch.stack(out, dim=1), tok, pos


def _row_top_ks(top_k, B: int, dev) -> torch.Tensor:
  """top_k an int (filled on the device: a host copy would block on the
  stream) or per-row values, as int32 [B]."""
  if isinstance(top_k, int):
    return torch.full((B,), top_k, dtype=torch.int32, device=dev)
  return top_k.to(device=dev, dtype=torch.int32).expand(B)


@tracked("decode.batch", ("cfg", "shard", "n_steps", "k_max"))
def fused_batch_decode(params, cfg: ModelConfig, shard: Shard, token, cache, positions, active, temps, n_steps: int, top_k=35, k_max: int = 64, generator=None, adapter_ids=None):
  """One decode chunk over every row of the slot cache.

  token [B, 1] int32, positions [B] int32, active [B] bool, temps [B] f32
  (≤ 0: greedy), top_k an int or [B] (capped at ``k_max``). Returns
  (tokens [B, n_steps], next_token [B, 1], positions [B], cache): the
  reference's contract, ``next_token`` left on the device as the next
  chunk's input. K2 carries the attention on the card with
  ``XOT_TPU_FLASH_DECODE=1`` at a window of at least
  ``XOT_TPU_FLASH_DECODE_MIN``, else the plain attention. ``adapter_ids``
  [B] int32: each row's adapter slot, None the base model."""
  _dense_full_model(params, shard, "fused_batch_decode")
  dev = token.device
  if generator is None:
    generator = torch.Generator(device=dev).manual_seed(0)
  B = token.shape[0]
  toks, nxt, pos = _batch_decode_scan(
    params, cfg, shard, token.to(torch.int32), cache, positions.to(device=dev, dtype=torch.int32), active.to(device=dev, dtype=torch.bool),
    temps.to(device=dev, dtype=torch.float32), _row_top_ks(top_k, B, dev), int(n_steps), int(k_max), generator, _ids(adapter_ids, dev),
  )
  return toks, nxt, pos, cache


# ------------------------------------------------------- paged serving
# (ops/paged.py + inference/batch_scheduler.py): rows map logical positions
# onto fixed-size pages of one shared pool through block tables [B, mp]. The
# pool is updated IN PLACE. Rows without a request keep their table zeroed,
# so their writes land in the reserved trash page 0. Dense and MoE layer
# stacks, each row with its own adapter slot (``adapter_ids``). gemma2 attends through the gather route
# (K3 has no softcap or window), as the reference's layer steps gate on
# ``cfg.plain_attention``; MLA pages hold the latent and the rope channel
# and decode through ``paged_mla_attention_ref``. MLA takes no mixed tick,
# no verify window and no batched speculation, as in the reference.

_DENSE_TOP_KEYS = frozenset({*STACKS, "embed", "final_norm", "lm_head", "lm_head_scale"})


def _no_mla(cfg: ModelConfig, what: str) -> None:
  if cfg.is_mla:
    raise ValueError(f"{what} does not support MLA models")


def paged_use_kernel(cfg: ModelConfig, batch: int, context: int, pool: Params, device) -> bool:
  """``use_kernel=None`` of the paged programs, as the reference resolves
  it: K3's route (``paged_decode_attention``) unless the config has no
  other (``paged_kernel_supported``) or the decode-path table answers
  "gather" at this (batch, window, KV quant) point (inference/paging.py
  ``select_decode_path``: always on the CPU, as off-TPU in the reference;
  the H100 table on a card). A head dim K3 lacks refuses on a card."""
  from ..inference.paging import select_decode_path
  from ..ops.paged import check_paged_kernel, paged_kernel_supported

  check_paged_kernel(cfg, device)
  return paged_kernel_supported(cfg) and select_decode_path(batch, context, pool_kv_quant(pool, cfg), device=device) != "gather"


def _ids(adapter_ids, dev):
  """Per-row adapter slots as int32 on ``dev`` (None passes through)."""
  return None if adapter_ids is None else adapter_ids.to(device=dev, dtype=torch.int32)


def _dense_full_model(params: Params, shard: Shard, what: str) -> None:
  _full_model(shard, what)
  extra = set(params) - _DENSE_TOP_KEYS
  if extra:
    raise NotImplementedError(f"{what} runs dense and MoE layer stacks only in the PyTorch port; got parameter groups {sorted(extra)}")


@tracked("prefill.pages_many", ("cfg", "shard", "page_size"))
def prefill_into_pages_many(params, cfg: ModelConfig, shard: Shard, tokens, pool, bt_rows, prefix_lens, prompt_lens, page_size: int, adapter_ids=None):
  """Prefill K requests into the page pool in one forward.

  tokens [K, S_pad] int32 — each row's prompt SUFFIX from its own
  ``prefix_lens[k]`` on; bt_rows [K, mp] int32 (padding rows all-zero: their
  writes land in the trash page); the caller keeps ``prefix_lens[k] + S_pad
  <= mp·page_size``. The rows' page windows are gathered, run through
  ``shard_forward`` (K1 with per-row ``q_offset = prefix_lens`` on the card),
  and the touched pages scattered back. Returns (last-token logits [K, V],
  pool updated in place). ``adapter_ids`` [K] int32: each row's adapter
  slot, None the base model."""
  from ..ops.paged import gather_row_pages, scatter_row_pages, touched_page_targets

  _dense_full_model(params, shard, "prefill_into_pages_many")
  K, S = tokens.shape
  temp = {key: gather_row_pages(val, bt_rows) for key, val in pool.items()}
  positions = prefix_lens[:, None] + torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
  logits, temp = shard_forward(params, cfg, shard, tokens, positions, temp, head_pos=(prompt_lens - prefix_lens - 1).long(), adapter_ids=_ids(adapter_ids, tokens.device))
  target = touched_page_targets(bt_rows, prefix_lens, prompt_lens, page_size)
  for key in pool:
    scatter_row_pages(pool[key], temp[key], target)
  return logits[:, 0, :], pool


def _next_token_batched(rows, generator, temps, top_ks, k_max: int):
  """Per-row sampling: temp ≤ 0 rows greedy, others top-k at their own
  temperature and top_k (ops/sampling.py sample_logits_per_row)."""
  from ..ops.sampling import sample_logits_per_row

  greedy_rows = torch.argmax(rows, dim=-1).to(torch.int32)
  safe_temp = torch.where(temps > 0, temps, torch.ones_like(temps))
  sampled = sample_logits_per_row(rows, generator, safe_temp, top_ks, k_max=k_max)
  return torch.where(temps > 0, sampled, greedy_rows)


def sample_rows(logits, generator, temps, top_ks, k_max: int):
  """First-token sampling for a batched admission: per-row temp/top_k over
  [K, V] logits. The unfused epilogue; ``prefill_into_pages_many_sampled``
  runs the same math on the same generator in one call."""
  return _next_token_batched(logits, generator, temps, top_ks, k_max)


@tracked("prefill.pages_many_sampled", ("cfg", "shard", "page_size", "k_max"))
def prefill_into_pages_many_sampled(params, cfg: ModelConfig, shard: Shard, tokens, pool, bt_rows, prefix_lens, prompt_lens, page_size: int, temps, top_ks, generator, k_max: int, adapter_ids=None):
  """``prefill_into_pages_many`` with the sampling epilogue: returns
  (first_tokens [K] int32, pool)."""
  last, pool = prefill_into_pages_many(params, cfg, shard, tokens, pool, bt_rows, prefix_lens, prompt_lens, page_size, adapter_ids)
  return _next_token_batched(last, generator, temps, top_ks, k_max), pool


def _paged_layer_step(h, p, pool_l, block_tables, positions, inv_freq, cfg: ModelConfig, page_size: int, use_kernel: bool, adapter_ids=None):
  """One decoder layer against the page pool — decode only (S == 1).

  ``pool_l`` is this layer's page dict: {"k", "v"} [P, Hkv, ps, kd]
  (+ "k_scale"/"v_scale" [P, Hkv, ps, 1] for int8/int4), written in place;
  positions [B, 1]. MLA pages hold the latent ("k") and the rope channel
  ("v"), one head entry."""
  from ..ops.paged import paged_decode_attention, paged_gqa_attention_ref, paged_mla_attention_ref, write_token_kv

  x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
  pos = positions[:, 0]
  lengths = pos + 1  # valid KV slots incl. the token written below
  if "wkv_a" in p:
    q_nope, q_pe, c_kv, k_pe = _mla_latents(x, p, cfg, positions, inv_freq)
    write_token_kv(pool_l["k"], c_kv[:, 0][:, None, :], block_tables, pos, page_size)
    write_token_kv(pool_l["v"], k_pe[:, 0][:, None, :], block_tables, pos, page_size)
    attn = paged_mla_attention_ref(
      q_nope, q_pe, pool_l["k"].to(h.dtype), pool_l["v"].to(h.dtype), block_tables, lengths, _mla_w_kv_b(p, h.dtype), cfg.v_head_dim, page_size,
    )
    return _mlp_block(h + _attn_out(attn, p, cfg), p, cfg)
  q, k, v = _dense_qkv(x, p, cfg, positions, inv_freq, adapter_ids)
  scales = {}
  if "k_scale" in pool_l:  # int8/int4 KV pages (models/quantize.py)
    from .quantize import quantize_kv, quantize_kv_int4

    packed = pool_l["k"].shape[-1] * 2 == k.shape[-1]  # int4: halved code axis
    quant_fn = quantize_kv_int4 if packed else quantize_kv
    kq, ks = quant_fn(k[:, 0])
    vq, vs = quant_fn(v[:, 0])
    for name, new in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
      write_token_kv(pool_l[name], new, block_tables, pos, page_size)
    scales = dict(k_scale_pool_l=pool_l["k_scale"], v_scale_pool_l=pool_l["v_scale"])
  else:
    write_token_kv(pool_l["k"], k[:, 0], block_tables, pos, page_size)
    write_token_kv(pool_l["v"], v[:, 0], block_tables, pos, page_size)
  if use_kernel and cfg.plain_attention:
    # K3 on the card: codes and scales straight off the pool. K3 has no
    # softcap or window, so gemma2 takes the gather route, as there.
    attn = paged_decode_attention(q[:, 0].contiguous(), pool_l["k"], pool_l["v"], block_tables, lengths, page_size, **scales)[:, None]
  else:
    attn = paged_gqa_attention_ref(q, pool_l["k"], pool_l["v"], block_tables, lengths, page_size, **scales, **_attn_opts(cfg, p.get("is_sliding")))
  return _mlp_block(h + _attn_out(attn, p, cfg), p, cfg)


def paged_decode_forward(params, cfg: ModelConfig, shard: Shard, tokens, positions, pool, block_tables, page_size: int, use_kernel: bool, adapter_ids=None):
  """One decode step for all rows against the page pool: tokens [B, 1]
  int32 → (logits [B, 1, V], pool updated in place). ``adapter_ids`` [B]:
  each row's adapter slot, None the base model."""
  h = embed_tokens(params, cfg, tokens)
  inv_freq = rope_inv_freq(cfg, device=h.device)
  for i, lp in enumerate(layer_params(params)):
    pool_l = {key: val[i] for key, val in pool.items()}
    h = _paged_layer_step(h, lp, pool_l, block_tables, positions, inv_freq, cfg, page_size, use_kernel, adapter_ids)
  return head_logits(params, cfg, h), pool


def _paged_decode_scan(params, cfg: ModelConfig, shard: Shard, token, pool, block_tables, positions, active, temps, top_ks, n_steps: int, k_max: int, page_size: int, use_kernel: bool, generator, adapter_ids=None):
  """The chunked paged decode loop: ``n_steps`` steps, each step's token
  feeding the next on the device (no host sync)."""
  # Inactive rows would write into whatever page their table names; pin
  # their table to the trash page so held-token rewrites can't land on a
  # page another row now owns.
  bt = torch.where(active[:, None], block_tables, torch.zeros_like(block_tables))
  tok, pos = token, positions
  out = []
  for _ in range(int(n_steps)):
    logits, pool = paged_decode_forward(params, cfg, shard, tok, pos[:, None], pool, bt, page_size, use_kernel, adapter_ids)
    nxt = _next_token_batched(logits[:, 0, :], generator, temps, top_ks, k_max)
    nxt = torch.where(active, nxt, tok[:, 0])  # inactive rows hold their token
    pos = torch.where(active, pos + 1, pos)  # ...and their position
    out.append(nxt)
    tok = nxt[:, None]
  return torch.stack(out, dim=1), tok, pos, pool


@tracked("decode.paged_batch", ("cfg", "shard", "n_steps", "k_max", "page_size", "use_kernel"))
def fused_paged_batch_decode(params, cfg: ModelConfig, shard: Shard, token, pool, block_tables, positions, active, temps, n_steps: int, top_k=35, k_max: int = 64, page_size: int = 64, use_kernel: bool | None = None, generator=None, adapter_ids=None):
  """One decode chunk over every row of the page pool.

  token [B, 1] int32 (each row's last token), block_tables [B, mp] int32
  (the host must have allocated pages covering [pos, pos + n_steps) for
  every active row), positions [B] int32, active [B] bool, temps [B] f32
  (≤ 0: greedy), top_k an int or [B] per-row (capped at ``k_max``).
  Returns (tokens [B, n_steps], next_token [B, 1], positions [B], pool):
  ``next_token`` stays on the device and is the next chunk's input.
  Inactive rows do not advance. ``use_kernel=None`` resolves through
  ``paged_use_kernel``. ``adapter_ids`` [B] int32: each row's adapter
  slot, None the base model."""
  _dense_full_model(params, shard, "fused_paged_batch_decode")
  dev = token.device
  B = token.shape[0]
  if use_kernel is None:
    use_kernel = paged_use_kernel(cfg, B, block_tables.shape[1] * int(page_size), pool, dev)
  if generator is None:
    generator = torch.Generator(device=dev).manual_seed(0)
  top_ks = _row_top_ks(top_k, B, dev)
  return _paged_decode_scan(
    params, cfg, shard, token.to(torch.int32), pool, block_tables.to(torch.int32).contiguous(), positions.to(torch.int32), active.to(torch.bool),
    temps.to(torch.float32), top_ks, int(n_steps), int(k_max), int(page_size), bool(use_kernel), generator, _ids(adapter_ids, dev),
  )


# --------------------------------------------------- mixed prefill+decode tick
# (inference/batch_scheduler.py, XOT_TPU_MIXED_TICK): one call per tick
# advances every resident row by its decode chunk AND pushes one admission's
# prefill forward by a token-budgeted slice, so resident rows never idle for
# a whole prefill chunk. Correct by page disjointness: the prefilling row's
# private pages are in no decode row's block table (pages stay private until
# donated at release), and shared prefix pages are read-only for both
# halves, so the decode half reads exactly what the plain program would.


def _fused_mixed_paged_batch_decode_impl(params, cfg: ModelConfig, shard: Shard, token, pool, block_tables, positions, active, temps, top_ks, pf_tokens, pf_bt, pf_prefix, pf_end, n_steps: int, k_max: int, page_size: int, use_kernel: bool, generator, adapter_ids=None, pf_adapter=None):
  from ..ops.paged import gather_row_pages, scatter_row_pages, touched_page_targets

  # Prefill half: prefill_into_pages_many's gather → shard_forward (K1 on
  # the card, q_offset = pf_prefix) → scatter, with no sampling: an
  # intermediate slice emits no token (the final slice samples through the
  # ordinary admission dispatch). Pad rows past pf_end write junk into the
  # gathered window only; touched_page_targets keeps it out of pages below
  # the slice and past its end, and the next slice overwrites the rest of
  # the last page before anything reads it.
  S = pf_tokens.shape[1]
  temp = {key: gather_row_pages(val, pf_bt) for key, val in pool.items()}
  ppos = pf_prefix[:, None] + torch.arange(S, dtype=torch.int32, device=pf_tokens.device)[None, :]
  # The slice applies its own admission's adapter (``pf_adapter`` [1]).
  _, temp = shard_forward(params, cfg, shard, pf_tokens, ppos, temp, head_pos=(pf_end - pf_prefix - 1).long(), adapter_ids=pf_adapter)
  target = touched_page_targets(pf_bt, pf_prefix, pf_end, page_size)
  for key in pool:
    scatter_row_pages(pool[key], temp[key], target)
  # Decode half: the plain chunk's loop, unchanged (K3 on the card).
  return _paged_decode_scan(params, cfg, shard, token, pool, block_tables, positions, active, temps, top_ks, n_steps, k_max, page_size, use_kernel, generator, adapter_ids)


@tracked("decode.mixed_paged_batch", ("cfg", "shard", "n_steps", "k_max", "page_size", "use_kernel"))
def fused_mixed_paged_batch_decode(params, cfg: ModelConfig, shard: Shard, token, pool, block_tables, positions, active, temps, pf_tokens, pf_bt, pf_prefix, pf_end, n_steps: int, top_k=35, k_max: int = 64, page_size: int = 64, use_kernel: bool | None = None, generator=None, adapter_ids=None, pf_adapter=None):
  """``fused_paged_batch_decode`` with one admission's prefill slice fused in.

  Decode operands as in ``fused_paged_batch_decode``; the slice is
  ``pf_tokens`` [1, S_pad] (the prompt's tokens from ``pf_prefix`` on,
  zero-padded), ``pf_bt`` [1, mp] (the admission's block-table row; the
  caller has allocated pages covering ``pf_end``) and [1] int32
  ``pf_prefix``/``pf_end`` bounding the slice's absolute positions
  (``pf_prefix + S_pad <= mp·page_size``). Returns the plain contract
  (tokens [B, n_steps], next_token [B, 1], positions [B], pool updated in
  place): the slice emits nothing, its pages advance. A partial shard,
  an MLA model (as in the reference) and any parameter set but the
  decoder's are refused. ``use_kernel=None`` resolves as in
  ``fused_paged_batch_decode``. ``adapter_ids`` [B] are the decode rows'
  adapter slots, ``pf_adapter`` [1] the slice's own."""
  _dense_full_model(params, shard, "fused_mixed_paged_batch_decode")
  _no_mla(cfg, "fused_mixed_paged_batch_decode")
  dev = token.device
  B = token.shape[0]
  if use_kernel is None:
    use_kernel = paged_use_kernel(cfg, B, block_tables.shape[1] * int(page_size), pool, dev)
  if generator is None:
    generator = torch.Generator(device=dev).manual_seed(0)
  top_ks = _row_top_ks(top_k, B, dev)
  return _fused_mixed_paged_batch_decode_impl(
    params, cfg, shard, token.to(torch.int32), pool, block_tables.to(torch.int32).contiguous(), positions.to(torch.int32), active.to(torch.bool),
    temps.to(torch.float32), top_ks, pf_tokens.to(torch.int32), pf_bt.to(torch.int32), pf_prefix.to(torch.int32), pf_end.to(torch.int32),
    int(n_steps), int(k_max), int(page_size), bool(use_kernel), generator, _ids(adapter_ids, dev), _ids(pf_adapter, dev),
  )


# ------------------------------------------------ batched speculation
# (inference/batch_scheduler.py, XOT_TPU_SPEC_BATCH): draft-then-verify
# inside the batched decode chunk. One chunk is ``n_rounds`` rounds; each
# round every row proposes up to gamma_max tokens, the target scores every
# row's whole (gamma_max+1)-token window in ONE forward, and each row
# advances by its own accepted run + 1. The advance varies per row, which
# the page pool absorbs as the lookahead pipeline's drop-on-read does:
# rejected tail positions hold garbage KV that the next round's window
# rewrites before anything reads it.
#
# Proposals come from a draft model (``params_d``: G greedy steps a round on
# the draft's own slot cache, then its catch-up over the window) and, per
# row, from host n-gram streams (inference/ngram.py) handed in as
# ``props``, which take the row over while it follows them. Per-row depths ``gammas``
# are device data, so a row at depth 0 decodes plain inside the same call.
# Greedy rows emit exactly the target's greedy tokens for ANY proposal;
# sampled rows run at depth 0 and draw one sample per round from the
# window's first position, with one draw of the generator per round, as the
# plain chunk draws one per step. The target applies each row's adapter
# (``adapter_ids``) and the draft stays the base model, as in the reference:
# greedy rows emit the adapter-applied target's own greedy tokens.


def _paged_window_layer_step(h, p, pool_l, block_tables, bt_window, positions, inv_freq, cfg: ModelConfig, page_size: int, use_kernel: bool, adapter_ids=None):
  """One decoder layer for a W-token verify window against the page pool.

  positions [B, W] are each row's own window positions. All W tokens' KV
  go into the pool in one indexed write per leaf; attention runs through K3
  in one launch over the B·W query rows (``bt_window`` [B·W, mp]) when
  ``use_kernel``, else through the gather route (the reference's two
  routes, token-exact)."""
  from ..ops.paged import paged_window_attention, paged_window_attention_ref, write_window_kv

  x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
  q, k, v = _dense_qkv(x, p, cfg, positions, inv_freq, adapter_ids)
  scales = {}
  if "k_scale" in pool_l:  # int8/int4 KV pages: per-(token, head) scales, as one-token writes make
    from .quantize import quantize_kv, quantize_kv_int4

    packed = pool_l["k"].shape[-1] * 2 == k.shape[-1]
    quant_fn = quantize_kv_int4 if packed else quantize_kv
    kq, ks = quant_fn(k)
    vq, vs = quant_fn(v)
    for name, new in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
      write_window_kv(pool_l[name], new, block_tables, positions, page_size)
    scales = dict(k_scale_pool_l=pool_l["k_scale"], v_scale_pool_l=pool_l["v_scale"])
  else:
    write_window_kv(pool_l["k"], k, block_tables, positions, page_size)
    write_window_kv(pool_l["v"], v, block_tables, positions, page_size)
  if use_kernel and cfg.plain_attention:
    attn = paged_window_attention(q, pool_l["k"], pool_l["v"], bt_window, positions, page_size, **scales)
  else:
    attn = paged_window_attention_ref(q, pool_l["k"], pool_l["v"], block_tables, positions, page_size, **scales, **_attn_opts(cfg, p.get("is_sliding")))
  return _mlp_block(h + _attn_out(attn, p, cfg), p, cfg)


def paged_window_forward(params, cfg: ModelConfig, shard: Shard, tokens, positions, pool, block_tables, page_size: int, use_kernel: bool, bt_window=None, adapter_ids=None):
  """W-token forward for every row against the page pool, the batched
  verify pass: tokens/positions [B, W] → (logits [B, W, V], pool updated in
  place). ``bt_window`` is ``window_block_tables(block_tables, W)``, made
  here when the caller has not made it once for the chunk; ``adapter_ids``
  [B] each row's adapter slot."""
  from ..ops.paged import window_block_tables

  _no_mla(cfg, "paged_window_forward")
  if use_kernel and bt_window is None:
    bt_window = window_block_tables(block_tables, tokens.shape[1])
  h = embed_tokens(params, cfg, tokens)
  inv_freq = rope_inv_freq(cfg, device=h.device)
  for i, lp in enumerate(layer_params(params)):
    pool_l = {key: val[i] for key, val in pool.items()}
    h = _paged_window_layer_step(h, lp, pool_l, block_tables, bt_window, positions, inv_freq, cfg, page_size, use_kernel, adapter_ids)
  return head_logits(params, cfg, h), pool


def _spec_batch_rounds(verify, token, positions, active, gammas, temps, top_ks, n_rounds: int, gamma_max: int, k_max: int, generator, props=None, prop_counts=None, draft=None):
  """The draft-free round loop: ``verify(window [B, W], wpos [B, W])``
  runs the target over each row's window and returns logits [B, W, V].
  Returns (buf [B, n_rounds·W], counts [B], n_prop [B], next_tok [B, 1],
  next_pos [B]), all on the device: row i's first counts[i] buffer slots
  are its emitted tokens; n_prop[i] is the number of tokens proposed for it
  (the host's acceptance denominator).

  Host-proposed rows: ``props`` [B, L] carries each row's n-gram stream,
  ``prop_counts`` [B] its valid length (0: no proposal, the row runs at
  its depth on zeros, as the reference's draft-free program does). A
  proposed row drafts the next G stream tokens each round for as long as
  every verified token continued the stream; the first divergence drops it
  to plain for the rest of the chunk. Nothing here reads a value back to
  the host.

  ``draft`` (``_draft_fns``) adds the model proposer: each round the draft
  proposes G tokens for every row in G single-token steps on its own slot
  cache (host-proposed rows take their stream over them), and after the
  verify it runs the whole window (its catch-up), so its cache covers
  every accepted position. Without it the rows draft zeros."""
  B = token.shape[0]
  G = int(gamma_max)
  W = G + 1
  dev = token.device
  widx = torch.arange(W, dtype=torch.int64, device=dev)
  buf = torch.zeros((B, n_rounds * W), dtype=torch.int32, device=dev)
  with_props = props is not None and G > 0
  if with_props:
    # Padded so each round's window [counts, counts + G) stays in range.
    props_pad = torch.cat([props.to(torch.int32), torch.zeros((B, n_rounds * W + G - props.shape[1]), dtype=torch.int32, device=dev)], dim=1)
    is_prop = prop_counts > 0
    on_stream = is_prop.clone()
  zeros_b = torch.zeros((B,), dtype=torch.int32, device=dev)
  tok, pos, counts, n_prop = token, positions, zeros_b, zeros_b
  for _ in range(int(n_rounds)):
    d = draft[0](tok, pos) if draft is not None and G > 0 else torch.zeros((B, G), dtype=torch.int32, device=dev)
    geff = gammas
    if with_props:
      d_stream = torch.gather(props_pad, 1, counts.long()[:, None] + widx[None, :G])
      use_prop = is_prop & on_stream
      d = torch.where(use_prop[:, None], d_stream, d)
      remaining = torch.clamp(prop_counts - counts, min=0)
      geff = torch.where(is_prop, torch.where(use_prop, torch.minimum(remaining, gammas), zeros_b), gammas)
    window = torch.cat([tok, d], dim=1)
    wpos = pos[:, None] + widx[None, :].to(torch.int32)
    logits = verify(window, wpos)
    t_greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, W]
    nxt0 = _next_token_batched(logits[:, 0, :], generator, temps, top_ks, k_max)  # one draw per round
    matches = ((d == t_greedy[:, :G]) & (widx[None, :G] < geff[:, None])).to(torch.int32)
    n_acc = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32)
    n_acc = torch.where(temps > 0, zeros_b, n_acc)  # sampled rows accept nothing
    corr = torch.gather(t_greedy, 1, n_acc.long()[:, None])[:, 0]  # the target's own next token
    corr = torch.where(temps > 0, nxt0, corr)
    d_pad = torch.cat([d, torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    emitted = torch.where(widx[None, :] < n_acc[:, None], d_pad, corr[:, None])
    # Each row appends at its own offset; slots past the advance hold the
    # correction and are overwritten by the next round's append.
    buf.scatter_(1, counts.long()[:, None] + widx[None, :], emitted)
    if draft is not None:
      draft[1](window, wpos)
    if with_props:
      # On-stream iff the whole window continued the stream: full
      # acceptance AND the correction is the stream's next token.
      nxt_idx = torch.clamp(counts + n_acc, 0, props_pad.shape[1] - 1)
      cont = torch.gather(props_pad, 1, nxt_idx.long()[:, None])[:, 0]
      on_stream = use_prop & (n_acc == geff) & (counts + n_acc < prop_counts) & (corr == cont)
    k_adv = torch.where(active, n_acc + 1, zeros_b)  # inactive rows hold token and position
    n_prop = n_prop + torch.where(active, geff, zeros_b)
    tok = torch.where(active, corr, tok[:, 0])[:, None]
    pos = pos + k_adv
    counts = counts + k_adv
  return buf, counts, n_prop, tok, pos


def _spec_props_args(props, prop_counts, B: int, n_rounds: int, gamma_max: int, device):
  """The host-proposal pair: both None (no n-gram rows this dispatch), or
  an int32 stream buffer [B, ≤ n_rounds·(gamma_max+1) + gamma_max] and [B]
  valid counts clipped to what the chunk can consume."""
  if props is None:
    return None, None
  cap = n_rounds * (gamma_max + 1) + gamma_max
  props = props.to(device=device, dtype=torch.int32)[:, :cap]
  if props.shape[0] != B:
    raise ValueError(f"props batch {props.shape[0]} != token batch {B}")
  counts = torch.clamp(prop_counts.to(device=device, dtype=torch.int32), max=props.shape[1])
  return props, counts


def _draft_fns(params_d, cfg_d: ModelConfig, shard_d: Shard, cache_d, G: int):
  """The model proposer of ``_spec_batch_rounds`` over the draft's own slot
  cache ``cache_d`` (written in place): ``propose(tok [B,1], pos [B])`` runs
  G greedy single-token steps (K2 on the card where the solo step takes
  it) and returns [B, G]; ``catch_up(window, wpos)`` runs the verify window
  through the draft (K1 on the card)."""

  def propose(tok, pos):
    out = []
    for _ in range(G):
      logits, _ = shard_forward(params_d, cfg_d, shard_d, tok, pos[:, None], cache_d)
      nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
      out.append(nxt)
      tok, pos = nxt[:, None], pos + 1
    return torch.stack(out, dim=1)

  def catch_up(window, wpos):
    shard_forward(params_d, cfg_d, shard_d, window, wpos, cache_d)

  return propose, catch_up


def _spec_chunk_args(what: str, params, shard: Shard, params_d, shard_d, cache_d, token, active, gammas, top_k, gamma_max: int, generator):
  """The spec chunks' refusals and per-row operands: (generator, top_ks [B],
  active [B] bool, gammas [B] clamped to ``gamma_max``). A draft
  (``params_d``) needs its slot cache and a full-model shard."""
  if params_d is not None:
    if cache_d is None:
      raise ValueError(f"{what}: a draft model (params_d) needs its slot cache (cache_d)")
    _full_model(shard_d, what)
  _dense_full_model(params, shard, what)
  dev = token.device
  if generator is None:
    generator = torch.Generator(device=dev).manual_seed(0)
  B = token.shape[0]
  return generator, _row_top_ks(top_k, B, dev), active.to(device=dev, dtype=torch.bool), torch.clamp(gammas.to(device=dev, dtype=torch.int32), max=int(gamma_max))


@tracked("spec.paged_batch", ("cfg", "shard", "cfg_d", "shard_d", "n_rounds", "gamma_max", "k_max", "page_size", "use_kernel"))
def fused_spec_paged_batch_decode(params, cfg: ModelConfig, shard: Shard, params_d, cfg_d, shard_d, token, pool, cache_d, block_tables, positions, active, gammas, temps, n_rounds: int, gamma_max: int, top_k=35, k_max: int = 64, page_size: int = 64, use_kernel: bool | None = None, generator=None, props=None, prop_counts=None, adapter_ids=None):
  """One speculative decode chunk over every row of the page pool.

  token [B, 1] / positions [B] / active [B] / temps [B] / top_k as in
  ``fused_paged_batch_decode``; ``gammas`` [B] int32 is each row's depth
  (0: plain decode for that row), clamped to ``gamma_max``; block_tables
  [B, mp] must cover every active row's worst-case advance
  ``n_rounds·(gamma_max+1)`` (inference/paging.py ``spec_worst_advance``).
  ``props``/``prop_counts`` carry the rows' n-gram streams
  (``_spec_batch_rounds``). Returns (tokens [B, n_rounds·(gamma_max+1)],
  counts [B], n_prop [B], next_token [B, 1], next_positions [B], pool,
  cache_d), every tensor on the device: a chained dispatch takes
  ``next_token`` and ``next_positions`` as its inputs without a host round
  trip. ``use_kernel=None`` resolves as in ``fused_paged_batch_decode``:
  K3 on the card, one launch per layer per round.

  ``params_d`` (with ``cfg_d`` / ``shard_d``) is the model proposer: the
  draft proposes from its own slot cache ``cache_d`` [L_d, B, max_seq,
  ...], written in place (``_spec_batch_rounds``); None is the draft-free
  chunk (``cache_d`` passes through). ``adapter_ids`` [B] applies each
  row's adapter in the target's verify windows (the draft stays the base
  model). An MLA model is refused, as in the reference (its paged server
  runs no batched speculation)."""
  _no_mla(cfg, "fused_spec_paged_batch_decode")
  generator, top_ks, active, gammas = _spec_chunk_args("fused_spec_paged_batch_decode", params, shard, params_d, shard_d, cache_d, token, active, gammas, top_k, gamma_max, generator)
  dev = token.device
  if use_kernel is None:
    use_kernel = paged_use_kernel(cfg, token.shape[0], block_tables.shape[1] * int(page_size), pool, dev)
  G = int(gamma_max)
  props, prop_counts = _spec_props_args(props, prop_counts, token.shape[0], int(n_rounds), G, dev)
  draft = _draft_fns(params_d, cfg_d, shard_d, cache_d, G) if params_d is not None else None
  buf, counts, n_prop, next_tok, next_pos = _spec_paged_rounds(
    params, cfg, shard, token.to(torch.int32), pool, block_tables.to(device=dev, dtype=torch.int32), positions.to(device=dev, dtype=torch.int32), active, gammas,
    temps.to(device=dev, dtype=torch.float32), top_ks, int(n_rounds), G, int(k_max), int(page_size), bool(use_kernel), generator, props, prop_counts, draft, _ids(adapter_ids, dev),
  )
  return buf, counts, n_prop, next_tok, next_pos, pool, cache_d


def _spec_paged_rounds(params, cfg: ModelConfig, shard: Shard, token, pool, block_tables, positions, active, gammas, temps, top_ks, n_rounds: int, G: int, k_max: int, page_size: int, use_kernel: bool, generator, props, prop_counts, draft=None, adapter_ids=None):
  """The body of ``fused_spec_paged_batch_decode`` on operands already of
  their device and dtype: the verify window through the page pool, the
  rounds of ``_spec_batch_rounds``."""
  from ..ops.paged import window_block_tables

  # Inactive rows' window writes must not land on pages another row may own
  # now: their tables pin to the trash page, once per chunk.
  bt = torch.where(active[:, None], block_tables, 0).contiguous()
  bt_window = window_block_tables(bt, G + 1) if use_kernel else None

  def verify(window, wpos):
    logits, _ = paged_window_forward(params, cfg, shard, window, wpos, pool, bt, page_size, use_kernel, bt_window, adapter_ids)
    return logits

  return _spec_batch_rounds(verify, token, positions, active, gammas, temps, top_ks, n_rounds, G, k_max, generator, props, prop_counts, draft)


def _spec_dense_rounds(params, cfg: ModelConfig, shard: Shard, token, cache, positions, active, gammas, temps, top_ks, n_rounds: int, G: int, k_max: int, generator, props, prop_counts, draft=None, adapter_ids=None):
  """The body of ``fused_spec_batch_decode``: the verify window run by
  ``shard_forward`` on the slot cache (K1 at Sq = G+1 over B rows of their
  own offsets on the card)."""

  def verify(window, wpos):
    logits, _ = shard_forward(params, cfg, shard, window, wpos, cache, adapter_ids=adapter_ids)
    return logits

  return _spec_batch_rounds(verify, token, positions, active, gammas, temps, top_ks, n_rounds, G, k_max, generator, props, prop_counts, draft)


_SPEC_BATCH_STATIC = ("cfg", "shard", "cfg_d", "shard_d", "n_rounds", "gamma_max", "k_max")


def fused_spec_batch_decode(params, cfg: ModelConfig, shard: Shard, params_d, cfg_d, shard_d, token, cache, cache_d, positions, active, gammas, temps, n_rounds: int, gamma_max: int, top_k=35, k_max: int = 64, generator=None, props=None, prop_counts=None, adapter_ids=None, programs=None):
  """One speculative decode chunk over every row of the dense slot cache:
  ``fused_spec_paged_batch_decode``'s contract with the verify window run
  by ``shard_forward`` on ``cache`` (K1 at Sq = gamma_max+1, one launch per
  layer per round on the card). The caller keeps every row's position plus
  ``n_rounds·(gamma_max+1)`` within the cache. The solo n-gram chunk calls
  it at B=1. Returns (tokens [B, n_rounds·(gamma_max+1)], counts [B],
  n_prop [B], next_token [B, 1], next_positions [B], cache, cache_d),
  every tensor on the device. One dispatch of ``spec.batch``; with
  ``programs`` (the ``SoloPrograms`` of ``cache``, and no ``generator``:
  the program seeds its own as a fresh one is seeded here) the chunk is one
  replay of its captured program, every round in it (draft-free only: the
  batched server's captured chunk is ``BatchedPrograms.spec``).

  ``params_d`` / ``cache_d`` are the model proposer, as in
  ``fused_spec_paged_batch_decode``, and so is ``adapter_ids``. MLA
  models verify through the dense latent cache, as in the reference."""
  sig = dict(
    params=params, cfg=cfg, shard=shard, params_d=params_d, cfg_d=cfg_d, shard_d=shard_d, token=token, cache=cache, cache_d=cache_d, positions=positions,
    active=active, gammas=gammas, temps=temps, n_rounds=int(n_rounds), gamma_max=int(gamma_max), top_k=top_k, k_max=int(k_max), generator=generator,
    props=props, prop_counts=prop_counts, adapter_ids=adapter_ids,
  )
  generator, top_ks, active, gammas = _spec_chunk_args("fused_spec_batch_decode", params, shard, params_d, shard_d, cache_d, token, active, gammas, top_k, gamma_max, generator)
  dev = token.device
  G = int(gamma_max)
  props, prop_counts = _spec_props_args(props, prop_counts, token.shape[0], int(n_rounds), G, dev)
  token, positions, temps = token.to(torch.int32), positions.to(device=dev, dtype=torch.int32), temps.to(device=dev, dtype=torch.float32)
  if programs is not None:
    if programs.cache is not cache or sig["generator"] is not None or params_d is not None or adapter_ids is not None:
      raise ValueError("programs= must be the cache's SoloPrograms, with no generator, no draft and no adapters")
    run = lambda: programs.spec_batch(token, positions, active, gammas, temps, top_ks, int(n_rounds), G, int(k_max), props, prop_counts)  # noqa: E731
  else:
    draft = _draft_fns(params_d, cfg_d, shard_d, cache_d, G) if params_d is not None else None
    aid = _ids(adapter_ids, dev)
    run = lambda: _spec_dense_rounds(params, cfg, shard, token, cache, positions, active, gammas, temps, top_ks, int(n_rounds), G, int(k_max), generator, props, prop_counts, draft, aid)  # noqa: E731

  buf, counts, n_prop, next_tok, next_pos = ledger.dispatch("spec.batch", sig, _SPEC_BATCH_STATIC, run)
  return buf, counts, n_prop, next_tok, next_pos, cache, cache_d


# ------------------------------------------------------- batched programs

_NP_DTYPES = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32, torch.bool: np.bool_}


class BatchedPrograms:
  """The captured batched programs of one KV store — a page pool, or with
  ``dense`` the slot cache [L, n_slots, max_seq, ...] — the reference's
  one-program-per-dispatch execution for the batched server on a CUDA
  device. Each dispatch is one replay of a CUDA graph holding the whole
  dispatch, every step or round of it:

  - ``prefill`` — ``prefill.pages_many_sampled``: an admission batch's
    prefill and first-token sampling (K1 on the card), one graph per row
    bucket, token width, page window and ``k_max``; on the slot cache
    ``prefill_slots`` — ``prefill.slots_sampled`` — one graph per row count,
    token width and ``k_max``;
  - ``decode`` — ``decode.paged_batch``: ``n_steps`` decode steps over
    every row (K3), one graph per row count, table width, ``n_steps``,
    ``k_max``, page size and route; on the slot cache ``batch_decode`` —
    ``decode.batch`` (K2 or the plain attention) — per row count,
    ``n_steps`` and ``k_max``;
  - ``mixed`` — ``decode.mixed_paged_batch``: the paged chunk with one
    admission's prefill slice fused in (K1 for the slice), also keyed on
    the slice's pad and page window;
  - ``spec`` — ``spec.paged_batch`` (K3 over the B·W window rows) or
    ``spec.batch`` on the slot cache (K1 at Sq = W over the B rows):
    ``n_rounds`` verify rounds at depth cap ``gamma_max``, also keyed on
    whether n-gram proposals come with it and their width, and on whether
    the draft model proposes (its G steps and its catch-up inside each
    round, on the draft's slot cache);
  - ``draft_prefill`` — ``prefill.slots`` on the draft's slot cache: the
    draft's prompt prefill riding an admission, per row count and width.

  The draft (``set_draft``: its params, config, shard and slot cache) is
  fixed for the instance's life, as the pool is: its graphs hold both.

  With ``adapter_ids`` ([rows] int32: each row's slot in the stacked
  adapter leaves; the mixed slice's own ``pf_adapter`` [1]) a family runs
  the adapter hook (``_dense_qkv``): the slots are one more filled buffer,
  so the adapter mix changes no graph, and only whether the hook runs
  keys one. The stacked leaves are written in place at their fixed
  addresses by the engine (``_install_adapter_slot``), so a replay reads
  the adapters installed when it runs.

  A graph is built at the first dispatch of a signature the ledger records
  as a build, so captures equal builds per family for one instance; it is
  keyed on that signature and the routing knobs (``routing_knobs``, and
  ``XOT_TPU_PAGED_KERNEL`` through the route). Every operand lives in a
  static buffer filled in place before the run: host arrays arrive as
  non-blocking copies out of pinned memory, device tensors (a chained
  dispatch's token and positions) as device-to-device copies, all queued
  on the compute stream ahead of the replay. Outputs are buffers allocated
  outside the captures, one set per graph: valid until that graph runs
  again, so a caller queues its reads of them (the scheduler's host copies,
  the next chained dispatch's fills) before the next dispatch. The store is
  written in place at its fixed address, so the instance lives and dies
  with it. One CUDA generator, registered with every graph, is reseeded
  with the dispatch's key before each run (``Graph.run(seed=)``): a replay
  draws exactly what the eager function draws from a generator seeded
  with that key. The graphs share one memory pool (``graph_pool``): they
  replay one at a time on one stream. On the CPU each program runs its
  body eagerly through the same buffers."""

  def __init__(self, params, cfg: ModelConfig, shard: Shard, pool: dict, dense: bool = False) -> None:
    _dense_full_model(params, shard, "BatchedPrograms")
    self.params, self.cfg, self.shard, self.pool, self.dense = params, cfg, shard, pool, bool(dense)
    self.device = pool["k"].device
    self.generator = torch.Generator(device=self.device)
    self.graph_pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
    self.draft: tuple | None = None  # (params_d, cfg_d, shard_d, cache_d)
    self._bufs: dict[tuple, torch.Tensor] = {}
    self._graphs: dict[tuple, tuple[Graph, dict]] = {}

  def set_draft(self, params_d, cfg_d: ModelConfig, shard_d: Shard, cache_d: dict) -> None:
    """Attach the draft model and its slot cache (before any graph that
    drafts is built)."""
    self.draft = (params_d, cfg_d, shard_d, cache_d)

  def graphs(self) -> list[Graph]:
    return [g for g, _ in self._graphs.values()]

  def close(self) -> None:
    """Drop the graphs and buffers now (their bodies refer back to this
    instance, so without this only the cycle collector would free them,
    and the graph memory pool with them)."""
    self._graphs.clear()
    self._bufs.clear()
    self.draft = None

  def _fill(self, name: str, x, dtype, shape: tuple | None = None) -> torch.Tensor:
    """The static input buffer ``name`` of ``x``'s shape and ``dtype``,
    filled in place with ``x`` without blocking the host."""
    shape = tuple(x.shape) if shape is None else tuple(shape)
    key = (name, shape, dtype)
    buf = self._bufs.get(key)
    if buf is None:
      buf = self._bufs[key] = torch.zeros(shape, dtype=dtype, device=self.device)
    if isinstance(x, torch.Tensor):
      buf.copy_(x.reshape(shape), non_blocking=True)
    else:
      host = torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=_NP_DTYPES[dtype]).reshape(shape)))
      buf.copy_(host.pin_memory() if buf.is_cuda else host, non_blocking=True)
    return buf

  def _program(self, family: str, key: tuple, outs: dict, body) -> tuple[Graph, dict]:
    """The graph of ``key`` (plus the routing knobs) with its output
    buffers; ``outs`` maps names to (shape, dtype) and ``body(outs)`` runs
    the dispatch into them. Both are used only when the graph is new."""
    key = (family,) + key + routing_knobs()
    entry = self._graphs.get(key)
    if entry is None:
      bufs = {name: torch.zeros(shape, dtype=dtype, device=self.device) for name, (shape, dtype) in outs.items()}
      graph = Graph(family, lambda: body(bufs), generators=(self.generator,), pool=self.graph_pool)
      entry = self._graphs[key] = (graph, bufs)
    return entry

  def _use_kernel(self, B: int, mp: int, page_size: int) -> bool:
    return paged_use_kernel(self.cfg, B, mp * page_size, self.pool, self.device)

  def _rows(self, token, block_tables, positions, active, temps, top_ks) -> tuple:
    """The decode operands every chunk family takes, in their buffers (no
    table on the slot cache: ``block_tables`` None)."""
    B = positions.shape[0]
    bt = None if block_tables is None else self._fill("block_tables", block_tables, torch.int32)
    return (
      self._fill("token", token, torch.int32, (B, 1)), bt, self._fill("positions", positions, torch.int32, (B,)),
      self._fill("active", active, torch.bool, (B,)), self._fill("temps", temps, torch.float32, (B,)), self._fill("top_ks", top_ks, torch.int32, (B,)),
    )

  def _adapter(self, name: str, adapter_ids, rows: int):
    """The filled adapter-slot buffer of ``adapter_ids``, or None."""
    return None if adapter_ids is None else self._fill(name, adapter_ids, torch.int32, (rows,))

  def _rows_sig(self, token, block_tables, positions, active, temps, top_ks, adapter_ids=None) -> dict:
    B, dev = positions.shape[0], self.device
    sig = dict(
      params=self.params, cfg=self.cfg, shard=self.shard, token=_Like(torch.int32, (B, 1), dev),
      positions=_Like(torch.int32, (B,), dev), active=_Like(torch.bool, (B,), dev), temps=_Like(torch.float32, (B,), dev), top_k=_Like(torch.int32, (B,), dev), generator=self.generator,
    )
    if adapter_ids is not None:
      sig["adapter_ids"] = _Like(torch.int32, (B,), dev)
    if self.dense:
      sig["cache"] = self.pool
    else:
      sig.update(pool=self.pool, block_tables=_Like(torch.int32, block_tables.shape, dev))
    return sig

  # ------------------------------------------------------------ families

  def prefill(self, tokens, bt_rows, prefix_lens, prompt_lens, page_size: int, temps, top_ks, k_max: int, key: int, adapter_ids=None) -> torch.Tensor:
    """``prefill_into_pages_many_sampled``'s contract: the first tokens
    [K] int32 (a fresh tensor); the pool is written in place."""
    K, S = tokens.shape
    mp, dev, page_size, k_max = bt_rows.shape[1], self.device, int(page_size), int(k_max)
    vec = _Like(torch.int32, (K,), dev)
    sig = dict(
      params=self.params, cfg=self.cfg, shard=self.shard, tokens=_Like(torch.int32, (K, S), dev), pool=self.pool, bt_rows=_Like(torch.int32, (K, mp), dev),
      prefix_lens=vec, prompt_lens=vec, page_size=page_size, temps=_Like(torch.float32, (K,), dev), top_ks=vec, generator=self.generator, k_max=k_max,
    )
    if adapter_ids is not None:
      sig["adapter_ids"] = vec

    def run():
      tok = self._fill("pf.tokens", tokens, torch.int32)
      bt = self._fill("pf.bt", bt_rows, torch.int32)
      pre, end = self._fill("pf.prefix", prefix_lens, torch.int32, (K,)), self._fill("pf.prompt", prompt_lens, torch.int32, (K,))
      tmp, tks = self._fill("pf.temps", temps, torch.float32, (K,)), self._fill("pf.top_ks", top_ks, torch.int32, (K,))
      aid = self._adapter("pf.adapters", adapter_ids, K)

      def body(out):
        last, _ = prefill_into_pages_many(self.params, self.cfg, self.shard, tok, self.pool, bt, pre, end, page_size, aid)
        out["first"].copy_(_next_token_batched(last, self.generator, tmp, tks, k_max))

      graph, out = self._program("prefill.pages_many_sampled", (K, S, mp, k_max, page_size, aid is not None), {"first": ((K,), torch.int32)}, body)
      graph.run(dev, seed=key)
      return out["first"].clone()

    return ledger.dispatch("prefill.pages_many_sampled", sig, ("cfg", "shard", "page_size", "k_max"), run)

  def prefill_slots(self, tokens, rows, prompt_lens, temps, top_ks, k_max: int, key: int, adapter_ids=None) -> torch.Tensor:
    """``prefill_into_slots_sampled``'s contract on the slot cache: the
    first tokens [K] int32 (a fresh tensor); the K rows are written in
    place."""
    K, S = tokens.shape
    dev, k_max = self.device, int(k_max)
    vec = _Like(torch.int32, (K,), dev)
    sig = dict(
      params=self.params, cfg=self.cfg, shard=self.shard, tokens=_Like(torch.int32, (K, S), dev), cache=self.pool, rows=vec, prompt_lens=vec,
      temps=_Like(torch.float32, (K,), dev), top_ks=vec, generator=self.generator, k_max=k_max,
    )
    if adapter_ids is not None:
      sig["adapter_ids"] = vec

    def run():
      tok = self._fill("ps.tokens", tokens, torch.int32)
      rws, lens = self._fill("ps.rows", rows, torch.int32, (K,)), self._fill("ps.prompt", prompt_lens, torch.int32, (K,))
      tmp, tks = self._fill("ps.temps", temps, torch.float32, (K,)), self._fill("ps.top_ks", top_ks, torch.int32, (K,))
      aid = self._adapter("ps.adapters", adapter_ids, K)

      def body(out):
        last, _ = prefill_into_slots(self.params, self.cfg, self.shard, tok, self.pool, rws, lens, aid)
        out["first"].copy_(_next_token_batched(last, self.generator, tmp, tks, k_max))

      graph, out = self._program("prefill.slots_sampled", (K, S, k_max, aid is not None), {"first": ((K,), torch.int32)}, body)
      graph.run(dev, seed=key)
      return out["first"].clone()

    return ledger.dispatch("prefill.slots_sampled", sig, ("cfg", "shard", "k_max"), run)

  def draft_prefill(self, tokens, rows, prompt_lens) -> None:
    """``prefill_into_slots`` of the draft on its slot cache (the draft's
    prompt prefill riding an admission dispatch); nothing is returned."""
    params_d, cfg_d, shard_d, cache_d = self.draft
    K, S = tokens.shape
    dev = self.device
    vec = _Like(torch.int32, (K,), dev)
    sig = dict(params=params_d, cfg=cfg_d, shard=shard_d, tokens=_Like(torch.int32, (K, S), dev), cache=cache_d, rows=vec, prompt_lens=vec)

    def run():
      tok = self._fill("dp.tokens", tokens, torch.int32)
      rws, lens = self._fill("dp.rows", rows, torch.int32, (K,)), self._fill("dp.prompt", prompt_lens, torch.int32, (K,))

      def body(_out):
        _prefill_into_slots_impl(params_d, cfg_d, shard_d, tok, cache_d, rws, lens)

      graph, _ = self._program("prefill.slots", (K, S), {}, body)
      graph.run(dev)

    ledger.dispatch("prefill.slots", sig, ("cfg", "shard"), run)

  def decode(self, token, block_tables, positions, active, temps, top_ks, n_steps: int, k_max: int, page_size: int, key: int, adapter_ids=None) -> tuple:
    """``fused_paged_batch_decode``'s contract: (tokens [B, n_steps],
    next_token [B, 1], positions [B]), the graph's output buffers."""
    return self._chunk("decode.paged_batch", (token, block_tables, positions, active, temps, top_ks), n_steps, k_max, page_size, key, adapter_ids=adapter_ids)

  def batch_decode(self, token, positions, active, temps, top_ks, n_steps: int, k_max: int, key: int, adapter_ids=None) -> tuple:
    """``fused_batch_decode``'s contract on the slot cache, as ``decode``."""
    return self._chunk("decode.batch", (token, None, positions, active, temps, top_ks), n_steps, k_max, 0, key, adapter_ids=adapter_ids)

  def mixed(self, token, block_tables, positions, active, temps, top_ks, n_steps: int, k_max: int, page_size: int, key: int, pf_tokens, pf_bt, pf_prefix, pf_end, adapter_ids=None, pf_adapter=None) -> tuple:
    """``fused_mixed_paged_batch_decode``'s contract, as ``decode``."""
    _no_mla(self.cfg, "fused_mixed_paged_batch_decode")
    return self._chunk("decode.mixed_paged_batch", (token, block_tables, positions, active, temps, top_ks), n_steps, k_max, page_size, key, (pf_tokens, pf_bt, pf_prefix, pf_end), adapter_ids, pf_adapter)

  def _chunk(self, family: str, rows: tuple, n_steps: int, k_max: int, page_size: int, key: int, pf: tuple | None = None, adapter_ids=None, pf_adapter=None) -> tuple:
    """A plain chunk (paged, or on the slot cache), or with ``pf`` (the
    slice's tokens [1, pad], table [1, mp], prefix and end [1]) a mixed
    one."""
    B = rows[2].shape[0]
    mp = 0 if self.dense else rows[1].shape[1]
    n_steps, k_max, page_size, dev = int(n_steps), int(k_max), int(page_size), self.device
    sig = dict(self._rows_sig(*rows, adapter_ids), n_steps=n_steps, k_max=k_max)
    if pf_adapter is not None:
      sig["pf_adapter"] = _Like(torch.int32, (1,), dev)
    static = ("cfg", "shard", "n_steps", "k_max")
    if not self.dense:
      sig.update(page_size=page_size)
      static += ("page_size", "use_kernel")
    slice_key = ()
    if pf is not None:
      slice_key = (pf[0].shape[1], pf[1].shape[1])
      one = _Like(torch.int32, (1,), dev)
      sig.update(pf_tokens=_Like(torch.int32, (1, slice_key[0]), dev), pf_bt=_Like(torch.int32, (1, slice_key[1]), dev), pf_prefix=one, pf_end=one)

    def run():
      use_kernel = False if self.dense else self._use_kernel(B, mp, page_size)
      tok, bt, pos, act, tmp, tks = self._rows(*rows)
      aid, pf_aid = self._adapter("adapters", adapter_ids, B), self._adapter("mx.adapter", pf_adapter, 1)
      if pf is not None:
        pf_bufs = tuple(self._fill(f"mx.{name}", x, torch.int32, shape) for name, x, shape in zip(("tokens", "bt", "prefix", "end"), pf, ((1, slice_key[0]), (1, slice_key[1]), (1,), (1,))))

      def body(out):
        if self.dense:
          toks, nxt, npos = _batch_decode_scan(self.params, self.cfg, self.shard, tok, self.pool, pos, act, tmp, tks, n_steps, k_max, self.generator, aid)
        else:
          common = (self.params, self.cfg, self.shard, tok, self.pool, bt, pos, act, tmp, tks)
          tail = (n_steps, k_max, page_size, use_kernel, self.generator, aid)
          toks, nxt, npos, _ = _paged_decode_scan(*common, *tail) if pf is None else _fused_mixed_paged_batch_decode_impl(*common, *pf_bufs, *tail, pf_aid)
        out["tokens"].copy_(toks)
        out["next_token"].copy_(nxt)
        out["positions"].copy_(npos)

      outs = {"tokens": ((B, n_steps), torch.int32), "next_token": ((B, 1), torch.int32), "positions": ((B,), torch.int32)}
      graph, out = self._program(family, (B, mp, n_steps, k_max, page_size, use_kernel, *slice_key, aid is not None, pf_aid is not None), outs, body)
      graph.run(dev, seed=key)
      return out["tokens"], out["next_token"], out["positions"]

    return ledger.dispatch(family, sig, static, run)

  def spec(self, token, block_tables, positions, active, gammas, temps, top_ks, n_rounds: int, gamma_max: int, k_max: int, page_size: int, key: int, props=None, prop_counts=None, use_draft: bool = False, adapter_ids=None) -> tuple:
    """``fused_spec_paged_batch_decode``'s contract (``fused_spec_batch_decode``'s
    on the slot cache, ``block_tables`` None) without the store and the
    draft cache: (tokens [B, n_rounds·(gamma_max+1)], counts [B], n_prop
    [B], next_token [B, 1], next_positions [B]), the graph's output
    buffers. ``props`` None (no n-gram rows) is a graph of its own, and so
    is ``use_draft`` (the draft model proposes: ``set_draft``)."""
    B = positions.shape[0]
    mp = 0 if self.dense else block_tables.shape[1]
    n_rounds, G, k_max, page_size, dev = int(n_rounds), int(gamma_max), int(k_max), int(page_size), self.device
    width = None if props is None else props.shape[1]
    vec = _Like(torch.int32, (B,), dev)
    # The draft's geometry keys the program whether it proposes or not (the
    # target's own without a draft), as the reference passes it.
    params_d, cfg_d, shard_d, cache_d = self.draft if self.draft is not None else (None, self.cfg, self.shard, None)
    if not use_draft:
      params_d = cache_d = None
    family = "spec.batch" if self.dense else "spec.paged_batch"
    sig = dict(
      self._rows_sig(token, block_tables, positions, active, temps, top_ks), params_d=params_d, cfg_d=cfg_d, shard_d=shard_d, cache_d=cache_d, gammas=vec,
      n_rounds=n_rounds, gamma_max=G, k_max=k_max, props=None if props is None else _Like(torch.int32, (B, width), dev),
      prop_counts=None if prop_counts is None else vec, adapter_ids=None if adapter_ids is None else vec,
    )
    static = ("cfg", "shard", "cfg_d", "shard_d", "n_rounds", "gamma_max", "k_max")
    if not self.dense:
      sig.update(page_size=page_size)
      static += ("page_size", "use_kernel")

    def run():
      use_kernel = False if self.dense else self._use_kernel(B, mp, page_size)
      tok, bt, pos, act, tmp, tks = self._rows(token, block_tables, positions, active, temps, top_ks)
      gam = self._fill("sp.gammas", gammas, torch.int32, (B,))
      aid = self._adapter("adapters", adapter_ids, B)
      pbuf = cbuf = None
      if props is not None:
        pbuf, cbuf = self._fill("sp.props", props, torch.int32, (B, width)), self._fill("sp.prop_counts", prop_counts, torch.int32, (B,))

      def body(out):
        p, c = _spec_props_args(pbuf, cbuf, B, n_rounds, G, dev)
        draft = _draft_fns(params_d, cfg_d, shard_d, cache_d, G) if use_draft else None
        g = torch.clamp(gam, max=G)
        if self.dense:
          res = _spec_dense_rounds(self.params, self.cfg, self.shard, tok, self.pool, pos, act, g, tmp, tks, n_rounds, G, k_max, self.generator, p, c, draft, aid)
        else:
          res = _spec_paged_rounds(self.params, self.cfg, self.shard, tok, self.pool, bt, pos, act, g, tmp, tks, n_rounds, G, k_max, page_size, use_kernel, self.generator, p, c, draft, aid)
        for name, t in zip(("tokens", "counts", "n_prop", "next_token", "positions"), res):
          out[name].copy_(t)

      vecs = ((B,), torch.int32)
      outs = {"tokens": ((B, n_rounds * (G + 1)), torch.int32), "counts": vecs, "n_prop": vecs, "next_token": ((B, 1), torch.int32), "positions": vecs}
      graph, out = self._program(family, (B, mp, n_rounds, G, k_max, page_size, use_kernel, width, bool(use_draft), aid is not None), outs, body)
      graph.run(dev, seed=key)
      return tuple(out[name] for name in ("tokens", "counts", "n_prop", "next_token", "positions"))

    return ledger.dispatch(family, sig, static, run)
