"""The dense decoder: llama 3.x, qwen-2.5/3, mistral and phi-family dense
checkpoints. Counterpart of the reference's ``models/decoder.py`` (dense
path only).

Parameters are a plain dict of tensors in the reference's layout: layer
leaves stacked on a leading [L] axis (``layers/wq`` [L, D, Hq·hd], used as
``x @ w``), ``embed`` [V, D], ``final_norm`` [D], ``lm_head`` [D, V]
(absent when tied to ``embed``). The reference's ``lax.scan`` over layers
and steps becomes a Python loop. The KV cache is a dict of
[L, B, max_seq, Hkv, hd] buffers (+ ``k_scale``/``v_scale`` [.., 1] for int8)
that the forward UPDATES IN PLACE — slot j holds absolute position j.
"""

from __future__ import annotations

import os

import torch

from ..inference.shard import Shard
from ..ops.attention import gqa_attention
from ..ops.norm import rms_norm
from ..ops.rope import apply_rope, rope_attention_factor, rope_inv_freq
from .config import ModelConfig

Params = dict

# fused_generate checks for all-rows-EOS every this many steps: each check is
# a host sync, so checking every step would stall the host on the device.
# Steps past an EOS write only slots beyond the kept tokens (masked later).
EOS_CHECK_EVERY = 16


# ---------------------------------------------------------------- KV cache


def kv_quant_mode(quant: str | None = None) -> str:
  """KV-cache quantization: explicit arg wins, else ``XOT_TPU_KV_QUANT``
  ("" or "int8"; the reference's "int4" waits for a later slice)."""
  mode = os.getenv("XOT_TPU_KV_QUANT", "") if quant is None else quant
  if mode not in ("", "int8"):
    raise ValueError(f"XOT_TPU_KV_QUANT supports '' or 'int8' in the PyTorch port; got {mode!r}")
  return mode


def init_kv_cache(cfg: ModelConfig, n_shard_layers: int, batch: int, max_seq: int, dtype=None, quant: str | None = None, device=None) -> Params:
  """Slot-indexed KV cache: slot j holds the KV of absolute position j;
  ``quant="int8"`` stores int8 codes plus per-(token, head) f32 scales."""
  shape = (n_shard_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
  if kv_quant_mode(quant):
    scale_shape = shape[:-1] + (1,)
    return {
      "k": torch.zeros(shape, dtype=torch.int8, device=device),
      "v": torch.zeros(shape, dtype=torch.int8, device=device),
      "k_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
      "v_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
    }
  dtype = dtype or cfg.dtype
  return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_cache(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
  """cache [B,S,H,hd] ← new [B,Sn,H,hd] at per-row slot offsets start [B],
  in place (returns ``cache``)."""
  B, Sn = new.shape[:2]
  rows = torch.arange(B, device=cache.device)[:, None]
  slots = start.to(cache.device)[:, None] + torch.arange(Sn, device=cache.device)[None, :]
  cache[rows, slots] = new.to(cache.dtype)
  return cache


# ---------------------------------------------------------------- init


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

  layers = {
    "attn_norm": ones(L, D),
    "wq": w(L, D, Qd),
    "wk": w(L, D, Kd),
    "wv": w(L, D, Kd),
    "wo": w(L, Qd, D),
    "mlp_norm": ones(L, D),
    "w_gate": w(L, D, F),
    "w_up": w(L, D, F),
    "w_down": w(L, F, D),
  }
  if cfg.qkv_bias:
    layers.update(bq=torch.zeros(L, Qd, dtype=dtype, device=device), bk=torch.zeros(L, Kd, dtype=dtype, device=device), bv=torch.zeros(L, Kd, dtype=dtype, device=device))
  if cfg.qk_norm:
    layers.update(q_norm=ones(L, cfg.head_dim), k_norm=ones(L, cfg.head_dim))
  params: Params = {"layers": layers}
  if shard.is_first_layer:
    params["embed"] = w(V, D, scale=0.02)
  if shard.is_last_layer:
    params["final_norm"] = ones(D)
    if not (cfg.tied_embedding and shard.is_first_layer):
      params["lm_head"] = w(D, V)
  return params


# ---------------------------------------------------------------- forward


def _dense_qkv(x, p, cfg: ModelConfig, positions, inv_freq):
  """x [B,S,D] → q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (qkv bias, qk norm, rope)."""
  B, S, _ = x.shape
  q = x @ p["wq"]
  k = x @ p["wk"]
  v = x @ p["wv"]
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


def _mlp_block(h, p, cfg: ModelConfig):
  """Post-attention norm + SwiGLU FFN (dense branch)."""
  x = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
  gated = torch.nn.functional.silu((x @ p["w_gate"]).float()).to(h.dtype) * (x @ p["w_up"])
  return h + gated @ p["w_down"]


def _attention(q, k, v, kv, positions, kv_positions, cfg: ModelConfig):
  """Write this layer's k/v into its cache slice ``kv`` (in place) and
  attend. The dispatch mirrors the reference: K1 for prefill (and int8-KV
  prefill), K2 for an opted-in long-cache decode step, else the plain
  ``gqa_attention``."""
  from ..ops.flash_attention import flash_attention_prefill, flash_decode_attention, flash_decode_supported, flash_supported

  S = q.shape[1]
  start = positions[:, 0]
  if "k_scale" in kv:  # int8 KV (models/quantize.py quantize_kv)
    from .quantize import quantize_kv

    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    for name, new in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
      _write_cache(kv[name], new, start)
    if cfg.plain_attention and S > 1 and flash_supported(q.shape, kv["k"].shape[1], q.device, q.dtype):
      # Prefill: codes + scales stream straight through K1 (in-kernel dequant).
      return flash_attention_prefill(q, kv["k"], kv["v"], q_offset=start, k_scale=kv["k_scale"], v_scale=kv["v_scale"])
    return gqa_attention(q, kv["k"], kv["v"], positions, kv_positions, k_scale=kv["k_scale"], v_scale=kv["v_scale"])
  _write_cache(kv["k"], k, start)
  _write_cache(kv["v"], v, start)
  k_cache, v_cache = kv["k"].to(q.dtype), kv["v"].to(q.dtype)
  if cfg.plain_attention and S > 1 and flash_supported(q.shape, k_cache.shape[1], q.device, q.dtype):
    # Prefill against the full cache: stale slots beyond the prompt are
    # masked by position (slot index > position).
    return flash_attention_prefill(q, k_cache, v_cache, q_offset=start)
  if cfg.plain_attention and S == 1 and flash_decode_supported(q.shape, k_cache.shape[1], q.device, q.dtype):
    return flash_decode_attention(q, k_cache, v_cache, positions)
  return gqa_attention(q, k_cache, v_cache, positions, kv_positions)


def _layer_step(h, p, kv, positions, kv_positions, inv_freq, cfg: ModelConfig):
  """One decoder layer. h [B,S,D] → h. ``kv`` is this layer's cache dict
  (views into the session cache, updated in place) or None (cache-less)."""
  B, S, D = h.shape
  x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
  q, k, v = _dense_qkv(x, p, cfg, positions, inv_freq)
  if kv is not None:
    attn = _attention(q, k, v, kv, positions, kv_positions, cfg)
  else:
    attn = gqa_attention(q, k, v, positions, positions[0])
  h = h + attn.reshape(B, S, -1) @ p["wo"]
  return _mlp_block(h, p, cfg)


def embed_tokens(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
  """Token ids [B,S] → embeddings [B,S,D] in model dtype."""
  return params["embed"][x].to(cfg.dtype)


def head_logits(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
  """Final norm + LM head: hidden [B,S,D] → fp32 logits [B,S,V]. The head
  product runs in model dtype (a fp32 copy of the [D,V] head would double
  its bytes on every decode step)."""
  h = rms_norm(h, params["final_norm"], cfg.norm_eps)
  w_out = params.get("lm_head")
  if w_out is None:
    w_out = params["embed"].T  # tied embeddings, single-params case
  return (h @ w_out.to(h.dtype)).float()


def shard_forward(
  params: Params,
  cfg: ModelConfig,
  shard: Shard,
  x: torch.Tensor,  # [B,S] int tokens (first shard) | [B,S,D] hidden
  positions: torch.Tensor,  # [B,S] int32 absolute positions
  kv_cache: Params | None = None,
  head_pos: torch.Tensor | None = None,  # [B] per-row S-axis index for the head
) -> tuple[torch.Tensor, Params | None]:
  """Run the shard's layers. Returns (hidden | logits, cache).

  With a cache (updated in place): queries attend to every cache slot ≤
  their absolute position. Without: plain causal attention within the call.
  ``head_pos`` (last shard only) gathers one row per batch entry before the
  LM head, returning logits [B, 1, V].
  """
  h = embed_tokens(params, cfg, x) if x.dim() == 2 else x.to(cfg.dtype)
  inv_freq = rope_inv_freq(cfg, device=h.device)
  kv_positions = torch.arange(kv_cache["k"].shape[2], dtype=torch.int32, device=h.device) if kv_cache is not None else None
  layers = params["layers"]
  for i in range(layers["wq"].shape[0]):
    lp = {key: val[i] for key, val in layers.items()}
    kv = None if kv_cache is None else {key: val[i] for key, val in kv_cache.items()}
    h = _layer_step(h, lp, kv, positions, kv_positions, inv_freq, cfg)
  if not shard.is_last_layer:
    return h, kv_cache
  if head_pos is not None:
    h = h[torch.arange(h.shape[0], device=h.device), head_pos.to(h.device)][:, None, :]
  return head_logits(params, cfg, h), kv_cache


# ---------------------------------------------------------------- decoding


def _next_token(row: torch.Tensor, generator, greedy: bool, temp: float, top_k: int) -> torch.Tensor:
  from ..ops.sampling import greedy as greedy_pick, sample_logits

  if greedy:
    return greedy_pick(row)
  return sample_logits(row, generator, temp=temp, top_k=top_k)


def _full_model(shard: Shard, what: str) -> None:
  if not (shard.is_first_layer and shard.is_last_layer):
    raise ValueError(f"{what} requires a full-model shard")


def fused_decode(params, cfg: ModelConfig, shard: Shard, token, cache, start_pos, n_steps: int, temp: float = 0.0, top_k: int = 35, generator=None):
  """Generate ``n_steps`` tokens on the device with no host round trip.

  token [B,1] int32; start_pos [B] int32. Each step's token feeds the next
  on the device; the cache updates in place. Returns (tokens [B, n_steps],
  cache).
  """
  _full_model(shard, "fused_decode")
  greedy = temp is None or float(temp) <= 0.0
  pos = start_pos.to(torch.int32)
  out = []
  for _ in range(int(n_steps)):
    logits, cache = shard_forward(params, cfg, shard, token, pos[:, None], cache)
    nxt = _next_token(logits[:, 0, :], generator, greedy, temp, top_k)
    out.append(nxt)
    token, pos = nxt[:, None], pos + 1
  return torch.stack(out, dim=1), cache


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
):
  """Generate until every row has sampled an EOS id or ``n_limit`` steps
  (default ``max_steps``). Returns (tokens [B, max_steps] int32, steps run,
  cache). Rows keep their EOS token; positions past a row's EOS hold what
  was sampled before every row finished (callers trim at the first EOS).
  """
  _full_model(shard, "fused_generate")
  greedy = temp is None or float(temp) <= 0.0
  B = token.shape[0]
  limit = min(int(max_steps if n_limit is None else n_limit), int(max_steps))
  buf = torch.zeros((B, int(max_steps)), dtype=torch.int32, device=token.device)
  eos = torch.tensor(sorted(eos_ids), dtype=torch.int32, device=token.device) if eos_ids else None
  done = torch.zeros((B,), dtype=torch.bool, device=token.device)
  pos = start_pos.to(torch.int32)
  n = 0
  while n < limit:
    logits, cache = shard_forward(params, cfg, shard, token, pos[:, None], cache)
    nxt = _next_token(logits[:, 0, :], generator, greedy, temp, top_k)
    buf[:, n] = nxt
    n += 1
    token, pos = nxt[:, None], pos + 1
    if eos is not None:
      done |= torch.isin(nxt, eos)
      if n % EOS_CHECK_EVERY == 0 and bool(done.all()):
        break
  return buf, n, cache
