"""Model configuration for the decoder families (llama, qwen2/qwen3,
mistral, phi3, gemma2, the mixture-of-experts mixtral, qwen2-moe and
qwen3-moe, deepseek-v2/v3 with multi-head latent attention, and llava's
vision-language checkpoints) and the HF ``config.json`` → internal mapping.

Counterpart of the reference's ``models/config.py``: llama3 / yarn /
longrope rope scaling, explicit ``head_dim``, qkv bias, qk_norm, tied
embeddings, gemma2's variations (pre+post norms, GeGLU, softcaps, the
``query_pre_attn_scalar`` scale, the sliding window on even layers, the
sqrt(dim) embed scale), the MoE key space (routed experts, shared
experts, the routing mode; ops/moe.py), MLA's latent ranks and head
dims, and llava's nested ``text_config`` with its tower's config
(models/vision.py ``VisionConfig``) and image placeholder id. ``dtype`` is
a torch dtype.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch


@dataclass(frozen=True)
class RopeScaling:
  """Llama-3 style frequency scaling (rope_type='llama3' in HF configs)."""

  factor: float = 8.0
  low_freq_factor: float = 1.0
  high_freq_factor: float = 4.0
  original_max_position_embeddings: int = 8192
  rope_type: str = "llama3"


@dataclass(frozen=True)
class YarnScaling:
  """Yarn frequency scaling; ``attention_factor`` is resolved at parse time
  and multiplies cos/sin at application."""

  factor: float = 1.0
  beta_fast: float = 32.0
  beta_slow: float = 1.0
  original_max_position_embeddings: int = 4096
  attention_factor: float = 1.0
  truncate: bool = True
  rope_type: str = "yarn"


@dataclass(frozen=True)
class LongRopeScaling:
  """Phi-3/phi-4 'longrope': per-frequency factors with a sqrt attention
  scale; short vs long factors are chosen from the effective max_seq_len."""

  short_factor: tuple[float, ...]
  long_factor: tuple[float, ...]
  original_max_position_embeddings: int
  attention_factor: float = 1.0
  rope_type: str = "longrope"


@dataclass(frozen=True)
class ModelConfig:
  vocab_size: int
  dim: int  # embedding/residual width
  n_layers: int
  n_heads: int
  n_kv_heads: int
  hidden_dim: int  # MLP intermediate width
  head_dim: int = 0  # 0 → dim // n_heads
  norm_eps: float = 1e-5
  rope_theta: float = 500000.0
  rope_scaling: RopeScaling | YarnScaling | LongRopeScaling | None = None
  max_seq_len: int = 8192
  qkv_bias: bool = False  # qwen2 uses attention biases
  qk_norm: bool = False  # qwen3: per-head RMSNorm on q and k before rope
  partial_rotary_factor: float = 1.0  # phi3/phi-4: rope only the leading channels
  tied_embedding: bool = False
  family: str = "llama"
  dtype: Any = torch.bfloat16
  eos_token_ids: tuple[int, ...] = ()
  quant_compute: str = ""  # int8 weight matmul mode ("w8a16" | "w8a8"); "" → XOT_TPU_QUANT_COMPUTE
  # gemma2: pre+post norms around each block, GeGLU (tanh-gelu) MLP, tanh
  # softcapping of the attention scores and the final logits, sqrt(dim)
  # embed scaling, the attention scale from query_pre_attn_scalar, and
  # sliding-window attention on the even layers.
  post_norms: bool = False
  mlp_act: str = "silu"  # "silu" | "gelu_tanh"
  attn_logit_softcap: float = 0.0  # 0 ⇒ off
  final_logit_softcap: float = 0.0
  query_pre_attn_scalar: float = 0.0  # 0 ⇒ scale by 1/sqrt(head_dim)
  sliding_window: int = 0  # 0 ⇒ global attention everywhere
  embed_scale: float = 1.0  # gemma multiplies embeddings by sqrt(dim)
  # --- MoE (ops/moe.py). n_experts == 0 ⇒ dense model; first_k_dense layers
  # stay dense even in an MoE model (deepseek puts layer 0 dense).
  n_experts: int = 0
  n_active_experts: int = 0  # top-k routed experts per token
  moe_hidden_dim: int = 0  # per-routed-expert intermediate width
  shared_expert_dim: int = 0  # total shared-expert intermediate width (0 ⇒ none)
  shared_expert_gate: bool = False  # qwen2-moe: sigmoid gate on the shared expert
  first_k_dense: int = 0
  router_scoring: str = "softmax"  # "softmax" | "sigmoid" (deepseek-v3)
  norm_topk_prob: bool = False
  routed_scaling_factor: float = 1.0
  moe_capacity_factor: float | None = None  # None ⇒ exact compute (no token drops)
  moe_aux_loss_coef: float = 0.0  # load-balancing loss weight in training
  # Group-limited routing (deepseek): only experts in the top ``topk_group``
  # groups are eligible; group score = max ("max") or top-2 sum ("top2sum").
  n_group: int = 1
  topk_group: int = 1
  group_mode: str = "none"  # "none" | "max" | "top2sum"
  # --- MLA (multi-head latent attention, deepseek-v2/v3). kv_lora_rank > 0
  # switches the attention block to MLA: queries optionally LoRA-compressed
  # (q_lora_rank, 0 ⇒ direct wq), KV compressed to a shared latent plus a
  # small MQA rope channel. Rope applies only to the rope parts, with
  # deepseek's interleaved pairing (ops/rope.py apply_rope_interleaved).
  q_lora_rank: int = 0
  kv_lora_rank: int = 0
  qk_nope_head_dim: int = 0
  qk_rope_head_dim: int = 0
  v_head_dim: int = 0
  # --- vision (llava): the CLIP tower's and projector's config
  # (models/vision.py VisionConfig) and the placeholder id the processor
  # expands once per image feature.
  vision: Any = None
  image_token_id: int = -1

  def __post_init__(self):
    if self.head_dim == 0:
      object.__setattr__(self, "head_dim", self.dim // self.n_heads)

  def layer_is_sliding(self, layer_idx: int) -> bool:
    """HF Gemma2: layers at even global indices use the sliding window."""
    return self.sliding_window > 0 and layer_idx % 2 == 0

  @property
  def plain_attention(self) -> bool:
    """No per-config attention variations (softcap, window, scale
    override) — the one gate for the attention kernels K1–K3, which
    implement none of them."""
    return not self.attn_logit_softcap and not self.sliding_window and not self.query_pre_attn_scalar

  @property
  def is_mla(self) -> bool:
    return self.kv_lora_rank > 0

  @property
  def qk_head_dim(self) -> int:
    return self.qk_nope_head_dim + self.qk_rope_head_dim if self.is_mla else self.head_dim

  # KV-cache geometry (models/decoder.py init_kv_cache, ops/paged.py
  # init_paged_pool): MLA caches the latent — the shared kv latent in the
  # "k" buffer, the rope channel in the "v" buffer, one head entry (the
  # kv_b up-projection is absorbed into attention, ops/attention.py
  # mla_absorbed_attention). Dense models cache GQA heads.
  @property
  def cache_kv_heads(self) -> int:
    return 1 if self.is_mla else self.n_kv_heads

  @property
  def cache_k_dim(self) -> int:
    return self.kv_lora_rank if self.is_mla else self.head_dim

  @property
  def cache_v_dim(self) -> int:
    return self.qk_rope_head_dim if self.is_mla else self.head_dim

  @property
  def q_dim(self) -> int:
    return self.n_heads * self.head_dim

  @property
  def kv_dim(self) -> int:
    return self.n_kv_heads * self.head_dim


def _family(hf: dict) -> str:
  arch = (hf.get("architectures") or [""])[0].lower()
  model_type = hf.get("model_type", "").lower()
  for key, family in (
    ("qwen3_moe", "qwen3-moe"), ("qwen3moe", "qwen3-moe"), ("qwen3", "qwen3"),
    ("qwen2_moe", "qwen2-moe"), ("qwen2moe", "qwen2-moe"), ("qwen2", "qwen2"),
    ("mixtral", "mixtral"), ("mistral", "mistral"), ("phi3", "phi3"),
    ("deepseek_v3", "deepseek-v3"), ("deepseekv3", "deepseek-v3"),
    ("deepseek_v2", "deepseek-v2"), ("deepseekv2", "deepseek-v2"),
    ("gemma2", "gemma2"),
  ):
    if key in model_type or key in arch:
      return family
  return "llama"


def _rope_scaling(hf: dict):
  rs = hf.get("rope_scaling")
  if not isinstance(rs, dict):
    return None
  rope_type = rs.get("rope_type", rs.get("type", ""))
  if rope_type == "llama3":
    return RopeScaling(
      factor=float(rs.get("factor", 8.0)),
      low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
      high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
      original_max_position_embeddings=int(rs.get("original_max_position_embeddings", 8192)),
    )
  if rope_type == "yarn":
    factor = float(rs.get("factor", 1.0))
    attention_factor = rs.get("attention_factor")
    if attention_factor is None:
      mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")

      def get_mscale(scale, m=1.0):
        return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0

      if mscale and mscale_all:
        attention_factor = get_mscale(factor, float(mscale)) / get_mscale(factor, float(mscale_all))
      else:
        attention_factor = get_mscale(factor)
    return YarnScaling(
      factor=factor,
      beta_fast=float(rs.get("beta_fast") or 32),
      beta_slow=float(rs.get("beta_slow") or 1),
      original_max_position_embeddings=int(rs.get("original_max_position_embeddings") or hf.get("max_position_embeddings", 4096)),
      attention_factor=float(attention_factor),
      truncate=bool(rs.get("truncate", True)),
    )
  if rope_type == "longrope":
    orig = int(hf.get("original_max_position_embeddings") or hf.get("max_position_embeddings", 4096))
    attention_factor = rs.get("attention_factor")
    if attention_factor is None:
      factor = rs.get("factor")
      if hf.get("original_max_position_embeddings"):
        factor = hf.get("max_position_embeddings", orig) / orig
      attention_factor = 1.0 if not factor or factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(orig))
    return LongRopeScaling(
      short_factor=tuple(float(x) for x in rs["short_factor"]),
      long_factor=tuple(float(x) for x in rs["long_factor"]),
      original_max_position_embeddings=orig,
      attention_factor=float(attention_factor),
    )
  return None


_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.bfloat16, "float32": torch.float32}


def _moe_fields(hf: dict, family: str) -> dict[str, Any]:
  """The MoE key space: mixtral (num_local_experts, expert width =
  intermediate_size), qwen2-moe (num_experts, moe_intermediate_size, a
  gated shared expert), qwen3-moe, deepseek-v2/v3 (n_routed_experts,
  n_shared_experts, first_k_dense_replace, sigmoid scoring and
  routed_scaling_factor on v3). Empty for a dense checkpoint."""
  n_experts = int(hf.get("num_local_experts") or hf.get("num_experts") or hf.get("n_routed_experts") or 0)
  if not n_experts:
    return {}
  moe_hidden = int(hf.get("moe_intermediate_size") or hf["intermediate_size"])
  shared_dim = int(hf.get("n_shared_experts") or 0) * moe_hidden
  if family == "qwen2-moe":
    shared_dim = int(hf.get("shared_expert_intermediate_size") or 0)
  # deepseek group-limited routing: v3 is always sigmoid + top-2-sum group
  # scores (HF DeepseekV3TopkRouter); v2 keys it on topk_method.
  scoring = "sigmoid" if (hf.get("scoring_func") == "sigmoid" or family == "deepseek-v3") else "softmax"
  if family == "deepseek-v3":
    group_mode = "top2sum"
  elif hf.get("topk_method") == "group_limited_greedy":
    group_mode = "max"
  else:
    group_mode = "none"
  return dict(
    n_experts=n_experts,
    n_active_experts=int(hf.get("num_experts_per_tok", 2)),
    moe_hidden_dim=moe_hidden,
    shared_expert_dim=shared_dim,
    shared_expert_gate=family == "qwen2-moe",
    first_k_dense=int(hf.get("first_k_dense_replace", 0)),
    router_scoring=scoring,
    norm_topk_prob=bool(hf.get("norm_topk_prob", family == "mixtral")),
    routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
    moe_aux_loss_coef=float(hf.get("router_aux_loss_coef", hf.get("aux_loss_alpha", 0.001))),
    n_group=int(hf.get("n_group") or 1),
    topk_group=int(hf.get("topk_group") or 1),
    group_mode=group_mode,
  )


def config_from_hf(hf: dict, dtype=None) -> ModelConfig:
  """Map an HF ``config.json`` dict to ModelConfig. A vision-language
  checkpoint (llava, llava-next) nests its decoder's config under
  ``text_config``: the decoder runs on it, and the tower's config rides
  along (``vision``), as the reference parses it."""
  vision_cfg = None
  image_token_id = -1
  if isinstance(hf.get("text_config"), dict):
    top = hf
    hf = dict(hf["text_config"])
    hf.setdefault("vocab_size", top.get("vocab_size", hf.get("vocab_size")))
    image_token_id = int(top.get("image_token_index", -1))
    if isinstance(top.get("vision_config"), dict):
      from .vision import vision_config_from_hf

      vision_cfg = vision_config_from_hf(top["vision_config"], int(hf["hidden_size"]), top)
  family = _family(hf)
  eos = hf.get("eos_token_id", [])
  if isinstance(eos, int):
    eos = [eos]
  # transformers ≥4.56 writes "dtype"; older checkpoints carry "torch_dtype"
  torch_dtype = str(hf.get("torch_dtype") or hf.get("dtype") or "bfloat16")
  gemma: dict[str, Any] = {}
  if family == "gemma2":
    gemma = dict(
      post_norms=True,
      mlp_act="gelu_tanh",
      attn_logit_softcap=float(hf.get("attn_logit_softcapping") or 0.0),
      final_logit_softcap=float(hf.get("final_logit_softcapping") or 0.0),
      query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar") or 0.0),
      sliding_window=int(hf.get("sliding_window") or 0),
      embed_scale=math.sqrt(float(hf["hidden_size"])),
    )
  mla: dict[str, Any] = {}
  if hf.get("kv_lora_rank"):
    mla = dict(
      q_lora_rank=int(hf.get("q_lora_rank") or 0),
      kv_lora_rank=int(hf["kv_lora_rank"]),
      qk_nope_head_dim=int(hf["qk_nope_head_dim"]),
      qk_rope_head_dim=int(hf["qk_rope_head_dim"]),
      v_head_dim=int(hf["v_head_dim"]),
    )
  n_heads = int(hf["num_attention_heads"])
  return ModelConfig(
    vocab_size=int(hf["vocab_size"]),
    dim=int(hf["hidden_size"]),
    n_layers=int(hf["num_hidden_layers"]),
    n_heads=n_heads,
    n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
    hidden_dim=int(hf["intermediate_size"]),
    head_dim=int(hf.get("head_dim") or 0),
    norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
    rope_theta=float(hf.get("rope_theta", 10000.0)),
    rope_scaling=_rope_scaling(hf),
    max_seq_len=int(hf.get("max_position_embeddings", 8192)),
    qkv_bias=family in ("qwen2", "qwen2-moe") or bool(hf.get("attention_bias", False)),
    qk_norm=family in ("qwen3", "qwen3-moe"),
    partial_rotary_factor=float(hf.get("partial_rotary_factor", 1.0)),
    tied_embedding=bool(hf.get("tie_word_embeddings", family == "gemma2" or (family == "qwen2" and int(hf["hidden_size"]) < 2048))),
    family=family,
    dtype=dtype or _DTYPES.get(torch_dtype, torch.bfloat16),
    eos_token_ids=tuple(int(e) for e in eos),
    vision=vision_cfg,
    image_token_id=image_token_id,
    **_moe_fields(hf, family),
    **mla,
    **gemma,
  )


def load_model_config(model_dir: str | Path, dtype=None) -> ModelConfig:
  with open(Path(model_dir) / "config.json") as f:
    return config_from_hf(json.load(f), dtype=dtype)


def tiny_test_config(**overrides) -> ModelConfig:
  """A small config for unit tests (CPU-fast, GQA)."""
  defaults = dict(
    vocab_size=256,
    dim=64,
    n_layers=4,
    n_heads=4,
    n_kv_heads=2,
    hidden_dim=128,
    norm_eps=1e-5,
    rope_theta=10000.0,
    max_seq_len=128,
    dtype=torch.float32,
  )
  defaults.update(overrides)
  return ModelConfig(**defaults)
