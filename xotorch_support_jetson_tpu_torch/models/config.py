"""Model configuration for the dense decoder families (llama, qwen2/qwen3,
mistral, phi3) and the HF ``config.json`` → internal mapping.

Counterpart of the reference's ``models/config.py`` for the dense key space:
llama3 / yarn / longrope rope scaling, explicit ``head_dim``, qkv bias,
qk_norm and tied embeddings. ``dtype`` is a torch dtype. Configurations the
port does not run yet (MoE, MLA, vision towers, gemma2's softcap and sliding
window) raise ``NotImplementedError`` at load.
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

  def __post_init__(self):
    if self.head_dim == 0:
      object.__setattr__(self, "head_dim", self.dim // self.n_heads)

  @property
  def plain_attention(self) -> bool:
    """No per-config attention variations — the gate for the attention
    kernels. Always true for the dense families this port loads."""
    return True

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


def _refuse_unported(hf: dict, family: str) -> None:
  """The port's dense decoder runs none of these yet: refuse at load with
  the reason instead of serving wrong logits."""
  reasons = []
  if "text_config" in hf or hf.get("vision_config"):
    reasons.append("vision-language checkpoints (llava towers)")
  if hf.get("num_local_experts") or hf.get("num_experts") or hf.get("n_routed_experts"):
    reasons.append("mixture-of-experts layers")
  if hf.get("kv_lora_rank"):
    reasons.append("multi-head latent attention (MLA)")
  if family == "gemma2" or hf.get("attn_logit_softcapping") or hf.get("final_logit_softcapping"):
    reasons.append("gemma2 softcapping / sliding-window attention")
  if reasons:
    raise NotImplementedError(
      f"the PyTorch port does not run {', '.join(reasons)} yet (model family {family!r}); "
      "serve this checkpoint with the JAX package"
    )


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


def config_from_hf(hf: dict, dtype=None) -> ModelConfig:
  """Map an HF ``config.json`` dict of a dense family to ModelConfig."""
  family = _family(hf)
  _refuse_unported(hf, family)
  eos = hf.get("eos_token_id", [])
  if isinstance(eos, int):
    eos = [eos]
  # transformers ≥4.56 writes "dtype"; older checkpoints carry "torch_dtype"
  torch_dtype = str(hf.get("torch_dtype") or hf.get("dtype") or "bfloat16")
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
    qkv_bias=family == "qwen2" or bool(hf.get("attention_bias", False)),
    qk_norm=family == "qwen3",
    partial_rotary_factor=float(hf.get("partial_rotary_factor", 1.0)),
    tied_embedding=bool(hf.get("tie_word_embeddings", family == "qwen2" and int(hf["hidden_size"]) < 2048)),
    family=family,
    dtype=dtype or _DTYPES.get(torch_dtype, torch.bfloat16),
    eos_token_ids=tuple(int(e) for e in eos),
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
