"""Model registry: model id → layer count, family, HF repo — the dense,
gemma2, qwen3-moe, deepseek (MLA + MoE), llava (vision) and
stable-diffusion cards of the reference's ``registry.py``, keyed by the
port engine's class name, and the dummy engine's card. A stable-diffusion
card's layer count is the reference's and unused: a diffusion model is
served whole on one node (inference/torch_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .inference.shard import Shard

TORCH_ENGINE = "TorchShardedInferenceEngine"


@dataclass(frozen=True)
class ModelCard:
  model_id: str
  layers: int
  pretty: str
  family: str  # "llama" | "qwen2" | "qwen3" | "qwen3-moe" | "deepseek-moe" | "mistral" | "phi3" | "gemma2" | "llava" | "stable-diffusion" | "dummy"
  repo: dict[str, str] = field(default_factory=dict)

  def repo_for(self, engine_classname: str) -> str | None:
    return self.repo.get(engine_classname)


def _card(model_id: str, layers: int, pretty: str, family: str, hf_repo: str) -> ModelCard:
  return ModelCard(model_id, layers, pretty, family, {TORCH_ENGINE: hf_repo})


_CARDS: list[ModelCard] = [
  _card("llama-3.3-70b", 80, "Llama 3.3 70B", "llama", "unsloth/Llama-3.3-70B-Instruct"),
  _card("llama-3.2-1b", 16, "Llama 3.2 1B", "llama", "unsloth/Llama-3.2-1B-Instruct"),
  _card("llama-3.2-3b", 28, "Llama 3.2 3B", "llama", "unsloth/Llama-3.2-3B-Instruct"),
  _card("llama-3.1-8b", 32, "Llama 3.1 8B", "llama", "unsloth/Meta-Llama-3.1-8B-Instruct"),
  _card("llama-3.1-70b", 80, "Llama 3.1 70B", "llama", "unsloth/Meta-Llama-3.1-70B-Instruct"),
  _card("llama-3-8b", 32, "Llama 3 8B", "llama", "unsloth/llama-3-8b"),
  _card("mistral-7b", 32, "Mistral 7B Instruct", "mistral", "mistralai/Mistral-7B-Instruct-v0.3"),
  _card("deepseek-coder-v2-lite", 27, "Deepseek Coder V2 Lite", "deepseek-moe", "deepseek-ai/DeepSeek-Coder-V2-Lite-Instruct"),
  _card("deepseek-v3", 61, "Deepseek V3", "deepseek-moe", "unsloth/DeepSeek-V3-bf16"),
  _card("deepseek-r1", 61, "Deepseek R1", "deepseek-moe", "deepseek-ai/DeepSeek-R1"),
  _card("deepseek-r1-distill-qwen-1.5b", 28, "DeepSeek R1 Distill Qwen 1.5B", "qwen2", "unsloth/DeepSeek-R1-Distill-Qwen-1.5B"),
  _card("deepseek-r1-distill-qwen-7b", 28, "DeepSeek R1 Distill Qwen 7B", "qwen2", "unsloth/DeepSeek-R1-Distill-Qwen-7B"),
  _card("deepseek-r1-distill-llama-8b", 32, "DeepSeek R1 Distill Llama 8B", "llama", "unsloth/DeepSeek-R1-Distill-Llama-8B"),
  _card("llava-1.5-7b-hf", 32, "LLaVa 1.5 7B (Vision Model)", "llava", "llava-hf/llava-1.5-7b-hf"),
  _card("llava-1.6-vicuna-7b", 32, "LLaVa 1.6 Vicuna 7B (Vision Model)", "llava", "llava-hf/llava-v1.6-vicuna-7b-hf"),
  _card("llava-1.6-mistral-7b", 32, "LLaVa 1.6 Mistral 7B (Vision Model)", "llava", "llava-hf/llava-v1.6-mistral-7b-hf"),
  _card("qwen-2.5-0.5b", 24, "Qwen 2.5 0.5B", "qwen2", "unsloth/Qwen2.5-0.5B-Instruct"),
  _card("qwen-2.5-1.5b", 28, "Qwen 2.5 1.5B", "qwen2", "unsloth/Qwen2.5-1.5B-Instruct"),
  _card("qwen-2.5-3b", 36, "Qwen 2.5 3B", "qwen2", "unsloth/Qwen2.5-3B-Instruct"),
  _card("qwen-2.5-7b", 28, "Qwen 2.5 7B", "qwen2", "unsloth/Qwen2.5-7B-Instruct"),
  _card("qwen-2.5-coder-7b", 28, "Qwen 2.5 Coder 7B", "qwen2", "unsloth/Qwen2.5-Coder-7B-Instruct"),
  _card("qwen-3-0.6b", 28, "Qwen 3 0.6B", "qwen3", "Qwen/Qwen3-0.6B"),
  _card("qwen-3-1.7b", 28, "Qwen 3 1.7B", "qwen3", "Qwen/Qwen3-1.7B"),
  _card("qwen-3-8b", 36, "Qwen 3 8B", "qwen3", "Qwen/Qwen3-8B"),
  _card("qwen-3-30b-a3b", 48, "Qwen 3 30B-A3B (MoE)", "qwen3-moe", "Qwen/Qwen3-30B-A3B"),
  _card("qwen-3-235b-a22b", 94, "Qwen 3 235B-A22B (MoE)", "qwen3-moe", "Qwen/Qwen3-235B-A22B"),
  _card("phi-4-mini-instruct", 32, "Phi-4 Mini Instruct", "phi3", "microsoft/Phi-4-mini-instruct"),
  _card("gemma2-9b", 42, "Gemma2 9B", "gemma2", "google/gemma-2-9b-it"),
  _card("gemma2-27b", 46, "Gemma2 27B", "gemma2", "google/gemma-2-27b-it"),
  # SD 2.1-base (OpenCLIP-H text encoder), SD 1.5 (quick_gelu CLIP, 8-head
  # UNet levels, conv proj_in) and the 768 px v-prediction SD 2.1
  _card("stable-diffusion-2-1-base", 31, "Stable Diffusion 2.1", "stable-diffusion", "stabilityai/stable-diffusion-2-1-base"),
  _card("stable-diffusion-1-5", 31, "Stable Diffusion 1.5", "stable-diffusion", "stable-diffusion-v1-5/stable-diffusion-v1-5"),
  _card("stable-diffusion-2-1", 31, "Stable Diffusion 2.1 (768, v-pred)", "stable-diffusion", "stabilityai/stable-diffusion-2-1"),
]

model_cards: dict[str, ModelCard] = {c.model_id: c for c in _CARDS}
# The dummy model runs on the dummy engine only (as in the reference).
model_cards["dummy"] = ModelCard("dummy", 8, "Dummy", "dummy", {"DummyInferenceEngine": "dummy"})


def get_repo(model_id: str, inference_engine_classname: str) -> str | None:
  card = model_cards.get(model_id)
  return card.repo_for(inference_engine_classname) if card else None


def get_pretty_name(model_id: str) -> str | None:
  card = model_cards.get(model_id)
  return card.pretty if card else None


def get_family(model_id: str) -> str | None:
  card = model_cards.get(model_id)
  return card.family if card else None


def build_base_shard(model_id: str, inference_engine_classname: str) -> Shard | None:
  card = model_cards.get(model_id)
  if card is None or card.repo_for(inference_engine_classname) is None:
    return None
  return Shard(model_id, 0, 0, card.layers)


def build_full_shard(model_id: str, inference_engine_classname: str) -> Shard | None:
  base = build_base_shard(model_id, inference_engine_classname)
  return None if base is None else Shard(model_id, 0, base.n_layers - 1, base.n_layers)


def get_supported_models(supported_inference_engine_lists: list[list[str]] | None = None) -> list[str]:
  """Models every engine list supports (each inner list is an OR of engine
  names or class names)."""
  if not supported_inference_engine_lists:
    return list(model_cards)
  from .inference.engine import inference_engine_classes

  normalized = [[inference_engine_classes.get(e, e) for e in engines] for engines in supported_inference_engine_lists]
  return [model_id for model_id, card in model_cards.items() if all(any(e in card.repo for e in engines) for engines in normalized)]
