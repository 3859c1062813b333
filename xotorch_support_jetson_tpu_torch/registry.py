"""Model registry: model id → layer count, family, HF repo — the dense
cards of the reference's ``registry.py``, keyed by the port engine's class
name. MoE, MLA, llava, gemma2 and diffusion cards wait for the slices that
port those model families.
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
  family: str  # "llama" | "qwen2" | "qwen3" | "mistral" | "phi3"
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
  _card("deepseek-r1-distill-qwen-1.5b", 28, "DeepSeek R1 Distill Qwen 1.5B", "qwen2", "unsloth/DeepSeek-R1-Distill-Qwen-1.5B"),
  _card("deepseek-r1-distill-qwen-7b", 28, "DeepSeek R1 Distill Qwen 7B", "qwen2", "unsloth/DeepSeek-R1-Distill-Qwen-7B"),
  _card("deepseek-r1-distill-llama-8b", 32, "DeepSeek R1 Distill Llama 8B", "llama", "unsloth/DeepSeek-R1-Distill-Llama-8B"),
  _card("qwen-2.5-0.5b", 24, "Qwen 2.5 0.5B", "qwen2", "unsloth/Qwen2.5-0.5B-Instruct"),
  _card("qwen-2.5-1.5b", 28, "Qwen 2.5 1.5B", "qwen2", "unsloth/Qwen2.5-1.5B-Instruct"),
  _card("qwen-2.5-3b", 36, "Qwen 2.5 3B", "qwen2", "unsloth/Qwen2.5-3B-Instruct"),
  _card("qwen-2.5-7b", 28, "Qwen 2.5 7B", "qwen2", "unsloth/Qwen2.5-7B-Instruct"),
  _card("qwen-2.5-coder-7b", 28, "Qwen 2.5 Coder 7B", "qwen2", "unsloth/Qwen2.5-Coder-7B-Instruct"),
  _card("qwen-3-0.6b", 28, "Qwen 3 0.6B", "qwen3", "Qwen/Qwen3-0.6B"),
  _card("qwen-3-1.7b", 28, "Qwen 3 1.7B", "qwen3", "Qwen/Qwen3-1.7B"),
  _card("qwen-3-8b", 36, "Qwen 3 8B", "qwen3", "Qwen/Qwen3-8B"),
  _card("phi-4-mini-instruct", 32, "Phi-4 Mini Instruct", "phi3", "microsoft/Phi-4-mini-instruct"),
]

model_cards: dict[str, ModelCard] = {c.model_id: c for c in _CARDS}


def get_repo(model_id: str, inference_engine_classname: str) -> str | None:
  card = model_cards.get(model_id)
  return card.repo_for(inference_engine_classname) if card else None


def build_base_shard(model_id: str, inference_engine_classname: str) -> Shard | None:
  card = model_cards.get(model_id)
  if card is None or card.repo_for(inference_engine_classname) is None:
    return None
  return Shard(model_id, 0, 0, card.layers)
