"""Inference engine contract + factory (own copy of the reference's
``inference/engine.py``, reduced to the serving surface the port runs)."""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from .shard import Shard
from .state import InferenceState


class PromptTooLongError(ValueError):
  """Prompt exceeds the serving context window; the API answers 400."""


class ImageInputError(ValueError):
  """A request's images cannot be turned into the model's input: Pillow is
  missing, an image does not decode, or the prompt's ``<image>``
  placeholders and the images disagree. The API answers 400."""


class ServerOverloadedError(RuntimeError):
  """Request admission queue is full (or the page pool cannot hold the
  prompt); the API answers 429."""


class InferenceEngine(ABC):
  """A model-executing backend bound to one shard at a time."""

  # Whether ``generate_image`` serves stable-diffusion checkpoints (the
  # image routes answer 501 otherwise).
  can_generate_images = False

  @abstractmethod
  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    ...

  @abstractmethod
  async def sample(self, x: np.ndarray, temp: float = 0.0, top_k: int = 0) -> np.ndarray:
    ...

  @abstractmethod
  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    ...

  @abstractmethod
  async def infer_tensor(
    self,
    request_id: str,
    shard: Shard,
    input_data: np.ndarray,
    inference_state: InferenceState | None = None,
  ) -> tuple[np.ndarray, InferenceState]:
    ...

  async def infer_prompt(
    self,
    request_id: str,
    shard: Shard,
    prompt: str,
    inference_state: InferenceState | None = None,
  ) -> tuple[np.ndarray, InferenceState]:
    tokens = await self.encode(shard, prompt)
    return await self.infer_tensor(request_id, shard, tokens.reshape(1, -1), inference_state)

  async def ensure_shard(self, shard: Shard) -> None:
    ...

  def end_request(self, request_id: str) -> None:
    """Drop the request's per-request state (an engine without any keeps
    this no-op)."""


# engine short-name → classname
inference_engine_classes: dict[str, str] = {"torch": "TorchShardedInferenceEngine", "dummy": "DummyInferenceEngine"}


def get_inference_engine(inference_engine_name: str, shard_downloader=None, **kwargs) -> InferenceEngine:
  """Lazy factory; ``kwargs`` go to the torch engine (``device``,
  ``tokenizer``). The dummy engine takes none."""
  if inference_engine_name == "torch":
    from .torch_engine import TorchShardedInferenceEngine

    return TorchShardedInferenceEngine(shard_downloader, **kwargs)
  if inference_engine_name == "dummy":
    from .dummy_engine import DummyInferenceEngine

    return DummyInferenceEngine()
  raise ValueError(f"unknown inference engine: {inference_engine_name!r} (known: {sorted(inference_engine_classes)})")
