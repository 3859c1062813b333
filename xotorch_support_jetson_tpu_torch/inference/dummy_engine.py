"""A deterministic fake engine, so the ring and the API run without a model
(own copy of the reference's ``inference/dummy_engine.py``;
``--inference-engine dummy``).

Its tokenizer counts word lengths and ends on ``DUMMY_EOS`` (69). The last
shard's ``infer_tensor`` returns its input plus one and ``sample`` takes
the last value, so a ring started on token t yields t+1, t+2, … up to 69;
other shards pass their input through unchanged. It keeps the wire
history (``state.tokens``) as the real engine does, so a replay after a
peer's loss re-prefills it.
"""

from __future__ import annotations

import numpy as np

from .engine import InferenceEngine
from .shard import Shard
from .state import InferenceState

DUMMY_EOS = 69


class DummyTokenizer:
  eos_token_id = DUMMY_EOS
  all_special_tokens: list[str] = []

  def encode(self, text: str) -> list[int]:
    return [int(len(word)) % 100 for word in text.split()] or [1]

  def decode(self, tokens) -> str:
    return " ".join(str(int(t)) for t in np.asarray(tokens).reshape(-1))

  def apply_chat_template(self, messages, tokenize: bool = False, add_generation_prompt: bool = True, **kwargs):
    text = " ".join(str(m.get("content", "")) for m in messages)
    return self.encode(text) if tokenize else text


class DummyInferenceEngine(InferenceEngine):
  def __init__(self) -> None:
    super().__init__()
    self.tokenizer = DummyTokenizer()

  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    return np.asarray(self.tokenizer.encode(prompt), dtype=np.int32)

  async def sample(self, x: np.ndarray, temp: float = 0.0, top_k: int = 0) -> np.ndarray:
    # Greedy over the fake "logits" (which are just token values here).
    return np.asarray(x).reshape(1, -1)[:, -1].astype(np.int32)

  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    return self.tokenizer.decode(tokens)

  async def infer_tensor(
    self,
    request_id: str,
    shard: Shard,
    input_data: np.ndarray,
    inference_state: InferenceState | None = None,
  ) -> tuple[np.ndarray, InferenceState]:
    state = inference_state or InferenceState()
    x = np.asarray(input_data)
    if x.ndim == 2 and np.issubdtype(x.dtype, np.integer):
      if state.curr_pos == 0:
        # Prefill (the prompt, or a replayed token history): the original
        # prompt length survives replays (setdefault).
        state.tokens = x.astype(np.int32)
        state.prompt_len = x.shape[1]
        state.extras.setdefault("orig_prompt_len", int(x.shape[1]))
      elif state.tokens is not None:
        # A decode step at the ring head: append the sampled token to the
        # wire history, as the real engine does; a replay re-prefills it.
        state.tokens = np.concatenate([state.tokens, x[:, -1:].astype(np.int32)], axis=1)
    output = (x.astype(np.float32) + 1.0) if shard.is_last_layer else x.astype(np.float32)
    state.curr_pos += x.shape[1] if x.ndim >= 2 else 1
    return output, state
