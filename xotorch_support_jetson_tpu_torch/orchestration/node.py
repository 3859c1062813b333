"""The serving node — single-node solo flow.

Counterpart of the reference's ``orchestration/node.py`` for one node that
owns the whole model: ``process_prompt`` → engine prefill → first token
sampled here → ``_fast_decode_loop`` (one device loop for a blocking
request, pipelined chunks for a streaming one) → ``_finish_request`` →
``engine.end_request``. Tokens reach listeners (the API) through
``on_token``. There is no ring, gRPC, discovery, QoS or SLO layer in the
port yet.
"""

from __future__ import annotations

import os
import uuid
from typing import Callable

import numpy as np

from ..inference.shard import Shard
from ..inference.state import InferenceState


class _Channel:
  def __init__(self) -> None:
    self.observers: list[Callable] = []

  def on_next(self, callback: Callable) -> None:
    self.observers.append(callback)


class CallbackRegistry:
  """Named observer channels; ``trigger_all`` calls every observer."""

  def __init__(self) -> None:
    self._channels: dict[str, _Channel] = {}

  def register(self, name: str) -> _Channel:
    return self._channels.setdefault(name, _Channel())

  def deregister(self, name: str) -> None:
    self._channels.pop(name, None)

  def trigger_all(self, *args) -> None:
    for channel in list(self._channels.values()):
      for observer in channel.observers:
        observer(*args)


class Node:
  def __init__(self, _id: str, inference_engine, max_generate_tokens: int = 10000, default_sample_temp: float = 0.6, default_sample_top_k: int = 35) -> None:
    self.id = _id
    self.inference_engine = inference_engine
    self.max_generate_tokens = max_generate_tokens
    self.default_sample_temp = default_sample_temp
    self.default_sample_top_k = default_sample_top_k
    self.buffered_token_output: dict[str, tuple[list[int], bool]] = {}
    self.request_options: dict[str, dict] = {}
    self.cancelled_requests: set[str] = set()
    self.outstanding_requests: dict[str, str] = {}
    self.on_token = CallbackRegistry()

  async def start(self) -> None:
    """Nothing to start: a solo node has no peers or discovery."""

  async def stop(self) -> None:
    """Nothing to stop (see ``start``)."""

  # --------------------------------------------------------------- serving

  def set_request_options(self, request_id: str, *, stream: bool | None = None, max_tokens: int | None = None, temperature: float | None = None, top_k: int | None = None) -> None:
    """Per-request serving hints set by the API before ``process_prompt``:
    ``stream=False`` lets the decode loop generate the whole response in one
    device loop; the rest override the node defaults for this request."""
    opts = self.request_options.setdefault(request_id, {})
    for k, v in (("stream", stream), ("max_tokens", max_tokens), ("temperature", temperature), ("top_k", top_k)):
      if v is not None:
        opts[k] = v

  def _request_limits(self, request_id: str) -> tuple[int, float, int]:
    opts = self.request_options.get(request_id, {})
    max_tokens = opts.get("max_tokens")
    max_tokens = self.max_generate_tokens if max_tokens is None else min(int(max_tokens), self.max_generate_tokens)
    temp = float(opts.get("temperature", self.default_sample_temp))
    top_k = int(opts.get("top_k", self.default_sample_top_k))
    return max_tokens, temp, top_k

  def get_current_shard(self, base_shard: Shard) -> Shard:
    """A solo node owns every layer of the model."""
    return Shard(base_shard.model_id, 0, base_shard.n_layers - 1, base_shard.n_layers)

  async def process_prompt(self, base_shard: Shard, prompt: str, request_id: str | None = None, inference_state: InferenceState | None = None):
    if request_id is None:
      request_id = str(uuid.uuid4())
    shard = self.get_current_shard(base_shard)
    self.outstanding_requests[request_id] = "processing"
    try:
      output, state = await self.inference_engine.infer_prompt(request_id, shard, prompt, inference_state)
      await self.process_inference_result(base_shard, output, request_id, state)
    except BaseException:
      self._finish_request(request_id)
      raise
    return output

  async def process_inference_result(self, base_shard: Shard, result, request_id: str, inference_state: InferenceState | None = None) -> None:
    """``result`` is the prefill's [B, vocab] logits: sample the first token,
    deliver it, then decode the rest on the fast path."""
    shard = self.get_current_shard(base_shard)
    if request_id in self.cancelled_requests:
      self.buffered_token_output.setdefault(request_id, ([], False))
      self.trigger_on_token_callbacks(request_id, [], True)
      self._finish_request(request_id)
      return
    tokens, _ = self.buffered_token_output.setdefault(request_id, ([], False))
    _, req_temp, req_top_k = self._request_limits(request_id)
    token = await self.inference_engine.sample(result, temp=req_temp, top_k=req_top_k)
    token_int = int(np.asarray(token).reshape(-1)[0])
    tokens.append(token_int)
    is_finished = self._check_finished(base_shard, token_int, len(tokens), request_id)
    self.buffered_token_output[request_id] = (tokens, is_finished)
    self.trigger_on_token_callbacks(request_id, [token_int], is_finished)
    if is_finished:
      self._finish_request(request_id)
      return
    await self._fast_decode_loop(base_shard, shard, request_id, token_int)

  async def _fast_decode_loop(self, base_shard: Shard, shard: Shard, request_id: str, last_token: int, chunk: int | None = None) -> None:
    """Blocking requests: the whole response in one device loop
    (``generate_oneshot``). Streaming: chunk N+1 is dispatched (its input
    token chained on the device) before chunk N is read back, so the host
    round trip hides behind compute; an EOS inside chunk N wastes at most
    one speculative chunk."""
    engine = self.inference_engine
    eos_ids = self._eos_token_ids(base_shard)
    max_tokens, temp, top_k = self._request_limits(request_id)

    if self.request_options.get(request_id, {}).get("stream") is False:
      tokens, _ = self.buffered_token_output[request_id]
      remaining = max_tokens - len(tokens)
      emit: list[int] = []
      if remaining > 0:
        emit = await engine.generate_oneshot(request_id, shard, last_token, remaining, eos_ids, temp, top_k)
        tokens.extend(emit)
      self.buffered_token_output[request_id] = (tokens, True)
      self.trigger_on_token_callbacks(request_id, emit, True)
      self._finish_request(request_id)
      return

    if chunk is None:
      chunk = int(os.getenv("XOT_TPU_DECODE_CHUNK", "32"))
    pending = await engine.dispatch_chunk(request_id, shard, chunk, temp, top_k, first_token=last_token)
    while pending is not None:
      if request_id in self.cancelled_requests:
        break
      tokens, _ = self.buffered_token_output[request_id]
      remaining = max_tokens - len(tokens)
      nxt = None
      if remaining > chunk:  # speculatively enqueue the next chunk while reading this one
        nxt = await engine.dispatch_chunk(request_id, shard, min(chunk, remaining - chunk), temp, top_k)
      new_tokens = (await engine.read_chunk(pending))[:remaining]
      emit = []
      hit_eos = False
      for t in new_tokens:
        emit.append(t)
        if t in eos_ids:
          hit_eos = True
          break
      tokens.extend(emit)
      done = hit_eos or len(tokens) >= max_tokens
      self.buffered_token_output[request_id] = (tokens, done)
      if emit or done:
        self.trigger_on_token_callbacks(request_id, emit, done)
      if done:
        break
      pending = nxt
      if pending is None:
        remaining = max_tokens - len(tokens)
        if remaining > 0:
          pending = await engine.dispatch_chunk(request_id, shard, min(chunk, remaining), temp, top_k)

    tokens, finished = self.buffered_token_output[request_id]
    self._finish_request(request_id)
    if not finished:  # cache exhaustion or cancel: listeners still see a finish
      self.buffered_token_output[request_id] = (tokens, True)
      self.trigger_on_token_callbacks(request_id, [], True)

  def cancel_request(self, request_id: str) -> None:
    """Stop generating for a request at the next chunk boundary."""
    if request_id in self.outstanding_requests:
      self.cancelled_requests.add(request_id)

  def _finish_request(self, request_id: str) -> None:
    self.outstanding_requests.pop(request_id, None)
    self.request_options.pop(request_id, None)
    self.cancelled_requests.discard(request_id)
    self.buffered_token_output.pop(request_id, None)
    self.inference_engine.end_request(request_id)

  def _check_finished(self, base_shard: Shard, token: int, n_tokens: int, request_id: str = "") -> bool:
    max_tokens, _, _ = self._request_limits(request_id)
    return n_tokens >= max_tokens or token in self._eos_token_ids(base_shard)

  def _eos_token_ids(self, base_shard: Shard) -> set[int]:
    tokenizer = getattr(self.inference_engine, "tokenizer", None)
    ids: set[int] = set()
    eos = getattr(tokenizer, "eos_token_id", None)
    if isinstance(eos, int):
      ids.add(eos)
    elif isinstance(eos, (list, tuple)):
      ids.update(int(e) for e in eos)
    cfg = getattr(self.inference_engine, "cfg", None)
    if cfg is not None:
      ids.update(cfg.eos_token_ids)
    return ids

  def trigger_on_token_callbacks(self, request_id: str, tokens: list[int], is_finished: bool) -> None:
    self.on_token.trigger_all(request_id, tokens, is_finished)
