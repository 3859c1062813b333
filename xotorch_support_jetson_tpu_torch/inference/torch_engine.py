"""The PyTorch/CUDA inference engine — solo serving surface.

Counterpart of the reference's ``inference/jax_engine.py`` for one node
serving one full model: encode/decode/sample, prompt prefill into a dense
slot-indexed KV cache (padded to a 128 bucket, per-request ``_Session``),
chunked decode (``dispatch_chunk``/``read_chunk``) for streaming, one-shot
decode (``generate_oneshot``) for blocking requests, and ``end_request``.
All device work runs on one executor thread off the asyncio loop. The cache
is updated in place by the decoder.

It runs on ``cuda`` unless the caller asks for the CPU (``device="cpu"`` or
``XOT_TPU_PLATFORM=cpu``); with no card visible it raises.
"""

from __future__ import annotations

import asyncio
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models.decoder import fused_decode, fused_generate, init_kv_cache, shard_forward
from ..utils.helpers import DEBUG, resolve_device
from .engine import InferenceEngine, PromptTooLongError
from .shard import Shard
from .state import InferenceState

DEFAULT_MAX_SEQ = int(os.getenv("XOT_TPU_MAX_SEQ", "4096"))
PREFILL_BUCKET = 128


def _round_up(n: int, multiple: int) -> int:
  return ((n + multiple - 1) // multiple) * multiple


class _Session:
  __slots__ = ("kv_cache", "curr_pos", "prompt_len", "max_seq", "next_token_dev")

  def __init__(self, kv_cache, max_seq: int) -> None:
    self.kv_cache = kv_cache
    self.curr_pos = 0
    self.prompt_len = 0
    self.max_seq = max_seq
    self.next_token_dev = None  # [B,1] device tensor chaining decode chunks


class TorchShardedInferenceEngine(InferenceEngine):
  def __init__(self, shard_downloader=None, max_seq_len: int | None = None, seed: int = 0, device=None, tokenizer=None):
    self.shard_downloader = shard_downloader
    self.device = resolve_device(device)
    self.shard: Shard | None = None
    self._effective_shard: Shard | None = None
    self.params = None
    self.cfg = None
    # A tokenizer handed in by the caller is kept across loads; otherwise
    # one is resolved from the checkpoint directory (inference/tokenizers.py).
    self._fixed_tokenizer = tokenizer
    self.tokenizer = tokenizer
    self.max_seq_len = max_seq_len or DEFAULT_MAX_SEQ
    self._max_seq_explicit = max_seq_len is not None or os.getenv("XOT_TPU_MAX_SEQ") is not None
    self.sessions: dict[str, _Session] = {}
    self.executor = ThreadPoolExecutor(max_workers=1)
    self._seed = seed
    self.generator = torch.Generator(device=self.device).manual_seed(seed)
    self._shard_lock = asyncio.Lock()

  # ---------------------------------------------------------------- loading

  async def ensure_shard(self, shard: Shard) -> None:
    async with self._shard_lock:
      if self.shard == shard:
        return
      if self.shard_downloader is None:
        raise RuntimeError("no shard downloader configured and shard not preloaded; use load_test_model() for tests")
      model_dir = await self.shard_downloader.ensure_shard(shard, type(self).__name__)
      await asyncio.get_running_loop().run_in_executor(self.executor, self._load_shard_sync, shard, model_dir)
      await self._load_tokenizer(shard, model_dir)

  def _serving_cap(self, cfg) -> int:
    """Effective max_seq_len: the engine cap, and for longrope (phi-3/4)
    the pre-scaling original context unless the operator chose a cap."""
    from ..models.config import LongRopeScaling

    cap = min(self.max_seq_len, cfg.max_seq_len)
    if not self._max_seq_explicit and isinstance(cfg.rope_scaling, LongRopeScaling):
      cap = min(cap, cfg.rope_scaling.original_max_position_embeddings)
    return cap

  def _load_shard_sync(self, shard: Shard, model_dir) -> None:
    from dataclasses import replace

    from ..models.config import load_model_config
    from ..models.loader import load_shard_weights

    cfg = load_model_config(model_dir)
    cfg = replace(cfg, max_seq_len=self._serving_cap(cfg))
    eff = shard
    if cfg.n_layers != shard.n_layers:
      # A local checkpoint can disagree with the registry's layer count:
      # remap the shard's layer fractions onto the checkpoint's depth.
      start = round(shard.start_layer * cfg.n_layers / shard.n_layers)
      end = round((shard.end_layer + 1) * cfg.n_layers / shard.n_layers) - 1
      eff = Shard(shard.model_id, start, max(start, end), cfg.n_layers)
    self.params = None  # free the old model's device memory before loading
    self.params = load_shard_weights(model_dir, cfg, eff, device=self.device)
    self.cfg = cfg
    self.shard = shard
    self._effective_shard = eff
    self.sessions.clear()
    self.generator.manual_seed(self._seed)
    if DEBUG >= 1:
      print(f"[torch_engine] loaded {shard} from {model_dir} on {self.device}")

  async def _load_tokenizer(self, shard: Shard, model_dir) -> None:
    if self._fixed_tokenizer is not None:
      self.tokenizer = self._fixed_tokenizer
      return
    from .. import registry
    from .tokenizers import resolve_tokenizer

    repo = registry.get_repo(shard.model_id, type(self).__name__) or shard.model_id
    self.tokenizer = await resolve_tokenizer(repo, model_dir)

  def load_test_model(self, shard: Shard, cfg, params, tokenizer=None) -> None:
    """Directly inject a model (tests)."""
    self.shard = shard
    self._effective_shard = shard
    self.cfg = cfg
    self.params = params
    self.tokenizer = tokenizer
    self.sessions.clear()
    self.generator.manual_seed(self._seed)

  # ---------------------------------------------------------------- contract

  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    await self.ensure_shard(shard)
    return np.asarray(self.tokenizer.encode(prompt), dtype=np.int32)

  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    await self.ensure_shard(shard)
    return self.tokenizer.decode(np.asarray(tokens).reshape(-1).tolist())

  async def sample(self, x: np.ndarray, temp: float = 0.6, top_k: int = 35) -> np.ndarray:
    return await asyncio.get_running_loop().run_in_executor(self.executor, self._sample_sync, x, temp, top_k)

  def _sample_sync(self, x: np.ndarray, temp: float, top_k: int) -> np.ndarray:
    from ..ops.sampling import greedy, sample_logits

    logits = torch.from_numpy(np.asarray(x, dtype=np.float32))
    if logits.dim() == 3:  # tolerate [B,S,V] callers: sample the last row
      logits = logits[:, -1, :]
    if temp <= 0:
      return greedy(logits).numpy()
    return sample_logits(logits.to(self.device), self.generator, temp=temp, top_k=top_k).cpu().numpy()

  async def infer_tensor(
    self,
    request_id: str,
    shard: Shard,
    input_data: np.ndarray,
    inference_state: InferenceState | None = None,
  ) -> tuple[np.ndarray, InferenceState]:
    await self.ensure_shard(shard)
    return await asyncio.get_running_loop().run_in_executor(self.executor, self._infer_tensor_sync, request_id, input_data, inference_state)

  def _new_session(self, request_id: str, B: int) -> _Session:
    max_seq = min(self.max_seq_len, self.cfg.max_seq_len)
    cache = init_kv_cache(self.cfg, self._effective_shard.n_shard_layers, B, max_seq, device=self.device)
    session = self.sessions[request_id] = _Session(cache, max_seq)
    return session

  def _infer_tensor_sync(self, request_id, input_data, state):
    shard = self._effective_shard
    state = state or InferenceState()
    x = np.asarray(input_data)
    is_tokens = x.ndim == 2 and np.issubdtype(x.dtype, np.integer)
    B = x.shape[0]
    session = self.sessions.get(request_id) or self._new_session(request_id, B)
    if session.curr_pos == 0:
      prompt_len = state.prompt_len or x.shape[1]
      if prompt_len + 1 > session.max_seq:
        self.sessions.pop(request_id, None)
        raise PromptTooLongError(f"prompt of {prompt_len} tokens exceeds the {session.max_seq}-token context window")
      state.extras.setdefault("orig_prompt_len", int(prompt_len))
      if is_tokens:
        state.tokens = x.astype(np.int32)
        state.prompt_len = prompt_len
        pad_to = min(_round_up(x.shape[1], PREFILL_BUCKET), session.max_seq)
        x_in = np.zeros((B, pad_to), dtype=np.int32)
        x_in[:, : x.shape[1]] = x
      else:
        x_in = x  # hidden states arrive already padded
      S = x_in.shape[1]
      positions = torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)
      head_pos = torch.full((B,), prompt_len - 1, dtype=torch.int64, device=self.device) if shard.is_last_layer else None
      out, session.kv_cache = shard_forward(self.params, self.cfg, shard, self._to_device(x_in), positions, session.kv_cache, head_pos=head_pos)
      if shard.is_last_layer:
        out = out[:, 0, :]
      session.curr_pos = session.prompt_len = prompt_len
    else:
      if session.curr_pos >= session.max_seq:
        raise RuntimeError(f"KV cache exhausted at {session.max_seq} positions for request {request_id}")
      if is_tokens:
        x_step = x[:, -1:].astype(np.int32)  # the freshly sampled token
        if state.tokens is not None:
          state.tokens = np.concatenate([state.tokens, x_step], axis=1)
      else:
        x_step = x
      positions = torch.full((B, 1), session.curr_pos, dtype=torch.int32, device=self.device)
      out, session.kv_cache = shard_forward(self.params, self.cfg, shard, self._to_device(x_step), positions, session.kv_cache)
      if shard.is_last_layer:
        out = out[:, 0, :]
      session.curr_pos += 1
    state.curr_pos = session.curr_pos
    return out.float().cpu().numpy(), state

  def _to_device(self, x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(self.device) if np.issubdtype(x.dtype, np.integer) else t.to(self.device, self.cfg.dtype)

  # ---------------------------------------------------------------- decoding

  async def generate_chunk(self, request_id: str, shard: Shard, last_token: int, n_steps: int, temp: float = 0.6, top_k: int = 35) -> list[int]:
    handle = await self.dispatch_chunk(request_id, shard, n_steps, temp, top_k, first_token=last_token)
    return await self.read_chunk(handle)

  async def dispatch_chunk(self, request_id: str, shard: Shard, n_steps: int, temp: float = 0.6, top_k: int = 35, first_token: int | None = None):
    """Enqueue one decode chunk; returns its device tensor of tokens.

    The chunk's input token is ``first_token`` (first chunk after prefill)
    or the previous chunk's last token, which stays on the device — so the
    node can dispatch chunk N+1 before reading chunk N. None when the KV
    cache is exhausted."""
    await self.ensure_shard(shard)
    return await asyncio.get_running_loop().run_in_executor(self.executor, self._dispatch_chunk_sync, request_id, n_steps, temp, top_k, first_token)

  def _dispatch_chunk_sync(self, request_id, n_steps, temp, top_k, first_token):
    session = self.sessions[request_id]
    n_steps = min(n_steps, session.max_seq - session.curr_pos)
    if n_steps <= 0:
      return None
    B = session.kv_cache["k"].shape[1]
    if first_token is not None:
      token = torch.full((B, 1), int(first_token), dtype=torch.int32, device=self.device)
    else:
      token = session.next_token_dev
      if token is None:
        raise RuntimeError(f"no chained token for request {request_id}; pass first_token after prefill")
    start_pos = torch.full((B,), session.curr_pos, dtype=torch.int32, device=self.device)
    toks, session.kv_cache = fused_decode(
      self.params, self.cfg, self._effective_shard, token, session.kv_cache, start_pos, n_steps,
      temp=float(temp), top_k=int(top_k), generator=self.generator,
    )
    session.next_token_dev = toks[:, -1:]
    session.curr_pos += n_steps
    return toks

  async def read_chunk(self, handle) -> list[int]:
    if handle is None:
      return []
    return await asyncio.get_running_loop().run_in_executor(self.executor, lambda: [int(t) for t in handle[0].cpu().tolist()])

  async def generate_oneshot(
    self,
    request_id: str,
    shard: Shard,
    first_token: int,
    max_steps: int,
    eos_ids=(),
    temp: float = 0.6,
    top_k: int = 35,
  ) -> list[int]:
    """Generate a whole response (until EOS) in one device loop; returns
    the tokens trimmed at the first EOS."""
    await self.ensure_shard(shard)
    return await asyncio.get_running_loop().run_in_executor(
      self.executor, self._generate_oneshot_sync, request_id, first_token, max_steps, eos_ids, temp, top_k
    )

  def _generate_oneshot_sync(self, request_id, first_token, max_steps, eos_ids, temp, top_k):
    session = self.sessions[request_id]
    room = session.max_seq - session.curr_pos
    if room <= 0:
      return []
    limit = max(1, min(max_steps, room))
    B = session.kv_cache["k"].shape[1]
    token = torch.full((B, 1), int(first_token), dtype=torch.int32, device=self.device)
    start_pos = torch.full((B,), session.curr_pos, dtype=torch.int32, device=self.device)
    eos = tuple(sorted(int(e) for e in eos_ids))
    buf, _n, session.kv_cache = fused_generate(
      self.params, self.cfg, self._effective_shard, token, session.kv_cache, start_pos, limit,
      eos_ids=eos, temp=float(temp), top_k=int(top_k), generator=self.generator,
    )
    row = buf[0].cpu().numpy()
    n = limit
    if eos:
      hits = np.nonzero(np.isin(row[:limit], eos))[0]
      if hits.size:
        n = int(hits[0]) + 1
    session.curr_pos += n
    session.next_token_dev = None  # chain broken: the next chunk must re-seed
    return [int(t) for t in row[:n]]

  def end_request(self, request_id: str) -> None:
    self.sessions.pop(request_id, None)
