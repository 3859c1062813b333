"""The serving node: one node serving the whole model, or one member of a
ring that splits the model's layers across nodes.

Counterpart of the reference's ``orchestration/node.py``. A node owns the
layer range its ring position gives it (``get_current_shard``: the
memory-weighted partition of the merged topology, the same on every node
that merged the same view).

- **Whole model** (no peers, or a partition that gives this node every
  layer): ``process_prompt`` → engine prefill → the first token sampled
  here → ``_fast_decode_loop`` (one device loop for a blocking request,
  pipelined chunks for a streaming one). With ``XOT_TPU_BATCHED=1`` every
  prompt goes to the engine's continuous-batching server instead
  (``_batched_serve``), except one with images (llava), which takes the
  solo path, as in the reference.
- **Ring**: a node that does not own layer 0 forwards the prompt to the one
  that does (``forward_prompt``, one retry over a refreshed topology). The
  head prefills its layers and forwards the hidden state
  (``forward_tensor``); each node runs its layers on what it receives
  (``process_tensor``) and forwards the result; the tail samples, streams
  the token to its listeners, broadcasts it to every peer
  (``broadcast_result``) and sends it back to the head (the ring wrap),
  one token per lap. Each hop awaits the hops after it, as the
  reference's RPCs do. The tail adopts the request's options
  (``max_tokens``, temperature, top-k) from the wire state
  (``_stash_options`` / ``_adopt_options``). A hop that fails replays the
  request's token history over the survivors (``_retry_request``) under a
  bumped ``replay_epoch``; every listener delivers only tokens past its
  per-request high-water mark (``trigger_on_token_callbacks``), so a
  replayed span never reaches a client twice. On a partial shard
  ``XOT_TPU_BATCHED=1`` takes the ring lap, as in the reference.

Membership: the server, the discovery and a first topology start with
``start``; ``periodic_topology_collection`` refreshes peers and the
merged view every 2 s. Before a prompt's model is loaded the head checks
the partition map against each member's reported memory
(``_ring_budget_problems``; the API answers 507). While the node runs, a
background task keeps the SLO engine's windows fresh off the event loop.
``score_tokens`` serves the API's ``logprobs`` (whole model only),
``process_image_prompt`` the image routes (the whole model on this node),
``graceful_drain`` the shutdown's wait. Not ported (each refused):
fault injection (``XOT_TPU_CHAOS``), disaggregation
(``XOT_TPU_DISAGG``), the cluster pulls over the opaque-status channel.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import traceback
import uuid

import numpy as np

from .. import registry
from ..inference.shard import Shard
from ..inference.state import InferenceState
from ..networking.discovery import Discovery, NoDiscovery
from ..networking.retry import breakers, peer_health
from ..topology.device_capabilities import UNKNOWN_DEVICE_CAPABILITIES, device_capabilities
from ..topology.partitioning import PartitioningStrategy, RingMemoryWeightedPartitioningStrategy, map_partitions_to_shards
from ..topology.topology import Topology
from ..utils.helpers import DEBUG, AsyncCallbackSystem
from ..utils.metrics import metrics
from .slo import slo_enabled, slo_engine

SLO_POLL_S = 1.0  # how often the node offers the SLO engine a tick (it self-gates to XOT_TPU_SLO_TICK_S)
TOPOLOGY_INTERVAL_S = 2.0  # the reference's collection period
# How long per-request dedup state (the high-water mark) outlives its
# request: the API's response timeout, so a straggling broadcast within any
# live client's window stays deduped.
RESPONSE_TIMEOUT_HORIZON_S = 900.0
# A chunk delivered ahead of the mark waits this long for the gap before the
# held chunks are released in order (a lost broadcast costs a visible gap,
# not a hung stream).
GAP_FLUSH_S = 5.0
# The reference's cluster pulls over the opaque-status channel and its drain
# announcement: not ported.
UNPORTED_STATUS_TYPES = frozenset({
  "metrics_pull", "metrics_snapshot", "timeline_pull", "timeline_fragment", "prefix_pull", "prefix_keys",
  "slo_pull", "slo_report", "disagg_pull", "disagg_stats", "bundle_pull", "bundle_part", "programs_pull", "programs_report",
  "node_draining",
})


def refuse_unported_ring_knobs() -> None:
  """Raise for the reference's ring knobs the port does not serve:
  ``XOT_TPU_CHAOS`` (fault injection) and ``XOT_TPU_DISAGG=1``
  (disaggregated prefill/decode)."""
  if os.getenv("XOT_TPU_CHAOS"):
    raise ValueError("XOT_TPU_CHAOS (fault injection) is not ported to the PyTorch package yet; unset it")
  if os.getenv("XOT_TPU_DISAGG", "0") not in ("", "0", "false"):
    raise ValueError("XOT_TPU_DISAGG (disaggregated prefill/decode) is not ported to the PyTorch package yet; unset it")


def check_opaque_status(status: str) -> None:
  """Refuse an opaque status of the reference's cluster pulls or its drain
  announcement (a ValueError the peer server answers as an error)."""
  try:
    kind = json.loads(status).get("type", "")
  except (ValueError, AttributeError):
    return
  if kind in UNPORTED_STATUS_TYPES:
    raise ValueError(f"opaque status {kind!r}: the cluster pulls are not ported to the PyTorch package yet")


class Node:
  def __init__(
    self,
    _id: str,
    inference_engine,
    max_generate_tokens: int = 10000,
    default_sample_temp: float = 0.6,
    default_sample_top_k: int = 35,
    shard_downloader=None,
    server=None,
    discovery: Discovery | None = None,
    partitioning_strategy: PartitioningStrategy | None = None,
  ) -> None:
    self.id = _id
    self.inference_engine = inference_engine
    self.shard_downloader = shard_downloader
    self.server = server
    self.discovery = discovery or NoDiscovery()
    self.partitioning_strategy = partitioning_strategy or RingMemoryWeightedPartitioningStrategy()
    # node id → its latest download progress (RepoProgressEvent.to_dict()):
    # this node's own from the downloader, peers' from their broadcasts.
    self.node_download_progress: dict[str, dict] = {}
    self.max_generate_tokens = max_generate_tokens
    self.default_sample_temp = default_sample_temp
    self.default_sample_top_k = default_sample_top_k
    self.peers: list = []
    self.device_capabilities = UNKNOWN_DEVICE_CAPABILITIES
    # Until start() merges a view, a node's topology is itself: it owns
    # every layer.
    self.topology = Topology()
    self.topology.update_node(self.id, self.device_capabilities)
    self.topology_inference_engines_pool: list[list[str]] = []
    self.buffered_token_output: dict[str, tuple[list[int], bool]] = {}
    self.request_options: dict[str, dict] = {}
    self.cancelled_requests: set[str] = set()
    self.outstanding_requests: dict[str, str] = {}
    # Replays after a peer's loss: attempts of the current incident, all of
    # a request's replays (the termination backstop), and the requests with
    # one in flight (concurrent failure reports coalesce).
    self._replay_attempts: dict[str, int] = {}
    self._replay_lifetime: dict[str, int] = {}
    self._replay_pending: set[str] = set()
    # The client stream's dedup: the per-request high-water mark of
    # delivered positions, chunks held ahead of it, their gap-flush timers,
    # the offset of a sampler's local buffer after a token-level replay,
    # and the last replay_epoch seen.
    self._emitted_counts: dict[str, int] = {}
    self._pending_chunks: dict[str, dict[int, tuple[list[int], bool]]] = {}
    self._gap_flush_timers: dict[str, asyncio.TimerHandle] = {}
    self._completion_offset: dict[str, int] = {}
    self._seen_epochs: dict[str, int] = {}
    self._ring_budget_cache: tuple | None = None
    self.on_token = AsyncCallbackSystem()
    self.on_opaque_status = AsyncCallbackSystem()
    self.on_opaque_status.register("node_status").on_next(self.on_node_status)
    self._slo_task: asyncio.Task | None = None
    self._topology_task: asyncio.Task | None = None
    self._background: set[asyncio.Task] = set()  # broadcasts and preloads in flight

  def spawn(self, coro) -> asyncio.Task:
    """Run ``coro`` as a background task the node keeps until it ends (the
    loop holds tasks weakly); its failure is printed under ``DEBUG``."""
    task = asyncio.get_running_loop().create_task(coro)
    self._background.add(task)

    def done(t: asyncio.Task) -> None:
      self._background.discard(t)
      if not t.cancelled() and t.exception() is not None and DEBUG >= 1:
        print(f"[node {self.id}] background task failed: {t.exception()!r}")

    task.add_done_callback(done)
    return task

  # ------------------------------------------------------------- lifecycle

  async def start(self, wait_for_peers: int = 0) -> None:
    """Probe this host, start the peer server and the discovery, merge a
    first topology and keep it fresh; start the SLO tick task."""
    refuse_unported_ring_knobs()
    self.device_capabilities = await device_capabilities()
    self.topology.update_node(self.id, self.device_capabilities)
    if self.server is not None:
      await self.server.start()
    await self.discovery.start()
    await self.update_peers(wait_for_peers)
    await self.collect_topology(set())
    if self._topology_task is None:
      self._topology_task = asyncio.create_task(self.periodic_topology_collection(TOPOLOGY_INTERVAL_S))
    if slo_enabled() and self._slo_task is None:
      self._slo_task = asyncio.create_task(self._slo_ticks())

  async def stop(self) -> None:
    """Stop the background tasks, the discovery and the peer server."""
    for task in (self._slo_task, self._topology_task):
      if task is not None:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    self._slo_task = self._topology_task = None
    await self.discovery.stop()
    if self.server is not None:
      await self.server.stop()
    for peer in self.peers:
      try:
        await peer.disconnect()
      except Exception:  # noqa: BLE001
        pass

  async def graceful_drain(self, drain_s: float | None = None, force: asyncio.Event | None = None) -> None:
    """The shutdown path's wait (main.py, after the API stopped taking
    requests): up to ``XOT_TPU_DRAIN_S`` (default 20 s) for outstanding
    requests, solo or batched, to finish; ``force`` (a second signal) ends
    the wait at once. Does not stop the node. The reference also announces
    the shutdown to its peers and migrates batched rows to a survivor; that
    is not ported."""
    if drain_s is None:
      try:
        drain_s = float(os.getenv("XOT_TPU_DRAIN_S", "20") or 20)
      except ValueError:
        drain_s = 20.0
    server = getattr(self.inference_engine, "_batched_server", None)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + drain_s
    while loop.time() < deadline and not (force is not None and force.is_set()):
      if not (self.outstanding_requests or (server is not None and server.busy())):
        break
      await asyncio.sleep(0.1)

  async def _slo_ticks(self) -> None:
    """Offer the SLO engine a tick every ``SLO_POLL_S``. A tick snapshots
    the whole metrics registry and computes every window, so it runs on a
    worker thread: neither the event loop nor the engine's device executor
    waits for it."""
    loop = asyncio.get_running_loop()
    while True:
      await asyncio.sleep(SLO_POLL_S)
      await loop.run_in_executor(None, slo_engine.maybe_tick)

  # ----------------------------------------------------- request options

  def set_request_options(self, request_id: str, *, stream: bool | None = None, max_tokens: int | None = None, temperature: float | None = None, top_k: int | None = None, priority: str | None = None, tenant: str | None = None, deadline_ms: float | None = None, adapter: str | None = None) -> None:
    """Per-request serving hints set by the API before ``process_prompt``:
    ``stream=False`` lets the decode loop generate the whole response in one
    device loop; ``priority``/``tenant``/``deadline_ms`` are the request's
    QoS identity for the batched server; ``adapter`` names a registered
    multi-LoRA adapter (solo and batched); the rest override the node
    defaults for this request."""
    opts = self.request_options.setdefault(request_id, {})
    for k, v in (("stream", stream), ("max_tokens", max_tokens), ("temperature", temperature), ("top_k", top_k), ("priority", priority), ("tenant", tenant), ("deadline_ms", deadline_ms), ("adapter", adapter)):
      if v is not None:
        opts[k] = v

  def _request_limits(self, request_id: str) -> tuple[int, float, int]:
    opts = self.request_options.get(request_id, {})
    max_tokens = opts.get("max_tokens")
    max_tokens = self.max_generate_tokens if max_tokens is None else min(int(max_tokens), self.max_generate_tokens)
    temp = float(opts.get("temperature", self.default_sample_temp))
    top_k = int(opts.get("top_k", self.default_sample_top_k))
    return max_tokens, temp, top_k

  def _stash_options(self, request_id: str, state: InferenceState | None) -> InferenceState | None:
    """Put this request's options on the wire state, so the tail (which
    samples and enforces the limits) sees them."""
    opts = self.request_options.get(request_id)
    if opts:
      state = state or InferenceState()
      state.extras["request_options"] = opts
    return state

  def _adopt_options(self, request_id: str, state: InferenceState | None, shard: Shard) -> None:
    """On the tail only (it samples and runs ``_finish_request``): take the
    request's options from the wire state, and after a bumped
    ``replay_epoch`` drop the stale local buffer (the wire history keeps
    the budget and the positions exact)."""
    if not shard.is_last_layer or state is None:
      return
    if "request_options" in state.extras and request_id not in self.request_options:
      self.request_options[request_id] = dict(state.extras["request_options"])
    epoch = int(state.extras.get("replay_epoch", 0))
    if epoch > self._seen_epochs.get(request_id, 0):
      self._seen_epochs[request_id] = epoch
      if request_id in self.buffered_token_output:
        self.buffered_token_output[request_id] = ([], False)
      self._completion_offset.pop(request_id, None)

  # --------------------------------------------------------------- serving

  async def process_prompt(self, base_shard: Shard, prompt: str, request_id: str | None = None, inference_state: InferenceState | None = None, wire_concrete: bool = False):
    """Serve one prompt. ``wire_concrete``: ``base_shard`` is the range a
    sender computed for this node (obeyed as it is); otherwise it is the
    model's base shard, resolved against this node's view."""
    if request_id is None:
      request_id = str(uuid.uuid4())
    shard = base_shard if wire_concrete else self.get_current_shard(base_shard)
    if self.peers:
      self.spawn(self.broadcast_opaque_status(request_id, json.dumps({
        "type": "node_status", "node_id": self.id, "status": "start_process_prompt",
        "base_shard": base_shard.to_dict(), "shard": shard.to_dict(), "prompt": prompt, "request_id": request_id,
      })))
    t0 = time.perf_counter_ns()
    try:
      return await self._process_prompt(base_shard, prompt, request_id, inference_state, wire_concrete)
    finally:
      if self.peers:
        self.spawn(self.broadcast_opaque_status(request_id, json.dumps({
          "type": "node_status", "node_id": self.id, "status": "end_process_prompt", "request_id": request_id, "elapsed_time_ns": time.perf_counter_ns() - t0,
        })))

  async def process_image_prompt(
    self,
    base_shard: Shard,
    prompt: str,
    request_id: str | None = None,
    *,
    negative: str = "",
    steps: int = 30,
    guidance: float = 7.5,
    seed: int = 0,
    size: tuple[int, int] | None = None,
    init_image=None,
    strength: float = 0.8,
    progress_cb=None,
    cancel_event=None,
    n: int = 1,
  ):
    """Image generation (the stable-diffusion family) → uint8 [H, W, 3]
    ([n, H, W, 3] when n > 1). The whole model runs on this node's engine,
    also on a ring node: the request never goes round the ring, and its
    progress comes from the denoise loop's chunk boundaries."""
    full = Shard(base_shard.model_id, 0, base_shard.n_layers - 1, base_shard.n_layers)
    metrics.inc("requests_total")
    return await self.inference_engine.generate_image(
      full, prompt, negative=negative, steps=steps, guidance=guidance, seed=seed, size=size,
      init_image=init_image, strength=strength, progress_cb=progress_cb, cancel_event=cancel_event, n=n,
    )

  async def _process_prompt(self, base_shard: Shard, prompt: str, request_id: str, inference_state: InferenceState | None, wire_concrete: bool):
    shard = base_shard if wire_concrete else self.get_current_shard(base_shard)
    if not wire_concrete:
      # Before any per-request state or load: a map that cannot hold the
      # model is refused here (a forwarded prompt was checked by its sender).
      self.check_ring_budget(base_shard)
    self._adopt_options(request_id, inference_state, shard)
    if not shard.is_first_layer:
      # Not the ring's head: route the prompt to the owner of layer 0,
      # retrying once over a refreshed topology if the head just left.
      for attempt in (0, 1):
        try:
          if attempt:
            # The retry regenerates from position 0: a bumped epoch resets
            # every survivor's buffer, and the listeners' high-water marks
            # drop the re-streamed prefix.
            inference_state = inference_state or InferenceState()
            inference_state.extras["replay_epoch"] = int(inference_state.extras.get("replay_epoch", 0)) + 1
          await self.forward_prompt(base_shard, prompt, request_id, self.get_partition_index(offset=0, owner_of_first_layer=True), inference_state)
          return None
        except Exception:  # noqa: BLE001
          if attempt:
            raise
          await asyncio.sleep(float(os.getenv("XOT_TPU_RETRY_DELAY_S", "3")))
          try:
            await self.update_peers()
            await self.collect_topology(set())
          except Exception:  # noqa: BLE001
            pass
      return None
    if (
      os.getenv("XOT_TPU_BATCHED", "0") == "1"
      and shard.is_last_layer
      and getattr(self.inference_engine, "supports_batched", lambda: False)()
      and not (inference_state is not None and inference_state.extras.get("images"))
    ):
      # Continuous batching (inference/batch_scheduler.py): concurrent
      # requests share fused decode chunks over the paged pool. A request
      # with images takes the solo path (the tower and the embeddings
      # prefill), as in the reference; text requests to the same model batch.
      return await self._batched_serve(base_shard, shard, prompt, request_id)
    self.outstanding_requests[request_id] = "processing"
    try:
      adapter = self.request_options.get(request_id, {}).get("adapter")
      if adapter and hasattr(self.inference_engine, "set_request_adapter"):
        # The solo path applies the same per-row hook per session; an
        # unknown name raises the client-error type before any device work.
        self.inference_engine.set_request_adapter(request_id, adapter)
      output, state = await self.inference_engine.infer_prompt(request_id, shard, prompt, inference_state)
      await self.process_inference_result(base_shard, output, request_id, state, shard=shard)
    except BaseException:
      self._finish_request(request_id)
      raise
    return output

  async def process_tensor(self, base_shard: Shard, tensor, request_id: str, inference_state: InferenceState | None = None, wire_concrete: bool = False):
    """Run this node's layers on a hop's input (a sampled token on the head,
    a hidden state elsewhere) and pass the result on. ``wire_concrete``: the
    sender's shard for this node is obeyed (a local re-derivation could
    disagree with it while views converge)."""
    shard = base_shard if wire_concrete else self.get_current_shard(base_shard)
    self._adopt_options(request_id, inference_state, shard)
    try:
      self.outstanding_requests[request_id] = "processing"
      output, state = await self.inference_engine.infer_tensor(request_id, shard, tensor, inference_state)
      await self.process_inference_result(base_shard, output, request_id, state, shard=shard)
      return output
    except Exception:  # noqa: BLE001 — a failed hop must not kill the server
      self._finish_request(request_id)
      print(f"[node {self.id}] error processing a tensor for {request_id}")
      traceback.print_exc()
      return None

  async def process_inference_result(self, base_shard: Shard, result, request_id: str, inference_state: InferenceState | None = None, shard: Shard | None = None) -> None:
    """``result`` is the tail's [B, vocab] logits (sample, deliver, then the
    fast decode loop on a whole-model node or the ring wrap) or a hidden
    state (forward it to the next node)."""
    shard = shard or self.get_current_shard(base_shard)
    if request_id in self.cancelled_requests:
      # The client is gone: stop the ring here.
      tokens, _ = self.buffered_token_output.setdefault(request_id, ([], False))
      self.buffered_token_output[request_id] = (tokens, True)
      self.trigger_on_token_callbacks(request_id, [], True)
      self._finish_request(request_id)
      return
    if not shard.is_last_layer:
      try:
        await self.forward_tensor(base_shard, result, request_id, self.get_partition_index(offset=1), inference_state)
      except Exception as e:  # noqa: BLE001 — the next hop is gone: replay over the new topology
        if DEBUG >= 1:
          print(f"[node {self.id}] mid-ring hop for {request_id} failed: {e!r}")
        await self._retry_request(base_shard, request_id, inference_state)
      return
    tokens, _ = self.buffered_token_output.setdefault(request_id, ([], False))
    _, req_temp, req_top_k = self._request_limits(request_id)
    token = await self.inference_engine.sample(result, temp=req_temp, top_k=req_top_k)
    token_int = int(np.asarray(token).reshape(-1)[0])
    tokens.append(token_int)
    is_finished = self._check_finished(base_shard, token_int, len(tokens), request_id, inference_state)
    self.buffered_token_output[request_id] = (tokens, is_finished)
    # The token's absolute completion index: after a token-level replay the
    # wire history floors it (this node's buffer restarted).
    off = self._completion_offset.get(request_id, 0)
    state = inference_state
    if state is not None and state.tokens is not None and "orig_prompt_len" in state.extras:
      hist_pos = int(np.asarray(state.tokens).shape[-1]) - int(state.extras["orig_prompt_len"])
      if hist_pos - (len(tokens) - 1) > off:
        off = self._completion_offset[request_id] = hist_pos - (len(tokens) - 1)
    abs_pos = off + len(tokens) - 1
    self.trigger_on_token_callbacks(request_id, [token_int], is_finished, start_pos=abs_pos)
    if self.peers:
      self.spawn(self.broadcast_result(request_id, [token_int], is_finished, start_pos=abs_pos))
    if is_finished:
      self._finish_request(request_id)
      return
    if shard.is_first_layer and hasattr(self.inference_engine, "dispatch_chunk"):
      # This node owns the whole model: decode in device loops.
      await self._fast_decode_loop(base_shard, shard, request_id, token_int)
      return
    # The ring wraps: the sampled token goes back to the head.
    next_token = np.asarray([[token_int]], dtype=np.int32)
    try:
      await self.forward_tensor(base_shard, next_token, request_id, self.get_partition_index(offset=1), inference_state)
    except Exception as e:  # noqa: BLE001
      if DEBUG >= 1:
        print(f"[node {self.id}] ring wrap hop for {request_id} failed: {e!r}")
      # The sampled (and streamed) token joins the wire history only at the
      # head: add it here, or the replay would regenerate it.
      if inference_state is not None and inference_state.tokens is not None:
        inference_state.tokens = np.concatenate([inference_state.tokens, next_token], axis=1)
      await self._retry_request(base_shard, request_id, inference_state)

  async def _retry_request(self, base_shard: Shard, request_id: str, state: InferenceState | None) -> None:
    """Replay a request whose next hop died: after discovery drops the dead
    peer and the topology is collected again, the wire state's token
    history (prompt and generated tokens) is prefilled afresh on the new
    head under a bumped ``replay_epoch`` (surviving engines drop their
    stale sessions; the tail its stale buffer). Generation continues where
    it stopped; streamed tokens are not re-sent. Up to
    ``XOT_TPU_INFLIGHT_RETRIES`` (default 4) attempts per incident and four
    times that over the request's life; concurrent failure reports of one
    request coalesce."""
    if request_id in self._replay_pending:
      return
    retries = int(os.getenv("XOT_TPU_INFLIGHT_RETRIES", "4"))
    attempt = self._replay_attempts.get(request_id, 0)
    lifetime = self._replay_lifetime.get(request_id, 0)
    if state is None or state.tokens is None or attempt >= retries or lifetime >= 4 * retries:
      self._finish_request(request_id)
      print(f"[node {self.id}] request {request_id} failed after {attempt} replay attempts")
      tokens, _ = self.buffered_token_output.setdefault(request_id, ([], False))
      self.buffered_token_output[request_id] = (tokens, True)
      self.trigger_on_token_callbacks(request_id, [], True)
      if self.peers:
        self.spawn(self.broadcast_result(request_id, [], True))
      return
    self._replay_attempts[request_id] = attempt + 1
    self._replay_lifetime[request_id] = lifetime + 1
    self._replay_pending.add(request_id)
    if DEBUG >= 1:
      print(f"[node {self.id}] replaying {request_id} (attempt {attempt + 1}) after a peer's loss")
    retry_state: InferenceState | None = None
    try:
      await asyncio.sleep(float(os.getenv("XOT_TPU_RETRY_DELAY_S", "3")))
      try:
        await self.update_peers()
        await self.collect_topology(set())
      except Exception:  # noqa: BLE001 — collection is best-effort here
        pass
      tokens = np.asarray(state.tokens, dtype=np.int32).reshape(1, -1)
      # The epoch derives from the wire state's, so a second failure seen on
      # another node still makes a higher one; the original prompt length
      # keeps the client's budget on the new tail.
      extras = {"replay_epoch": int(state.extras.get("replay_epoch", 0)) + 1}
      for key in ("orig_prompt_len", "request_options"):
        if key in state.extras:
          extras[key] = state.extras[key]
      replay_state = InferenceState(tokens=tokens.copy(), prompt_len=tokens.shape[1], extras=extras)
      try:
        await self.forward_tensor(base_shard, tokens, request_id, self.get_partition_index(offset=0, owner_of_first_layer=True), replay_state)
      except Exception as e:  # noqa: BLE001 — the next attempt
        if DEBUG >= 1:
          print(f"[node {self.id}] replay forward for {request_id} failed: {e!r}")
        retry_state = replay_state
    finally:
      self._replay_pending.discard(request_id)
    if retry_state is not None:
      await self._retry_request(base_shard, request_id, retry_state)
    else:
      self._replay_attempts.pop(request_id, None)

  async def _fast_decode_loop(self, base_shard: Shard, shard: Shard, request_id: str, last_token: int, chunk: int | None = None) -> None:
    """Blocking requests: the whole response in one device loop
    (``generate_oneshot``). Streaming: chunk N+1 is dispatched (its input
    token chained on the device) before chunk N is read back, so the host
    round trip hides behind compute; an EOS inside chunk N wastes at most
    one speculative chunk."""
    engine = self.inference_engine
    eos_ids = self._eos_token_ids(base_shard)
    max_tokens, temp, top_k = self._request_limits(request_id)
    off = self._completion_offset.get(request_id, 0)

    if self.request_options.get(request_id, {}).get("stream") is False:
      tokens, _ = self.buffered_token_output[request_id]
      start = off + len(tokens)
      remaining = max_tokens - start
      emit: list[int] = []
      if remaining > 0:
        emit = await engine.generate_oneshot(request_id, shard, last_token, remaining, eos_ids, temp, top_k)
        tokens.extend(emit)
      self.buffered_token_output[request_id] = (tokens, True)
      self._deliver(request_id, emit, True, start)
      self._finish_request(request_id)
      return

    if chunk is None:
      chunk = int(os.getenv("XOT_TPU_DECODE_CHUNK", "32"))
    pending = await engine.dispatch_chunk(request_id, shard, chunk, temp, top_k, first_token=last_token)
    while pending is not None:
      if request_id in self.cancelled_requests:
        break
      tokens, _ = self.buffered_token_output[request_id]
      remaining = max_tokens - off - len(tokens)
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
      start = off + len(tokens)
      tokens.extend(emit)
      done = hit_eos or off + len(tokens) >= max_tokens
      self.buffered_token_output[request_id] = (tokens, done)
      if emit or done:
        self._deliver(request_id, emit, done, start)
      if done:
        break
      pending = nxt
      if pending is None:
        remaining = max_tokens - off - len(tokens)
        if remaining > 0:
          pending = await engine.dispatch_chunk(request_id, shard, min(chunk, remaining), temp, top_k)

    tokens, finished = self.buffered_token_output[request_id]
    self._finish_request(request_id)
    if not finished:  # cache exhaustion or cancel: listeners still see a finish
      self.buffered_token_output[request_id] = (tokens, True)
      self.trigger_on_token_callbacks(request_id, [], True)
      if self.peers:
        self.spawn(self.broadcast_result(request_id, [], True))

  def _deliver(self, request_id: str, tokens: list[int], finished: bool, start: int) -> None:
    """Tokens generated on this node: to its listeners and to its peers."""
    self.trigger_on_token_callbacks(request_id, tokens, finished, start_pos=start)
    if self.peers:
      self.spawn(self.broadcast_result(request_id, list(tokens), finished, start_pos=start))

  async def _batched_serve(self, base_shard: Shard, shard: Shard, prompt: str, request_id: str) -> None:
    """Serve one prompt through the engine's batched server; tokens stream
    to listeners as its chunks settle."""
    engine = self.inference_engine
    self.outstanding_requests[request_id] = "processing"
    try:
      tokens = await engine.encode(shard, prompt)
      max_tokens, temp, top_k = self._request_limits(request_id)
      eos_ids = self._eos_token_ids(base_shard)
      self.buffered_token_output[request_id] = ([], False)

      def emit(rid: str, new_tokens: list, finished: bool) -> None:
        buffered, _ = self.buffered_token_output.get(rid, ([], False))
        start = len(buffered)
        buffered.extend(new_tokens)
        self.buffered_token_output[rid] = (buffered, finished)
        self._deliver(rid, list(new_tokens), finished, start)

      opts = self.request_options.get(request_id, {})
      await engine.get_batched_server().submit(
        request_id, tokens, max_tokens=max_tokens, temp=temp, top_k=top_k, eos_ids=eos_ids, emit=emit,
        priority=opts.get("priority", "standard"), tenant=opts.get("tenant", "default"), deadline_ms=opts.get("deadline_ms"), adapter=opts.get("adapter"),
      )
    finally:
      self._finish_request(request_id)

  async def score_tokens(self, base_shard: Shard, tokens, n_scored: int, top_n: int):
    """Logprobs after the fact for the API's ``logprobs`` field: one
    scoring forward over prompt and completion on this node, which must
    hold the whole model (None when the engine cannot score)."""
    scorer = getattr(self.inference_engine, "score_tokens", None)
    if scorer is None:
      return None
    shard = self.get_current_shard(base_shard)
    if not (shard.is_first_layer and shard.is_last_layer):
      raise ValueError(f"logprobs need the whole model on one node; this node holds layers {shard.start_layer}-{shard.end_layer} of {shard.n_layers}")
    return await scorer(shard, tokens, n_scored, top_n)

  def cancel_request(self, request_id: str) -> None:
    """Stop generating for a request at the next chunk or hop boundary (the
    batched server frees its row there); peers are told too."""
    self._cancel_locally(request_id)
    if self.peers:
      self.spawn(self.broadcast_opaque_status(request_id, json.dumps({"type": "cancel_request", "request_id": request_id})))

  def _cancel_locally(self, request_id: str) -> None:
    if request_id in self.outstanding_requests:
      self.cancelled_requests.add(request_id)
      server = getattr(self.inference_engine, "_batched_server", None)
      if server is not None:
        server.cancel(request_id)

  def _finish_request(self, request_id: str) -> None:
    self.outstanding_requests.pop(request_id, None)
    self.request_options.pop(request_id, None)
    self.cancelled_requests.discard(request_id)
    self.buffered_token_output.pop(request_id, None)
    self._replay_attempts.pop(request_id, None)
    self._replay_lifetime.pop(request_id, None)
    self._replay_pending.discard(request_id)
    self._completion_offset.pop(request_id, None)
    self._seen_epochs.pop(request_id, None)
    self.inference_engine.end_request(request_id)

  def _check_finished(self, base_shard: Shard, token: int, n_tokens: int, request_id: str = "", state: InferenceState | None = None) -> bool:
    max_tokens, _, _ = self._request_limits(request_id)
    # After a replay the tail's buffer may have restarted: the wire
    # history (beyond the original prompt, plus the token just sampled)
    # keeps the client's budget.
    if state is not None and state.tokens is not None and "orig_prompt_len" in state.extras:
      n_tokens = max(n_tokens, int(np.asarray(state.tokens).shape[-1]) - int(state.extras["orig_prompt_len"]) + 1)
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

  # ------------------------------------------------------------ forwarding

  def _peer(self, node_id: str):
    return next((p for p in self.peers if p.id() == node_id), None)

  async def forward_prompt(self, base_shard: Shard, prompt: str, request_id: str, target_index: int, inference_state: InferenceState | None = None) -> None:
    target_id = self.partitioning_strategy.partition(self.topology)[target_index].node_id
    next_shard = self.get_current_shard(base_shard, target_index)
    inference_state = self._stash_options(request_id, inference_state)
    if target_id == self.id:
      await self.process_prompt(next_shard, prompt, request_id, inference_state, wire_concrete=True)
      return
    peer = self._peer(target_id)
    if peer is None:
      raise ValueError(f"peer for partition {target_index} not found")
    await peer.send_prompt(next_shard, prompt, request_id, inference_state)

  async def forward_tensor(self, base_shard: Shard, tensor, request_id: str, target_index: int, inference_state: InferenceState | None = None) -> None:
    target_id = self.partitioning_strategy.partition(self.topology)[target_index].node_id
    next_shard = self.get_current_shard(base_shard, target_index)
    inference_state = self._stash_options(request_id, inference_state)
    if target_id == self.id:
      await self.process_tensor(next_shard, tensor, request_id, inference_state, wire_concrete=True)
      return
    peer = self._peer(target_id)
    if peer is None:
      raise ValueError(f"peer for partition {target_index} not found")
    await peer.send_tensor(next_shard, tensor, request_id, inference_state)

  # ------------------------------------------------------------ partitions

  def get_partition_index(self, offset: int = 0, owner_of_first_layer: bool = False) -> int:
    partitions = self.partitioning_strategy.partition(self.topology)
    if owner_of_first_layer:
      return 0
    current = next((i for i, p in enumerate(partitions) if p.node_id == self.id), None)
    if current is None:
      raise ValueError(f"node {self.id} not in the partition table")
    return (current + offset) % len(partitions)

  def get_current_shard(self, base_shard: Shard, index: int | None = None) -> Shard:
    if index is None:
      index = self.get_partition_index()
    partitions = self.partitioning_strategy.partition(self.topology)
    shards = map_partitions_to_shards(partitions, base_shard.n_layers, base_shard.model_id)
    return shards[min(index, len(shards) - 1)]

  def _model_cfg_for_budget(self, model_id: str):
    """The model's geometry without its weights: the loaded engine's
    config, an ``XOT_TPU_MODEL_DIR`` checkpoint's, or a downloaded
    directory's ``config.json``; None when none is on disk."""
    eng = self.inference_engine
    cfg, eng_shard = getattr(eng, "cfg", None), getattr(eng, "shard", None)
    if cfg is not None and eng_shard is not None and eng_shard.model_id == model_id:
      return cfg
    from pathlib import Path

    candidates = []
    if local := os.getenv("XOT_TPU_MODEL_DIR"):
      candidates.append(Path(local))
    from ..download.downloader import get_models_dir, repo_to_dirname

    repo = registry.get_repo(model_id, type(eng).__name__)
    if repo:
      candidates.append(get_models_dir() / repo_to_dirname(repo))
    from ..models.config import load_model_config

    for d in candidates:
      try:
        if (d / "config.json").exists():
          return load_model_config(d)
      except Exception:  # noqa: BLE001 — an unreadable config skips the check
        continue
    return None

  def _ring_budget_problems(self, base_shard: Shard) -> list[str]:
    """The current partition map against each member's reported memory
    (parallel/hbm_planner.py ``ring_partition_fits``): empty when the ring
    fits, when this node serves alone, when a member's memory is unknown
    (0: never refuse on a placeholder), or when the model's geometry is not
    on disk. Cached per (model, ids and memories)."""
    partitions = self.partitioning_strategy.partition(self.topology)
    if len(partitions) <= 1:
      return []
    mems_mb = [int(getattr(self.topology.nodes.get(p.node_id), "memory", 0) or 0) for p in partitions]
    if any(m <= 0 for m in mems_mb):
      return []
    fingerprint = (base_shard.model_id, tuple(zip([p.node_id for p in partitions], mems_mb)))
    if self._ring_budget_cache and self._ring_budget_cache[0] == fingerprint:
      return self._ring_budget_cache[1]
    cfg = self._model_cfg_for_budget(base_shard.model_id)
    if cfg is None:
      return []  # not cached: the next prompt checks once the config is on disk
    from ..parallel.hbm_planner import ring_partition_fits

    shards = map_partitions_to_shards(partitions, cfg.n_layers, base_shard.model_id)
    problems = ring_partition_fits(cfg, shards, [m * 1024**2 for m in mems_mb], quant=os.getenv("XOT_TPU_QUANT") or None)
    self._ring_budget_cache = (fingerprint, problems)
    return problems

  def check_ring_budget(self, base_shard: Shard) -> None:
    """Raise ``RingBudgetError`` when the ring cannot hold the model."""
    problems = self._ring_budget_problems(base_shard)
    if problems:
      from ..parallel.hbm_planner import RingBudgetError

      raise RingBudgetError("ring cannot hold the model: " + "; ".join(problems))

  # -------------------------------------------------------------- topology

  async def update_peers(self, wait_for_peers: int = 0) -> bool:
    """Take the discovery's peer list: connect the new and moved peers,
    disconnect the gone and moved ones (forgetting their breakers and
    health counts). Returns whether anything changed."""
    next_peers = await self.discovery.discover_peers(wait_for_peers)
    current = {p.id(): p for p in self.peers}
    next_ids = {p.id() for p in next_peers}
    added = [p for p in next_peers if p.id() not in current]
    removed = [p for p in self.peers if p.id() not in next_ids]
    updated = [p for p in next_peers if p.id() in current and current[p.id()].addr() != p.addr()]
    unchanged = [p for p in next_peers if p.id() in current and current[p.id()].addr() == p.addr()]

    async def disconnect(peer, timeout=5):
      breakers.forget(peer.id())
      peer_health.forget(peer.id())
      try:
        await asyncio.wait_for(peer.disconnect(), timeout)
      except Exception:  # noqa: BLE001
        if DEBUG >= 1:
          print(f"[node {self.id}] disconnect error for {peer.id()}")

    async def connect(peer, timeout=5):
      try:
        await asyncio.wait_for(peer.connect(), timeout)
      except Exception:  # noqa: BLE001
        if DEBUG >= 1:
          print(f"[node {self.id}] connect error for {peer.id()}")

    await asyncio.gather(*(disconnect(p) for p in removed + [current[p.id()] for p in updated]), *(connect(p) for p in added + updated))
    self.peers = [current[p.id()] for p in unchanged] + added + updated
    return bool(added or removed or updated)

  async def collect_topology(self, visited: set[str], max_depth: int = 4) -> Topology:
    """Merge this node's and its peers' views: each peer's latest
    self-report (else the capabilities its handle came with), then each
    peer's own view; self-reports win over hearsay; unreachable peers are
    left out after every merge (a peer's hearsay must not resurrect a dead
    node in the partition map)."""
    nxt = Topology()
    nxt.update_node(self.id, self.device_capabilities)
    for peer in self.peers:
      nxt.update_node(peer.id(), self.topology.nodes.get(peer.id()) or peer.device_capabilities())
      nxt.add_edge(self.id, peer.id(), peer.description())
    unreachable: set[str] = set()
    self_reports = {}
    if max_depth > 0:
      prev_visited = set(visited)
      visited.add(self.id)
      visited.update(p.id() for p in self.peers)
      for peer in self.peers:
        if peer.id() in prev_visited:
          continue
        try:
          other = await asyncio.wait_for(peer.collect_topology(visited, max_depth - 1), timeout=5.0)
          nxt.merge(peer.id(), other)
          if peer.id() in other.nodes:
            self_reports[peer.id()] = other.nodes[peer.id()]
        except Exception as e:  # noqa: BLE001
          if DEBUG >= 1:
            print(f"[node {self.id}] error collecting topology from {peer.id()}: {e!r}")
          unreachable.add(peer.id())
      # Self-knowledge wins over hearsay: this node's, and each peer's own
      # report over what a third node last heard of it. (The reference
      # re-applies only its own, and with three nodes two of them can keep
      # passing each other a stale figure for the third: their partition
      # maps then disagree.)
      for nid, peer_caps in self_reports.items():
        nxt.update_node(nid, peer_caps)
      nxt.update_node(self.id, self.device_capabilities)
    for dead in unreachable:
      nxt.nodes.pop(dead, None)
    nxt.active_node_id = self.topology.active_node_id or self.id
    self.topology = nxt
    return nxt

  async def periodic_topology_collection(self, interval: float) -> None:
    """Refresh the peers and collect the topology every ``interval`` s (every
    cycle, changed or not: a view taken while a peer booted must not stay)."""
    while True:
      await asyncio.sleep(interval)
      try:
        await self.update_peers()
        await self.collect_topology(set())
      except Exception:  # noqa: BLE001
        if DEBUG >= 1:
          traceback.print_exc()

  @property
  def current_topology(self) -> Topology:
    return self.topology

  # ------------------------------------------------------------- callbacks

  def on_node_status(self, request_id: str, opaque_status: str) -> None:
    try:
      data = json.loads(opaque_status)
      kind = data.get("type", "")
      if kind == "node_status":
        if data.get("status", "").startswith("start_"):
          self.topology.active_node_id = data.get("node_id")
        elif data.get("status", "").startswith("end_") and data.get("node_id") == self.topology.active_node_id:
          self.topology.active_node_id = None
      elif kind == "supported_inference_engines":
        self.topology_inference_engines_pool.append(data.get("engines", []))
      elif kind == "download_progress":
        self.node_download_progress[data.get("node_id")] = data.get("progress")
      elif kind == "cancel_request" and data.get("request_id"):
        # A peer's client left: stop this node's share at the next boundary.
        self._cancel_locally(data["request_id"])
    except Exception:  # noqa: BLE001
      if DEBUG >= 1:
        traceback.print_exc()

  def trigger_on_token_callbacks(self, request_id: str, tokens: list[int], is_finished: bool, start_pos: int | None = None) -> None:
    """The one place tokens reach listeners. With ``start_pos`` (the
    absolute completion index of ``tokens[0]``) tokens below the request's
    high-water mark are dropped as replayed duplicates, and tokens ahead of
    it are held until the gap fills (or ``GAP_FLUSH_S`` passes), so a client
    sees the exact in-order stream. Without it tokens pass and advance the
    mark."""
    if start_pos is not None and (tokens or is_finished):
      emitted = self._emitted_counts.get(request_id, 0)
      if start_pos > emitted:
        held = self._pending_chunks.setdefault(request_id, {})
        cur = held.get(start_pos)
        if cur is None or len(tokens) > len(cur[0]):
          held[start_pos] = (list(tokens), is_finished or (cur[1] if cur else False))
        elif is_finished and not cur[1]:
          held[start_pos] = (cur[0], True)
        self._arm_gap_flush(request_id)
        return
      skip = emitted - start_pos
      if skip > 0:
        tokens = tokens[skip:]
        if not tokens and not is_finished:
          return
        start_pos = emitted
      self._emitted_counts[request_id] = max(emitted, start_pos + len(tokens))
    elif tokens:
      self._emitted_counts[request_id] = self._emitted_counts.get(request_id, 0) + len(tokens)
    self.on_token.trigger_all(request_id, tokens, is_finished)
    if is_finished:
      # The mark stays as a tombstone against straggling broadcasts until
      # the response-timeout horizon.
      self._pending_chunks.pop(request_id, None)
      self._disarm_gap_flush(request_id)
      self._expire_dedup_state(request_id)
      return
    pend = self._pending_chunks.get(request_id)
    if pend:
      emitted = self._emitted_counts.get(request_id, 0)
      for sp in sorted(pend):
        if sp <= emitted:
          held_tokens, held_fin = pend.pop(sp)
          if not pend:
            self._pending_chunks.pop(request_id, None)
          self.trigger_on_token_callbacks(request_id, held_tokens, held_fin, start_pos=sp)
          break
    if request_id not in self._pending_chunks:
      self._disarm_gap_flush(request_id)
    elif start_pos is not None and tokens:
      # Progress, but a later hole still blocks: give it a full window.
      self._disarm_gap_flush(request_id)
      self._arm_gap_flush(request_id)

  def _expire_dedup_state(self, request_id: str) -> None:
    def clear() -> None:
      self._emitted_counts.pop(request_id, None)
      self._pending_chunks.pop(request_id, None)

    try:
      asyncio.get_running_loop().call_later(RESPONSE_TIMEOUT_HORIZON_S, clear)
    except RuntimeError:  # no loop (a synchronous caller)
      pass

  def _arm_gap_flush(self, request_id: str) -> None:
    if request_id in self._gap_flush_timers:
      return

    def flush() -> None:
      self._gap_flush_timers.pop(request_id, None)
      pend = self._pending_chunks.pop(request_id, None)
      for sp in sorted(pend or ()):
        held_tokens, held_fin = pend[sp]
        self._emitted_counts[request_id] = max(self._emitted_counts.get(request_id, 0), sp)  # over the hole
        self.trigger_on_token_callbacks(request_id, held_tokens, held_fin, start_pos=sp)

    try:
      self._gap_flush_timers[request_id] = asyncio.get_running_loop().call_later(GAP_FLUSH_S, flush)
    except RuntimeError:
      pass

  def _disarm_gap_flush(self, request_id: str) -> None:
    handle = self._gap_flush_timers.pop(request_id, None)
    if handle is not None:
      handle.cancel()

  def handle_remote_result(self, request_id: str, result, is_finished: bool, start_pos: int | None = None) -> None:
    """A peer's SendResult: token lists through the dedup; a finished
    request also releases this node's share of it (its engine session; the
    reference keeps a head's and a middle's sessions until a replay)."""
    if isinstance(result, list):
      self.trigger_on_token_callbacks(request_id, result, is_finished, start_pos=start_pos)
    else:
      self.on_token.trigger_all(request_id, result, is_finished)
    if is_finished and request_id not in self.buffered_token_output:
      self.outstanding_requests.pop(request_id, None)
      self.inference_engine.end_request(request_id)

  async def broadcast_result(self, request_id: str, result: list[int], is_finished: bool, start_pos: int | None = None) -> None:
    async def send(peer):
      try:
        await asyncio.wait_for(peer.send_result(request_id, result, is_finished, start_pos=start_pos), timeout=15.0)
      except Exception:  # noqa: BLE001 — the gap flush covers a lost broadcast
        if DEBUG >= 1:
          print(f"[node {self.id}] result broadcast to {peer.id()} failed")

    await asyncio.gather(*(send(p) for p in self.peers), return_exceptions=True)

  async def broadcast_opaque_status(self, request_id: str, status: str) -> None:
    async def send(peer):
      try:
        await asyncio.wait_for(peer.send_opaque_status(request_id, status), timeout=15.0)
      except Exception:  # noqa: BLE001
        if DEBUG >= 1:
          print(f"[node {self.id}] status broadcast to {peer.id()} failed")

    await asyncio.gather(*(send(p) for p in self.peers), return_exceptions=True)
    self.on_opaque_status.trigger_all(request_id, status)  # the reference triggers its own handlers last
