"""Client side of a peer over asyncio TCP streams (counterpart of the
reference's ``networking/grpc/grpc_peer_handle.py``).

One connection per peer, opened lazily (``CONNECT_TIMEOUT``), carries
every call at once: each request frame takes a fresh call id and a future
that the connection's reader task settles when the answer with that id
arrives. A dropped connection fails every pending call with
``ConnectionError`` and the next call reconnects. Execution goes through
the retry policy (networking/retry.py): the circuit breaker's gate, the
per-method timeout, and bounded retries with backoff for the idempotent
methods. A remote handler's error (``PeerRemoteError``) means the peer
answered, so it is not charged to the breaker; a transport failure is.
``health_check`` is the probe that closes a breaker and feeds the flap
damping. Per peer and method the registry counts ``peer_rpc_seconds``,
``peer_rpc_bytes_sent_total`` / ``_received_total`` and
``peer_rpc_failures_total``.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import time

from ...inference.shard import Shard
from ...inference.state import InferenceState
from ...topology.device_capabilities import DeviceCapabilities
from ...topology.topology import Topology
from ...utils.metrics import metrics
from ..peer_handle import PeerHandle
from ..retry import PeerCircuitOpenError, backoff_s, breakers, peer_health, retry_budget, rpc_retries, rpc_timeout
from .serialization import PREFIX_BYTES, decode_frame, encode_frame, frame_lengths, state_fields, topology_from_dict
from .tcp_server import STREAM_LIMIT

# Defaults for the connect and health-check timeouts, monkeypatchable; an
# XOT_TPU_RPC_TIMEOUT_* knob read at call time wins over them.
CONNECT_TIMEOUT = 10.0
HEALTH_TIMEOUT = 5.0


def _env_timeout(method: str, fallback: float | None) -> float | None:
  if os.getenv(f"XOT_TPU_RPC_TIMEOUT_{method.upper()}_S") is not None or os.getenv("XOT_TPU_RPC_TIMEOUT_S") is not None:
    return rpc_timeout(method)
  return fallback


class PeerRemoteError(RuntimeError):
  """The peer answered the call with an error (its handler raised, or the
  method is not ported there)."""


class TCPPeerHandle(PeerHandle):
  def __init__(self, _id: str, address: str, desc: str, device_capabilities: DeviceCapabilities) -> None:
    self._id = _id
    self.address = address
    self.desc = desc
    self._device_capabilities = device_capabilities
    self._reader: asyncio.StreamReader | None = None
    self._writer: asyncio.StreamWriter | None = None
    self._read_task: asyncio.Task | None = None
    self._pending: dict[int, asyncio.Future] = {}
    self._ids = itertools.count(1)
    self._write_lock = asyncio.Lock()
    self._connect_lock = asyncio.Lock()

  def id(self) -> str:
    return self._id

  def addr(self) -> str:
    return self.address

  def description(self) -> str:
    return self.desc

  def device_capabilities(self) -> DeviceCapabilities:
    return self._device_capabilities

  # ------------------------------------------------------------ connection

  async def connect(self) -> None:
    async with self._connect_lock:
      if await self.is_connected():
        return
      host, _, port = self.address.rpartition(":")
      self._reader, self._writer = await asyncio.wait_for(asyncio.open_connection(host, int(port), limit=STREAM_LIMIT), timeout=_env_timeout("Connect", CONNECT_TIMEOUT))
      self._read_task = asyncio.create_task(self._read_loop(self._reader))

  async def is_connected(self) -> bool:
    return self._writer is not None and not self._writer.is_closing() and self._read_task is not None and not self._read_task.done()

  async def disconnect(self) -> None:
    writer, task = self._writer, self._read_task
    self._writer = self._reader = self._read_task = None
    if task is not None:
      task.cancel()
      await asyncio.gather(task, return_exceptions=True)
    if writer is not None:
      writer.close()
    self._fail_pending(ConnectionError(f"disconnected from peer {self._id}"))

  def _fail_pending(self, exc: Exception) -> None:
    pending, self._pending = self._pending, {}
    for fut in pending.values():
      if not fut.done():
        fut.set_exception(exc)

  async def _read_loop(self, reader: asyncio.StreamReader) -> None:
    try:
      while True:
        head_n, payload_n = frame_lengths(await reader.readexactly(PREFIX_BYTES))
        head = await reader.readexactly(head_n)
        payload = await reader.readexactly(payload_n) if payload_n else b""
        header, tensors = decode_frame(head, payload)
        fut = self._pending.pop(header.get("id"), None)
        if fut is not None and not fut.done():
          fut.set_result((header, tensors, PREFIX_BYTES + head_n + payload_n))
    except asyncio.CancelledError:
      raise
    except Exception as e:  # noqa: BLE001 — EOF, reset or a corrupt frame: the connection is gone
      if self._reader is reader:
        self._writer = None
      self._fail_pending(ConnectionError(f"connection to peer {self._id} ({self.address}) lost: {e!r}"))

  def _breaker(self):
    return breakers.get(self._id, self.address)

  async def _ensure_connected(self, probe: bool = False) -> None:
    if not probe and not self._breaker().allow():
      raise PeerCircuitOpenError(f"circuit open for peer {self._id} ({self.address})")
    if not await self.is_connected():
      try:
        await self.connect()
      except (asyncio.TimeoutError, OSError) as e:
        if not probe:  # the probe records its own outcome
          self._breaker().record_failure()
        raise ConnectionError(f"connect to {self.address} failed: {e!r}") from None

  async def _roundtrip(self, frame_header: dict, tensors: dict | None, timeout: float | None):
    """Send one call and await its answer: (header, tensors, bytes in)."""
    call_id = next(self._ids)
    frame = encode_frame({"id": call_id, **frame_header}, tensors)
    fut = asyncio.get_running_loop().create_future()
    self._pending[call_id] = fut
    try:
      async with self._write_lock:
        writer = self._writer
        if writer is None:
          raise ConnectionError(f"not connected to peer {self._id}")
        writer.write(frame)
        await writer.drain()
      header, out, n_in = await (asyncio.wait_for(fut, timeout) if timeout is not None else fut)
    finally:
      self._pending.pop(call_id, None)
    if "error" in header:
      raise PeerRemoteError(f"peer {self._id}: {header['error']}")
    return header, out, len(frame), n_in

  async def health_check(self) -> bool:
    ok = cancelled = False
    try:
      await self._ensure_connected(probe=True)
      header, _, _, _ = await self._roundtrip({"method": "HealthCheck"}, None, _env_timeout("HealthCheck", HEALTH_TIMEOUT))
      ok = bool(header.get("is_healthy"))
      return ok
    except asyncio.CancelledError:
      cancelled = True  # the caller's teardown says nothing about the peer
      raise
    except Exception:  # noqa: BLE001 — any failure reads as unhealthy
      return False
    finally:
      if not cancelled:
        peer_health.record(self._id, ok)
        if ok:
          self._breaker().record_success()
        else:
          self._breaker().record_failure()

  async def _invoke(self, method: str, header: dict, tensors: dict | None = None, request_id: str = ""):
    """One call of ``method`` under the retry policy; returns (header,
    tensors) of the answer."""
    breaker = self._breaker()
    labels = {"peer": self._id, "method": method}
    attempt = 0
    while True:
      await self._ensure_connected()
      t0 = time.perf_counter()
      try:
        out_header, out, n_out, n_in = await self._roundtrip({"method": method, **header}, tensors, rpc_timeout(method))
      except asyncio.CancelledError:
        raise  # the caller's teardown is not a peer failure
      except Exception as e:
        metrics.inc("peer_rpc_failures_total", labels=labels)
        if not isinstance(e, PeerRemoteError):
          breaker.record_failure()
          if isinstance(e, asyncio.TimeoutError):
            await self.disconnect()  # the answer may still come: drop the connection with it
        if attempt >= rpc_retries(method) or not retry_budget.take(request_id):
          raise
        attempt += 1
        metrics.inc("rpc_retries_total", labels={"method": method})
        await asyncio.sleep(backoff_s(attempt))
        if not breaker.allow():
          raise PeerCircuitOpenError(f"circuit open for peer {self._id} ({self.address})") from None
        continue
      finally:
        metrics.observe_hist("peer_rpc_seconds", time.perf_counter() - t0, labels=labels)
      breaker.record_success()
      metrics.inc("peer_rpc_bytes_sent_total", n_out, labels=labels)
      metrics.inc("peer_rpc_bytes_received_total", n_in, labels=labels)
      return out_header, out

  # ------------------------------------------------------------ calls

  async def send_prompt(self, shard: Shard, prompt: str, request_id: str, inference_state: InferenceState | None = None) -> None:
    fields, tokens = state_fields(inference_state)
    await self._invoke("SendPrompt", {"shard": shard.to_dict(), "prompt": prompt, "request_id": request_id, "state": fields}, {"state_tokens": tokens}, request_id)

  async def send_tensor(self, shard: Shard, tensor, request_id: str, inference_state: InferenceState | None = None) -> None:
    fields, tokens = state_fields(inference_state)
    await self._invoke("SendTensor", {"shard": shard.to_dict(), "request_id": request_id, "state": fields}, {"tensor": tensor, "state_tokens": tokens}, request_id)

  async def send_result(self, request_id: str, result, is_finished: bool, start_pos: int | None = None) -> None:
    header = {"request_id": request_id, "is_finished": bool(is_finished), "start_pos": None if start_pos is None else int(start_pos)}
    if isinstance(result, list):
      await self._invoke("SendResult", {**header, "result": [int(r) for r in result]}, None, request_id)
    else:
      await self._invoke("SendResult", header, {"tensor": result}, request_id)

  async def send_opaque_status(self, request_id: str, status: str) -> None:
    await self._invoke("SendOpaqueStatus", {"request_id": request_id, "status": status}, None, request_id)

  async def collect_topology(self, visited: set[str], max_depth: int) -> Topology:
    header, _ = await self._invoke("CollectTopology", {"visited": sorted(visited), "max_depth": int(max_depth)})
    return topology_from_dict(header["topology"])
