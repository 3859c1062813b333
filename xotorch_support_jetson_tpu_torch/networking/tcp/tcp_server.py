"""The node's peer server over asyncio TCP streams (counterpart of the
reference's ``networking/grpc/grpc_server.py``).

One connection carries many calls at once: every request frame names a
call id, runs in a task of its own, and its answer frame carries the same
id back (a ring's calls nest, each hop's handler awaiting the downstream
hops). Methods, as the reference's RPC set:

- ``SendPrompt`` / ``SendTensor`` → ``node.process_prompt`` /
  ``process_tensor`` with the sender's concrete shard
  (``wire_concrete=True``), answered once the node returns (the awaited
  downstream generation); the answer carries no tensor (the reference
  sends the node's return value back, which its callers drop);
- ``SendResult`` → ``node.handle_remote_result`` (the high-water dedup);
- ``SendOpaqueStatus`` → the node's opaque-status callbacks (the
  reference's cluster pulls answer "not ported");
- ``CollectTopology`` → the node's current merged view, not a fresh
  collection;
- ``HealthCheck`` → healthy;
- ``SendExample``, ``SendLoss`` and ``SendKvPages`` answer "not ported"
  (training and disaggregation wait for their slices).

A handler that raises answers an application error: the peer is alive,
so the caller's circuit breaker is not charged. A connection that drops
cancels its calls' handlers, as a gRPC server cancels a broken call.
Per method the registry counts ``peer_rpcs_total{method}``,
``peer_rpc_handler_failures_total{method}`` and
``peer_rpc_handler_seconds{method}``.
"""

from __future__ import annotations

import asyncio
import time

from ...utils.helpers import DEBUG
from ...utils.metrics import metrics
from ..server import Server
from .serialization import WireError, encode_frame, read_frame, shard_from_dict, state_from, topology_to_dict

NOT_PORTED = {
  "SendExample": "the training ring is not ported to the PyTorch package yet",
  "SendLoss": "the training ring is not ported to the PyTorch package yet",
  "SendKvPages": "disaggregated prefill/decode (the KV-page stream) is not ported to the PyTorch package yet",
}
STREAM_LIMIT = 64 * 1024 * 1024  # asyncio's line limit; frames are read by length


class TCPServer(Server):
  def __init__(self, node, host: str, port: int) -> None:
    self.node = node
    self.host = host
    self.port = port
    self.server: asyncio.AbstractServer | None = None
    self._conns: set[asyncio.Task] = set()

  async def start(self) -> None:
    self.server = await asyncio.start_server(self._serve, self.host, self.port, limit=STREAM_LIMIT)
    if DEBUG >= 1:
      print(f"[tcp] peer server on {self.host}:{self.port}")

  async def stop(self) -> None:
    if self.server is not None:
      self.server.close()
      for task in list(self._conns):
        task.cancel()
      await asyncio.gather(*self._conns, return_exceptions=True)
      await self.server.wait_closed()
      self.server = None

  async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    me = asyncio.current_task()
    self._conns.add(me)
    lock = asyncio.Lock()
    calls: set[asyncio.Task] = set()
    try:
      while True:
        try:
          header, tensors = await read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
          break
        except WireError as e:  # a corrupt frame: the stream cannot be resynchronised
          if DEBUG >= 1:
            print(f"[tcp] dropping a connection: {e}")
          break
        task = asyncio.create_task(self._call(header, tensors, writer, lock))
        calls.add(task)
        task.add_done_callback(calls.discard)
    finally:
      for task in list(calls):
        task.cancel()
      await asyncio.gather(*calls, return_exceptions=True)
      writer.close()
      self._conns.discard(me)

  async def _call(self, header: dict, tensors: dict, writer: asyncio.StreamWriter, lock: asyncio.Lock) -> None:
    method, call_id = str(header.get("method", "")), header.get("id")
    metrics.inc("peer_rpcs_total", labels={"method": method})
    t0 = time.perf_counter()
    try:
      handler = getattr(self, f"_{method}", None) if method.isidentifier() and method[:1].isupper() else None
      if method in NOT_PORTED:
        reply, out = {"error": f"{method}: {NOT_PORTED[method]}"}, None
      elif handler is None:
        reply, out = {"error": f"unknown method {method!r}"}, None
      else:
        reply, out = await handler(header, tensors)
    except asyncio.CancelledError:
      raise
    except Exception as e:  # noqa: BLE001 — the caller gets the error; the server lives on
      metrics.inc("peer_rpc_handler_failures_total", labels={"method": method})
      if DEBUG >= 1:
        import traceback

        traceback.print_exc()
      reply, out = {"error": f"{type(e).__name__}: {e}"}, None
    finally:
      metrics.observe_hist("peer_rpc_handler_seconds", time.perf_counter() - t0, labels={"method": method})
    frame = encode_frame({"id": call_id, **reply}, out)
    async with lock:
      writer.write(frame)
      await writer.drain()

  # ------------------------------------------------------------ methods

  async def _SendPrompt(self, h: dict, t: dict):
    state = state_from(h.get("state"), t.get("state_tokens"))
    await self.node.process_prompt(shard_from_dict(h["shard"]), str(h["prompt"]), str(h["request_id"]), state, wire_concrete=True)
    return {}, None

  async def _SendTensor(self, h: dict, t: dict):
    state = state_from(h.get("state"), t.get("state_tokens"))
    await self.node.process_tensor(shard_from_dict(h["shard"]), t["tensor"], str(h["request_id"]), state, wire_concrete=True)
    return {}, None

  async def _SendResult(self, h: dict, t: dict):
    result = t["tensor"] if "tensor" in t else [int(x) for x in h.get("result", [])]
    start_pos = h.get("start_pos")
    self.node.handle_remote_result(str(h["request_id"]), result, bool(h.get("is_finished")), start_pos=None if start_pos is None else int(start_pos))
    return {}, None

  async def _SendOpaqueStatus(self, h: dict, t: dict):
    from ...orchestration.node import check_opaque_status

    check_opaque_status(str(h["status"]))  # the cluster pulls answer "not ported"
    self.node.on_opaque_status.trigger_all(str(h.get("request_id", "")), str(h["status"]))
    return {}, None

  async def _CollectTopology(self, h: dict, t: dict):
    # The current merged view: a collection here would rebuild this node's
    # view from static capabilities on every peer's poll.
    return {"topology": topology_to_dict(self.node.current_topology)}, None

  async def _HealthCheck(self, h: dict, t: dict):
    return {"is_healthy": True}, None
