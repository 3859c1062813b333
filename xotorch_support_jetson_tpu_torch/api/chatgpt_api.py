"""OpenAI-compatible HTTP API: ``/healthcheck``, ``/v1/models``,
``/v1/chat/completions`` (blocking, and SSE with ``"stream": true``),
``/metrics`` (Prometheus text), ``/v1/slo`` (the local SLO report),
``/v1/kv/tier`` (the host KV tier's state), ``/v1/programs`` (the device
program ledger) and ``POST /v1/warmup`` (build the expected programs before
traffic).

Counterpart of those routes of the reference's ``api/chatgpt_api.py``, with
the same request and response shapes: a chat request may carry a QoS
identity (``priority``/``deadline_ms``/``tenant`` body fields or
``x-priority``/``x-deadline-ms``/``x-tenant-id`` headers; a bad value is a
400), and an overload refusal is a structured 429 with ``Retry-After``.
The server is a small HTTP/1.1 server on ``asyncio`` streams from the
standard library (one request per connection, ``Connection: close``), so
the serving path depends on no web framework.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import math
import os
import time
import uuid
from pathlib import Path
from urllib.parse import parse_qs

from .. import registry
from ..inference.engine import PromptTooLongError, ServerOverloadedError
from ..inference.qos import PRIORITY_CLASSES
from ..orchestration import slo
from ..utils.helpers import DEBUG
from ..utils.metrics import metrics

_REASONS = {200: "OK", 204: "No Content", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout", 413: "Payload Too Large", 429: "Too Many Requests", 500: "Internal Server Error"}
MAX_BODY_BYTES = 16 << 20


class Message:
  def __init__(self, role: str, content, tools=None):
    self.role = role
    self.content = content
    self.tools = tools  # per-message tool definitions, rendered by the chat template

  def to_dict(self) -> dict:
    data = {"role": self.role, "content": _flatten(self.content)}
    if self.tools:
      data["tools"] = self.tools
    return data


class ChatCompletionRequest:
  def __init__(self, model: str, messages: list[Message], temperature: float | None = None, max_tokens=None, stream=False, stop=(), tools=None):
    self.model = model
    self.messages = messages
    self.temperature = temperature
    self.max_tokens = max_tokens
    self.stream = stream
    self.stop = tuple(stop)
    self.tools = tools  # request-level tool definitions (the chat template's ``tools``)


def find_stop(text: str, stops: tuple) -> tuple[int | None, int]:
  """(cut, safe_len): the earliest stop-string index (None if absent) and how
  much of ``text`` can be emitted without risking a stop string completed
  across a later chunk boundary."""
  cut = None
  for s in stops:
    i = text.find(s)
    if i != -1:
      cut = i if cut is None else min(cut, i)
  if cut is not None:
    return cut, cut
  hold = 0
  for s in stops:
    for n in range(min(len(s) - 1, len(text)), 0, -1):
      if text.endswith(s[:n]):
        hold = max(hold, n)
        break
  return None, len(text) - hold


def _flatten(content) -> str:
  """Multimodal content blocks → their text parts (images are dropped: the
  port serves text-only models)."""
  if isinstance(content, list):
    return " ".join(part.get("text", "") for part in content if isinstance(part, dict) and part.get("type") == "text")
  return content


def build_prompt(tokenizer, messages: list[Message], tools=None) -> str:
  """The chat template over ``messages`` (with their own ``tools``) and the
  request's ``tools``, as the reference renders them."""
  kwargs = {"tools": tools} if tools else {}
  return tokenizer.apply_chat_template([m.to_dict() for m in messages], tokenize=False, add_generation_prompt=True, **kwargs)


def parse_chat_request(data: dict, default_model: str) -> ChatCompletionRequest:
  if not isinstance(data, dict) or not data.get("messages"):
    raise ValueError("'messages' must be a non-empty list")
  messages = []
  for m in data["messages"]:
    if not isinstance(m, dict) or "role" not in m or "content" not in m:
      raise ValueError(f"Invalid message: {m}. Must have 'role' and 'content'")
    messages.append(Message(m["role"], m["content"], m.get("tools")))
  max_tokens = data.get("max_tokens")
  if max_tokens is not None and (not isinstance(max_tokens, int) or isinstance(max_tokens, bool) or max_tokens < 1):
    raise ValueError("'max_tokens' must be a positive integer")
  temperature = data.get("temperature")
  if temperature is not None and (not isinstance(temperature, (int, float)) or isinstance(temperature, bool) or not 0 <= temperature <= 2):
    raise ValueError("'temperature' must be a number in [0, 2]")
  stop = data.get("stop")
  if stop is None:
    stop = ()
  elif isinstance(stop, str):
    stop = (stop,)
  elif isinstance(stop, list) and all(isinstance(s, str) and s for s in stop) and len(stop) <= 4:
    stop = tuple(stop)
  else:
    raise ValueError("'stop' must be a non-empty string or a list of up to 4 non-empty strings")
  if data.get("logprobs"):
    raise ValueError("'logprobs' is not supported by the PyTorch port yet")
  model = data.get("model", default_model)
  if not model or model.startswith("gpt-") or model not in registry.model_cards:  # alias client defaults
    model = default_model
  return ChatCompletionRequest(model, messages, temperature, max_tokens, bool(data.get("stream", False)), stop, data.get("tools"))


def parse_qos_fields(data: dict, headers) -> tuple[str | None, str | None, float | None]:
  """(priority, tenant, deadline_ms) from the body fields ``priority``,
  ``deadline_ms`` and ``tenant``, or the headers ``x-priority``,
  ``x-deadline-ms`` and ``x-tenant-id`` (lower-case keys). A client that
  sets neither gets all-None (the node's defaults apply). The tenant falls
  back to a hash of the Authorization header (per-API-key buckets, the key
  itself never kept). Raises ``ValueError`` on a malformed value: a typo is
  a 400, not a silently dropped QoS hint.

  Trust: the API authenticates nobody, so every tenant key is
  client-asserted; per-tenant limits mean something only behind a gateway
  that pins ``x-tenant-id``. Tenant state is LRU-bounded (inference/qos.py
  ``MAX_TENANTS``)."""
  priority = data.get("priority")
  if priority is None:
    priority = headers.get("x-priority")
  if priority is not None:
    priority = str(priority).lower()
    if priority not in PRIORITY_CLASSES:
      raise ValueError(f"'priority' must be one of {list(PRIORITY_CLASSES)}")
  deadline = data.get("deadline_ms")
  if deadline is None:
    deadline = headers.get("x-deadline-ms")
  if deadline is not None:
    if isinstance(deadline, bool):
      raise ValueError("'deadline_ms' must be a positive number")
    try:
      deadline = float(deadline)
    except (TypeError, ValueError):
      raise ValueError("'deadline_ms' must be a positive number") from None
    if not deadline > 0:
      raise ValueError("'deadline_ms' must be a positive number")
  tenant = data.get("tenant")
  if tenant is None:
    tenant = headers.get("x-tenant-id")
  if tenant is None:
    auth = headers.get("authorization")
    if auth:
      tenant = "key-" + hashlib.sha256(auth.encode()).hexdigest()[:12]
  if tenant is not None:
    tenant = str(tenant)[:64] or None
  return priority, tenant, deadline


def completion_chunk(request_id: str, model: str, created: int, content: str | None, finish_reason: str | None) -> dict:
  delta = {} if content is None else {"role": "assistant", "content": content}
  return {
    "id": f"chatcmpl-{request_id}",
    "object": "chat.completion.chunk",
    "created": created,
    "model": model,
    "system_fingerprint": "xot_tpu_0.1.0",
    "choices": [{"index": 0, "delta": delta, "logprobs": None, "finish_reason": finish_reason}],
  }


class _Request:
  def __init__(self, method: str, path: str, headers: dict, body: bytes, query: dict | None = None) -> None:
    self.method, self.path, self.headers, self.body = method, path, headers, body
    self.query = query or {}  # the query string's parameters, last value of each


class _Response:
  """A complete (non-streaming) HTTP response: a JSON body, or ``text`` with
  its content type."""

  def __init__(self, body: dict | None, status: int = 200, headers: dict | None = None, text: str | None = None, content_type: str = "application/json") -> None:
    self.body, self.status, self.headers, self.text, self.content_type = body, status, headers or {}, text, content_type


def json_response(body: dict, status: int = 200, headers: dict | None = None) -> _Response:
  return _Response(body, status, headers)


def overloaded_response(e: Exception) -> _Response:
  """ServerOverloadedError (and its QoS subclasses) → a structured 429:
  ``{"error": {"type", "message", "retry_after_ms"}}`` plus a standard
  ``Retry-After`` header (whole seconds, at least 1) when the refusal
  carries a backoff hint."""
  retry_ms = getattr(e, "retry_after_ms", None)
  body = {"error": {"message": str(e), "type": getattr(e, "error_type", "overloaded")}}
  headers = {}
  if retry_ms is not None:
    body["error"]["retry_after_ms"] = round(float(retry_ms), 1)
    headers["Retry-After"] = str(max(1, math.ceil(float(retry_ms) / 1e3)))
  return json_response(body, 429, headers)


async def _read_request(reader: asyncio.StreamReader) -> _Request | None:
  head = await reader.readuntil(b"\r\n\r\n")
  lines = head.decode("latin-1").split("\r\n")
  parts = lines[0].split(" ")
  if len(parts) < 2:
    return None
  headers = {}
  for line in lines[1:]:
    if ":" in line:
      k, v = line.split(":", 1)
      headers[k.strip().lower()] = v.strip()
  n = int(headers.get("content-length", "0") or 0)
  if n > MAX_BODY_BYTES:
    raise ValueError("request body too large")
  body = await reader.readexactly(n) if n else b""
  path, _, qs = parts[1].partition("?")
  return _Request(parts[0].upper(), path, headers, body, {k: v[-1] for k, v in parse_qs(qs).items()})


async def _write_head(writer: asyncio.StreamWriter, status: int, headers: dict) -> None:
  lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}"] + [f"{k}: {v}" for k, v in headers.items()]
  writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
  await writer.drain()


_CORS = {"Access-Control-Allow-Origin": "*", "Access-Control-Allow-Methods": "GET, POST, OPTIONS", "Access-Control-Allow-Headers": "*"}


async def _send_json(writer: asyncio.StreamWriter, resp: _Response) -> None:
  data = (resp.text if resp.text is not None else json.dumps(resp.body)).encode()
  await _write_head(writer, resp.status, {"Content-Type": resp.content_type, "Content-Length": str(len(data)), "Connection": "close", **resp.headers, **_CORS})
  writer.write(data)
  await writer.drain()


class _SSEStream:
  """A committed ``text/event-stream`` response."""

  def __init__(self, writer: asyncio.StreamWriter) -> None:
    self.writer = writer

  async def prepare(self) -> None:
    await _write_head(self.writer, 200, {"Content-Type": "text/event-stream", "Cache-Control": "no-cache", "Connection": "close", **_CORS})

  async def write(self, data: bytes) -> None:
    self.writer.write(data)
    await self.writer.drain()


class ChatGPTAPI:
  def __init__(self, node, inference_engine_classname: str, response_timeout: float | None = None, default_model: str | None = None, system_prompt: str | None = None):
    self.node = node
    self.inference_engine_classname = inference_engine_classname
    if response_timeout is None:
      try:
        response_timeout = float(os.getenv("XOT_TPU_RESPONSE_TIMEOUT_S", "900") or 900)
      except ValueError:
        response_timeout = 900.0
    self.response_timeout = response_timeout if response_timeout > 0 else 900.0
    self.default_model = default_model or "llama-3.2-1b"
    self.system_prompt = system_prompt
    self.token_queues: dict[str, asyncio.Queue] = {}
    self.node.on_token.register("chatgpt-api-token-handler").on_next(self.handle_tokens)
    self.routes = {
      ("GET", "/healthcheck"): self.handle_healthcheck,
      ("GET", "/v1/models"): self.handle_get_models,
      ("GET", "/models"): self.handle_get_models,
      ("POST", "/v1/chat/completions"): self.handle_post_chat_completions,
      ("POST", "/chat/completions"): self.handle_post_chat_completions,
      ("GET", "/metrics"): self.handle_metrics,
      ("GET", "/v1/slo"): self.handle_slo,
      ("GET", "/v1/kv/tier"): self.handle_kv_tier,
      ("GET", "/v1/programs"): self.handle_programs,
      ("POST", "/v1/warmup"): self.handle_warmup,
    }

  # ------------------------------------------------------------- server

  async def run(self, host: str = "0.0.0.0", port: int = 52415) -> asyncio.AbstractServer:
    """Start serving; returns the server (``close()`` + ``wait_closed()`` stop it)."""
    return await asyncio.start_server(self._serve_connection, host, port)

  async def _serve_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    try:
      try:
        request = await _read_request(reader)
      except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ValueError, UnicodeDecodeError):
        request = None
      if request is None:
        await _send_json(writer, json_response({"error": "malformed request"}, 400))
        return
      if request.method == "OPTIONS":
        await _write_head(writer, 204, {"Content-Length": "0", "Connection": "close", **_CORS})
        return
      handler = self.routes.get((request.method, request.path))
      if handler is None:
        known = any(path == request.path for _, path in self.routes)
        await _send_json(writer, json_response({"error": "method not allowed" if known else "not found"}, 405 if known else 404))
        return
      resp = await handler(request, writer)
      if resp is not None:
        await _send_json(writer, resp)
    except (ConnectionResetError, BrokenPipeError):
      pass
    finally:
      writer.close()

  # ------------------------------------------------------------- routes

  async def handle_healthcheck(self, request, writer):
    return json_response({"status": "ok"})

  async def handle_get_models(self, request, writer):
    local = os.getenv("XOT_TPU_MODEL_DIR")
    downloaded = bool(local) and any(Path(local).glob("*.safetensors"))
    models = [
      {"id": model_id, "object": "model", "owned_by": "xot_tpu", "ready": True, "name": card.pretty, "downloaded": downloaded}
      for model_id, card in registry.model_cards.items()
      if card.repo_for(self.inference_engine_classname)
    ]
    return json_response({"object": "list", "data": models})

  async def handle_metrics(self, request, writer):
    """GET /metrics — the registry in Prometheus text format (local scope)."""
    return _Response(None, text=metrics.render_prometheus(), content_type="text/plain; version=0.0.4")

  async def handle_slo(self, request, writer):
    """GET /v1/slo — the SLO engine's local report: per-class objectives,
    burn rates over each window, availability and goodput, each rate with
    its raw counts. ``{"enabled": false}`` when ``XOT_TPU_SLO=0``."""
    if not slo.slo_enabled():
      return json_response({"enabled": False, "detail": "SLO engine disabled (XOT_TPU_SLO=0)"})

    def local_report():
      slo.slo_engine.maybe_tick()
      return slo.slo_engine.report(node_id=getattr(self.node, "id", None))

    # The tick and the report copy the registry: off the event loop.
    return json_response(await asyncio.get_running_loop().run_in_executor(None, local_report))

  async def handle_kv_tier(self, request, writer):
    """GET /v1/kv/tier — the KV memory hierarchy's state, with the
    reference's keys: whether the tier is on, host occupancy and budget,
    spill and restore totals, and the prefix registry's view. The port has
    no ring yet, so ``?scope=cluster`` answers with this same local view,
    as the reference does on a node without peers."""
    from ..inference.kv_tier import kv_tier_enabled, prefix_registry

    tier = getattr(getattr(self.node.inference_engine, "_batched_server", None), "tier", None)
    return json_response({
      "enabled": kv_tier_enabled(),
      # No live batched server (or the tier off): the gauges' view.
      "host": tier.stats() if tier is not None else {"host_pages": metrics.gauges.get("kv_tier_host_pages", 0), "host_bytes": metrics.gauges.get("kv_tier_host_bytes", 0)},
      "spilled_pages_total": metrics.counter_value("kv_tier_spilled_pages_total"),
      "restored_pages_total": metrics.counter_value("kv_tier_restored_pages_total"),
      "prefix_registry": prefix_registry.snapshot(),
    })

  async def handle_programs(self, request, writer):
    """GET /v1/programs — the device-program ledger (utils/programs.py):
    per family the builds, dispatches, steady builds, their seconds and
    signatures, and the port's graph captures and replays; the warmup
    manifest and the steady flag. The port has no ring yet, so
    ``?scope=cluster`` answers as the reference does on a node without
    peers: this snapshot merged alone, with ``unreachable: []``."""
    from ..utils.programs import ProgramLedger, ledger

    local = ledger.snapshot()
    local["node_id"] = getattr(self.node, "id", None)
    if request.query.get("scope") != "cluster":
      return json_response(local)
    merged = ProgramLedger.merge_snapshots([local])
    merged["unreachable"] = []
    return json_response(merged)

  async def handle_warmup(self, request, writer):
    """POST /v1/warmup — build the expected program set off the serving
    path, as the reference does: when the engine supports batched serving
    (a full-model shard does, also on a solo daemon) the batched server
    drives its warmup manifest and marks the ledger steady, loading the
    default model first on a cold engine. Without a batched server the
    ledger is marked steady over an empty manifest."""
    from ..utils.programs import ledger

    engine = getattr(self.node, "inference_engine", None)
    server = None
    if engine is not None and getattr(engine, "supports_batched", None):
      try:
        if getattr(engine, "shard", None) is None and self.default_model:
          shard = registry.build_base_shard(self.default_model, self.inference_engine_classname)
          if shard is not None:
            await engine.ensure_shard(shard)
        if getattr(engine, "shard", None) is not None and engine.supports_batched():
          server = engine.get_batched_server()
      except Exception:  # noqa: BLE001 — a cold engine warms up empty
        if DEBUG >= 1:
          import traceback

          traceback.print_exc()
        server = None
    if server is None:
      ledger.mark_steady(manifest=[])
      return json_response({"manifest": [], "warmup_s": 0.0, "steady": True, "detail": "no batched scheduler; ledger marked steady over an empty manifest"})
    return json_response(await server.warmup())

  def handle_tokens(self, request_id: str, tokens: list[int], is_finished: bool) -> None:
    queue = self.token_queues.get(request_id)
    if queue is not None:
      if is_finished:
        # Availability's good event, once per client request, at the layer
        # every serving path streams through (refusals never finish here:
        # they are counted bad where they are refused).
        slo.note_good(self.node.request_options.get(request_id, {}).get("priority") or "standard")
      queue.put_nowait((list(tokens), is_finished))

  async def _tokenizer_for(self, shard):
    """The serving engine's tokenizer, loading the model if it is not yet."""
    engine = self.node.inference_engine
    await engine.ensure_shard(self.node.get_current_shard(shard))
    return engine.tokenizer

  async def _next_tokens(self, request_id: str, gen_task: asyncio.Task):
    """Next (tokens, finished) from the queue; a failed generation surfaces
    promptly instead of waiting out the response timeout."""
    queue = self.token_queues[request_id]
    deadline = asyncio.get_running_loop().time() + self.response_timeout
    while True:
      remaining = deadline - asyncio.get_running_loop().time()
      if remaining <= 0:
        raise asyncio.TimeoutError
      try:
        return await asyncio.wait_for(queue.get(), timeout=min(1.0, remaining))
      except asyncio.TimeoutError:
        if gen_task.done() and gen_task.exception() is not None:
          raise gen_task.exception()

  def _eos_set(self, tokenizer) -> set:
    eos = getattr(tokenizer, "eos_token_id", None)
    eos_set = {eos} if isinstance(eos, int) else set(eos or [])
    cfg = getattr(self.node.inference_engine, "cfg", None)
    return eos_set | set(cfg.eos_token_ids if cfg is not None else ())

  def _finish_reason(self, tokenizer, last_token: int) -> str:
    return "stop" if last_token in self._eos_set(tokenizer) else "length"

  async def handle_post_chat_completions(self, request, writer):
    try:
      data = json.loads(request.body or b"null")
    except (json.JSONDecodeError, UnicodeDecodeError):
      return json_response({"error": "invalid JSON body"}, 400)
    try:
      chat_request = parse_chat_request(data, self.default_model)
      priority, tenant, deadline_ms = parse_qos_fields(data, request.headers)
    except ValueError as e:
      return json_response({"error": str(e)}, 400)
    shard = registry.build_base_shard(chat_request.model, self.inference_engine_classname)
    if shard is None:
      return json_response({"detail": f"Unsupported model: {chat_request.model} with engine {self.inference_engine_classname}"}, 400)
    if self.system_prompt and not any(m.role == "system" for m in chat_request.messages):
      chat_request.messages.insert(0, Message("system", self.system_prompt))

    request_id = str(uuid.uuid4())
    self.token_queues[request_id] = asyncio.Queue()
    created = int(time.time())
    gen_task = None
    try:
      tokenizer = await self._tokenizer_for(shard)
      prompt = build_prompt(tokenizer, chat_request.messages, chat_request.tools)
      self.node.set_request_options(
        request_id, stream=chat_request.stream, max_tokens=chat_request.max_tokens, temperature=chat_request.temperature,
        priority=priority, tenant=tenant, deadline_ms=deadline_ms,
      )
      gen_task = asyncio.create_task(self.node.process_prompt(shard, prompt, request_id))
      if chat_request.stream:
        return await self._stream_response(writer, chat_request, request_id, tokenizer, created, gen_task)
      await asyncio.wait_for(asyncio.shield(gen_task), timeout=self.response_timeout)
      prompt_tokens = len(tokenizer.encode(prompt))
      return await self._blocking_response(chat_request, request_id, tokenizer, created, prompt_tokens, gen_task)
    except asyncio.TimeoutError:
      return json_response({"detail": "Response generation timed out"}, 408)
    except PromptTooLongError as e:
      return json_response({"error": {"message": str(e), "type": "invalid_request_error", "code": "context_length_exceeded"}}, 400)
    except ServerOverloadedError as e:
      # A full queue or page pool, a rate limit or a deadline shed: a
      # retryable 429, with Retry-After where the refusal has a backoff hint.
      return overloaded_response(e)
    except Exception as e:  # noqa: BLE001 — the API boundary reports every failure as a 500
      if DEBUG >= 1:
        import traceback

        traceback.print_exc()
      return json_response({"detail": f"Error processing prompt: {e}"}, 500)
    finally:
      if gen_task is not None and not gen_task.done():
        self.node.cancel_request(request_id)
        try:
          await asyncio.wait_for(asyncio.shield(gen_task), timeout=30)
        except Exception:  # noqa: BLE001 — already reported to the client
          pass
      self.token_queues.pop(request_id, None)
      self.node.request_options.pop(request_id, None)

  async def _blocking_response(self, chat_request, request_id, tokenizer, created, prompt_tokens, gen_task):
    all_tokens: list[int] = []
    while True:
      tokens, is_finished = await self._next_tokens(request_id, gen_task)
      all_tokens.extend(tokens)
      if is_finished:
        break
    eos_set = self._eos_set(tokenizer)
    content = tokenizer.decode([t for t in all_tokens if t not in eos_set])
    finish_reason = self._finish_reason(tokenizer, all_tokens[-1] if all_tokens else -1)
    if chat_request.stop:
      cut, _ = find_stop(content, chat_request.stop)
      if cut is not None:
        content, finish_reason = content[:cut], "stop"
    return json_response({
      "id": f"chatcmpl-{request_id}",
      "object": "chat.completion",
      "created": created,
      "model": chat_request.model,
      "system_fingerprint": "xot_tpu_0.1.0",
      "choices": [{"index": 0, "message": {"role": "assistant", "content": content}, "logprobs": None, "finish_reason": finish_reason}],
      "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": len(all_tokens), "total_tokens": prompt_tokens + len(all_tokens)},
    })

  async def _stream_response(self, writer, chat_request, request_id, tokenizer, created, gen_task):
    """SSE: incremental detokenization (decode the whole list, emit the new
    suffix), stop-string hold-back, finish_reason from the raw final batch.
    The first batch is fetched before the response is committed, so errors
    known at admission still get their HTTP status."""
    tokens, is_finished = await self._next_tokens(request_id, gen_task)
    stream = _SSEStream(writer)
    await stream.prepare()
    eos_set = self._eos_set(tokenizer)
    all_tokens: list[int] = []
    emitted_text = ""

    async def emit(chunk: dict) -> None:
      await stream.write(f"data: {json.dumps(chunk)}\n\n".encode())

    try:
      while True:
        all_tokens.extend(t for t in tokens if t not in eos_set)
        full_text = tokenizer.decode(all_tokens) if all_tokens else ""
        cut, safe_len = None, len(full_text)
        if chat_request.stop:
          cut, safe_len = find_stop(full_text, chat_request.stop)
          if cut is not None:
            full_text = full_text[:cut]
          elif is_finished:
            safe_len = len(full_text)
        delta = full_text[len(emitted_text):safe_len]
        if delta:
          emitted_text = full_text[:safe_len]
          await emit(completion_chunk(request_id, chat_request.model, created, delta, None))
        if cut is not None:
          await emit(completion_chunk(request_id, chat_request.model, created, None, "stop"))
          break
        if is_finished:
          await emit(completion_chunk(request_id, chat_request.model, created, None, self._finish_reason(tokenizer, tokens[-1] if tokens else -1)))
          break
        tokens, is_finished = await self._next_tokens(request_id, gen_task)
    except (ConnectionResetError, BrokenPipeError):
      return None  # client gone; the handler cancels the generation
    except Exception as e:  # noqa: BLE001 — the response is committed: report in-band
      detail = "Response generation timed out" if isinstance(e, asyncio.TimeoutError) else f"Error processing prompt: {e}"
      await stream.write(f"data: {json.dumps({'error': {'message': detail}})}\n\n".encode())
    await stream.write(b"data: [DONE]\n\n")
    return None
