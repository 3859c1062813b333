"""OpenAI-compatible HTTP API: ``/healthcheck``, ``/v1/models`` and
``/v1/chat/completions`` (blocking, and SSE with ``"stream": true``).

Counterpart of those routes of the reference's ``api/chatgpt_api.py``, with
the same request and response shapes. The server is a small HTTP/1.1 server
on ``asyncio`` streams from the standard library (one request per
connection, ``Connection: close``), so the serving path depends on no web
framework.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import uuid
from pathlib import Path

from .. import registry
from ..inference.engine import PromptTooLongError
from ..utils.helpers import DEBUG

_REASONS = {200: "OK", 204: "No Content", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout", 413: "Payload Too Large", 500: "Internal Server Error"}
MAX_BODY_BYTES = 16 << 20


class Message:
  def __init__(self, role: str, content):
    self.role = role
    self.content = content

  def to_dict(self) -> dict:
    return {"role": self.role, "content": self.content}


class ChatCompletionRequest:
  def __init__(self, model: str, messages: list[Message], temperature: float | None = None, max_tokens=None, stream=False, stop=()):
    self.model = model
    self.messages = messages
    self.temperature = temperature
    self.max_tokens = max_tokens
    self.stream = stream
    self.stop = tuple(stop)


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


def build_prompt(tokenizer, messages: list[Message]) -> str:
  conversation = [{"role": m.role, "content": _flatten(m.content)} for m in messages]
  return tokenizer.apply_chat_template(conversation, tokenize=False, add_generation_prompt=True)


def parse_chat_request(data: dict, default_model: str) -> ChatCompletionRequest:
  if not isinstance(data, dict) or not data.get("messages"):
    raise ValueError("'messages' must be a non-empty list")
  messages = []
  for m in data["messages"]:
    if not isinstance(m, dict) or "role" not in m or "content" not in m:
      raise ValueError(f"Invalid message: {m}. Must have 'role' and 'content'")
    messages.append(Message(m["role"], m["content"]))
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
  return ChatCompletionRequest(model, messages, temperature, max_tokens, bool(data.get("stream", False)), stop)


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
  def __init__(self, method: str, path: str, headers: dict, body: bytes) -> None:
    self.method, self.path, self.headers, self.body = method, path, headers, body


class _Response:
  """A complete (non-streaming) HTTP response."""

  def __init__(self, body: dict, status: int = 200) -> None:
    self.body, self.status = body, status


def json_response(body: dict, status: int = 200) -> _Response:
  return _Response(body, status)


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
  return _Request(parts[0].upper(), parts[1].split("?", 1)[0], headers, body)


async def _write_head(writer: asyncio.StreamWriter, status: int, headers: dict) -> None:
  lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}"] + [f"{k}: {v}" for k, v in headers.items()]
  writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
  await writer.drain()


_CORS = {"Access-Control-Allow-Origin": "*", "Access-Control-Allow-Methods": "GET, POST, OPTIONS", "Access-Control-Allow-Headers": "*"}


async def _send_json(writer: asyncio.StreamWriter, resp: _Response) -> None:
  data = json.dumps(resp.body).encode()
  await _write_head(writer, resp.status, {"Content-Type": "application/json", "Content-Length": str(len(data)), "Connection": "close", **_CORS})
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

  def handle_tokens(self, request_id: str, tokens: list[int], is_finished: bool) -> None:
    queue = self.token_queues.get(request_id)
    if queue is not None:
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
      prompt = build_prompt(tokenizer, chat_request.messages)
      self.node.set_request_options(request_id, stream=chat_request.stream, max_tokens=chat_request.max_tokens, temperature=chat_request.temperature)
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
