"""OpenAI-compatible HTTP API: ``/healthcheck``, ``/v1/models``,
``/v1/chat/completions`` and the legacy ``/v1/completions`` (blocking, and
SSE with ``"stream": true``; OpenAI ``logprobs`` on blocking requests,
scored after the generation in one forward), ``/v1/chat/token/encode``,
``/metrics`` (Prometheus text), ``/v1/slo`` (the local SLO report),
``/v1/kv/tier`` (the host KV tier's state), ``/v1/programs`` (the device
program ledger), ``POST /v1/warmup`` (build the expected programs before
traffic), ``/v1/adapters`` (the multi-LoRA registry), the model-management routes (``/initial_models``, the
``/modelpool`` SSE stream, ``POST /download``, ``/v1/download/progress``,
``DELETE /models/{model_name}``), ``POST /quit``, the ring's merged
topology (``GET /topology`` and ``/v1/topology``), the web chat
(``GET /`` and the static files of ``tinychat/``), and image generation
on a stable-diffusion model: ``POST /v1/image/generations`` (JSON lines of
progress, then the saved PNGs' URLs), ``POST /v1/images/generations`` (the
OpenAI Images shape, ``url`` or ``b64_json``) and ``GET /images/<name>``
(the saved PNGs, under ``XOT_TPU_HOME/images``).

Counterpart of those routes of the reference's ``api/chatgpt_api.py``, with
the same request and response shapes: a chat request may carry a QoS
identity (``priority``/``deadline_ms``/``tenant`` body fields or
``x-priority``/``x-deadline-ms``/``x-tenant-id`` headers; a bad value is a
400) and an adapter (``parse_adapter_field``: the ``x-adapter`` header, a
``model`` field naming a registered adapter, or the tenant's default; an
unknown name is a 400 ``unknown_adapter`` before any device work), and an
overload refusal (a full queue, every adapter slot pinned) is a structured
429 with ``Retry-After``. On a vision model (llava), each ``data:``
``image_url`` part of a chat message becomes an ``<image>`` placeholder in
the prompt and its base64 payload rides to the engine in the request's
state (``remap_messages``); on a text model image parts are dropped. An
image the server cannot take (no Pillow, an undecodable image, more
placeholders than images) is a 400.
An image request answers 400 for a model outside the stable-diffusion
family or a bad field, 501 when the engine (or the server: PNGs need
Pillow) cannot generate images, 408 when the generation outlives its time
limit, and a client that disconnects stops the denoise at the next chunk;
a text request to a stable-diffusion model is refused with the engine's
501. Any request whose body is not read within 30 s is a 408.
A ring whose partition map cannot hold the model answers 507
``insufficient_resources`` before anything loads. On a ring node,
``logprobs`` (they need the whole model on one node) and ``?scope=cluster``
on ``/metrics``, ``/v1/slo``, ``/v1/programs`` and ``/v1/kv/tier`` (the
cluster pulls are not ported) are refused. ``/metrics`` also carries each
kernel's launches in this process (``kernel_launches_total{kernel}``: the
wrappers' host launches plus those inside graph replays).
The server is a small HTTP/1.1 server on ``asyncio`` streams from the
standard library (one request per connection, ``Connection: close``), so
the serving path depends on no web framework.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import importlib.util
import io
import json
import math
import mimetypes
import os
import signal
import threading
import time
import uuid
from pathlib import Path
from urllib.parse import parse_qs, unquote

from .. import registry
from ..inference.adapters import UnknownAdapterError, check_known, lora_tenant_map
from ..inference.engine import ImageInputError, PromptTooLongError, ServerOverloadedError
from ..inference.state import InferenceState
from ..inference.qos import PRIORITY_CLASSES
from ..orchestration import slo
from ..parallel.hbm_planner import RingBudgetError
from ..utils.helpers import DEBUG, xot_home
from ..utils.metrics import metrics

_REASONS = {200: "OK", 204: "No Content", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout", 413: "Payload Too Large", 429: "Too Many Requests", 500: "Internal Server Error", 501: "Not Implemented", 507: "Insufficient Storage"}
MAX_BODY_BYTES = 16 << 20
BODY_READ_TIMEOUT_S = 30.0  # a request body's read (the reference bounds the image routes' at 30 s)
STATIC_DIR = Path(__file__).resolve().parent.parent / "tinychat"


class Message:
  def __init__(self, role: str, content, tools=None):
    self.role = role
    self.content = content
    self.tools = tools  # per-message tool definitions, rendered by the chat template

  def to_dict(self) -> dict:
    data = {"role": self.role, "content": self.content}
    if self.tools:
      data["tools"] = self.tools
    return data


class ChatCompletionRequest:
  def __init__(self, model: str, messages: list[Message], temperature: float | None = None, max_tokens=None, stream=False, stop=(), tools=None, logprobs=False, top_logprobs=0):
    self.model = model
    self.messages = messages
    self.temperature = temperature
    self.max_tokens = max_tokens
    self.stream = stream
    self.stop = tuple(stop)
    self.tools = tools  # request-level tool definitions (the chat template's ``tools``)
    self.logprobs = bool(logprobs)
    self.top_logprobs = int(top_logprobs)


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


def remap_messages(messages: list[Message], vision: bool = False) -> tuple[list[Message], list[str]]:
  """Flatten multimodal content blocks into text, as the reference does.
  With ``vision`` (the served model has a tower) each ``data:`` image URL
  becomes an ``<image>`` placeholder (the processor expands it into the
  image's feature placeholders) and its base64 payload is collected for the
  engine; on a text model image parts are dropped, leaving no
  placeholder. Returns (messages with text content, payloads)."""
  remapped = []
  images: list[str] = []
  for message in messages:
    if isinstance(message.content, list):
      parts = []
      for part in message.content:
        if not isinstance(part, dict):
          continue
        if part.get("type") == "text":
          parts.append(part.get("text", ""))
        elif part.get("type") == "image_url" and vision:
          url = (part.get("image_url") or {}).get("url", "")
          if url.startswith("data:") and "," in url:
            images.append(url.split(",", 1)[1])
            parts.append("<image>")
      remapped.append(Message(message.role, " ".join(parts), message.tools))
    else:
      remapped.append(message)
  return remapped, images


def build_prompt(tokenizer, messages: list[Message], tools=None) -> str:
  """The chat template over ``messages`` (with their own ``tools``) and the
  request's ``tools``, as the reference renders them; content blocks not
  remapped yet lose their image parts (``remap_messages``)."""
  kwargs = {"tools": tools} if tools else {}
  messages, _ = remap_messages(messages)
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
  model = data.get("model", default_model)
  if not model or model.startswith("gpt-") or model not in registry.model_cards:  # alias client defaults
    model = default_model
  logprobs = data.get("logprobs", False)
  if not isinstance(logprobs, bool):
    raise ValueError("'logprobs' must be a boolean")
  top_logprobs = data.get("top_logprobs", 0) or 0
  if not isinstance(top_logprobs, int) or isinstance(top_logprobs, bool) or not 0 <= top_logprobs <= 20:
    raise ValueError("'top_logprobs' must be an integer in [0, 20]")
  if top_logprobs and not logprobs:
    raise ValueError("'top_logprobs' requires 'logprobs': true")
  if logprobs and data.get("stream"):
    # Logprobs are scored after the generation, in one forward over the
    # whole response: a stream has no final message to attach them to.
    raise ValueError("'logprobs' is not supported with 'stream': true")
  return ChatCompletionRequest(model, messages, temperature, max_tokens, bool(data.get("stream", False)), stop, data.get("tools"), logprobs, top_logprobs)


def _align_logprobs(tokenizer, all_tokens: list, eos_set, text: str, prompt_len: int, stop_cut: bool) -> tuple[list, list, list]:
  """Token strings, text offsets and kept indices for ``/v1/completions``
  logprobs. The arrays align with the returned text: no entries for EOS
  tokens (the text omits them) or for tokens that start past a stop-string
  cut; ``keep`` indexes the surviving positions in ``all_tokens``. When the
  per-token decodes concatenate to the joint decode, offsets are their
  running lengths; otherwise (a byte-level BPE splitting a multi-byte
  character) each offset is the length of a joint prefix decode, O(tokens²):
  callers run this off the event loop."""
  ids = [int(t) for t in all_tokens if t not in eos_set]
  positions = [i for i, t in enumerate(all_tokens) if t not in eos_set]
  pieces = [tokenizer.decode([t]) for t in ids]
  if "".join(pieces) == tokenizer.decode(ids):
    prefix_lens, acc = [], 0
    for piece in pieces:
      prefix_lens.append(acc)
      acc += len(piece)
  else:
    prefix_lens = [len(tokenizer.decode(ids[:j])) for j in range(len(ids))]
  toks, offsets, keep = [], [], []
  for j, (i, piece) in enumerate(zip(positions, pieces)):
    start = prefix_lens[j]
    if stop_cut and start >= len(text):  # starts past the cut
      break
    toks.append(piece)
    offsets.append(prompt_len + min(start, len(text)))
    keep.append(i)
  return toks, offsets, keep


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


def parse_adapter_field(data: dict, headers, tenant: str | None, known=None) -> str | None:
  """The request's multi-LoRA adapter, first hit wins: the ``x-adapter``
  header; an OpenAI-compatible ``model`` field that names a REGISTERED
  adapter (``known(name)``: only a known name aliases the model field, so
  ordinary model ids keep their meaning); the tenant's default from
  ``XOT_TPU_LORA_TENANTS``. None is the base model. Trust: adapter names
  are client-asserted, like tenant keys."""
  name = headers.get("x-adapter")
  if name:
    return str(name)[:128]
  model = data.get("model")
  if model and known is not None and known(str(model)):
    return str(model)
  if tenant:
    return lora_tenant_map().get(tenant)
  return None


def unknown_adapter_response(e: Exception) -> _Response:
  return json_response({"error": {"message": str(e), "type": "invalid_request_error", "code": "unknown_adapter"}}, 400)


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
    self.match = ""  # the path parameter of a prefix route (DELETE /models/{model_name})
    self.reader: asyncio.StreamReader | None = None  # the connection's read side (a client gone reads EOF)

  def json(self):
    """The body as JSON; ValueError when it is not JSON."""
    try:
      return json.loads(self.body or b"null")
    except (json.JSONDecodeError, UnicodeDecodeError):
      raise ValueError("invalid JSON body") from None


class _Response:
  """A complete (non-streaming) HTTP response: a JSON body, ``text``, or
  raw ``data`` bytes, with its content type."""

  def __init__(self, body: dict | None, status: int = 200, headers: dict | None = None, text: str | None = None, content_type: str = "application/json", data: bytes | None = None) -> None:
    self.body, self.status, self.headers, self.text, self.content_type, self.data = body, status, headers or {}, text, content_type, data


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
  path, _, qs = parts[1].partition("?")
  # A body that does not arrive in time raises asyncio.TimeoutError: a 408.
  body = await asyncio.wait_for(reader.readexactly(n), BODY_READ_TIMEOUT_S) if n else b""
  return _Request(parts[0].upper(), path, headers, body, {k: v[-1] for k, v in parse_qs(qs).items()})


async def _write_head(writer: asyncio.StreamWriter, status: int, headers: dict) -> None:
  lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}"] + [f"{k}: {v}" for k, v in headers.items()]
  writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
  await writer.drain()


_CORS = {"Access-Control-Allow-Origin": "*", "Access-Control-Allow-Methods": "GET, POST, DELETE, OPTIONS", "Access-Control-Allow-Headers": "*"}


async def _send_json(writer: asyncio.StreamWriter, resp: _Response) -> None:
  data = resp.data if resp.data is not None else (resp.text if resp.text is not None else json.dumps(resp.body)).encode()
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

  async def event(self, payload) -> None:
    await self.write(f"data: {json.dumps(payload)}\n\n".encode())


def _static_file(rel: str) -> Path | None:
  """A file of ``tinychat/`` by its URL path, or None: a path that leaves
  the directory is refused, as aiohttp's static route refuses it."""
  root = STATIC_DIR.resolve()
  target = (root / unquote(rel).lstrip("/")).resolve()
  return target if target.is_relative_to(root) and target.is_file() else None


async def _file_response(path: Path | None) -> _Response:
  if path is None:
    return json_response({"error": "not found"}, 404)
  data = await asyncio.to_thread(path.read_bytes)
  return _Response(None, data=data, content_type=mimetypes.guess_type(path.name)[0] or "application/octet-stream")


def _check_image_fields(n: int, steps: int, size: tuple[int, ...] | None) -> None:
  """An image request's ranges, as the reference checks them (ValueError)."""
  if not 1 <= n <= 4:
    raise ValueError("n must be in [1, 4]")
  if size is not None:
    if len(size) != 2:
      raise ValueError("size must be [height, width]")
    if not all(8 <= v <= 2048 for v in size):
      raise ValueError("size dims must be in [8, 2048]")
  if not 1 <= steps <= 1000:
    raise ValueError("steps must be in [1, 1000]")


def _decode_image_b64(image_url: str):
  """A data URL or raw base64 → a uint8 RGB array, capped at 2048 px on its
  long side and its dims floored to a multiple of 8 (the pipeline snaps it
  onto the model's own grid)."""
  import numpy as np
  from PIL import Image

  payload = image_url.split(",", 1)[1] if image_url.startswith("data:") else image_url
  img = Image.open(io.BytesIO(base64.b64decode(payload))).convert("RGB")
  w, h = img.size
  if max(w, h) > 2048:  # one request must not exhaust the worker's memory
    scale = 2048 / max(w, h)
    w, h = max(int(w * scale), 8), max(int(h * scale), 8)
  w8, h8 = max(w // 8 * 8, 8), max(h // 8 * 8, 8)
  if (w8, h8) != img.size:
    img = img.resize((w8, h8))
  return np.asarray(img, dtype=np.uint8)


def _png_bytes(image) -> list[bytes]:
  """uint8 [H, W, 3] or [n, H, W, 3] → one PNG file's bytes per image."""
  from PIL import Image

  out = []
  for arr in image if image.ndim == 4 else image[None]:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    out.append(buf.getvalue())
  return out


async def _client_gone(reader: asyncio.StreamReader | None) -> None:
  """Returns when the client closes its end of the connection (EOF, or a
  reset, on its read side); never without a reader."""
  if reader is None:
    await asyncio.Event().wait()
  try:
    while await reader.read(4096):
      pass
  except ConnectionError:
    pass


async def _stop_generation(gen: asyncio.Task, cancel_event: threading.Event) -> None:
  """Stop an image generation: the denoise loop on the worker thread sees
  the event before its next chunk; the task's outcome is retrieved."""
  cancel_event.set()
  gen.cancel()
  await asyncio.gather(gen, return_exceptions=True)


def _kernel_launch_lines() -> str:
  """``kernel_launches_total{kernel}`` in Prometheus text: each kernel's
  launches in this process so far (host launches and those inside replayed
  graphs)."""
  from ..ops import flash_attention, int4_matmul, paged
  from ..utils.programs import REPLAYED

  host = {**flash_attention.LAUNCHES, **paged.LAUNCHES, **int4_matmul.LAUNCHES}
  lines = ["# TYPE xot_tpu_kernel_launches_total counter"]
  lines += [f'xot_tpu_kernel_launches_total{{kernel="{name}"}} {n + REPLAYED.get(name, 0)}' for name, n in sorted(host.items())]
  return "\n".join(lines) + "\n"


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
    self._downloads: set[asyncio.Task] = set()
    self.node.on_token.register("chatgpt-api-token-handler").on_next(self.handle_tokens)
    self.routes = {
      ("GET", "/healthcheck"): self.handle_healthcheck,
      ("GET", "/v1/models"): self.handle_get_models,
      ("GET", "/models"): self.handle_get_models,
      ("POST", "/v1/chat/completions"): self.handle_post_chat_completions,
      ("POST", "/chat/completions"): self.handle_post_chat_completions,
      ("POST", "/v1/completions"): self.handle_post_completions,
      ("POST", "/completions"): self.handle_post_completions,
      ("POST", "/v1/chat/token/encode"): self.handle_post_chat_token_encode,
      ("POST", "/chat/token/encode"): self.handle_post_chat_token_encode,
      ("GET", "/initial_models"): self.handle_get_initial_models,
      ("GET", "/modelpool"): self.handle_model_support,
      ("GET", "/metrics"): self.handle_metrics,
      ("GET", "/v1/slo"): self.handle_slo,
      ("GET", "/v1/kv/tier"): self.handle_kv_tier,
      ("GET", "/v1/programs"): self.handle_programs,
      ("GET", "/v1/topology"): self.handle_get_topology,
      ("GET", "/topology"): self.handle_get_topology,
      ("POST", "/v1/warmup"): self.handle_warmup,
      ("GET", "/v1/adapters"): self.handle_adapters,
      ("GET", "/v1/download/progress"): self.handle_get_download_progress,
      ("POST", "/download"): self.handle_post_download,
      ("POST", "/quit"): self.handle_quit,
      ("POST", "/v1/image/generations"): self.handle_image_generations,
      ("POST", "/v1/images/generations"): self.handle_openai_image_generations,
      ("GET", "/"): self.handle_root,
    }
    # Routes with one path parameter (the rest of the path, one segment).
    self.prefix_routes = {("DELETE", "/models/"): self.handle_delete_model, ("GET", "/images/"): self.handle_image_file}

  # ------------------------------------------------------------- server

  async def run(self, host: str = "0.0.0.0", port: int = 52415) -> asyncio.AbstractServer:
    """Start serving; returns the server (``close()`` + ``wait_closed()`` stop it)."""
    return await asyncio.start_server(self._serve_connection, host, port)

  def _route(self, request: _Request):
    """The handler of ``request``: an exact route, a prefix route (its
    parameter in ``request.match``), or a ``tinychat/`` file for a GET."""
    handler = self.routes.get((request.method, request.path))
    if handler is not None:
      return handler
    for (method, prefix), prefix_handler in self.prefix_routes.items():
      rest = request.path[len(prefix):]
      if request.method == method and request.path.startswith(prefix) and rest and "/" not in rest:
        request.match = unquote(rest)
        return prefix_handler
    if request.method == "GET" and _static_file(request.path) is not None:
      return self.handle_static
    return None

  async def _serve_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    try:
      try:
        request = await _read_request(reader)
      except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ValueError, UnicodeDecodeError):
        request = None
      except asyncio.TimeoutError:
        await _send_json(writer, json_response({"error": "request body read timed out"}, 408))
        return
      if request is None:
        await _send_json(writer, json_response({"error": "malformed request"}, 400))
        return
      if request.method == "OPTIONS":
        await _write_head(writer, 204, {"Content-Length": "0", "Connection": "close", **_CORS})
        return
      request.reader = reader
      handler = self._route(request)
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

  async def handle_root(self, request, writer):
    return await _file_response(_static_file("index.html"))

  async def handle_static(self, request, writer):
    return await _file_response(_static_file(request.path))

  async def handle_healthcheck(self, request, writer):
    return json_response({"status": "ok"})

  async def handle_quit(self, request, writer):
    """POST /quit — answer, then send SIGINT to this process (the daemon's
    handler starts its shutdown)."""
    await _send_json(writer, json_response({"detail": "Quit signal received"}))
    os.kill(os.getpid(), signal.SIGINT)
    return None

  def _served_cards(self):
    return ((model_id, card) for model_id, card in registry.model_cards.items() if card.repo_for(self.inference_engine_classname))

  async def handle_get_models(self, request, writer):
    """GET /v1/models — ``downloaded`` is per card: its own directory under
    the downloads home holds safetensors."""
    from ..download.downloader import get_models_dir, repo_to_dirname

    models_dir = get_models_dir()

    def has_local_weights(card) -> bool:
      d = models_dir / repo_to_dirname(card.repo_for(self.inference_engine_classname))
      return d.is_dir() and any(d.glob("*.safetensors"))

    models = [
      {"id": model_id, "object": "model", "owned_by": "xot_tpu", "ready": True, "name": card.pretty, "downloaded": has_local_weights(card)}
      for model_id, card in self._served_cards()
    ]
    return json_response({"object": "list", "data": models})

  async def handle_get_initial_models(self, request, writer):
    return json_response({
      model_id: {"name": card.pretty, "downloaded": None, "download_percentage": None, "total_size": None, "total_downloaded": None, "loading": False}
      for model_id, card in self._served_cards()
    })

  async def handle_model_support(self, request, writer):
    """GET /modelpool — one SSE event per served model, then ``[DONE]``."""
    stream = _SSEStream(writer)
    await stream.prepare()
    for model_id, card in self._served_cards():
      await stream.event({"model": model_id, "name": card.pretty, "downloaded": None, "download_percentage": None})
    await stream.write(b"data: [DONE]\n\n")
    return None

  async def handle_get_download_progress(self, request, writer):
    return json_response({str(node_id): progress for node_id, progress in self.node.node_download_progress.items()})

  async def handle_post_download(self, request, writer):
    """POST /download — resolve a model's checkpoint in the background
    (download/downloader.py: a local directory, or else a fetch from the
    hub); progress lands in ``/v1/download/progress``."""
    try:
      data = request.json()
    except ValueError as e:
      return json_response({"error": str(e)}, 400)
    model_id = data.get("model") if isinstance(data, dict) else None
    shard = registry.build_full_shard(model_id, self.inference_engine_classname)
    if shard is None:
      return json_response({"error": f"Invalid model: {model_id}"}, 400)
    if self.node.shard_downloader is None:
      return json_response({"error": "no downloader configured"}, 400)
    task = asyncio.create_task(self.node.shard_downloader.ensure_shard(shard, self.inference_engine_classname))
    self._downloads.add(task)
    task.add_done_callback(self._download_done)
    return json_response({"status": f"Download started for {model_id}"})

  def _download_done(self, task: asyncio.Task) -> None:
    self._downloads.discard(task)
    if not task.cancelled() and task.exception() is not None:
      print(f"[api] download failed: {task.exception()}")

  async def handle_delete_model(self, request, writer):
    from ..download.downloader import delete_model

    model_name = request.match
    if await delete_model(model_name, self.inference_engine_classname):
      return json_response({"status": f"Model {model_name} deleted"})
    return json_response({"detail": f"Model {model_name} not found"}, 404)

  # ------------------------------------------------------------- images

  @property
  def images_dir(self) -> Path:
    return xot_home() / "images"

  def _image_request_prologue(self, request, allow_default_model: bool = False):
    """The checks both image routes share → (data, shard, None), or (None,
    None, the refusal). ``allow_default_model`` (the OpenAI route, where
    ``model`` is optional) takes the first stable-diffusion card."""
    try:
      data = request.json()
      if not isinstance(data, dict):
        raise ValueError("invalid JSON body")
    except ValueError:
      return None, None, json_response({"error": "invalid JSON body"}, 400)
    model = data.get("model") or ""
    if not model and allow_default_model:
      model = next((m for m in registry.model_cards if registry.get_family(m) == "stable-diffusion"), "")
      data = {**data, "model": model}
    if not isinstance(model, str) or registry.get_family(model) != "stable-diffusion":
      return None, None, json_response({"error": f"Unsupported model for image generation: {model}"}, 400)
    if not getattr(self.node.inference_engine, "can_generate_images", False):
      return None, None, json_response({"detail": "image generation models are not supported by this engine"}, 501)
    shard = registry.build_base_shard(model, self.inference_engine_classname)
    if shard is None:
      return None, None, json_response({"error": f"Unsupported model: {model} with engine {self.inference_engine_classname}"}, 400)
    if importlib.util.find_spec("PIL") is None:
      return None, None, json_response({"detail": "image generation needs Pillow (the PIL package) to encode PNGs; it is not installed"}, 501)
    return data, shard, None

  async def handle_image_generations(self, request, writer):
    """POST /v1/image/generations: JSON lines of progress (``{"progress",
    "step", "total_steps"}``, at 0 and after every denoise chunk), then
    ``{"images": [{"url", "content_type"}]}``. Fields: ``model``,
    ``prompt``, ``image_url`` (img2img, a data URL or base64), and
    ``negative_prompt``, ``steps``, ``guidance``, ``seed``, ``size``
    ([height, width]), ``strength``, ``n`` (1-4)."""
    data, shard, err = self._image_request_prologue(request)
    if err is not None:
      return err
    init_image = None
    if image_url := data.get("image_url") or "":
      try:
        init_image = await asyncio.to_thread(_decode_image_b64, str(image_url))
      except Exception as e:  # noqa: BLE001 — whatever the payload does to the decoder is a bad image_url
        return json_response({"error": f"invalid image_url: {e}"}, 400)
    # Every numeric field is coerced before the 200 goes out: a bad one is
    # a clean 400, not a truncated stream.
    try:
      gen_kwargs = dict(
        negative=str(data.get("negative_prompt", "")),
        steps=int(data.get("steps", 30)),
        guidance=float(data.get("guidance", 7.5)),
        seed=int(data.get("seed", 0)),
        size=tuple(int(v) for v in data["size"]) if data.get("size") else None,
        strength=float(data.get("strength", 0.8)),
        n=int(data.get("n", 1)),
      )
      _check_image_fields(gen_kwargs["n"], gen_kwargs["steps"], gen_kwargs["size"])
    except (TypeError, ValueError) as e:
      return json_response({"error": f"invalid parameters: {e}"}, 400)

    request_id = str(uuid.uuid4())
    await _write_head(writer, 200, {"Content-Type": "application/octet-stream", "Cache-Control": "no-cache", "Connection": "close", **_CORS})
    progress_q: asyncio.Queue = asyncio.Queue()
    cancel_event = threading.Event()  # polled by the denoise loop between chunks
    gen = asyncio.create_task(self.node.process_image_prompt(
      shard, str(data.get("prompt", "")), request_id, init_image=init_image,
      progress_cb=lambda done, total: progress_q.put_nowait((done, total)), cancel_event=cancel_event, **gen_kwargs,
    ))
    gone = asyncio.create_task(_client_gone(request.reader))
    get_q = None

    async def line(payload: dict) -> None:
      writer.write(json.dumps(payload).encode() + b"\n")
      await writer.drain()

    try:
      while True:
        get_q = asyncio.create_task(progress_q.get())
        finished, _ = await asyncio.wait({gen, get_q, gone}, return_when=asyncio.FIRST_COMPLETED, timeout=self.response_timeout)
        if get_q in finished:
          done, total = get_q.result()
          pct = int(100 * done / max(total, 1))
          bar = "-" * max(pct // 2 - 1, 0) + ">" + " " * (50 - max(pct // 2, 1))
          await line({"progress": f"Progress: [{bar}] {pct}% ({done}/{total})", "step": done, "total_steps": total})
          continue
        if gen in finished:
          break
        if gone in finished:
          raise ConnectionResetError("the client closed the connection")
        await _stop_generation(gen, cancel_event)
        await line({"error": "image generation timed out"})
        return None
      image = gen.result()  # uint8 [H, W, 3], or [n, H, W, 3]
      urls = await self._save_images(request, request_id, image)
      await line({"images": [{"url": u, "content_type": "image/png"} for u in urls]})
    except asyncio.CancelledError:
      await _stop_generation(gen, cancel_event)
      raise
    except Exception as e:  # noqa: BLE001 — the response is committed: a failure (or a client gone) is reported in-band
      await _stop_generation(gen, cancel_event)
      if DEBUG >= 2:
        import traceback

        traceback.print_exception(e)
      try:
        await line({"error": str(e)})
      except (ConnectionError, RuntimeError):
        pass  # the client is gone
    finally:
      for task in (get_q, gone):
        if task is not None and not task.done():
          task.cancel()
    return None

  async def handle_openai_image_generations(self, request, writer):
    """POST /v1/images/generations, the OpenAI Images shape: a blocking
    ``{"created", "data": [{"url"} | {"b64_json"}]}``. Fields: ``prompt``,
    ``n`` (1-4), ``size`` ("WxH"), ``response_format`` ("url" or
    ``b64_json``), ``model`` (default: the first stable-diffusion card),
    ``steps``, ``seed``, ``negative_prompt``."""
    data, shard, err = self._image_request_prologue(request, allow_default_model=True)
    if err is not None:
      return err
    try:
      n = int(data.get("n", 1))
      size = None
      if data.get("size"):
        w, h = (int(v) for v in str(data["size"]).lower().split("x"))
        size = (h, w)
      steps = int(data.get("steps", 30))
      _check_image_fields(n, steps, size)
      seed = int(data.get("seed", 0))
      negative = str(data.get("negative_prompt", ""))
      response_format = str(data.get("response_format", "url"))
      if response_format not in ("url", "b64_json"):
        raise ValueError("response_format must be 'url' or 'b64_json'")
    except (TypeError, ValueError) as e:
      return json_response({"error": f"invalid parameters: {e}"}, 400)

    request_id = str(uuid.uuid4())
    cancel_event = threading.Event()
    gen = asyncio.create_task(self.node.process_image_prompt(
      shard, str(data.get("prompt", "")), request_id, negative=negative, steps=steps, seed=seed, size=size, n=n, cancel_event=cancel_event,
    ))
    gone = asyncio.create_task(_client_gone(request.reader))
    try:
      # ten times the response timeout, as the reference's image wait
      finished, _ = await asyncio.wait({gen, gone}, return_when=asyncio.FIRST_COMPLETED, timeout=self.response_timeout * 10)
      if gen not in finished:
        await _stop_generation(gen, cancel_event)
        return None if gone in finished else json_response({"error": "image generation timed out"}, 408)
      image = gen.result()
    except asyncio.CancelledError:
      await _stop_generation(gen, cancel_event)
      raise
    except NotImplementedError as e:
      return json_response({"error": str(e)}, 501)
    except Exception as e:  # noqa: BLE001 — the API boundary reports every failure with its status
      if DEBUG >= 2:
        import traceback

        traceback.print_exception(e)
      return json_response({"error": str(e)}, 500)
    finally:
      if not gone.done():
        gone.cancel()

    if response_format == "b64_json":
      entries = [{"b64_json": base64.b64encode(png).decode()} for png in await asyncio.to_thread(_png_bytes, image)]
    else:
      entries = [{"url": u} for u in await self._save_images(request, request_id, image)]
    return json_response({"created": int(time.time()), "data": entries})

  async def _save_images(self, request, request_id: str, image) -> list[str]:
    """uint8 [H, W, 3] or [n, H, W, 3] → PNGs under ``images_dir``, their
    absolute URLs (``GET /images/<name>``)."""
    pngs = await asyncio.to_thread(_png_bytes, image)
    names = [f"{request_id}.png"] if len(pngs) == 1 else [f"{request_id}-{i}.png" for i in range(len(pngs))]
    folder = self.images_dir
    await asyncio.to_thread(folder.mkdir, parents=True, exist_ok=True)
    for name, png in zip(names, pngs):
      await asyncio.to_thread((folder / name).write_bytes, png)
    host = request.headers.get("host") or "127.0.0.1"
    return [f"http://{host}/images/{name}" for name in names]

  async def handle_image_file(self, request, writer):
    """GET /images/<name>: a saved PNG (a path that leaves the folder is a
    404)."""
    root = self.images_dir.resolve()
    target = (root / request.match).resolve()
    if not (target.is_relative_to(root) and target.is_file()):
      return json_response({"error": "not found"}, 404)
    return await _file_response(target)

  async def handle_post_chat_token_encode(self, request, writer):
    """POST /v1/chat/token/encode — the chat template's prompt and its ids."""
    try:
      data = request.json()
      if not isinstance(data, dict):
        raise ValueError("invalid JSON body")
      model = data.get("model", self.default_model)
      if model.startswith("gpt-"):
        model = self.default_model
      messages = [Message(m["role"], m["content"], m.get("tools")) for m in data.get("messages", [])]
    except (ValueError, TypeError, KeyError, AttributeError) as e:
      return json_response({"error": f"invalid request: {e}"}, 400)
    shard = registry.build_base_shard(model, self.inference_engine_classname)
    if shard is None:
      return json_response({"error": f"Unsupported model: {model}"}, 400)
    try:
      tokenizer = await self._tokenizer_for(shard)
    except NotImplementedError as e:
      return self._error_response(e)
    prompt = build_prompt(tokenizer, messages, data.get("tools"))
    tokens = tokenizer.encode(prompt)
    return json_response({"length": len(prompt), "num_tokens": len(tokens), "encoded_tokens": [int(t) for t in tokens], "encoded_prompt": prompt})

  def _cluster_scope_refusal(self, request) -> _Response | None:
    """``?scope=cluster`` on a node with peers: the reference merges its
    peers' answers through pulls the port has not ported, so it answers 501
    rather than a local view under a cluster label. Without peers the
    cluster is this node, as in the reference."""
    if request.query.get("scope") == "cluster" and getattr(self.node, "peers", None):
      return json_response({"error": {"message": f"{request.path}?scope=cluster: the cluster pulls are not ported to the PyTorch package yet", "type": "not_implemented"}}, 501)
    return None

  async def handle_get_topology(self, request, writer):
    """GET /topology, /v1/topology — the node's merged ring view."""
    topology = self.node.current_topology
    return json_response(topology.to_json() if topology else {})

  async def handle_metrics(self, request, writer):
    """GET /metrics — the registry in Prometheus text format (local scope),
    and each kernel's launches in this process."""
    if (refusal := self._cluster_scope_refusal(request)) is not None:
      return refusal
    return _Response(None, text=metrics.render_prometheus() + _kernel_launch_lines(), content_type="text/plain; version=0.0.4")

  async def handle_slo(self, request, writer):
    """GET /v1/slo — the SLO engine's local report: per-class objectives,
    burn rates over each window, availability and goodput, each rate with
    its raw counts. ``{"enabled": false}`` when ``XOT_TPU_SLO=0``."""
    if (refusal := self._cluster_scope_refusal(request)) is not None:
      return refusal
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
    spill and restore totals, and the prefix registry's view. The cluster
    pulls are not ported: without peers ``?scope=cluster`` answers with
    this same local view, as the reference does; with peers, 501."""
    from ..inference.kv_tier import kv_tier_enabled, prefix_registry

    if (refusal := self._cluster_scope_refusal(request)) is not None:
      return refusal
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
    manifest and the steady flag. Without peers ``?scope=cluster`` answers
    as the reference does on a node alone: this snapshot merged alone, with
    ``unreachable: []``; with peers, 501 (the pulls are not ported)."""
    from ..utils.programs import ProgramLedger, ledger

    if (refusal := self._cluster_scope_refusal(request)) is not None:
      return refusal
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

  def _adapter_registry(self):
    return getattr(getattr(self.node, "inference_engine", None), "adapter_registry", None)

  async def handle_adapters(self, request, writer):
    """GET /v1/adapters — the multi-LoRA registry: every registered adapter
    with its device slot, host residency and pins, the capacity and the
    byte budgets; ``{"enabled": false}`` when multi-LoRA serving is off."""
    reg = self._adapter_registry()
    if reg is None:
      return json_response({"enabled": False, "detail": "multi-LoRA serving off (XOT_TPU_LORA=0 or no adapters loaded)"})
    return json_response({"enabled": True, **reg.snapshot()})

  def _adapter_known(self, name: str) -> bool:
    """Is ``name`` a registered adapter on this node (the ``model`` field's
    alias)? The router's replicas are not consulted: the router is not
    ported."""
    reg = self._adapter_registry()
    return reg is not None and reg.known(name)

  def _resolve_adapter(self, data: dict, headers, tenant: str | None) -> str | None:
    """The request's adapter name (or None), checked against this node's
    registry: raises ``UnknownAdapterError`` for a name it never saw."""
    name = parse_adapter_field(data, headers, tenant, known=self._adapter_known)
    if name is not None:
      check_known(self._adapter_registry(), name)
    return name

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
    """The serving engine's tokenizer, loading this node's shard of the
    model if it is not yet (after the ring's memory check)."""
    engine = self.node.inference_engine
    check = getattr(self.node, "check_ring_budget", None)
    if check is not None:
      check(shard)  # a ring that cannot hold the model loads nothing
    await engine.ensure_shard(self.node.get_current_shard(shard))
    if getattr(engine, "diffusion", None) is not None:
      raise NotImplementedError(f"{shard.model_id} is an image-generation model; use /v1/image/generations")
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

  async def _collect_all_tokens(self, request_id: str, gen_task: asyncio.Task) -> list[int]:
    """Drain the request's token queue to its finish event."""
    all_tokens: list[int] = []
    while True:
      tokens, is_finished = await self._next_tokens(request_id, gen_task)
      all_tokens.extend(tokens)
      if is_finished:
        return all_tokens

  def _error_response(self, e: Exception) -> _Response:
    """A generation request's failure → its status: 408 timeout, 400 too
    long a prompt, an unknown adapter or an image the server cannot take, a structured 429 for an overload
    refusal (a full queue or page pool, a rate limit, a deadline shed,
    every adapter slot pinned), 507 for a ring that cannot hold the model,
    501 for what the engine cannot serve (text on an image model), else
    500."""
    if isinstance(e, asyncio.TimeoutError):
      return json_response({"detail": "Response generation timed out"}, 408)
    if isinstance(e, PromptTooLongError):
      return json_response({"error": {"message": str(e), "type": "invalid_request_error", "code": "context_length_exceeded"}}, 400)
    if isinstance(e, ImageInputError):
      return json_response({"error": {"message": str(e), "type": "invalid_request_error", "code": "invalid_image"}}, 400)
    if isinstance(e, UnknownAdapterError):
      return unknown_adapter_response(e)
    if isinstance(e, ServerOverloadedError):
      return overloaded_response(e)
    if isinstance(e, RingBudgetError):
      return json_response({"error": {"message": str(e), "type": "insufficient_resources"}}, 507)
    if isinstance(e, NotImplementedError):
      return json_response({"detail": str(e)}, 501)
    if DEBUG >= 1:
      import traceback

      traceback.print_exception(e)
    return json_response({"detail": f"Error processing prompt: {e}"}, 500)

  async def _close_request(self, request_id: str, gen_task: asyncio.Task | None) -> None:
    """Cancel an unfinished generation (a timeout, an error, a client gone,
    a stop string) and drop the request's state."""
    if gen_task is not None and not gen_task.done():
      self.node.cancel_request(request_id)
      try:
        await asyncio.wait_for(asyncio.shield(gen_task), timeout=30)
      except Exception:  # noqa: BLE001 — already reported to the client
        pass
    self.token_queues.pop(request_id, None)
    self.node.request_options.pop(request_id, None)

  def _start(self, shard, prompt: str, request_id: str, stream: bool, max_tokens, temperature, qos, adapter: str | None = None, images: list[str] | None = None) -> asyncio.Task:
    priority, tenant, deadline_ms = qos
    self.node.set_request_options(request_id, stream=stream, max_tokens=max_tokens, temperature=temperature, priority=priority, tenant=tenant, deadline_ms=deadline_ms, adapter=adapter)
    state = InferenceState(extras={"images": images}) if images else None
    return asyncio.create_task(self.node.process_prompt(shard, prompt, request_id, inference_state=state))

  def _serves_vision(self, model: str) -> bool:
    """Whether image parts become placeholders: a llava card, or a loaded
    model with a tower (a local checkpoint served under any id), as the
    reference decides."""
    card = registry.model_cards.get(model)
    engine_cfg = getattr(self.node.inference_engine, "cfg", None)
    return (card is not None and card.family == "llava") or getattr(engine_cfg, "vision", None) is not None

  async def handle_post_chat_completions(self, request, writer):
    try:
      data = request.json()
      chat_request = parse_chat_request(data, self.default_model)
      qos = parse_qos_fields(data, request.headers)
      adapter = self._resolve_adapter(data, request.headers, qos[1])
      stream_options = data.get("stream_options")
      if stream_options is not None and not isinstance(stream_options, dict):
        raise ValueError("'stream_options' must be an object")
    except UnknownAdapterError as e:
      return unknown_adapter_response(e)
    except ValueError as e:
      return json_response({"error": str(e)}, 400)
    include_usage = bool((stream_options or {}).get("include_usage"))
    shard = registry.build_base_shard(chat_request.model, self.inference_engine_classname)
    if shard is None:
      supported = registry.get_supported_models([[self.inference_engine_classname]])
      return json_response({"detail": f"Unsupported model: {chat_request.model} with engine {self.inference_engine_classname}. Supported: {supported}"}, 400)
    if self.system_prompt and not any(m.role == "system" for m in chat_request.messages):
      chat_request.messages.insert(0, Message("system", self.system_prompt))

    if chat_request.logprobs and (refusal := self._ring_logprobs_refusal(shard)) is not None:
      return refusal
    request_id = str(uuid.uuid4())
    self.token_queues[request_id] = asyncio.Queue()
    created = int(time.time())
    gen_task = None
    try:
      tokenizer = await self._tokenizer_for(shard)
      messages, images = remap_messages(chat_request.messages, vision=self._serves_vision(chat_request.model))
      prompt = build_prompt(tokenizer, messages, chat_request.tools)
      # Usage costs one more encode: paid where it is reported (blocking
      # always, streaming with stream_options.include_usage).
      prompt_ids = tokenizer.encode(prompt) if not chat_request.stream or include_usage else []
      gen_task = self._start(shard, prompt, request_id, chat_request.stream, chat_request.max_tokens, chat_request.temperature, qos, adapter, images)
      if chat_request.stream:
        return await self._stream_response(writer, chat_request, request_id, tokenizer, created, gen_task, len(prompt_ids), include_usage)
      await asyncio.wait_for(asyncio.shield(gen_task), timeout=self.response_timeout)
      return await self._blocking_response(chat_request, request_id, tokenizer, created, prompt_ids, gen_task, shard)
    except Exception as e:  # noqa: BLE001 — the API boundary reports every failure with its status
      return self._error_response(e)
    finally:
      await self._close_request(request_id, gen_task)

  async def handle_post_completions(self, request, writer):
    """Legacy text completions (``/v1/completions``): the prompt runs raw,
    with no chat template, through the same generation. Takes
    ``max_tokens``, ``temperature``, ``stop``, ``stream``, ``echo`` and
    OpenAI's integer ``logprobs`` (the top-N per generated token, scored
    after the generation; blocking only)."""
    try:
      data = request.json()
      if not isinstance(data, dict):
        raise ValueError("invalid JSON body")
    except ValueError as e:
      return json_response({"error": str(e)}, 400)
    prompt = data.get("prompt")
    if isinstance(prompt, list):
      if len(prompt) != 1 or not isinstance(prompt[0], str):
        return json_response({"error": "'prompt' must be a string (or a single-element list of one)"}, 400)
      prompt = prompt[0]
    if not isinstance(prompt, str) or not prompt:
      return json_response({"error": "'prompt' must be a non-empty string"}, 400)
    logprobs_n = data.get("logprobs")
    if logprobs_n is not None and (not isinstance(logprobs_n, int) or isinstance(logprobs_n, bool) or not 0 <= logprobs_n <= 20):
      return json_response({"error": "'logprobs' must be an integer in [0, 20]"}, 400)
    if logprobs_n and data.get("stream"):
      return json_response({"error": "'logprobs' is not supported with 'stream': true"}, 400)
    try:
      # The chat validation checks the shared fields.
      base = parse_chat_request({**data, "messages": [{"role": "user", "content": prompt}], "logprobs": False, "top_logprobs": 0}, self.default_model)
      qos = parse_qos_fields(data, request.headers)
      adapter = self._resolve_adapter(data, request.headers, qos[1])
    except UnknownAdapterError as e:
      return unknown_adapter_response(e)
    except ValueError as e:
      return json_response({"error": str(e)}, 400)
    shard = registry.build_base_shard(base.model, self.inference_engine_classname)
    if shard is None:
      return json_response({"detail": f"Unsupported model: {base.model}"}, 400)
    if logprobs_n and (refusal := self._ring_logprobs_refusal(shard)) is not None:
      return refusal

    request_id = str(uuid.uuid4())
    self.token_queues[request_id] = asyncio.Queue()
    created = int(time.time())
    gen_task = None

    def chunk(text: str, finish_reason, logprobs=None) -> dict:
      return {"id": f"cmpl-{request_id}", "object": "text_completion", "created": created, "model": base.model, "choices": [{"index": 0, "text": text, "logprobs": logprobs, "finish_reason": finish_reason}]}

    try:
      tokenizer = await self._tokenizer_for(shard)
      prompt_ids = list(tokenizer.encode(prompt))
      gen_task = self._start(shard, prompt, request_id, base.stream, base.max_tokens, base.temperature, qos, adapter)
      if base.stream:
        return await self._run_sse_stream(writer, request_id, tokenizer, base.stop, gen_task, lambda delta: chunk(delta, None), lambda reason: chunk("", reason))
      await asyncio.wait_for(asyncio.shield(gen_task), timeout=self.response_timeout)
      all_tokens = await self._collect_all_tokens(request_id, gen_task)
      eos_set = self._eos_set(tokenizer)
      text = tokenizer.decode([t for t in all_tokens if t not in eos_set])
      finish_reason = self._finish_reason(tokenizer, all_tokens[-1] if all_tokens else -1)
      stop_cut = False
      if base.stop:
        cut, _ = find_stop(text, base.stop)
        if cut is not None:
          text, finish_reason, stop_cut = text[:cut], "stop", True
      logprobs_obj = None
      if logprobs_n:
        scored = await self._score_logprobs(shard, prompt_ids, all_tokens, logprobs_n)
        if scored is not None:
          chosen_lp, top_ids, top_lp = scored
          toks, offsets, keep = await asyncio.to_thread(_align_logprobs, tokenizer, all_tokens, eos_set, text, len(prompt), stop_cut)
          logprobs_obj = {
            "tokens": toks,
            "token_logprobs": [float(chosen_lp[i]) for i in keep],
            "top_logprobs": [{tokenizer.decode([int(tid)]): float(tlp) for tid, tlp in zip(top_ids[i][:logprobs_n], top_lp[i][:logprobs_n])} for i in keep],
            "text_offset": offsets,
          }
      if data.get("echo"):
        text = prompt + text
      usage = {"prompt_tokens": len(prompt_ids), "completion_tokens": len(all_tokens), "total_tokens": len(prompt_ids) + len(all_tokens)}
      return json_response({**chunk(text, finish_reason, logprobs_obj), "system_fingerprint": "xot_tpu_0.1.0", "usage": usage})
    except Exception as e:  # noqa: BLE001 — the API boundary reports every failure with its status
      return self._error_response(e)
    finally:
      await self._close_request(request_id, gen_task)

  def _ring_logprobs_refusal(self, shard) -> _Response | None:
    """A 400 when this node holds only part of the model (a ring node):
    the scoring forward needs every layer on one node, and the reference's
    silent omission of the field is not mirrored."""
    own = self.node.get_current_shard(shard)
    if own.is_first_layer and own.is_last_layer:
      return None
    return json_response({"error": {"message": f"logprobs need the whole model on one node; this ring splits it (this node holds layers {own.start_layer}-{own.end_layer})", "type": "invalid_request_error", "code": "logprobs_unsupported"}}, 400)

  async def _score_logprobs(self, shard, prompt_ids, gen_tokens, top_n: int):
    """(chosen_lp, top_ids, top_lp) for the generated tokens, scored in one
    forward over prompt and completion; None when there is nothing to
    score or the scoring failed (logprobs are decoration: the response
    still goes out, as in the reference)."""
    if not prompt_ids or not gen_tokens:
      return None
    try:
      return await self.node.score_tokens(shard, list(prompt_ids) + list(gen_tokens), len(gen_tokens), max(top_n, 1))
    except Exception as e:  # noqa: BLE001 — reported, and the response goes out without logprobs
      print(f"[api] logprobs scoring failed: {e}")
      if DEBUG >= 1:
        import traceback

        traceback.print_exc()
      return None

  @staticmethod
  def _chat_logprobs(tokenizer, token_ids, scored, top_n: int) -> dict | None:
    """The chat body's ``logprobs``: one entry per generated token."""
    if scored is None:
      return None
    chosen_lp, top_ids, top_lp = scored

    def entry(tid: int, lp: float) -> dict:
      s = tokenizer.decode([int(tid)])
      return {"token": s, "logprob": float(lp), "bytes": list(s.encode())}

    content = []
    for i, t in enumerate(token_ids):
      e = entry(t, chosen_lp[i])
      e["top_logprobs"] = [entry(int(tid), float(tlp)) for tid, tlp in zip(top_ids[i][:top_n], top_lp[i][:top_n])]
      content.append(e)
    return {"content": content, "refusal": None}

  async def _blocking_response(self, chat_request, request_id, tokenizer, created, prompt_ids, gen_task, shard):
    all_tokens = await self._collect_all_tokens(request_id, gen_task)
    eos_set = self._eos_set(tokenizer)
    content = tokenizer.decode([t for t in all_tokens if t not in eos_set])
    finish_reason = self._finish_reason(tokenizer, all_tokens[-1] if all_tokens else -1)
    if chat_request.stop:
      cut, _ = find_stop(content, chat_request.stop)
      if cut is not None:
        content, finish_reason = content[:cut], "stop"
    logprobs_obj = None
    if chat_request.logprobs:
      # Every generated token is scored, a trailing EOS and tokens past a
      # stop-string cut included (token and text boundaries differ there).
      scored = await self._score_logprobs(shard, prompt_ids, all_tokens, chat_request.top_logprobs)
      logprobs_obj = self._chat_logprobs(tokenizer, all_tokens, scored, chat_request.top_logprobs)
    prompt_tokens = len(prompt_ids)
    return json_response({
      "id": f"chatcmpl-{request_id}",
      "object": "chat.completion",
      "created": created,
      "model": chat_request.model,
      "system_fingerprint": "xot_tpu_0.1.0",
      "choices": [{"index": 0, "message": {"role": "assistant", "content": content}, "logprobs": logprobs_obj, "finish_reason": finish_reason}],
      "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": len(all_tokens), "total_tokens": prompt_tokens + len(all_tokens)},
    })

  async def _stream_response(self, writer, chat_request, request_id, tokenizer, created, gen_task, prompt_tokens: int, include_usage: bool):
    def trailer(n_completion: int) -> dict | None:
      if not include_usage:  # OpenAI stream_options.include_usage: a last, usage-only chunk
        return None
      usage = completion_chunk(request_id, chat_request.model, created, None, None)
      usage["choices"] = []
      usage["usage"] = {"prompt_tokens": prompt_tokens, "completion_tokens": n_completion, "total_tokens": prompt_tokens + n_completion}
      return usage

    return await self._run_sse_stream(
      writer, request_id, tokenizer, chat_request.stop, gen_task,
      lambda delta: completion_chunk(request_id, chat_request.model, created, delta, None),
      lambda reason: completion_chunk(request_id, chat_request.model, created, None, reason),
      trailer,
    )

  async def _run_sse_stream(self, writer, request_id, tokenizer, stops, gen_task, make_delta_chunk, make_finish_chunk, make_trailer_chunk=None):
    """The one SSE token loop of both endpoints: incremental
    detokenization (decode the whole list, emit the new suffix), stop-string
    hold-back, finish_reason from the raw final batch, and an optional
    trailer chunk (``make_trailer_chunk(n_completion)``, usage). The chunk
    shapes come from the callbacks. The first batch is fetched before the
    response is committed, so errors known at admission still get their
    HTTP status; later ones are reported in-band."""
    tokens, is_finished = await self._next_tokens(request_id, gen_task)
    stream = _SSEStream(writer)
    await stream.prepare()
    eos_set = self._eos_set(tokenizer)
    all_tokens: list[int] = []
    n_completion = 0
    emitted_text = ""
    try:
      while True:
        n_completion += len(tokens)
        all_tokens.extend(t for t in tokens if t not in eos_set)
        full_text = tokenizer.decode(all_tokens) if all_tokens else ""
        cut, safe_len = None, len(full_text)
        if stops:
          cut, safe_len = find_stop(full_text, stops)
          if cut is not None:
            full_text = full_text[:cut]
          elif is_finished:
            safe_len = len(full_text)
        delta = full_text[len(emitted_text):safe_len]
        if delta:
          emitted_text = full_text[:safe_len]
          await stream.event(make_delta_chunk(delta))
        if cut is not None:
          await stream.event(make_finish_chunk("stop"))
          break
        if is_finished:
          await stream.event(make_finish_chunk(self._finish_reason(tokenizer, tokens[-1] if tokens else -1)))
          break
        tokens, is_finished = await self._next_tokens(request_id, gen_task)
      trailer = make_trailer_chunk(n_completion) if make_trailer_chunk is not None else None
      if trailer is not None:
        await stream.event(trailer)
    except (ConnectionResetError, BrokenPipeError):
      return None  # client gone; the handler cancels the generation
    except Exception as e:  # noqa: BLE001 — the response is committed: report in-band
      detail = "Response generation timed out" if isinstance(e, asyncio.TimeoutError) else f"Error processing prompt: {e}"
      await stream.event({"error": {"message": detail}})
    await stream.write(b"data: [DONE]\n\n")
    return None
