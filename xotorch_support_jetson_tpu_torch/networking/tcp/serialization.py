"""The peer wire format: frames of a JSON header and raw tensor bytes.

The port carries the reference's RPC set (``networking/grpc/
node_service.proto``) over the standard library's asyncio streams: no
grpcio or protobuf on the card's machine. It is not wire-compatible with
the JAX package's nodes. A frame is

    u32 header length | u32 payload length | header (UTF-8 JSON) | payload

with both lengths big-endian. The header names the message and carries
its fields; each tensor is a descriptor in the header (``dtype``,
``shape``, ``kind``, ``offset``, ``nbytes``) over the payload's bytes. A
``torch`` tensor keeps its dtype on the wire (bf16 stays 2 bytes per
element: numpy has no bfloat16) and arrives as a torch tensor; a numpy
array (token ids, the dummy engine's values) arrives as a numpy array.
Only the dtypes in ``_DTYPES`` are accepted, and nothing a peer sends is
unpickled. The inference state travels as its tokens (a tensor), its two
positions and its extras as JSON; the topology as the reference's proto
carries it (capabilities and neighbour ids, no edge descriptions).
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ...inference.shard import Shard
from ...inference.state import InferenceState
from ...topology.device_capabilities import DeviceCapabilities
from ...topology.topology import Topology

_PREFIX = struct.Struct(">II")
PREFIX_BYTES = _PREFIX.size
MAX_HEADER_BYTES = 16 * 1024 * 1024
MAX_PAYLOAD_BYTES = 256 * 1024 * 1024  # the reference's gRPC message limit

_DTYPES = {
  "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16, "float64": torch.float64,
  "int64": torch.int64, "int32": torch.int32, "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_TORCH_NAMES = {v: k for k, v in _DTYPES.items()}
_NUMPY_NAMES = frozenset(_DTYPES) - {"bfloat16"}  # numpy has no bfloat16


class WireError(ValueError):
  """A frame that does not parse, or a tensor of a dtype the wire refuses."""


def _tensor_bytes(t) -> tuple[dict, bytes]:
  if isinstance(t, torch.Tensor):
    name = _TORCH_NAMES.get(t.dtype)
    if name is None:
      raise WireError(f"tensor dtype {t.dtype} does not travel")
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    data = flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
    return {"kind": "torch", "dtype": name, "shape": list(t.shape)}, data
  arr = np.asarray(t)
  if str(arr.dtype) not in _NUMPY_NAMES:
    raise WireError(f"array dtype {arr.dtype} does not travel")
  return {"kind": "numpy", "dtype": str(arr.dtype), "shape": list(arr.shape)}, arr.tobytes()


def _tensor_from(desc: dict, payload: memoryview):
  name, shape = desc.get("dtype"), tuple(int(s) for s in desc.get("shape", ()))
  if name not in _DTYPES:
    raise WireError(f"dtype {name!r} does not travel")
  start, n = int(desc["offset"]), int(desc["nbytes"])
  if start < 0 or n < 0 or start + n > len(payload):
    raise WireError("tensor bytes out of the frame")
  raw = payload[start : start + n]
  if desc.get("kind") == "torch":
    dtype = _DTYPES[name]
    count = int(np.prod(shape)) if shape else 1
    if n != count * torch.empty((), dtype=dtype).element_size():
      raise WireError("tensor bytes do not match its shape")
    if n == 0:
      return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dtype).reshape(shape)
  if name not in _NUMPY_NAMES:
    raise WireError(f"dtype {name!r} does not travel as an array")
  arr = np.frombuffer(raw, dtype=np.dtype(name))
  if arr.size != (int(np.prod(shape)) if shape else 1):
    raise WireError("array bytes do not match its shape")
  return arr.reshape(shape).copy()


def encode_frame(header: dict, tensors: dict | None = None) -> bytes:
  """One frame: ``header`` plus ``tensors`` (name → tensor or array, None
  entries left out), each described under ``header["tensors"]``."""
  parts, descs, offset = [], {}, 0
  for name, t in (tensors or {}).items():
    if t is None:
      continue
    desc, data = _tensor_bytes(t)
    desc.update(offset=offset, nbytes=len(data))
    descs[name] = desc
    parts.append(data)
    offset += len(data)
  if descs:
    header = {**header, "tensors": descs}
  head = json.dumps(header, separators=(",", ":")).encode()
  if len(head) > MAX_HEADER_BYTES or offset > MAX_PAYLOAD_BYTES:
    raise WireError(f"frame too large: header {len(head)} B, payload {offset} B")
  return b"".join([_PREFIX.pack(len(head), offset), head, *parts])


def frame_lengths(prefix: bytes) -> tuple[int, int]:
  head_n, payload_n = _PREFIX.unpack(prefix)
  if head_n > MAX_HEADER_BYTES or payload_n > MAX_PAYLOAD_BYTES:
    raise WireError(f"frame too large: header {head_n} B, payload {payload_n} B")
  return head_n, payload_n


def decode_frame(head: bytes, payload: bytes) -> tuple[dict, dict]:
  """(header, tensors) of a frame's two parts."""
  try:
    header = json.loads(head)
  except (UnicodeDecodeError, json.JSONDecodeError) as e:
    raise WireError(f"malformed frame header: {e}") from None
  if not isinstance(header, dict):
    raise WireError("frame header is not an object")
  view = memoryview(payload)
  tensors = {name: _tensor_from(desc, view) for name, desc in (header.pop("tensors", None) or {}).items()}
  return header, tensors


async def read_frame(reader) -> tuple[dict, dict]:
  """The next frame from an ``asyncio.StreamReader`` (IncompleteReadError at
  the end of the stream)."""
  head_n, payload_n = frame_lengths(await reader.readexactly(PREFIX_BYTES))
  head = await reader.readexactly(head_n)
  payload = await reader.readexactly(payload_n) if payload_n else b""
  return decode_frame(head, payload)


# ------------------------------------------------------------ messages


def shard_from_dict(d: dict) -> Shard:
  return Shard(str(d["model_id"]), int(d["start_layer"]), int(d["end_layer"]), int(d["n_layers"]))


def state_fields(state: InferenceState | None) -> tuple[dict | None, object]:
  """(header fields, tokens) of an inference state."""
  if state is None:
    return None, None
  return {"curr_pos": int(state.curr_pos), "prompt_len": int(state.prompt_len), "extras": state.extras or {}}, state.tokens


def state_from(fields: dict | None, tokens) -> InferenceState | None:
  if fields is None:
    return None
  extras = fields.get("extras") or {}
  if not isinstance(extras, dict):
    raise WireError("state extras must be an object")
  return InferenceState(tokens=tokens, curr_pos=int(fields.get("curr_pos", 0)), prompt_len=int(fields.get("prompt_len", 0)), extras=extras)


def topology_to_dict(topology: Topology) -> dict:
  """The reference proto's topology: each node's capabilities and sorted
  neighbour ids, and the active node (edge descriptions do not travel)."""
  nodes = [{"node_id": nid, "capabilities": caps.to_dict(), "connected_to": sorted(topology.get_neighbors(nid))} for nid, caps in topology.nodes.items()]
  return {"nodes": nodes, "active_node_id": topology.active_node_id or ""}


def topology_from_dict(d: dict) -> Topology:
  topology = Topology()
  for node in d.get("nodes", []):
    topology.update_node(str(node["node_id"]), DeviceCapabilities.from_dict(node.get("capabilities") or {}))
    for neighbor in node.get("connected_to", []):
      topology.add_edge(str(node["node_id"]), str(neighbor))
  topology.active_node_id = d.get("active_node_id") or None
  return topology
