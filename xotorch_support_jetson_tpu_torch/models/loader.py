"""HF safetensors → decoder params, shard-aware, for the dense families.
Counterpart of ``load_shard_weights`` in the reference's
``models/loader.py``.

The port reads and writes ``.safetensors`` with its own small codec (an
8-byte header length, a JSON header, raw little-endian tensor bytes) and
``torch.frombuffer`` — bf16 needs no ``ml_dtypes`` and no ``safetensors``
package. Per-layer tensors are stacked into the reference's [L, ...] leaves;
HF ``[out, in]`` projections are transposed to ``[in, out]`` once, here.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path

import torch

from ..inference.shard import Shard
from ..utils.helpers import DEBUG
from .config import ModelConfig
from .decoder import Params

_ST_DTYPES = {
  "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
  "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

# HF per-layer suffix → (our key, transpose?)
_LAYER_MAP: dict[str, tuple[str, bool]] = {
  "input_layernorm.weight": ("attn_norm", False),
  "self_attn.q_proj.weight": ("wq", True),
  "self_attn.k_proj.weight": ("wk", True),
  "self_attn.v_proj.weight": ("wv", True),
  "self_attn.o_proj.weight": ("wo", True),
  "self_attn.q_proj.bias": ("bq", False),
  "self_attn.k_proj.bias": ("bk", False),
  "self_attn.v_proj.bias": ("bv", False),
  "self_attn.q_norm.weight": ("q_norm", False),
  "self_attn.k_norm.weight": ("k_norm", False),
  "post_attention_layernorm.weight": ("mlp_norm", False),
  "mlp.gate_proj.weight": ("w_gate", True),
  "mlp.up_proj.weight": ("w_up", True),
  "mlp.down_proj.weight": ("w_down", True),
}


# ------------------------------------------------------------ safetensors codec


def read_safetensors_header(path: str | Path) -> tuple[dict, int]:
  """(header dict, byte offset of the data section)."""
  with open(path, "rb") as f:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n)), 8 + n


def iter_safetensors(path: str | Path, names=None):
  """Yield (name, CPU tensor) for the tensors of one file (all, or ``names``)."""
  header, base = read_safetensors_header(path)
  with open(path, "rb") as f:
    for name, info in header.items():
      if name == "__metadata__" or (names is not None and name not in names):
        continue
      start, end = info["data_offsets"]
      buf = bytearray(end - start)
      f.seek(base + start)
      f.readinto(buf)
      dtype = _ST_DTYPES[info["dtype"]]
      t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
      yield name, t.reshape(info["shape"])


def save_safetensors(path: str | Path, tensors: dict[str, torch.Tensor], metadata: dict | None = None) -> None:
  """Write ``tensors`` as one ``.safetensors`` file (readable by HF tools)."""
  header: dict = {"__metadata__": dict(metadata or {"format": "pt"})}
  offset = 0
  flat = {}
  for name, t in tensors.items():
    t = t.detach().contiguous().cpu()
    nbytes = t.numel() * t.element_size()
    header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
    flat[name] = t
    offset += nbytes
  raw = json.dumps(header, separators=(",", ":")).encode()
  raw += b" " * (-len(raw) % 8)  # the format pads the header to 8 bytes
  with open(path, "wb") as f:
    f.write(struct.pack("<Q", len(raw)))
    f.write(raw)
    for t in flat.values():
      if t.numel():
        f.write(t.reshape(-1).view(torch.uint8).numpy().data)


# ------------------------------------------------------------ loading


def _weight_files_for_shard(model_dir: Path, shard: Shard) -> list[Path]:
  index_path = model_dir / "model.safetensors.index.json"
  if not index_path.exists():
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
      raise FileNotFoundError(f"no safetensors files under {model_dir}")
    return files
  with open(index_path) as f:
    weight_map: dict[str, str] = json.load(f)["weight_map"]
  needed: set[str] = set()
  for name, fname in weight_map.items():
    m = _LAYER_RE.match(name)
    if m:
      if shard.start_layer <= int(m.group(1)) <= shard.end_layer:
        needed.add(fname)
    elif name.startswith("model.embed_tokens") and (shard.is_first_layer or shard.is_last_layer):
      needed.add(fname)
    elif (name.startswith("model.norm") or name.startswith("lm_head")) and shard.is_last_layer:
      needed.add(fname)
  return [model_dir / f for f in sorted(needed)]


def load_shard_weights(model_dir: str | Path, cfg: ModelConfig, shard: Shard, device=None) -> Params:
  """Load a shard's params from HF safetensors into the decoder layout, in
  ``cfg.dtype`` on ``device``."""
  model_dir = Path(model_dir)
  per_layer: dict[int, dict[str, torch.Tensor]] = {i: {} for i in range(shard.start_layer, shard.end_layer + 1)}
  top: dict[str, torch.Tensor] = {}

  def put(t: torch.Tensor, transpose: bool) -> torch.Tensor:
    t = t.to(device=device, dtype=cfg.dtype)
    return t.T.contiguous() if transpose else t

  for file in _weight_files_for_shard(model_dir, shard):
    for name, t in iter_safetensors(file):
      m = _LAYER_RE.match(name)
      if m:
        idx, suffix = int(m.group(1)), m.group(2)
        if not (shard.start_layer <= idx <= shard.end_layer):
          continue
        if suffix in _LAYER_MAP:
          key, transpose = _LAYER_MAP[suffix]
          per_layer[idx][key] = put(t, transpose)
        elif suffix == "self_attn.qkv_proj.weight":  # phi3: fused [q+k+v, D]
          qd, kd = cfg.q_dim, cfg.kv_dim
          per_layer[idx]["wq"] = put(t[:qd], True)
          per_layer[idx]["wk"] = put(t[qd : qd + kd], True)
          per_layer[idx]["wv"] = put(t[qd + kd :], True)
        elif suffix == "mlp.gate_up_proj.weight":  # phi3: fused [2F, D]
          per_layer[idx]["w_gate"] = put(t[: cfg.hidden_dim], True)
          per_layer[idx]["w_up"] = put(t[cfg.hidden_dim :], True)
        elif DEBUG >= 3:
          print(f"[loader] skipping unmapped tensor {name}")
      elif name == "model.embed_tokens.weight":
        if shard.is_first_layer or (shard.is_last_layer and cfg.tied_embedding):
          top["embed"] = put(t, False)
      elif name == "model.norm.weight" and shard.is_last_layer:
        top["final_norm"] = put(t, False)
      elif name == "lm_head.weight" and shard.is_last_layer:
        top["lm_head"] = put(t, True)

  indices = list(per_layer)
  layer_keys = sorted(per_layer[indices[0]])
  for idx in indices:
    missing = set(layer_keys) - set(per_layer[idx])
    if missing:
      raise ValueError(f"layer {idx}: missing tensors {sorted(missing)}")
  params: Params = {"layers": {key: torch.stack([per_layer[i].pop(key) for i in indices]) for key in layer_keys}}
  if shard.is_first_layer:
    params["embed"] = top["embed"]
  if shard.is_last_layer:
    params["final_norm"] = top["final_norm"]
    if "lm_head" in top:
      params["lm_head"] = top["lm_head"]
    elif cfg.tied_embedding:
      if not shard.is_first_layer:
        params["lm_head"] = top["embed"].T.contiguous()
    else:
      raise ValueError("last shard: no lm_head weight and embeddings not tied")
  check_shard_params(params, cfg, shard)
  return params


def check_shard_params(params: Params, cfg: ModelConfig, shard: Shard) -> None:
  """Shape validator for a dense shard."""
  L = shard.n_shard_layers
  expect = {
    "attn_norm": (L, cfg.dim),
    "wq": (L, cfg.dim, cfg.q_dim),
    "wk": (L, cfg.dim, cfg.kv_dim),
    "wv": (L, cfg.dim, cfg.kv_dim),
    "wo": (L, cfg.q_dim, cfg.dim),
    "mlp_norm": (L, cfg.dim),
    "w_gate": (L, cfg.dim, cfg.hidden_dim),
    "w_up": (L, cfg.dim, cfg.hidden_dim),
    "w_down": (L, cfg.hidden_dim, cfg.dim),
  }
  if cfg.qkv_bias:
    expect.update({"bq": (L, cfg.q_dim), "bk": (L, cfg.kv_dim), "bv": (L, cfg.kv_dim)})
  if cfg.qk_norm:
    expect.update({"q_norm": (L, cfg.head_dim), "k_norm": (L, cfg.head_dim)})
  layers = params.get("layers", {})
  for key, shape in expect.items():
    if key not in layers:
      raise ValueError(f"layers/{key}: missing")
    if tuple(layers[key].shape) != shape:
      raise ValueError(f"layers/{key}: expected {shape}, got {tuple(layers[key].shape)}")
  if shard.is_first_layer and tuple(params["embed"].shape) != (cfg.vocab_size, cfg.dim):
    raise ValueError(f"embed: expected {(cfg.vocab_size, cfg.dim)}, got {tuple(params['embed'].shape)}")
  if shard.is_last_layer and "lm_head" in params and tuple(params["lm_head"].shape) != (cfg.dim, cfg.vocab_size):
    raise ValueError(f"lm_head: expected {(cfg.dim, cfg.vocab_size)}, got {tuple(params['lm_head'].shape)}")
