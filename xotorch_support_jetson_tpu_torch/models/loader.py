"""HF safetensors → decoder params, shard-aware. Counterpart of
``load_shard_weights`` in the reference's ``models/loader.py``.

The port reads and writes ``.safetensors`` with its own small codec (an
8-byte header length, a JSON header, raw little-endian tensor bytes) and
``torch.frombuffer`` — bf16 needs no ``ml_dtypes`` and no ``safetensors``
package. Per-layer tensors are stacked into the reference's [L, ...] leaves;
HF ``[out, in]`` projections are transposed to ``[in, out]`` once, here.
gemma2's zero-centred norm gains become ``1 + w`` in f32, and its layer
stack carries ``is_sliding`` [L] f32 flags from the global layer indices.
An MoE checkpoint (mixtral's ``block_sparse_moe.*`` names, qwen2-moe's and
qwen3-moe's ``mlp.*``) loads as a dense prefix ``layers`` (global layers
below ``first_k_dense``) and a ``moe_layers`` stack: its router, its shared
expert and gate, and each expert's projections written straight into the
stacked ``[L, E, D, F]`` / ``[L, E, F, D]`` leaves (no second copy of the
experts at any time). A deepseek-v2/v3 checkpoint's MLA projections load
as ``wq`` (or ``wq_a`` / ``q_a_norm`` / ``wq_b`` with a ``q_lora_rank``),
``wkv_a``, ``kv_a_norm`` and ``wkv_b``. A llava checkpoint prefixes its
decoder with ``language_model.`` (stripped here); its CLIP tower
(``vision_tower.vision_model.*``), its projector
(``multi_modal_projector.*``) and llava-next's ``image_newline`` load as
the ``vision`` and ``projector`` groups (models/vision.py), on the first
shard only: the node that embeds the prompt embeds the images.
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
from .decoder import Params, sliding_flags

_ST_DTYPES = {
  "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
  "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")
_NORM_KEYS = ("attn_norm", "post_attn_norm", "mlp_norm", "post_mlp_norm")

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
  # MLA (deepseek-v2/v3): q optionally LoRA-compressed; KV compressed to a
  # latent plus an MQA rope channel.
  "self_attn.q_a_proj.weight": ("wq_a", True),
  "self_attn.q_a_layernorm.weight": ("q_a_norm", False),
  "self_attn.q_b_proj.weight": ("wq_b", True),
  "self_attn.kv_a_proj_with_mqa.weight": ("wkv_a", True),
  "self_attn.kv_a_layernorm.weight": ("kv_a_norm", False),
  "self_attn.kv_b_proj.weight": ("wkv_b", True),
  "post_attention_layernorm.weight": ("mlp_norm", False),
  # gemma2's four-norm layout: input_layernorm / post_attention_layernorm
  # wrap attention (the latter is post_attn_norm under cfg.post_norms),
  # pre/post_feedforward_layernorm wrap the MLP.
  "pre_feedforward_layernorm.weight": ("mlp_norm", False),
  "post_feedforward_layernorm.weight": ("post_mlp_norm", False),
  "mlp.gate_proj.weight": ("w_gate", True),
  "mlp.up_proj.weight": ("w_up", True),
  "mlp.down_proj.weight": ("w_down", True),
  # MoE routers and shared experts (mixtral, qwen2-moe, qwen3-moe, deepseek)
  "block_sparse_moe.gate.weight": ("w_router", True),
  "mlp.gate.weight": ("w_router", True),
  "mlp.gate.e_score_correction_bias": ("router_bias", False),
  "mlp.shared_expert.gate_proj.weight": ("w_shared_gate", True),
  "mlp.shared_expert.up_proj.weight": ("w_shared_up", True),
  "mlp.shared_expert.down_proj.weight": ("w_shared_down", True),
  "mlp.shared_experts.gate_proj.weight": ("w_shared_gate", True),
  "mlp.shared_experts.up_proj.weight": ("w_shared_up", True),
  "mlp.shared_experts.down_proj.weight": ("w_shared_down", True),
  "mlp.shared_expert_gate.weight": ("w_shared_expert_gate", True),
}

# Per-expert projections `{block_sparse_moe|mlp}.experts.{e}.{proj}.weight`
# (mixtral names w1 / w3 / w2), stacked into [L, E, D, F] / [L, E, F, D].
_EXPERT_RE = re.compile(r"^(?:block_sparse_moe|mlp)\.experts\.(\d+)\.(w1|w2|w3|gate_proj|up_proj|down_proj)\.weight$")
_EXPERT_KEY = {"w1": "w_experts_gate", "gate_proj": "w_experts_gate", "w3": "w_experts_up", "up_proj": "w_experts_up", "w2": "w_experts_down", "down_proj": "w_experts_down"}

# llava's CLIP tower: per-layer suffix → (our key, transpose?), and the
# tower's and the projector's other tensors by name.
_VISION_LAYER_MAP = {
  "layer_norm1.weight": ("ln1_scale", False),
  "layer_norm1.bias": ("ln1_bias", False),
  "self_attn.q_proj.weight": ("wq", True),
  "self_attn.q_proj.bias": ("bq", False),
  "self_attn.k_proj.weight": ("wk", True),
  "self_attn.k_proj.bias": ("bk", False),
  "self_attn.v_proj.weight": ("wv", True),
  "self_attn.v_proj.bias": ("bv", False),
  "self_attn.out_proj.weight": ("wo", True),
  "self_attn.out_proj.bias": ("bo", False),
  "layer_norm2.weight": ("ln2_scale", False),
  "layer_norm2.bias": ("ln2_bias", False),
  "mlp.fc1.weight": ("fc1", True),
  "mlp.fc1.bias": ("bfc1", False),
  "mlp.fc2.weight": ("fc2", True),
  "mlp.fc2.bias": ("bfc2", False),
}
_VISION_TOP_MAP = {
  "vision_tower.vision_model.embeddings.class_embedding": "class_embed",
  "vision_tower.vision_model.embeddings.patch_embedding.weight": "patch_embed",
  "vision_tower.vision_model.embeddings.position_embedding.weight": "pos_embed",
  "vision_tower.vision_model.pre_layrnorm.weight": "pre_ln_scale",  # HF's spelling, as stored
  "vision_tower.vision_model.pre_layrnorm.bias": "pre_ln_bias",
}
_PROJECTOR_MAP = {
  "multi_modal_projector.linear_1.weight": ("w1", True),
  "multi_modal_projector.linear_1.bias": ("b1", False),
  "multi_modal_projector.linear_2.weight": ("w2", True),
  "multi_modal_projector.linear_2.bias": ("b2", False),
  "image_newline": ("image_newline", False),  # llava-next's row terminator
}
_VISION_LAYER_RE = re.compile(r"^vision_tower\.vision_model\.encoder\.layers\.(\d+)\.(.+)$")
_VISION_PREFIXES = ("vision_tower.", "multi_modal_projector.")


def _normalize_name(name: str) -> str:
  """llava prefixes its decoder with ``language_model.``: strip it so the
  decoder's maps apply."""
  return name[len("language_model.") :] if name.startswith("language_model.") else name


def _is_vision(raw_name: str) -> bool:
  return raw_name.startswith(_VISION_PREFIXES) or raw_name == "image_newline"


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
  for raw_name, fname in weight_map.items():
    name = _normalize_name(raw_name)
    m = _LAYER_RE.match(name)
    if m:
      if shard.start_layer <= int(m.group(1)) <= shard.end_layer:
        needed.add(fname)
    elif name.startswith("model.embed_tokens") and (shard.is_first_layer or shard.is_last_layer):
      needed.add(fname)
    elif (name.startswith("model.norm") or name.startswith("lm_head")) and shard.is_last_layer:
      needed.add(fname)
    elif _is_vision(raw_name) and shard.is_first_layer:
      needed.add(fname)
  return [model_dir / f for f in sorted(needed)]


def load_shard_weights(model_dir: str | Path, cfg: ModelConfig, shard: Shard, device=None) -> Params:
  """Load a shard's params from HF safetensors into the decoder layout, in
  ``cfg.dtype`` on ``device``."""
  model_dir = Path(model_dir)
  per_layer: dict[int, dict[str, torch.Tensor]] = {i: {} for i in range(shard.start_layer, shard.end_layer + 1)}
  top: dict[str, torch.Tensor] = {}
  # The dense prefix and the MoE stack, by global layer index.
  first_k = cfg.first_k_dense if cfg.n_experts else shard.end_layer + 1
  groups = {"layers": [i for i in per_layer if i < first_k], "moe_layers": [i for i in per_layer if i >= first_k]}
  moe_start = groups["moe_layers"][0] if groups["moe_layers"] else 0
  experts: dict[str, torch.Tensor] = {}  # key → [Lm, E, in, out], filled in place
  seen: dict[str, set] = {}
  vision_layers: dict[str, dict[int, torch.Tensor]] = {}
  vision_top: dict[str, torch.Tensor] = {}
  projector: dict[str, torch.Tensor] = {}
  with_vision = shard.is_first_layer and cfg.vision is not None

  def put(t: torch.Tensor, transpose: bool, key: str = "") -> torch.Tensor:
    t = t.to(device=device, dtype=torch.float32 if key == "router_bias" else cfg.dtype)
    return t.T.contiguous() if transpose else t

  def put_expert(key: str, layer: int, e: int, t: torch.Tensor) -> None:
    if key not in experts:
      experts[key] = torch.empty((len(groups["moe_layers"]), cfg.n_experts, t.shape[1], t.shape[0]), dtype=cfg.dtype, device=device)
    experts[key][layer - moe_start, e].copy_(t.to(device=device, dtype=cfg.dtype).T)
    seen.setdefault(key, set()).add((layer, e))

  def gain(t: torch.Tensor) -> torch.Tensor:
    """A gemma norm gain: HF computes x·(1 + w.float()) in f32, so the
    gain stays f32 (a bf16 1 + w loses every |w| < 2^-8)."""
    return t.to(device=device, dtype=torch.float32) + 1.0

  def wanted(raw_name: str) -> bool:
    """Read from disk only what the shard keeps (a ring node's range; the
    tower and projector on the first shard of a llava model)."""
    if _is_vision(raw_name):
      return with_vision
    name = _normalize_name(raw_name)
    m = _LAYER_RE.match(name)
    if m:
      return shard.start_layer <= int(m.group(1)) <= shard.end_layer
    if name == "model.embed_tokens.weight":
      return shard.is_first_layer or (shard.is_last_layer and cfg.tied_embedding)
    return name in ("model.norm.weight", "lm_head.weight") and shard.is_last_layer

  for file in _weight_files_for_shard(model_dir, shard):
    header, _ = read_safetensors_header(file)
    for raw_name, t in iter_safetensors(file, names={n for n in header if n != "__metadata__" and wanted(n)}):
      if _is_vision(raw_name):
        vm = _VISION_LAYER_RE.match(raw_name)
        if vm and vm.group(2) in _VISION_LAYER_MAP:
          key, transpose = _VISION_LAYER_MAP[vm.group(2)]
          vision_layers.setdefault(key, {})[int(vm.group(1))] = put(t, transpose)
        elif raw_name in _VISION_TOP_MAP:
          vision_top[_VISION_TOP_MAP[raw_name]] = put(t, False)
        elif raw_name in _PROJECTOR_MAP:
          key, transpose = _PROJECTOR_MAP[raw_name]
          projector[key] = put(t, transpose)
        elif DEBUG >= 3:
          print(f"[loader] skipping unmapped tensor {raw_name}")
        continue
      name = _normalize_name(raw_name)
      m = _LAYER_RE.match(name)
      if m:
        idx, suffix = int(m.group(1)), m.group(2)
        if suffix in _LAYER_MAP:
          key, transpose = _LAYER_MAP[suffix]
          if cfg.post_norms and suffix == "post_attention_layernorm.weight":
            key = "post_attn_norm"  # gemma2: this norm follows attention
          per_layer[idx][key] = gain(t) if cfg.post_norms and key in _NORM_KEYS else put(t, transpose, key)
        elif suffix == "self_attn.qkv_proj.weight":  # phi3: fused [q+k+v, D]
          qd, kd = cfg.q_dim, cfg.kv_dim
          per_layer[idx]["wq"] = put(t[:qd], True)
          per_layer[idx]["wk"] = put(t[qd : qd + kd], True)
          per_layer[idx]["wv"] = put(t[qd + kd :], True)
        elif suffix == "mlp.gate_up_proj.weight":  # phi3: fused [2F, D]
          per_layer[idx]["w_gate"] = put(t[: cfg.hidden_dim], True)
          per_layer[idx]["w_up"] = put(t[cfg.hidden_dim :], True)
        elif (em := _EXPERT_RE.match(suffix)) is not None and idx >= first_k:
          put_expert(_EXPERT_KEY[em.group(2)], idx, int(em.group(1)), t)
        elif DEBUG >= 3:
          print(f"[loader] skipping unmapped tensor {name}")
      elif name == "model.embed_tokens.weight":
        top["embed"] = put(t, False)
      elif name == "model.norm.weight":
        top["final_norm"] = gain(t) if cfg.post_norms else put(t, False)
      else:  # lm_head.weight
        top["lm_head"] = put(t, True)

  for key, got in seen.items():
    want = {(i, e) for i in groups["moe_layers"] for e in range(cfg.n_experts)}
    if got != want:
      raise ValueError(f"moe_layers/{key}: missing expert tensors {sorted(want - got)[:8]}")
  params: Params = {}
  for name, indices in groups.items():
    if not indices:
      continue
    layer_keys = sorted(per_layer[indices[0]])
    for idx in indices:
      missing = set(layer_keys) - set(per_layer[idx])
      if missing:
        raise ValueError(f"layer {idx}: missing tensors {sorted(missing)}")
    params[name] = {key: torch.stack([per_layer[i].pop(key) for i in indices]) for key in layer_keys}
    if cfg.sliding_window:
      params[name]["is_sliding"] = sliding_flags(cfg, indices, device)
  if groups["moe_layers"]:
    params["moe_layers"].update(experts)
  if shard.is_first_layer:
    params["embed"] = top["embed"]
    if vision_layers:
      L = cfg.vision.n_layers
      for key, by_idx in vision_layers.items():
        if sorted(by_idx) != list(range(L)):
          raise ValueError(f"vision/{key}: missing layers (have {sorted(by_idx)})")
      params["vision"] = {**vision_top, "layers": {key: torch.stack([by_idx.pop(i) for i in range(L)]) for key, by_idx in vision_layers.items()}}
      params["projector"] = projector
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
  """Shape validator (the reference's ``check_shard_params``): the dense
  stack, and an MoE model's ``moe_layers`` stack; MLA's projections in
  either layout (direct ``wq`` or the q LoRA)."""
  L = shard.n_shard_layers
  n_dense = sum(1 for i in range(shard.start_layer, shard.end_layer + 1) if i < cfg.first_k_dense) if cfg.n_experts else L

  def attn_expect(L: int) -> dict:
    if cfg.is_mla:
      H = cfg.n_heads
      expect = {
        "attn_norm": (L, cfg.dim),
        "wkv_a": (L, cfg.dim, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "kv_a_norm": (L, cfg.kv_lora_rank),
        "wkv_b": (L, cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "wo": (L, H * cfg.v_head_dim, cfg.dim),
        "mlp_norm": (L, cfg.dim),
      }
      if cfg.q_lora_rank:
        expect.update({"wq_a": (L, cfg.dim, cfg.q_lora_rank), "q_a_norm": (L, cfg.q_lora_rank), "wq_b": (L, cfg.q_lora_rank, H * cfg.qk_head_dim)})
      else:
        expect["wq"] = (L, cfg.dim, H * cfg.qk_head_dim)
      return expect
    expect = {
      "attn_norm": (L, cfg.dim),
      "wq": (L, cfg.dim, cfg.q_dim),
      "wk": (L, cfg.dim, cfg.kv_dim),
      "wv": (L, cfg.dim, cfg.kv_dim),
      "wo": (L, cfg.q_dim, cfg.dim),
      "mlp_norm": (L, cfg.dim),
    }
    if cfg.qkv_bias:
      expect.update({"bq": (L, cfg.q_dim), "bk": (L, cfg.kv_dim), "bv": (L, cfg.kv_dim)})
    if cfg.qk_norm:  # the decoder gates on the keys: a missing q/k norm fails here
      expect.update({"q_norm": (L, cfg.head_dim), "k_norm": (L, cfg.head_dim)})
    if cfg.post_norms:  # ...and a missing post-norm
      expect.update({"post_attn_norm": (L, cfg.dim), "post_mlp_norm": (L, cfg.dim)})
    if cfg.sliding_window:
      expect["is_sliding"] = (L,)
    return expect

  checks: dict[str, dict] = {}
  if n_dense:
    checks["layers"] = {**attn_expect(n_dense), "w_gate": (n_dense, cfg.dim, cfg.hidden_dim), "w_up": (n_dense, cfg.dim, cfg.hidden_dim), "w_down": (n_dense, cfg.hidden_dim, cfg.dim)}
  if L - n_dense:
    Lm, E, Fm, Fs = L - n_dense, cfg.n_experts, cfg.moe_hidden_dim, cfg.shared_expert_dim
    moe = {
      **attn_expect(Lm),
      "w_router": (Lm, cfg.dim, E),
      "w_experts_gate": (Lm, E, cfg.dim, Fm),
      "w_experts_up": (Lm, E, cfg.dim, Fm),
      "w_experts_down": (Lm, E, Fm, cfg.dim),
    }
    if Fs:
      moe.update({"w_shared_gate": (Lm, cfg.dim, Fs), "w_shared_up": (Lm, cfg.dim, Fs), "w_shared_down": (Lm, Fs, cfg.dim)})
      if cfg.shared_expert_gate:
        moe["w_shared_expert_gate"] = (Lm, cfg.dim, 1)
    checks["moe_layers"] = moe
  for name, expect in checks.items():
    stack = params.get(name, {})
    for key, shape in expect.items():
      if key not in stack:
        raise ValueError(f"{name}/{key}: missing")
      _check_leaf(f"{name}/{key}", stack, key, shape)
  if shard.is_first_layer and tuple(params["embed"].shape) != (cfg.vocab_size, cfg.dim):
    raise ValueError(f"embed: expected {(cfg.vocab_size, cfg.dim)}, got {tuple(params['embed'].shape)}")
  if shard.is_last_layer and "lm_head" in params:
    _check_leaf("lm_head", params, "lm_head", (cfg.dim, cfg.vocab_size))


def _check_leaf(path: str, group: dict, key: str, shape: tuple) -> None:
  """One weight leaf of ``shape`` [.., in, out]; quantized
  (models/quantize.py) when ``<key>_scale`` [.., out] f32 sits beside it:
  int8 codes of ``shape``, or packed int4 with a halved in-axis."""
  got = tuple(group[key].shape)
  scale = group.get(f"{key}_scale")
  if scale is None:
    if got != shape:
      raise ValueError(f"{path}: expected {shape}, got {got}")
    return
  packed = shape[:-2] + (shape[-2] // 2, shape[-1])
  if group[key].dtype != torch.int8 or got not in (shape, packed):
    raise ValueError(f"{path}: expected int8 codes {shape} or packed int4 {packed}, got {group[key].dtype} {got}")
  want = shape[:-2] + shape[-1:]
  if scale.dtype != torch.float32 or tuple(scale.shape) != want:
    raise ValueError(f"{path}_scale: expected float32 {want}, got {scale.dtype} {tuple(scale.shape)}")
