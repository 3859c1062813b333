"""Flash attention for prefill (K1) and decode (K2): CUDA kernels and their
plain PyTorch versions. Counterpart of the reference's
``ops/pallas_attention.py``.

Each wrapper takes the plain version for a tensor on the CPU and launches
its hand-written kernel (``csrc/flash_prefill.cu``, ``csrc/flash_decode.cu``)
for a CUDA tensor — or raises on what the kernel does not take. There is no
fallback from a CUDA tensor to the plain version. ``LAUNCHES`` counts kernel
launches per wrapper (one per successful launch, nowhere else), so a run can
show that its main path went through the kernels; a call recorded into a
CUDA graph launches at the graph's replays and is counted there
(``kernels.count_launch``).
"""

from __future__ import annotations

import os

import torch

from ..utils.helpers import env_flag
from .attention import gqa_attention
from .kernels import PREFILL_ROWS, check_cuda as _check_cuda, count_launch, decode_plan, decode_rows, load, prefill_plan, sm_count, stream_ptr as _stream_ptr

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = PREFILL_ROWS  # q heads per kv head one 64-row consumer warpgroup of K1 can hold

LAUNCHES = {"flash_prefill": 0, "flash_decode": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def _offsets(q_offset, B: int, device) -> torch.Tensor:
  """int or [B] → contiguous int32 [B] on ``device``. A Python int is
  filled on the device: a host copy would block on the stream."""
  if isinstance(q_offset, int):
    return torch.full((B,), q_offset, dtype=torch.int32, device=device)
  off = torch.as_tensor(q_offset, dtype=torch.int32, device=device)
  return off.expand(B).contiguous() if off.dim() == 0 else off.reshape(B).contiguous()


# ------------------------------------------------------------- K1: prefill


def flash_attention_prefill_ref(q, k, v, q_offset=0, k_scale=None, v_scale=None):
  """Plain version of K1 (dense formulation): causal GQA attention with
  query row i at absolute position ``q_offset[b] + i`` over cache slots
  ``j <= pos``; int8 codes with per-(slot, head) scales when given."""
  B, Sq = q.shape[:2]
  q_pos = _offsets(q_offset, B, q.device)[:, None] + torch.arange(Sq, dtype=torch.int32, device=q.device)[None, :]
  kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
  return gqa_attention(q, k, v, q_pos, kv_pos, k_scale=k_scale, v_scale=v_scale)


def flash_attention_prefill(q, k, v, q_offset=0, k_scale=None, v_scale=None):
  """q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd] → [B,Sq,Hq,hd] in q's dtype.

  ``q_offset`` — int or [B] int32: absolute position of each row's first
  query. With ``k_scale``/``v_scale`` [B,Skv,Hkv,1] f32, k/v are int8 codes
  (models/quantize.py quantize_kv). Any Sq and Skv: ragged edges are masked
  in the kernel, and slots past a row's position are masked by position
  (they may hold finite junk). On CUDA: bf16 q (and k/v unless int8),
  hd ∈ {64, 128, 256}, Hq a multiple of Hkv with Hq/Hkv ≤ 64, q/k/v
  16-byte aligned (the kernel's TMA reads them).
  """
  if (k_scale is None) != (v_scale is None):
    # A half-specified quant call would silently ignore v_scale (or read int8
    # v codes as values): fail loudly instead.
    raise ValueError("flash_attention_prefill: k_scale and v_scale must be passed together (int8-KV codes carry both scale leaves)")
  if q.device.type == "cpu":
    return flash_attention_prefill_ref(q, k, v, q_offset, k_scale, v_scale)
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention_prefill: no kernel for device {q.device}")
  B, Sq, Hq, hd = q.shape
  Skv, Hkv = k.shape[1], k.shape[2]
  quantized = k_scale is not None
  if hd not in HEAD_DIMS or Hq % Hkv or Hq // Hkv > MAX_GROUP:
    raise ValueError(f"flash_attention_prefill: unsupported geometry Hq={Hq} Hkv={Hkv} hd={hd}")
  kv_dtype = torch.int8 if quantized else torch.bfloat16
  _check_cuda("q", q, torch.bfloat16, (B, Sq, Hq, hd), q.device)
  _check_cuda("k", k, kv_dtype, (B, Skv, Hkv, hd), q.device)
  _check_cuda("v", v, kv_dtype, (B, Skv, Hkv, hd), q.device)
  if quantized:
    _check_cuda("k_scale", k_scale, torch.float32, (B, Skv, Hkv, 1), q.device)
    _check_cuda("v_scale", v_scale, torch.float32, (B, Skv, Hkv, 1), q.device)
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.data_ptr() % 16:  # the TMA reads q, k and v
      raise ValueError(f"flash_attention_prefill: {name} must be 16-byte aligned")
  offsets = _offsets(q_offset, B, q.device)
  out = torch.empty_like(q)
  plan = prefill_plan(hd, quantized, B, Sq, Hq, Hkv, sm_count(q.device.index))
  rc = load("flash_prefill")(
    q.data_ptr(), k.data_ptr(), v.data_ptr(),
    k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
    offsets.data_ptr(), out.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, int(quantized),
    plan["consumers"], plan["block_k"], plan["stages"], plan["smem"], _stream_ptr(q.device),
  )
  if rc != 0:
    raise RuntimeError(f"flash_prefill kernel launch failed (plan {plan}): cudaError {rc}")
  count_launch(LAUNCHES, "flash_prefill")
  return out


def flash_supported(q_shape, kv_len: int, device=None, dtype=torch.bfloat16) -> bool:
  """Whether a prefill (Sq > 1) takes K1: the tensors are on CUDA in bf16
  with a supported head dim, unless ``XOT_TPU_NO_FLASH`` is set. No tile-size
  condition: the kernel masks ragged Sq/Skv edges itself."""
  if os.getenv("XOT_TPU_NO_FLASH"):
    return False
  B, Sq, Hq, hd = q_shape
  return torch.device(device or "cpu").type == "cuda" and dtype == torch.bfloat16 and Sq > 1 and kv_len > 0 and hd in HEAD_DIMS


# -------------------------------------------------------------- K2: decode


def flash_decode_attention_ref(q, k, v, q_positions):
  """Plain version of K2: q [B,1,Hq,hd] against the slot cache up to
  ``q_positions`` [B,1] (inclusive)."""
  kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
  return gqa_attention(q, k, v, q_positions, kv_pos)


def flash_decode_attention(q, k, v, q_positions):
  """One-token decode attention: q [B,1,Hq,hd], k/v [B,Skv,Hkv,hd] (slot-
  indexed cache), q_positions [B,1] → [B,1,Hq,hd]. Work follows each row's
  live context: slots past its position are never read."""
  if q.device.type == "cpu":
    return flash_decode_attention_ref(q, k, v, q_positions)
  if q.device.type != "cuda":
    raise ValueError(f"flash_decode_attention: no kernel for device {q.device}")
  B, Sq, Hq, hd = q.shape
  Skv, Hkv = k.shape[1], k.shape[2]
  if Sq != 1 or hd not in HEAD_DIMS or Hq % Hkv:
    raise ValueError(f"flash_decode_attention: unsupported geometry Sq={Sq} Hq={Hq} Hkv={Hkv} hd={hd}")
  _check_cuda("q", q, torch.bfloat16, (B, 1, Hq, hd), q.device)
  _check_cuda("k", k, torch.bfloat16, (B, Skv, Hkv, hd), q.device)
  _check_cuda("v", v, torch.bfloat16, (B, Skv, Hkv, hd), q.device)
  for name, t in (("k", k), ("v", v)):
    if t.data_ptr() % 16:
      raise ValueError(f"flash_decode_attention: {name} must be 16-byte aligned")
  pos = q_positions.reshape(B).to(device=q.device, dtype=torch.int32).contiguous()
  cluster, range_ = decode_plan(Skv, decode_rows(B, Hq, Hkv), sm_count(q.device.index))
  out = torch.empty_like(q)
  rc = load("flash_decode")(
    q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(), B, Skv, Hq, Hkv, hd, cluster, range_, _stream_ptr(q.device)
  )
  if rc != 0:
    raise RuntimeError(f"flash_decode kernel launch failed (cluster of {cluster}, {range_} slots per block): cudaError {rc}")
  count_launch(LAUNCHES, "flash_decode")
  return out


def flash_decode_supported(q_shape, kv_len: int, device=None, dtype=torch.bfloat16) -> bool:
  """Use K2 for a decode step (Sq == 1) on a long cache. Opt-in
  (``XOT_TPU_FLASH_DECODE=1``, cache length ≥ ``XOT_TPU_FLASH_DECODE_MIN``,
  default 8192) as in the reference; whether it becomes the default is an
  H100 measurement (PERF.md)."""
  if os.getenv("XOT_TPU_NO_FLASH") or not env_flag("XOT_TPU_FLASH_DECODE"):
    return False
  B, Sq, Hq, hd = q_shape
  threshold = int(os.getenv("XOT_TPU_FLASH_DECODE_MIN", "8192"))
  return torch.device(device or "cpu").type == "cuda" and dtype == torch.bfloat16 and Sq == 1 and kv_len >= threshold and hd in HEAD_DIMS
