"""Weight and KV-cache quantization, int8 and packed int4. Counterpart of
the reference's ``models/quantize.py``.

Weights (``XOT_TPU_QUANT``): symmetric per-output-channel int8, or int4
packed two codes per byte along the IN axis (even in-rows in the low
nibble, odd in the high: ``[.., in/2, out]``). A quantized leaf keeps its
name and gains a sibling ``<name>_scale`` [.., out] f32 leaf. Stacked
expert leaves ([.., E, in, out]) are dequantized next to their product
(ops/moe.py, ``dequantize_leaf``), as in the reference. ``qdot``
computes a product with a two-dimensional quantized leaf: ``w8a16`` (int8 codes upcast
next to the product), ``w8a8`` (activations quantized per row too, an
int8×int8→int32 product), or packed int4, detected by the halved in-axis
(the K4 kernel, ops/int4_matmul.py).

KV cache: K/V vectors quantize at cache-write time, symmetric int8 per
(token, head); the scale rides as a sibling cache leaf with a trailing
[..., 1] axis. The attention read keeps the codes and applies the scales
outside the contraction (ops/attention.py gqa_attention, the K1 kernel's
int8 variant).
"""

from __future__ import annotations

import torch

# Weight leaves eligible for quantization (last two dims [in, out]; expert
# leaves carry an extra [E] axis), by parameter group, plus the top-level
# lm_head — the reference's table. Norm gains, biases, routers and the
# embedding table stay in the model dtype, and so do llava's ``vision`` and
# ``projector`` groups (the reference quantizes neither).
# ``quantize_params`` refuses any other parameter group.
_MLA_LEAVES = ("wq_a", "wq_b", "wkv_a", "wkv_b")
QUANT_STACK_LEAVES = {
  "layers": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", *_MLA_LEAVES),
  "moe_layers": (
    "wq", "wk", "wv", "wo", *_MLA_LEAVES,
    "w_experts_gate", "w_experts_up", "w_experts_down", "w_shared_gate", "w_shared_up", "w_shared_down",
  ),
}
QUANT_TOP_LEAVES = ("lm_head",)
_KNOWN_GROUPS = {*QUANT_STACK_LEAVES, "embed", "final_norm", "lm_head", "lm_head_scale", "vision", "projector"}


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-output-channel int8: w [..., in, out] → (q int8
  [..., in, out], scale f32 [..., out]), w ≈ q · scale[..., None, :]."""
  wf = w.float().contiguous()
  absmax = wf.abs().amax(dim=-2)
  scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
  return torch.round(wf / scale[..., None, :]).to(torch.int8), scale


def quantize_weight_int4(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-output-channel int4 packed along the in-axis: w
  [..., in, out] → (packed int8 [..., in/2, out], scale f32 [..., out])."""
  if w.shape[-2] % 2:
    raise ValueError(f"int4 packing needs an even in-dim; got {tuple(w.shape)}")
  wf = w.float().contiguous()
  absmax = wf.abs().amax(dim=-2)
  scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
  q = torch.clamp(torch.round(wf / scale[..., None, :]), -8, 7).to(torch.int8)
  lo = q[..., 0::2, :] & 0x0F
  hi = (q[..., 1::2, :] & 0x0F) << 4
  return (lo | hi).to(torch.int8).contiguous(), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
  """packed int8 [..., in/2, out] → int8 codes [..., in, out] (sign-extended)."""
  lo = (packed << 4) >> 4  # arithmetic shifts on int8 sign-extend the nibble
  hi = packed >> 4
  return torch.stack([lo, hi], dim=-2).reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def quantize_params(params: dict, mode: str = "int8") -> dict:
  """A shard's params with each eligible leaf ``w`` quantized (int8, or
  packed int4) beside a sibling ``w_scale``; a new dict, the input is not
  modified. Tied embeddings gain a quantized ``lm_head`` copy of
  ``embed.T`` (decode then reads ≤ 1 byte per parameter of the [D, V]
  head); the full-precision table stays for the embedding gather."""
  if mode not in ("int8", "int4"):
    raise ValueError(f"unsupported quantization mode {mode!r}")
  other = set(params) - _KNOWN_GROUPS
  if other:
    raise NotImplementedError(f"weight quantization in the PyTorch port covers the decoder's layer stacks and head only; got parameter groups {sorted(other)}")
  base = quantize_weight if mode == "int8" else quantize_weight_int4

  def quant(w):
    """A stacked expert leaf one layer at a time: its f32 working copies
    stay one layer's size (the codes are the same, per output channel)."""
    if w.dim() < 4:
      return base(w)
    codes, scales = zip(*(base(w[i]) for i in range(w.shape[0])))
    return torch.stack(codes), torch.stack(scales)

  out = dict(params)

  def fits(w) -> bool:
    return w.dtype != torch.int8 and not (mode == "int4" and w.shape[-2] % 2)  # odd in-dim: stays full precision

  for group, eligible in QUANT_STACK_LEAVES.items():
    if group not in params:
      continue
    stack = dict(params[group])
    for name in eligible:
      if name in stack and fits(stack[name]):
        stack[name], stack[f"{name}_scale"] = quant(stack[name])
    out[group] = stack
  for name in QUANT_TOP_LEAVES:
    if name in out and fits(out[name]):
      out[name], out[f"{name}_scale"] = quant(out[name])
  if "lm_head" not in out and "embed" in out and "final_norm" in out and not (mode == "int4" and out["embed"].shape[-1] % 2):
    out["lm_head"], out["lm_head_scale"] = quant(out["embed"].T)
  return out


def qdot(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, compute: str = "w8a16") -> torch.Tensor:
  """x [..., in] @ quantized w → [..., out] in x's dtype.

  ``w`` is int8 [in, out] or packed int4 [in/2, out] (detected by the
  halved in-axis). int4 goes through K4 (``ops/int4_matmul.py``) when
  ``int4_kernel_supported`` admits it — on a CUDA tensor that launches the
  kernel — else through the reference's two-dot product.
  ``compute='w8a8'`` quantizes x per row to int8 and runs an
  int8×int8→int32 product (int8 layout only)."""
  if w.shape[-2] * 2 == x.shape[-1]:  # packed int4
    from ..ops.int4_matmul import int4_kernel_supported, int4_matmul, int4_two_dot

    if w.dim() != 2:
      raise NotImplementedError("stacked (expert) int4 leaves are dequantized next to their product (ops/moe.py), not taken by qdot")
    x2 = x.reshape(-1, x.shape[-1])
    if int4_kernel_supported(x2.shape, w.shape):
      y = int4_matmul(x2.contiguous(), w, scale.float())
    else:
      y = int4_two_dot(x2, w, scale)
    return y.reshape(*x.shape[:-1], w.shape[-1])
  if compute == "w8a8":
    xf = x.float()
    row = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(row > 0, row / 127.0, torch.ones_like(row))
    xq = torch.round(xf / sx).to(torch.int8).reshape(-1, x.shape[-1])
    M = xq.shape[0]
    if xq.is_cuda and M <= 16:  # the CUDA int8 product takes more than 16 rows
      xq = torch.nn.functional.pad(xq, (0, 0, 0, 17 - M))
    acc = torch._int_mm(xq, w)[:M].reshape(*x.shape[:-1], w.shape[-1])
    return (acc.float() * sx * scale.float()).to(x.dtype)
  acc = (x @ w.to(x.dtype)).float()
  return (acc * scale.float()).to(x.dtype)


def is_quantized(p: dict, name: str) -> bool:
  return f"{name}_scale" in p


def dequantize_leaf(w: torch.Tensor, scale: torch.Tensor, in_dim: int, dtype) -> torch.Tensor:
  """A quantized leaf (int8, or packed int4 detected against the expected
  ``in_dim``) materialised back to ``dtype``."""
  if w.shape[-2] * 2 == in_dim:
    w = unpack_int4(w)
  return w.to(dtype) * scale[..., None, :].to(dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """x [..., hd] → (codes int8 [..., hd], scale f32 [..., 1])."""
  xf = x.float()
  absmax = xf.abs().amax(dim=-1, keepdim=True)
  scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
  return torch.round(xf / scale).to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
  """codes [..., hd] × scale [..., 1] → [..., hd] in ``dtype``."""
  return (codes.float() * scale).to(dtype)


# int4 KV: two 4-bit codes per int8 byte along the head dim (channel 2i in
# the low nibble, 2i+1 in the high), one f32 scale per (token, head) — the
# int8 scale machinery consumes the codes once they are unpacked to int8
# values in [-8, 7] (counterpart of the reference's quantize_kv_int4 /
# unpack_int4_kv).


def quantize_kv_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """x [..., hd] → (packed int8 [..., hd/2], scale f32 [..., 1])."""
  if x.shape[-1] % 2:
    raise ValueError(f"int4 KV packing needs an even head dim; got {tuple(x.shape)}")
  xf = x.float()
  absmax = xf.abs().amax(dim=-1, keepdim=True)
  scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
  q = torch.clamp(torch.round(xf / scale), -8, 7).to(torch.int8)
  lo = q[..., 0::2] & 0x0F
  hi = (q[..., 1::2] & 0x0F) << 4
  return (lo | hi).to(torch.int8), scale


def unpack_int4_kv(packed: torch.Tensor) -> torch.Tensor:
  """packed int8 [..., hd/2] → int8 codes [..., hd] (sign-extended, channel
  order restored)."""
  lo = (packed << 4) >> 4  # arithmetic shifts on int8 sign-extend the nibble
  hi = packed >> 4
  return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)
