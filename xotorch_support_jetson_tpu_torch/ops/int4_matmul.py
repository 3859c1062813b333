"""Packed-int4 weight matmul (K4): the CUDA kernel and its plain PyTorch
version. Counterpart of the reference's ``ops/pallas_int4.py``.

The contract is the packed layout ``models/quantize.py
quantize_weight_int4`` writes: w int8 [in/2, out], in-row 2r in the low
nibble and 2r+1 in the high, a per-output-channel f32 scale [out];
``y[t, f] = (Σ_d x[t, d]·unpack(w)[d, f])·scale[f]``.

``int4_matmul`` takes the plain version (``int4_matmul_ref``) for a tensor
on the CPU and launches the hand-written kernel ``csrc/int4_matmul.cu`` for
a CUDA tensor — or raises on what the kernel does not take. There is no
fallback from a CUDA tensor to the plain version. ``LAUNCHES`` counts
kernel launches.

Unlike the reference, the kernel is the default for every product
``int4_kernel_supported`` admits; ``XOT_TPU_INT4_KERNEL=0`` is the one way
to the non-kernel two-dot product (``int4_two_dot``) on a card.
"""

from __future__ import annotations

import torch

from ..utils.helpers import env_flag
from .kernels import check_cuda, load, stream_ptr

MAX_T = 256  # rows of x the kernel takes: decode (B ≤ slots) and short prefill
BLOCK_N = 256  # output channels per block of the kernel
CHUNK = 32  # packed rows per staged x chunk; a split covers a multiple of it
MIN_SPLIT_ROWS = 64  # fewest packed rows per in-split (bounds the partial-sum traffic)
TARGET_BLOCKS = 132 * 8  # blocks that fill the H100's 132 SMs several times over

LAUNCHES = {"int4_matmul": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def int4_two_dot(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """The reference's non-kernel product (``models/quantize.py`` qdot's
  two-dot formulation): x [..., in] with operands in x's dtype, each half
  summed in f32, then the scale → [..., out] in x's dtype."""
  lo = ((w_packed << 4) >> 4).to(x.dtype)  # arithmetic shifts sign-extend the low nibble
  hi = (w_packed >> 4).to(x.dtype)
  acc = (x[..., 0::2] @ lo).float() + (x[..., 1::2] @ hi).float()
  return (acc * scale.float()).to(x.dtype)


def int4_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """Plain version of K4, same signature as ``int4_matmul``: the two-dot
  formulation in f32, returned in x's dtype."""
  return int4_two_dot(x.float(), w_packed, scale).to(x.dtype)


def int4_kernel_supported(x_shape, w_shape) -> bool:
  """Whether qdot sends a packed-int4 product through ``int4_matmul``: 2-D
  operands, at most ``MAX_T`` rows, the halved in-axis, and no explicit
  ``XOT_TPU_INT4_KERNEL=0``. None of the TPU kernel's tile constraints
  apply: the kernel masks ragged edges."""
  if len(x_shape) != 2 or len(w_shape) != 2 or not env_flag("XOT_TPU_INT4_KERNEL", default=True):
    return False
  T, d_in = x_shape
  return T <= MAX_T and w_shape[-2] * 2 == d_in


def plan(T: int, d_in: int, d_out: int) -> tuple[int, int, int]:
  """(rows of x per block, in-splits, packed rows per split) for a launch:
  enough blocks to fill the card at decode shapes, each split a whole
  number of staged chunks and at least ``MIN_SPLIT_ROWS`` rows long."""
  tt = 1 if T <= 1 else 2 if T == 2 else 4 if T <= 4 else 8
  K = d_in // 2
  blocks = -(-d_out // BLOCK_N) * -(-T // tt)
  n_split = max(1, min(-(-TARGET_BLOCKS // blocks), K // MIN_SPLIT_ROWS))
  rows = -(-K // n_split)
  rows = -(-rows // CHUNK) * CHUNK
  return tt, -(-K // rows), rows


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """x [T, in] @ packed int4 w [in/2, out] → [T, out] in x's dtype.

  On CUDA: bf16 x, int8 w, f32 scale [out], all contiguous, T ≤ ``MAX_T``."""
  if x.device.type == "cpu":
    return int4_matmul_ref(x, w_packed, scale)
  if x.device.type != "cuda":
    raise ValueError(f"int4_matmul: no kernel for device {x.device}")
  if x.dim() != 2 or w_packed.dim() != 2 or x.shape[0] > MAX_T or w_packed.shape[0] * 2 != x.shape[1]:
    raise ValueError(f"int4_matmul: unsupported geometry x {tuple(x.shape)}, packed w {tuple(w_packed.shape)} (T ≤ {MAX_T}, w [in/2, out])")
  T, d_in = x.shape
  K, N = w_packed.shape
  dev = x.device
  check_cuda("x", x, torch.bfloat16, (T, d_in), dev)
  check_cuda("w_packed", w_packed, torch.int8, (K, N), dev)
  check_cuda("scale", scale, torch.float32, (N,), dev)
  if x.data_ptr() % 4:
    raise ValueError("int4_matmul: x must be 4-byte aligned")
  y = torch.empty((T, N), dtype=torch.bfloat16, device=dev)
  if T == 0:
    return y
  tt, n_split, rows = plan(T, d_in, N)
  partial = torch.empty((n_split, T, N), dtype=torch.float32, device=dev) if n_split > 1 else None
  fn = load("int4_matmul")
  rc = fn(
    x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), partial.data_ptr() if partial is not None else None, y.data_ptr(),
    T, K, N, tt, n_split, rows, stream_ptr(dev),
  )
  if rc != 0:
    raise RuntimeError(f"int4_matmul kernel launch failed: cudaError {rc}")
  LAUNCHES["int4_matmul"] += 1
  return y
