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
kernel launches (a call recorded into a CUDA graph is counted at the
graph's replays, ``kernels.count_launch``); ``CALLS`` counts calls of the two-dot product, so a run can
show that none took it.

Unlike the reference, the kernel is the default for every product
``int4_kernel_supported`` admits; ``XOT_TPU_INT4_KERNEL=0`` is the one way
to the non-kernel two-dot product (``int4_two_dot``) on a card.
"""

from __future__ import annotations

import torch

from ..utils.helpers import env_flag
from .kernels import check_cuda, count_launch, load, sm_count, stream_ptr

# Launch geometry, as csrc/int4_matmul.cu defines it: config c takes
# BLOCK_OUT[c] output channels and TILE_T[c] tokens per block and
# STAGE_ROWS[c] packed rows per pipeline stage. Config 2 (wgmma) takes bf16
# x with 16-byte-aligned rows only.
BLOCK_OUT = (64, 64, 128)
TILE_T = (8, 32, 128)
STAGE_ROWS = (64, 64, 32)
MAX_SPLIT = 16  # blocks of a cluster that share the in-axis (16 is a non-portable cluster size the H100 runs)
WIDE_MACS = 1 << 30  # multiply-adds from which the wide tile wins

LAUNCHES = {"int4_matmul": 0}
CALLS = {"int4_two_dot": 0}  # calls of the non-kernel product (not a kernel launch)


def reset_launch_counts() -> None:
  for counts in (LAUNCHES, CALLS):
    for name in counts:
      counts[name] = 0


def _two_dot(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  lo = ((w_packed << 4) >> 4).to(x.dtype)  # arithmetic shifts sign-extend the low nibble
  hi = (w_packed >> 4).to(x.dtype)
  acc = (x[..., 0::2] @ lo).float() + (x[..., 1::2] @ hi).float()
  return (acc * scale.float()).to(x.dtype)


def int4_two_dot(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """The reference's non-kernel product (``models/quantize.py`` qdot's
  two-dot formulation): x [..., in] with operands in x's dtype, each half
  summed in f32, then the scale → [..., out] in x's dtype. Counted in
  ``CALLS``; the plain version of K4 shares its arithmetic uncounted."""
  CALLS["int4_two_dot"] += 1
  return _two_dot(x, w_packed, scale)


def int4_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """Plain version of K4, same signature as ``int4_matmul``: the two-dot
  formulation in f32, returned in x's dtype."""
  return _two_dot(x.float(), w_packed, scale).to(x.dtype)


def int4_kernel_supported(x_shape, w_shape) -> bool:
  """Whether qdot sends a packed-int4 product through ``int4_matmul``: 2-D
  operands, the halved in-axis, and no explicit ``XOT_TPU_INT4_KERNEL=0``.
  Any number of rows: the kernel tiles over them. None of the TPU kernel's
  tile constraints apply: the kernel masks ragged edges."""
  if len(x_shape) != 2 or len(w_shape) != 2 or not env_flag("XOT_TPU_INT4_KERNEL", default=True):
    return False
  return w_shape[-2] * 2 == x_shape[-1]


def wide_ok(x: torch.Tensor, w_packed: torch.Tensor) -> bool:
  """Whether the wgmma tile (config 2) takes these operands: bf16 x, and
  16-byte-aligned rows and bases of x and w for its cp.async copies."""
  return x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 and w_packed.shape[-1] % 16 == 0 and x.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0


def plan(T: int, d_in: int, d_out: int, sms: int, wide: bool) -> tuple[int, int]:
  """(config, split) for a launch on a device with ``sms`` SMs, chosen from
  ``scripts/k4_sweep.py`` on an H100. The token tile: 8 rows up to T = 8;
  past that 32 rows, or, where ``wide`` (``wide_ok``), the 128 x 128 wgmma
  tile for a product of at least 2^30 multiply-adds, long enough to pay for
  its one block per SM. The split: a cluster of ``split`` blocks shares the
  in-axis (a power of two, at least one stage of packed rows per block)
  until the grid covers the SMs — for the wide tile, whose blocks hold 90 KB
  of shared memory and 256 threads, until one more doubling would pass one
  block per SM."""
  cfg = 0 if T <= TILE_T[0] else 2 if wide and T > TILE_T[1] and T * d_in * d_out >= WIDE_MACS else 1
  tiles = -(-d_out // BLOCK_OUT[cfg]) * -(-T // TILE_T[cfg])
  stages = -(-(d_in // 2) // STAGE_ROWS[cfg])
  split = 1
  while split < MAX_SPLIT and 2 * split <= stages and (2 * tiles * split <= sms if cfg == 2 else tiles * split < sms):
    split *= 2
  return cfg, split


def k_ranges(K: int, cfg: int, split: int) -> list[tuple[int, int]]:
  """Packed rows [begin, end) that each block of a cluster sums: the
  kernel's split of the ceil(K / STAGE_ROWS) stages, clipped to K."""
  n = -(-K // STAGE_ROWS[cfg])
  return [(min(K, r * n // split * STAGE_ROWS[cfg]), min(K, (r + 1) * n // split * STAGE_ROWS[cfg])) for r in range(split)]


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """x [T, in] @ packed int4 w [in/2, out] → [T, out] in x's dtype.

  On CUDA: bf16 or f32 x (f32 is rounded to bf16 for the tensor cores, as
  the TPU kernel does, and y is f32), int8 w, f32 scale [out], all
  contiguous; any T. ``plan`` picks the launch geometry."""
  if x.device.type == "cpu":
    return int4_matmul_ref(x, w_packed, scale)
  if x.device.type != "cuda":
    raise ValueError(f"int4_matmul: no kernel for device {x.device}")
  if x.dim() != 2 or w_packed.dim() != 2 or w_packed.shape[0] * 2 != x.shape[1]:
    raise ValueError(f"int4_matmul: unsupported geometry x {tuple(x.shape)}, packed w {tuple(w_packed.shape)} (x [T, in], w [in/2, out])")
  if x.dtype not in (torch.bfloat16, torch.float32):
    raise ValueError(f"int4_matmul: x must be torch.bfloat16 or torch.float32, got {x.dtype}")
  T, d_in = x.shape
  K, N = w_packed.shape
  dev = x.device
  check_cuda("x", x, x.dtype, (T, d_in), dev)
  check_cuda("w_packed", w_packed, torch.int8, (K, N), dev)
  check_cuda("scale", scale, torch.float32, (N,), dev)
  y = torch.empty((T, N), dtype=x.dtype, device=dev)
  if T == 0:
    return y
  cfg, split = plan(T, d_in, N, sm_count(dev.index), wide_ok(x, w_packed))
  rc = load("int4_matmul")(
    x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), y.data_ptr(), T, K, N, int(x.dtype == torch.float32), cfg, split, stream_ptr(dev)
  )
  if rc != 0:
    raise RuntimeError(f"int4_matmul kernel launch failed: cudaError {rc}")
  count_launch(LAUNCHES, "int4_matmul")
  return y
