"""Build-and-load for the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` — seconds per file,
since no source includes PyTorch's headers. Builds happen at first use, from
the checkout's own sources, into ``build/kernels/`` beside the package (a
git-ignored directory). The library name carries a hash of the source, the
local headers it includes (``#include "…"``, recursively) and the flags, so
an edited source or header is rebuilt and a stale one is never loaded.
``ptxas -v`` output (registers, shared memory, spills) is kept next to each
library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the kernels' entry points (every pointer and the stream as
# c_void_p, every int as c_int; each returns the launch's cudaError_t).
SIGNATURES = {
  "flash_prefill": ("xot_flash_prefill", [_P] * 7 + [_I] * 11 + [_P]),
  "flash_decode": ("xot_flash_decode", [_P] * 5 + [_I] * 7 + [_P]),
  "paged_decode": ("xot_paged_decode", [_P] * 8 + [_I] * 9 + [_P]),
  "int4_matmul": ("xot_int4_matmul", [_P] * 4 + [_I] * 6 + [_P]),
}

_lock = threading.Lock()
_loaded: dict[str, object] = {}  # kernel name → its bound C entry point


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
  if cand.exists():
    return str(cand)
  raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
  """``csrc/<name>.cu`` and every local header it includes, recursively."""
  todo, seen = [CSRC / f"{name}.cu"], []
  while todo:
    path = todo.pop()
    if path in seen:
      continue
    seen.append(path)
    todo += [path.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
  return seen


def library_path(name: str) -> Path:
  digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources(name)) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
  return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
  """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
  out = library_path(name)
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.parent / f"{out.stem}.tmp{os.getpid()}-{threading.get_ident()}.so"
  cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
  res = subprocess.run(cmd, capture_output=True, text=True)
  out.with_suffix(".log").write_text(res.stdout + res.stderr)
  if res.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed for {name}.cu (exit {res.returncode}):\n{res.stderr[-4000:]}")
  os.replace(tmp, out)  # atomic: a concurrent builder never sees a partial file
  return out


def build_all(names=None) -> dict[str, Path]:
  """Build several kernels at once, one ``nvcc`` process each."""
  names = list(names or SIGNATURES)
  with ThreadPoolExecutor(max_workers=len(names)) as pool:
    return dict(zip(names, pool.map(build, names)))


def count_launch(counts: dict, name: str) -> None:
  """Count one launch of kernel ``name`` in ``counts`` (a wrapper's
  ``LAUNCHES``), or, while the current stream is being captured into a CUDA
  graph, in ``utils/programs.py``'s ``CAPTURED``: the kernel then runs at
  each replay of the graph, which counts it there (``REPLAYED``)."""
  import torch

  from ..utils.programs import CAPTURED

  if torch.cuda.is_current_stream_capturing():
    CAPTURED[name] = CAPTURED.get(name, 0) + 1
  else:
    counts[name] += 1


def stream_ptr(device) -> int:
  """The current CUDA stream of ``device`` as the int a C entry point takes."""
  import torch

  return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def sm_count(device_index: int) -> int:
  """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
  import torch

  return torch.cuda.get_device_properties(device_index).multi_processor_count


# The launch plan of K2 and K3 (``csrc/decode_attention.cuh``, their shared core).
MAX_CLUSTER = 8  # largest cluster the plan picks (the kernel takes 16, which measured slower: scripts/attn_sweep.py)
MIN_RANGE = 64  # fewest window slots a decode cluster splits down to per block


def decode_plan(window: int, rows: int, sms: int) -> tuple[int, int]:
  """(cluster, range) for K2 and K3 on a device with ``sms`` SMs: the
  ``rows`` (batch row, kv head, group of up to 8 q heads) triples each take
  a cluster of ``cluster`` blocks, and block r reads window slots
  [r·range, (r+1)·range). A block holds one SM's registers (16 warps at hd
  64), so the cluster doubles, up to ``MAX_CLUSTER``, while the grid stays
  within one block per SM and a block keeps more than ``MIN_RANGE`` slots
  (``scripts/attn_sweep.py``). From the host's shapes only: never from the
  lengths or positions, which live on the device."""
  cluster = 1
  while cluster < MAX_CLUSTER and 2 * rows * cluster <= sms and window > cluster * MIN_RANGE:
    cluster *= 2
  return cluster, max(1, -(-window // cluster))


def decode_rows(B: int, Hq: int, Hkv: int) -> int:
  """Clusters of one K2/K3 launch: one per (batch row, kv head, group of up
  to 8 q heads)."""
  return B * Hkv * -(-(Hq // Hkv) // 8)


# The launch plan of K1 (``csrc/flash_prefill.cu``, whose ``Cfg`` it mirrors:
# the C entry refuses a plan that disagrees with the build).
PREFILL_ROWS = 64  # query rows per consumer warpgroup
SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block can opt into


def prefill_plan(hd: int, quantized: bool, B: int, Sq: int, Hq: int, Hkv: int, sms: int) -> dict:
  """K1's geometry for a launch at head dim ``hd`` with bf16 (or int8) K/V
  over ``B`` rows of ``Sq`` queries, ``Hq``/``Hkv`` heads, on ``sms`` SMs:
  one producer warpgroup and ``consumers`` consumer warpgroups per block —
  three at hd 64 (so that 192 query rows share each K/V tile) once a grid of
  such blocks covers the card more than once, else two (a short prompt is
  bound by fixed cost, and smaller blocks spread it over more SMs);
  ``block_k`` kv slots per tile; ``stages`` bf16 K/V tiles in the TMA ring
  (``raw_stages`` int8 tiles before widening); the grid (``bq`` positions
  per consumer, ``n_qt`` q tiles per (row, kv head), ``blocks``); and the
  shared-memory bytes a block takes: Q for every consumer, the ring, the
  raw ring and its scales, 256 bytes of barriers and 1024 of alignment
  slack for the 128-byte-swizzled tiles."""
  bq = PREFILL_ROWS // (Hq // Hkv)
  consumers = 2
  if hd == 64 and -(-Sq // (3 * bq)) * Hkv * B > sms:
    consumers = 3
  n_qt = -(-Sq // (consumers * bq))
  block_k = 64 if hd == 256 else 128
  stages = 2 if hd == 256 else (2 if quantized else 3) if hd == 128 else (3 if quantized else 4)
  raw_stages = (2 if hd == 64 else 1) if quantized else 0
  pieces = hd // 64
  q_bytes = consumers * pieces * PREFILL_ROWS * 128
  stage_bytes = 2 * pieces * block_k * 128
  raw_bytes = 2 * block_k * hd
  scale_bytes = 2 * block_k * 4 if quantized else 0
  smem = 1024 + q_bytes + stages * (stage_bytes + scale_bytes) + raw_stages * raw_bytes + 256
  return dict(
    consumers=consumers, threads=128 * (consumers + 1), block_k=block_k, stages=stages, raw_stages=raw_stages, smem=smem,
    bq=bq, n_qt=n_qt, blocks=n_qt * Hkv * B,
  )


def prefill_item(block: int, B: int, Hkv: int, n_qt: int) -> tuple[int, int, int]:
  """(q tile, batch row, kv head) of K1's block ``block``: the kernel's own
  decode of ``blockIdx.x``. Blocks go out in index order, so the last q
  tiles — the longest causal ranges — come first."""
  per_qt = Hkv * B
  return n_qt - 1 - block // per_qt, block % per_qt // Hkv, block % Hkv


def check_cuda(name: str, t, dtype, shape, device) -> None:
  """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
  if t.device != device:
    raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
  if t.dtype != dtype:
    raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: expected a contiguous tensor")


def load(name: str):
  """The bound C entry point of kernel ``name`` (built and bound on first use)."""
  fn = _loaded.get(name)
  if fn is not None:
    return fn
  with _lock:
    if name not in _loaded:
      symbol, argtypes = SIGNATURES[name]
      fn = getattr(ctypes.CDLL(str(build(name))), symbol)
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
      _loaded[name] = fn
    return _loaded[name]
