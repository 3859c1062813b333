"""Build-and-load for the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` — seconds per file,
since no source includes PyTorch's headers. Builds happen at first use, from
the checkout's own sources, into ``build/kernels/`` beside the package (a
git-ignored directory). The library name carries a hash of the source and
flags, so an edited source is rebuilt and a stale one is never loaded.
``ptxas -v`` output (registers, shared memory, spills) is kept next to each
library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
  "flash_prefill": ("xot_flash_prefill", [_P] * 7 + [_I] * 7 + [_P]),
  "flash_decode": ("xot_flash_decode", [_P] * 8 + [_I] * 6 + [_P]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
  if cand.exists():
    return str(cand)
  raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
  src = CSRC / f"{name}.cu"
  digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
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


def load(name: str):
  """The bound C entry point of kernel ``name`` (built on first use)."""
  with _lock:
    lib = _loaded.get(name)
    if lib is None:
      lib = _loaded[name] = ctypes.CDLL(str(build(name)))
  symbol, argtypes = SIGNATURES[name]
  fn = getattr(lib, symbol)
  fn.argtypes = argtypes
  fn.restype = ctypes.c_int
  return fn
