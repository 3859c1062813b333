"""Mutation check of the port's K4 (packed-int4 weight matmul) on one NVIDIA
GPU: a temporary copy of the port and ``chip_smoke.py`` with the two nibbles
of every packed byte swapped in the kernel's fragment unpack (``unpack4`` in
``csrc/int4_matmul.cu``: ``__byte_perm(lo, hi, ...)`` becomes
``__byte_perm(hi, lo, ...)``), built there, and ``chip_smoke.py``'s K4
phase run on it. The check passes when that phase fails, at its first shape.

    python3 scripts/k4_mutation.py         # from the repository root

The repository's own files are only read.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "xotorch_support_jetson_tpu_torch"
SWAPS = [("__byte_perm(lo, hi, 0x5140u)", "__byte_perm(hi, lo, 0x5140u)"), ("__byte_perm(lo, hi, 0x7362u)", "__byte_perm(hi, lo, 0x7362u)")]
EXPECTED = "int4_matmul disagrees with its plain version"
RUN = "import torch, chip_smoke as cs; cs.int4_kernel_rows(torch, torch.Generator(device='cuda').manual_seed(cs.SEED))"


def main() -> int:
  tmp = Path(tempfile.mkdtemp(prefix="k4_mutant_"))
  try:
    shutil.copytree(ROOT / PKG, tmp / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", tmp / "chip_smoke.py")
    src = tmp / PKG / "csrc" / "int4_matmul.cu"
    text = src.read_text()
    for old, new in SWAPS:
      if text.count(old) != 1:
        print(f"k4_mutation: expected one `{old}` in int4_matmul.cu", file=sys.stderr)
        return 2
      text = text.replace(old, new)
    src.write_text(text)
    res = subprocess.run([sys.executable, "-c", RUN], cwd=tmp, capture_output=True, text=True, timeout=900)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  out = res.stdout + res.stderr
  caught = res.returncode != 0 and EXPECTED in out
  first = next((line for line in out.splitlines() if EXPECTED in line), out.strip().splitlines()[-1] if out.strip() else "")
  print(f"k4_mutation: mutant K4 phase exit {res.returncode}: {first}")
  print(f"k4_mutation: {'caught' if caught else 'NOT caught'}")
  return 0 if caught else 1


if __name__ == "__main__":
  sys.exit(main())
