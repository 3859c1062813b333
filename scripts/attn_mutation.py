"""Mutation check of the port's decode attention kernels (K2 flash decode, K3
paged decode) on one NVIDIA GPU. Each mutant is a temporary copy of the
port and ``chip_smoke.py`` with one fault put into their shared core,
``csrc/decode_attention.cuh``:

- ``merge``: the cluster merge drops the partial of the cluster's last
  block (rank 0 sums csize - 1 of the csize partials);
- ``octet``: every warp skips the first octet (8 slots) it streams, as if
  its scores were masked.

Each mutant is built in its copy, and ``chip_smoke.py``'s K2 rows and K3
rows run on it, each in its own process (the four processes at once). The
check passes when every one of them fails against its plain version.

    python3 scripts/attn_mutation.py       # from the repository root

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
MUTANTS = {  # name: (line of the core, its mutant)
  "merge": ("for (int r = 0; r < csize; ++r) A += wts", "for (int r = 0; r < csize - 1; ++r) A += wts"),
  "octet": ("live[u][e] = j0 + 2 * t + e < end;", "live[u][e] = j0 + 2 * t + e < end && (i > 0 || u > 0);"),
}
SETUP = "import torch, chip_smoke as cs; gen = torch.Generator(device='cuda').manual_seed(cs.SEED); "
PHASES = {
  "flash_decode": SETUP + "cs.flash_decode_rows(torch, gen, 32, 8, 64)",
  "paged_decode": SETUP + "cs.paged_kernel_rows(torch, gen, 32, 8, 64)",
}


def main() -> int:
  tmp = Path(tempfile.mkdtemp(prefix="attn_mutant_"))
  results, procs = {}, {}
  try:
    for mutant, (line, fault) in MUTANTS.items():
      copy = tmp / mutant
      shutil.copytree(ROOT / PKG, copy / PKG, ignore=shutil.ignore_patterns("__pycache__"))
      shutil.copy2(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
      src = copy / PKG / "csrc" / "decode_attention.cuh"
      text = src.read_text()
      if text.count(line) != 1:
        print(f"attn_mutation: expected one `{line}` in decode_attention.cuh", file=sys.stderr)
        return 2
      src.write_text(text.replace(line, fault))
      for name, run in PHASES.items():
        with open(copy / f"{name}.log", "w") as log:  # a file, not a pipe: four writers at once never block
          procs[mutant, name] = subprocess.Popen([sys.executable, "-c", run], cwd=copy, stdout=log, stderr=subprocess.STDOUT)
    for (mutant, name), proc in procs.items():
      proc.wait(timeout=900)
      results[mutant, name] = (proc.returncode, (tmp / mutant / f"{name}.log").read_text())
  finally:
    for proc in procs.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)
  caught = True
  for (mutant, name), (rc, out) in results.items():
    expected = f"{name} disagrees with its plain version"
    hit = rc != 0 and expected in out
    caught &= hit
    first = next((line for line in out.splitlines() if expected in line), out.strip().splitlines()[-1] if out.strip() else "")
    print(f"attn_mutation: mutant {mutant}, {name} rows exit {rc}: {first}")
  print(f"attn_mutation: {'caught' if caught else 'NOT caught'}")
  return 0 if caught else 1


if __name__ == "__main__":
  sys.exit(main())
