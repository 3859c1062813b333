"""Mutation check of the port's flash-prefill kernel (K1) on one NVIDIA GPU.
Each mutant is a temporary copy of the port and ``chip_smoke.py`` with one
fault put into ``csrc/flash_prefill.cu``:

- ``diagonal``: the diagonal tile's mask is dropped (a tile counts as wholly
  below a consumer's diagonal whenever it lies inside Skv), so queries see
  later slots;
- ``stage``: every K/V tile that lands in the ring's last stage is skipped
  (its scores are masked out), as if that stage were never filled.

Each mutant is built in its copy, and ``chip_smoke.py``'s K1 rows
(``flash_prefill_rows``) run on it, both mutants at once. The check passes
when both fail against the plain version.

    python3 scripts/k1_mutation.py       # from the repository root

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
MUTANTS = {  # name: (line of the kernel, its mutant)
  "diagonal": ("if (!(slot0 + BK - 1 <= min_pos && slot0 + BK <= p.Skv)) {", "if (!(slot0 + BK <= p.Skv)) {"),
  "stage": (
    "const int slot0 = t * BK;\n",
    "const int slot0 = t * BK;\n      if (t % C::kStages == C::kStages - 1)\n        for (int i = 0; i < BK / 2; ++i) sacc[i] = kNegInf;\n",
  ),
}
RUN = "import torch, chip_smoke as cs; gen = torch.Generator(device='cuda').manual_seed(cs.SEED); cs.flash_prefill_rows(torch, gen)"


def main() -> int:
  tmp = Path(tempfile.mkdtemp(prefix="k1_mutant_"))
  results, procs = {}, {}
  try:
    for mutant, (line, fault) in MUTANTS.items():
      copy = tmp / mutant
      shutil.copytree(ROOT / PKG, copy / PKG, ignore=shutil.ignore_patterns("__pycache__"))
      shutil.copy2(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
      src = copy / PKG / "csrc" / "flash_prefill.cu"
      text = src.read_text()
      if text.count(line) != 1:
        print(f"k1_mutation: expected one `{line.strip()}` in flash_prefill.cu", file=sys.stderr)
        return 2
      src.write_text(text.replace(line, fault))
      with open(copy / "k1.log", "w") as log:  # a file, not a pipe: two writers at once never block
        procs[mutant] = subprocess.Popen([sys.executable, "-c", RUN], cwd=copy, stdout=log, stderr=subprocess.STDOUT)
    for mutant, proc in procs.items():
      proc.wait(timeout=900)
      results[mutant] = (proc.returncode, (tmp / mutant / "k1.log").read_text())
  finally:
    for proc in procs.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)
  caught = True
  expected = "flash_prefill disagrees with its plain version"
  for mutant, (rc, out) in results.items():
    hit = rc != 0 and expected in out
    caught &= hit
    first = next((line for line in out.splitlines() if expected in line), out.strip().splitlines()[-1] if out.strip() else "")
    print(f"k1_mutation: mutant {mutant}, K1 rows exit {rc}: {first}")
  print(f"k1_mutation: {'caught' if caught else 'NOT caught'}")
  return 0 if caught else 1


if __name__ == "__main__":
  sys.exit(main())
