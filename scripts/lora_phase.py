"""Run ``chip_smoke.py``'s multi-LoRA phase alone on one card.

    python3 scripts/lora_phase.py

Builds the kernels, writes the seeded random llama-3.2-1b checkpoint
(bf16, full width) and runs ``chip_smoke.phase_lora`` on it: ten seeded
adapters served from ``XOT_TPU_LORA_DIR``, solo (with ``XOT_TPU_LORA=0``
first), batched on the paged default, the dense layout with K2 and int4
base weights, and the hook's device time in a captured solo step and a
captured B=8 chunk. Every gate of the phase applies.
``chiprun_out/lora_phase.json`` keeps the record; the ``[time]`` lines
split the run.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402 — after the path is set


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("lora_phase: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  smi = cs.phase_device(torch)
  t0 = time.perf_counter()
  cs.phase_build()
  cs.log(f"[time] build: {time.perf_counter() - t0:.1f} s")
  ckpt = ROOT / "build" / "lora_phase_ckpt"
  try:
    t0 = time.perf_counter()
    cs.write_checkpoint(torch, ckpt)
    cs.log(f"[time] checkpoint: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = cs.phase_lora(torch, ckpt, smi)
    cs.log(f"[time] lora: {time.perf_counter() - t0:.1f} s")
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "lora_phase.json").write_text(json.dumps({"card": smi, **res}, indent=1, default=float))
  print(json.dumps({"lora_launches": res["launches"]}), flush=True)
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
