"""Run ``chip_smoke.py``'s gemma2 phase alone on one card.

    python3 scripts/gemma2_phase.py [--layers N]

Builds the kernels, times K4 at gemma-2-9b's weight shapes (T = 1) against
its plain version, writes the seeded random gemma-2-9b checkpoint (full
width; ``chip_smoke.GEMMA_LAYERS`` layers, or N: 42 is the full depth,
~18.5 GB) and serves it through the daemon: solo bf16 with
``XOT_TPU_MAX_SEQ=8192`` (captured; chat, a 6,000-token prompt, logprobs, an
n-gram request; the served logits past position 4,096 against a plain f32
forward with and without the window; captured against eager; the decode
step's and the long prefill's device time and attention share), batched at
the defaults on the same engine, then solo with ``XOT_TPU_QUANT=int4``.
Every gate of the phase applies. ``chiprun_out/gemma2_phase.json`` keeps
the record; the ``[time]`` lines split the run.
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
    print("gemma2_phase: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  smi = cs.phase_device(torch)
  record: dict = {"card": smi}
  t0 = time.perf_counter()
  cs.phase_build()
  gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
  rows = cs.int4_kernel_rows(torch, gen, cs.GEMMA_2_9B_MATMULS, tokens=(1,), f32_row=False, model="gemma-2-9b")
  record["int4_matmul_gemma2"] = rows
  record["int4_matmul_gemma2_bound"] = cs.int4_matmul_bound(rows, cs.GEMMA_CALLS_PER_STEP, tokens=(1,), model="gemma-2-9b")
  cs.log(f"[time] build and K4 rows: {time.perf_counter() - t0:.1f} s")
  ckpt = ROOT / "build" / "gemma2_phase_ckpt"
  try:
    t0 = time.perf_counter()
    cs.write_gemma_checkpoint(torch, ckpt, layers=int(sys.argv[sys.argv.index("--layers") + 1]) if "--layers" in sys.argv else cs.GEMMA_LAYERS)
    cs.log(f"[time] gemma2 checkpoint: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["gemma2"] = cs.phase_gemma2(torch, ckpt, smi)
    cs.log(f"[time] gemma2: {time.perf_counter() - t0:.1f} s")
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "gemma2_phase.json").write_text(json.dumps(record, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
