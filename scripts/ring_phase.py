"""Run ``chip_smoke.py``'s ring phase alone on one card.

    python3 scripts/ring_phase.py

Builds the kernels, writes the seeded random llama-3.2-1b checkpoint (bf16,
published shapes) with the word-level tokenizer files, and runs the ring
phase: three partial shards (layers 0-7, 8-11, 12-15) chained by hand in
this process (the tail's prefill logits against the whole model's,
captured against uncaptured per shard, K1 / K2 / K4 launches, the
per-token lap against the three captured steps' device time, the bytes per
hop), then three daemon processes joined into a ring by manual discovery
on 127.0.0.1 (streaming and blocking chat on the head, streaming on the
tail, ``/v1/topology`` on each, a 507 for a model the ring cannot hold).
Every gate of the phase applies; the solo comparison is left out (it is
``chip_smoke.py``'s serving phase). ``chiprun_out/ring_phase.json`` keeps
the record.
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
    print("ring_phase: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  smi = cs.phase_device(torch)
  t0 = time.perf_counter()
  cs.phase_build()
  cs.log(f"[time] build: {time.perf_counter() - t0:.1f} s")
  ckpt = ROOT / "build" / "ring_phase_ckpt"
  try:
    t0 = time.perf_counter()
    cs.write_checkpoint(torch, ckpt)
    cs.write_tokenizer(ckpt)
    cs.log(f"[time] checkpoint and tokenizer: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record = {"card": smi, "ring": cs.phase_ring(torch, ckpt, smi, None)}
    cs.log(f"[time] ring: {time.perf_counter() - t0:.1f} s")
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "ring_phase.json").write_text(json.dumps(record, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
