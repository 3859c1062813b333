"""Run ``chip_smoke.py``'s MoE phase alone on one card.

    python3 scripts/moe_phase.py [--layers N]

Builds the kernels, writes the seeded random Qwen3-30B-A3B checkpoint (full
width; ``chip_smoke.MOE_LAYERS`` of its 48 layers, or N) and serves it
through the daemon: the two MoE paths timed at the experts' shapes, solo
bf16 (captured; the served logits against a plain f32 forward; captured
against uncaptured; the decode step's device time and the routed FFN's
share), batched at the defaults on the same engine, then solo with
``XOT_TPU_QUANT=int4``. Every gate of the phase applies. ``--layers 48``
(the full depth, ~61 GB of bf16 weights) serves solo bf16 alone and
reports the device memory, TTFT and decode rate: its int4 codes would not
fit on the card beside the bf16 stacks while they are quantized, and a
~61 GB checkpoint is not written for one run, so the weights are drawn on
the card from the checkpoint's distributions
(``chip_smoke.moe_params_on_card``) and put into the daemon's engine.
``chiprun_out/moe_phase_<N>.json`` keeps the record; the ``[time]`` lines split
the run.
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

FULL_DEPTH = 48  # Qwen3-30B-A3B's layers (the qwen-3-30b-a3b card)


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("moe_phase: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  layers = int(sys.argv[sys.argv.index("--layers") + 1]) if "--layers" in sys.argv else cs.MOE_LAYERS
  smi = cs.phase_device(torch)
  record: dict = {"card": smi, "layers": layers}
  t0 = time.perf_counter()
  cs.phase_build()
  cs.log(f"[time] build: {time.perf_counter() - t0:.1f} s")
  ckpt = ROOT / "build" / "moe_phase_ckpt"
  try:
    t0 = time.perf_counter()
    preload = None
    if layers == FULL_DEPTH:
      preload = cs.moe_params_on_card(torch, layers)
      record["weight_bytes"] = sum(t.numel() * t.element_size() for t in cs._leaves(preload[1]))
      cs.log(f"[moe] drew a random bf16 Qwen3-30B-A3B on the card ({record['weight_bytes'] / 1e9:.2f} GB, full width and depth)")
    else:
      cs.write_moe_checkpoint(torch, ckpt, layers=layers)
      record["checkpoint_bytes"] = sum(f.stat().st_size for f in ckpt.iterdir())
      cs.log(f"[moe] wrote a random bf16 Qwen3-30B-A3B checkpoint ({record['checkpoint_bytes'] / 1e9:.2f} GB, full width, {layers} of 48 layers)")
    cs.log(f"[time] moe weights: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    record["moe"] = cs.phase_moe(torch, None if preload else ckpt, smi, full=preload is None, preload=preload)
    del preload
    record["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    cs.log(f"[moe] peak device memory allocated over the phase {record['peak_allocated_bytes'] / 1e9:.2f} GB | {smi}")
    cs.log(f"[time] moe: {time.perf_counter() - t0:.1f} s")
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / f"moe_phase_{layers}.json").write_text(json.dumps(record, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
