"""Run ``chip_smoke.py``'s diffusion phase alone on one card.

    python3 scripts/diffusion_phase.py

Writes the seeded random bf16 stable-diffusion-2-1-base checkpoint (full
width, the diffusers layout, ~2.6 GB under ``build/``), serves it through
the port's daemon and applies every gate of the phase: the image routes
over HTTP (progress, PNG URLs, determinism, ``n=2``, img2img from an
off-grid PNG, the chat refusal), two Euler candidates, CLIP / one UNet
call / one VAE decode in bf16 against plain f32, no K1-K4 launch. It
builds no kernel: the diffusion path has none. ``chiprun_out/diffusion_phase.json``
keeps the record; the ``[time]`` lines split the run.
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
    print("diffusion_phase: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  smi = cs.phase_device(torch)
  record: dict = {"card": smi}
  ckpt = ROOT / "build" / "diffusion_phase_ckpt"
  try:
    t0 = time.perf_counter()
    record["write_s"] = cs.write_diffusion_checkpoint(torch, ckpt)
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    cs.log(f"[diffusion] wrote a random bf16 {cs.DIFFUSION_MODEL} checkpoint ({size / 1e9:.2f} GB, full width, the diffusers layout, no tokenizer) in {record['write_s']:.1f} s")
    cs.log(f"[time] diffusion checkpoint: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["phase"] = cs.phase_diffusion(torch, ckpt, smi)
    record["checkpoint_bytes"] = size
    cs.log(f"[time] diffusion: {time.perf_counter() - t0:.1f} s")
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "diffusion_phase.json").write_text(json.dumps(record, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
