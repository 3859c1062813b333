"""Run ``chip_smoke.py``'s llava phase alone on one card, at a chosen
depth, and one llava-1.6-vicuna-7b any-res request after it.

    python3 scripts/llava_phase.py [--layers N]

Builds the kernels, holds K1-K4 at llava-1.5-7b's shapes against their
plain versions, writes the seeded random llava-1.5-7b checkpoint (full
width: the whole CLIP ViT-L/14-336 tower, the projector and N of the
decoder's 32 layers, default all 32, ~14 GB) and serves it through the
daemon with ``XOT_TPU_FLASH_DECODE=1``: an image request (HTTP with a PNG
where Pillow is present, else the engine's device half), a text request,
a batched text wave at the defaults, then the two solo requests on
``XOT_TPU_QUANT=int4`` weights, every gate of the phase applied (K1
exactly once per layer in a prefill, K2 in the decode, K3 in the wave, K4
on int4 weights, the answer equal to the uncaptured forward's, the tower
and the prefill logits against plain f32, nothing built after the
warm-up). Then it removes that checkpoint, writes a llava-1.6-vicuna-7b
one of the same depth and serves one 672×672 any-res request (5 tiles,
2,928 features) through the engine, held to the uncaptured forward.
``chiprun_out/llava_phase_<N>.json`` keeps the record; the ``[time]``
lines split the run.
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
    print("llava_phase: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  layers = int(sys.argv[sys.argv.index("--layers") + 1]) if "--layers" in sys.argv else 32
  smi = cs.phase_device(torch)
  record: dict = {"card": smi, "layers": layers}
  t0 = time.perf_counter()
  cs.phase_build()
  cs.log(f"[time] build: {time.perf_counter() - t0:.1f} s")
  gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
  record["kernels"] = {
    "flash_prefill": cs.flash_prefill_rows(torch, gen, [(640, [0], "bf16", 128), (3072, [0], "bf16", 128)], heads=(32, 32)),
    "flash_decode": cs.flash_decode_rows(torch, gen, 32, 32, 128, (([640], cs.CACHE), ([2950], cs.CACHE))),
    "paged_decode": cs.paged_kernel_rows(torch, gen, 32, 32, 128, length_sets=cs.K3_LENGTHS[-1:], kvs=("bf16",)),
    "int4_matmul": cs.int4_kernel_rows(torch, gen, cs.LLAVA_MATMULS, tokens=(1,), f32_row=False, model="llava-1.5-7b"),
  }
  ckpt = ROOT / "build" / "llava_phase_ckpt"
  try:
    for name, config, phase in (("llava-1.5-7b", cs.LLAVA_15, cs.phase_llava), ("llava-1.6-vicuna-7b", cs.LLAVA_16_VICUNA, cs.phase_llava_next)):
      t0 = time.perf_counter()
      cs.write_llava_checkpoint(torch, ckpt, layers=layers, config=config)
      size = sum(f.stat().st_size for f in ckpt.iterdir())
      cs.log(f"[llava] wrote a random bf16 {name} checkpoint ({size / 1e9:.2f} GB, full width, the whole tower and {layers} of the decoder's 32 layers) in {time.perf_counter() - t0:.1f} s")
      t0 = time.perf_counter()
      torch.cuda.reset_peak_memory_stats()
      record[name] = phase(torch, ckpt, smi, layers)
      record[name]["checkpoint_bytes"] = size
      record[name]["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
      cs.log(f"[llava] {name}: peak device memory allocated over the phase {record[name]['peak_allocated_bytes'] / 1e9:.2f} GB | {smi}")
      cs.log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
      shutil.rmtree(ckpt, ignore_errors=True)
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / f"llava_phase_{layers}.json").write_text(json.dumps(record, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
