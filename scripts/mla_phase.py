"""Run ``chip_smoke.py``'s MLA phase alone on one card.

    python3 scripts/mla_phase.py [--layers N]

Builds the kernels, holds K4 at DeepSeek-Coder-V2-Lite's weight products
(T = 1), writes the seeded random DeepSeek-Coder-V2-Lite checkpoint (full
width; ``chip_smoke.MLA_LAYERS`` of its 27 layers, or N) and serves it
through the daemon: one attention layer at DeepSeek-V3's widths against
the naive f32 form, solo bf16 (captured; chat, a 3,000-token prompt,
logprobs, an n-gram request; the served logits against the naive f32
forward; captured against uncaptured; the decode step's device time with
the absorbed op's and the MoE FFN's shares), batched at the defaults on
the same engine (no mixed tick, no speculation), then solo with
``XOT_TPU_QUANT=int4``. Every gate of the phase applies. ``--layers 27``
(the full depth, ~31.4 GB of bf16 weights) serves solo bf16 alone and
reports the device memory, TTFT and decode rate; its weights are drawn on
the card from the checkpoint's distributions
(``chip_smoke.mla_params_on_card``) and put into the daemon's engine
rather than written to disk. ``chiprun_out/mla_phase_<N>.json`` keeps the
record; the ``[time]`` lines split the run.
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

FULL_DEPTH = 27  # DeepSeek-Coder-V2-Lite's layers (the deepseek-coder-v2-lite card)


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("mla_phase: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  layers = int(sys.argv[sys.argv.index("--layers") + 1]) if "--layers" in sys.argv else cs.MLA_LAYERS
  smi = cs.phase_device(torch)
  record: dict = {"card": smi, "layers": layers}
  t0 = time.perf_counter()
  cs.phase_build()
  cs.log(f"[time] build: {time.perf_counter() - t0:.1f} s")
  if layers != FULL_DEPTH:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    record["int4_matmul_mla"] = cs.int4_kernel_rows(torch, gen, cs.DEEPSEEK_V2_LITE_MATMULS, tokens=(1,), f32_row=False, model="DeepSeek-Coder-V2-Lite")
  ckpt = ROOT / "build" / "mla_phase_ckpt"
  try:
    t0 = time.perf_counter()
    preload = None
    if layers == FULL_DEPTH:
      preload = cs.mla_params_on_card(torch, layers)
      record["weight_bytes"] = sum(t.numel() * t.element_size() for t in cs._leaves(preload[1]))
      cs.log(f"[mla] drew a random bf16 DeepSeek-Coder-V2-Lite on the card ({record['weight_bytes'] / 1e9:.2f} GB, full width and depth)")
    else:
      cs.write_mla_checkpoint(torch, ckpt, layers=layers)
      record["checkpoint_bytes"] = sum(f.stat().st_size for f in ckpt.iterdir())
      cs.log(f"[mla] wrote a random bf16 DeepSeek-Coder-V2-Lite checkpoint ({record['checkpoint_bytes'] / 1e9:.2f} GB, full width, {layers} of 27 layers)")
    cs.log(f"[time] mla weights: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    record["mla"] = cs.phase_mla(torch, None if preload else ckpt, smi, full=preload is None, preload=preload)
    del preload
    record["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    cs.log(f"[mla] peak device memory allocated over the phase {record['peak_allocated_bytes'] / 1e9:.2f} GB | {smi}")
    cs.log(f"[time] mla: {time.perf_counter() - t0:.1f} s")
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / f"mla_phase_{layers}.json").write_text(json.dumps(record, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
