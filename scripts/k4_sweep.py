"""Launch-geometry sweep of the port's K4 (packed-int4 weight matmul) on one
NVIDIA GPU: every token tile (config 0 / 1 / 2: 8 / 32 / 128 tokens per
block) and in-axis split (1 … 16 blocks per cluster) at llama-3.2-1b's five
weight shapes and T = 1, 8, 32, 128, 512, timed as ``chip_smoke.py`` times its
kernel rows (L2 flushed, CUDA events), each launch checked against the plain
version. The row ``ops/int4_matmul.py plan`` picks is starred.

    python3 scripts/k4_sweep.py            # from the repository root

Writes chiprun_out/k4_sweep.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
  import torch

  from xotorch_support_jetson_tpu_torch.models.quantize import dequantize_leaf, quantize_weight_int4
  from xotorch_support_jetson_tpu_torch.ops import int4_matmul as k4
  from xotorch_support_jetson_tpu_torch.ops.kernels import load, stream_ptr

  if not torch.cuda.is_available():
    raise SystemExit("k4_sweep: no CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
  print(f"[sweep] {smi}", flush=True)
  fn = load("int4_matmul")
  gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
  rows = []
  for name, (d_in, d_out) in cs.LLAMA_1B_MATMULS.items():
    packed, scale = quantize_weight_int4(torch.randn((d_in, d_out), generator=gen, device="cuda") * d_in**-0.5)
    w_bf16 = dequantize_leaf(packed, scale, d_in, torch.bfloat16)
    K, N = packed.shape
    for T in (1, 8, 32, 128, 512):
      x = cs._rand(torch, (T, d_in), gen, torch.bfloat16)
      want = k4.int4_matmul_ref(x, packed, scale).float()
      lib = cs._cuda_ms(torch, lambda: torch.matmul(x, w_bf16))
      best = None
      for cfg in range(len(k4.TILE_T)):
        if k4.TILE_T[cfg] > 8 * max(T, 1) and cfg > 0:
          continue  # a token tile more than 8x T only adds zero rows
        for split in (1, 2, 4, 8, 16):
          if split > -(-K // k4.STAGE_ROWS[cfg]):
            continue
          y = torch.empty((T, N), dtype=torch.bfloat16, device="cuda")

          def run():
            rc = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), T, K, N, 0, cfg, split, stream_ptr(x.device))
            if rc:
              raise RuntimeError(f"cudaError {rc}")

          run()
          torch.cuda.synchronize()
          used = ((y.float() - want).abs() / (cs.K4_ATOL + cs.K4_RTOL * want.abs())).max().item()
          if not used <= 1.0:
            raise SystemExit(f"k4_sweep: {name} T={T} cfg {cfg} split {split}: {used:.2f}x the K4 tolerance")
          ms = cs._cuda_ms(torch, run)
          planned = k4.plan(T, d_in, d_out, k4.sm_count(x.device.index), k4.wide_ok(x, packed)) == (cfg, split)
          rows.append(dict(weight=name, d_in=d_in, d_out=d_out, T=T, cfg=cfg, split=split, ms=ms, library_ms=lib, planned=planned))
          best = ms if best is None else min(best, ms)
          print(f"[sweep] {name} ({d_in}, {d_out}) T={T} cfg {cfg} ({k4.TILE_T[cfg]} tokens) split {split:2d}: {ms:.4f} ms{' *' if planned else ''} | bf16 matmul {lib:.4f} ms", flush=True)
      print(f"[sweep] {name} T={T}: best {best:.4f} ms, planned {next(r['ms'] for r in rows if r['planned'] and r['weight'] == name and r['T'] == T):.4f} ms", flush=True)
    del packed, scale, w_bf16
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "k4_sweep.json").write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
  return 0


if __name__ == "__main__":
  sys.exit(main())
