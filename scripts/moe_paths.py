"""Time the two MoE paths of ``ops/moe.py`` on one card, at Qwen3-30B-A3B's
and DeepSeek-V2-Lite's expert shapes, and derive the H100 table
(``H100_GATHER_MAX``).

    python3 scripts/moe_paths.py [qwen3|deepseek ...]

For bf16, int8 and int4 experts, one layer's routed FFN (Qwen3-30B-A3B:
128 experts of 2048 → 768, top-8 renormalised; DeepSeek-V2-Lite: 64
experts of 2048 → 1408, top-6) runs on the gather path and on the einsum
path at T = 1, 2, 4, 8, 16, 32, 72 and 128 tokens
(``chip_smoke.moe_path_rows``: CUDA events, L2 flushed, the two outputs
compared), and the largest T up to which the gather path was faster is
printed beside the table's entry. Both shapes by default.
``chiprun_out/moe_paths.json`` keeps the record.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402 — after the path is set


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("moe_paths: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  from xotorch_support_jetson_tpu_torch.ops import moe

  shapes = {"qwen3": cs.QWEN3_MOE_FFN, "deepseek": cs.MLA_FFN}
  names = [a for a in sys.argv[1:] if a in shapes] or list(shapes)
  smi = cs.phase_device(torch)
  record: dict = {"card": smi}
  t0 = time.perf_counter()
  cs.phase_build()
  for name in names:
    ffn = shapes[name]
    for weights in ("bf16", "int8", "int4"):
      rows, best = cs.moe_path_rows(torch, weights, ffn=ffn)
      record[f"{name}/{weights}"] = dict(rows=rows, gather_max=best, table=moe.H100_GATHER_MAX.get((ffn["E"], ffn["k"], weights)))
      cs.log(f"[moe] {name} ({ffn['E']} experts, top-{ffn['k']}), {weights} experts: the gather path was faster up to T = {best}; the table holds {record[f'{name}/{weights}']['table']} | {smi}")
  cs.log(f"[time] paths: {time.perf_counter() - t0:.1f} s")
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "moe_paths.json").write_text(json.dumps(record, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
