"""K1 (flash prefill) times on one NVIDIA GPU, for comparing two checkouts of
the port in turns: every row of ``chip_smoke.py``'s ``K1_ROWS`` (llama-3.2-1b's
attention shapes, cache 4096, Sq 128 … 4096, bf16 and int8 K/V, batched rows
with a shared prefix, hd 128) plus a one-query row that is the call's fixed
cost, called through the checkout's wrapper ``flash_attention_prefill``.
Each row gives the CUDA-event time as ``chip_smoke.py`` takes it (L2 flushed,
the call enqueued behind a spin kernel), the device time of the K1 kernel(s)
from ``torch.profiler``, the fair SDPA yardstick (``chip_smoke.k1_library``)
and the card's bound. A one-element PyTorch kernel is timed the same way:
what any launch costs in this harness.

The rows, inputs, yardstick and bound come from this repository's
``chip_smoke.py``; only the kernel comes from the checkout, through the
wrapper's public signature, so the script runs unchanged against an older
checkout. Unpack the parent with ``git archive`` into a git-ignored
directory (``build/parent``) and run parent, change, change, parent in one
call:

    python3 scripts/k1_profile.py [checkout root, default: this repository]

Writes chiprun_out/k1_profile-<checkout name>-<n>.json.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CALLS = 20


def main() -> int:
  root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
  sys.path.insert(0, str(root))  # the checkout's package
  spec = importlib.util.spec_from_file_location("k1_rows", HERE / "chip_smoke.py")
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa

  if not torch.cuda.is_available():
    raise SystemExit("k1_profile: no CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
  print(f"[k1] {root.name}: {smi}", flush=True)
  gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
  flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
  one = torch.zeros(1, device="cuda")
  record = dict(card=smi, checkout=str(root), one_element_kernel_ms=cs._cuda_ms(torch, lambda: one.add_(1)), rows=[])
  print(f"[k1] {root.name} one-element kernel: {record['one_element_kernel_ms']:.4f} ms (CUDA events)", flush=True)
  for Sq, offsets, kv, hd in [(1, [0], "bf16", 64)] + cs.K1_ROWS:
    q, k, v, kw = cs.k1_case(torch, gen, Sq, offsets, kv, hd)

    def call():
      return fa.flash_attention_prefill(q, k, v, **kw)

    ms = cs._cuda_ms(torch, call)
    call()
    torch.cuda.synchronize()
    kern = defaultdict(lambda: [0, 0.0])
    for _ in range(4):  # a session can come back without its device events: retake it
      with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
          flush.zero_()
          call()
        torch.cuda.synchronize()
      for e in prof.events():
        if e.device_type == DeviceType.CUDA and "elementwise" not in e.name and "FillFunctor" not in e.name:  # not the L2 flush
          kern[e.name][0] += 1
          kern[e.name][1] += e.device_time_total / 1e3
      if kern:
        break
    bound_ms, bound_by, flops, _ = cs.k1_bound(Sq, offsets, kv, hd)
    lib_ms, library = cs.k1_library(torch, q, k, v, offsets) if kv == "bf16" else (None, "int8")
    row = dict(
      Sq=Sq, offsets=offsets, kv=kv, hd=hd, event_ms=ms, bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9, library_ms=lib_ms, library=library,
      kernels={name: dict(per_call=n / CALLS, ms_per_launch=t / max(n, 1)) for name, (n, t) in kern.items()},
    )
    record["rows"].append(row)
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms, {library}"
    dev = "; ".join(f"{name[:60]}: {r['per_call']:.2f}/call {r['ms_per_launch']:.4f} ms" for name, r in row["kernels"].items())
    print(f"[k1] {root.name} Sq={Sq} offsets={offsets} kv={kv} hd={hd}: {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s; bound {bound_ms:.5f} ms {bound_by}) | sdpa {lib} | profiler: {dev}", flush=True)
    del q, k, v, kw
  out = HERE / "chiprun_out"
  out.mkdir(exist_ok=True)
  n = len(list(out.glob(f"k1_profile-{root.name}-*.json")))
  (out / f"k1_profile-{root.name}-{n}.json").write_text(json.dumps(record, indent=1))
  return 0


if __name__ == "__main__":
  sys.exit(main())
