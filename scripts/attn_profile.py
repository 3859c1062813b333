"""Where a decode-attention call's device time goes, on one NVIDIA GPU: K2
(flash decode) at position 4095 of a 4096 cache and K3 (paged decode) at
B=1 length 4096 and at B=8 mixed lengths, bf16 pages, at llama-3.2-1b's
attention shapes, called through the port's wrappers
(``flash_decode_attention``, ``paged_decode_attention``).
``torch.profiler`` records 20 calls per row, each behind an L2 flush; the
script prints every device kernel's name, launches per call and mean device
time per launch, and the rows' CUDA-event times as ``chip_smoke.py`` takes
them. It uses only the wrappers' public signatures, so it runs unchanged
against an older checkout of the port (its kernels split a call into a
split-K kernel and a merge kernel):

    python3 scripts/attn_profile.py [checkout root, default: this repository]

Writes chiprun_out/attn_profile-<checkout name>.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CALLS = 20


def main() -> int:
  root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
  sys.path.insert(0, str(root))
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke as cs
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, paged

  if not torch.cuda.is_available():
    raise SystemExit("attn_profile: no CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
  print(f"[profile] {root.name}: {smi}", flush=True)
  gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
  Hq, Hkv, hd, mp = 32, 8, 64, cs.CACHE // cs.PAGE
  cases = {}
  q = cs._rand(torch, (1, 1, Hq, hd), gen, torch.bfloat16)
  k = cs._rand(torch, (1, cs.CACHE, Hkv, hd), gen, torch.bfloat16)
  v = cs._rand(torch, (1, cs.CACHE, Hkv, hd), gen, torch.bfloat16)
  pos = torch.tensor([[4095]], dtype=torch.int32, device="cuda")
  cases["K2 position 4095"] = lambda: fa.flash_decode_attention(q, k, v, pos)
  for lengths in ([4096], [1, 64, 65, 777, 1500, 2048, 3333, 4096]):
    B, P = len(lengths), len(lengths) * mp + 1
    qp = cs._rand(torch, (B, Hq, hd), gen, torch.bfloat16)
    kp = cs._rand(torch, (P, Hkv, cs.PAGE, hd), gen, torch.bfloat16)
    vp = cs._rand(torch, (P, Hkv, cs.PAGE, hd), gen, torch.bfloat16)
    bt = torch.randperm(P - 1, generator=gen, device="cuda").to(torch.int32).add_(1).reshape(B, mp)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    label = f"K3 B={B} {'length 4096' if B == 1 else 'mixed 1..4096'} bf16"
    cases[label] = lambda qp=qp, kp=kp, vp=vp, bt=bt, lens=lens: paged.paged_decode_attention(qp, kp, vp, bt, lens, cs.PAGE)

  flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
  record = dict(card=smi, checkout=root.name, rows={})
  for label, fn in cases.items():
    ms = cs._cuda_ms(torch, fn)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
      for _ in range(CALLS):
        flush.zero_()
        fn()
      torch.cuda.synchronize()
    kern = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
      if e.device_type == DeviceType.CUDA and "elementwise" not in e.name and "fill" not in e.name.lower():
        kern[e.name][0] += 1
        kern[e.name][1] += e.device_time_total / 1e3
    table = {name: dict(per_call=n / CALLS, ms_per_launch=t / max(n, 1)) for name, (n, t) in kern.items()}
    record["rows"][label] = dict(event_ms=ms, kernels=table)
    print(f"[profile] {root.name} {label}: {ms:.4f} ms (CUDA events)", flush=True)
    for name, r in table.items():
      print(f"[profile]   {name[:90]}: {r['per_call']:.2f} per call, {r['ms_per_launch']:.4f} ms per launch", flush=True)
  out = HERE / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / f"attn_profile-{root.name}.json").write_text(json.dumps(record, indent=1))
  return 0


if __name__ == "__main__":
  sys.exit(main())
