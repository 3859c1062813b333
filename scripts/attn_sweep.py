"""Cluster-size sweep of the port's decode attention kernels on one NVIDIA
GPU: K2 (flash decode, dense slot cache) and K3 (paged decode, bf16 / int8
/ int4 pages) at llama-3.2-1b's attention shapes (Hq 32, Hkv 8, hd 64, page
size 64), each launched with a cluster of 1, 2, 4, 8 and 16 blocks per
(row, kv head), every launch checked against the plain version and timed as
``chip_smoke.py`` times its kernel rows (L2 flushed, CUDA events). The
cluster ``ops/kernels.py decode_plan`` picks is starred; SDPA on the
same window is the yardstick.

    python3 scripts/attn_sweep.py          # from the repository root

Writes chiprun_out/attn_sweep.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CLUSTERS = (1, 2, 4, 8, 16)


def main() -> int:
  import torch
  import torch.nn.functional as F

  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv, quantize_kv_int4
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, paged
  from xotorch_support_jetson_tpu_torch.ops.kernels import decode_plan, decode_rows, load, sm_count, stream_ptr

  if not torch.cuda.is_available():
    raise SystemExit("attn_sweep: no CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
  print(f"[sweep] {smi}", flush=True)
  gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
  Hq, Hkv, hd = 32, 8, 64
  sms = sm_count(0)
  rows = []

  def sweep(label, window, B, launch, check, library_ms):
    planned = decode_plan(window, decode_rows(B, Hq, Hkv), sms)[0]
    for cluster in CLUSTERS:
      range_ = -(-window // cluster)

      def run():
        rc = launch(cluster, range_)
        if rc:
          raise RuntimeError(f"cudaError {rc}")

      run()
      torch.cuda.synchronize()
      check(label, cluster)
      ms = cs._cuda_ms(torch, run)
      rows.append(dict(row=label, cluster=cluster, range=range_, ms=ms, library_ms=library_ms, planned=cluster == planned))
      print(f"[sweep] {label} cluster {cluster:2d} ({range_} slots per block): {ms:.4f} ms{' *' if cluster == planned else ''} | sdpa {library_ms:.4f} ms", flush=True)

  # Floors: a one-element PyTorch kernel (what the timing itself costs), and
  # K2 with no live slot (launch, cluster barriers and merge, no K/V read).
  one = torch.zeros(1, device="cuda")
  floor_ms = cs._cuda_ms(torch, lambda: one.add_(1.0))
  rows.append(dict(row="one-element torch add", cluster=None, range=None, ms=floor_ms, library_ms=None, planned=False))
  print(f"[sweep] floor: one-element torch add {floor_ms:.4f} ms", flush=True)
  k2 = load("flash_decode")
  for positions, cache in (([-1], 4096), ([4095], 4096), ([16383], 16384), ([0, 1000, 2047, 4095], 4096)):
    B = len(positions)
    q = cs._rand(torch, (B, 1, Hq, hd), gen, torch.bfloat16)
    k = cs._rand(torch, (B, cache, Hkv, hd), gen, torch.bfloat16)
    v = cs._rand(torch, (B, cache, Hkv, hd), gen, torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    want = fa.flash_decode_attention_ref(q, k, v, pos[:, None]).float()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(cache, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    lib = cs._cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))

    def check(label, cluster, out=out, want=want, empty=positions == [-1]):
      want = torch.zeros_like(want) if empty else want  # no live slot: zeros
      used = ((out.float() - want).abs() / (cs.K2_ATOL + cs.K2_RTOL * want.abs())).max().item()
      if not used <= 1.0:
        raise SystemExit(f"attn_sweep: {label} cluster {cluster}: {used:.2f}x the K2 tolerance")

    sweep(
      f"K2 B={B} positions={positions} cache={cache}", cache, B,
      lambda cluster, range_, q=q, k=k, v=v, pos=pos, out=out, B=B, cache=cache: k2(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(), B, cache, Hq, Hkv, hd, cluster, range_, stream_ptr(q.device)
      ),
      check, lib,
    )
    del q, k, v, out

  k3 = load("paged_decode")
  mp = cs.CACHE // cs.PAGE
  for lengths in ([4096], [1, 64, 65, 777, 1500, 2048, 3333, 4096]):
    B = len(lengths)
    P = B * mp + 1
    q = cs._rand(torch, (B, Hq, hd), gen, torch.bfloat16)
    k_f = cs._rand(torch, (P, Hkv, cs.PAGE, hd), gen, torch.bfloat16)
    v_f = cs._rand(torch, (P, Hkv, cs.PAGE, hd), gen, torch.bfloat16)
    bt = torch.randperm(P - 1, generator=gen, device="cuda").to(torch.int32).add_(1).reshape(B, mp)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qt = q[:, :, None, :]
    mask = (torch.arange(mp * cs.PAGE, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    kd = paged.gather_pages(k_f, bt).transpose(1, 2).contiguous()
    vd = paged.gather_pages(v_f, bt).transpose(1, 2).contiguous()
    lib = cs._cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True))
    del kd, vd
    for kind, kv in enumerate(cs.KV_MODES):
      k, v, ks, vs = k_f, v_f, None, None
      if kv != "bf16":
        quant = quantize_kv_int4 if kv == "int4" else quantize_kv
        (k, ks), (v, vs) = quant(k_f), quant(v_f)
      scales = dict(k_scale_pool_l=ks, v_scale_pool_l=vs) if ks is not None else {}
      out = torch.empty_like(q)
      want = paged.paged_decode_attention_ref(q, k, v, bt, lens, cs.PAGE, **scales).float()

      def check(label, cluster, out=out, want=want):
        used = ((out.float() - want).abs() / (cs.K3_ATOL + cs.K3_RTOL * want.abs())).max().item()
        if not used <= 1.0:
          raise SystemExit(f"attn_sweep: {label} cluster {cluster}: {used:.2f}x the K3 tolerance")

      sweep(
        f"K3 B={B} lengths={lengths if B == 1 else 'mixed 1..4096'} kv={kv}", mp * cs.PAGE, B,
        lambda cluster, range_, q=q, k=k, v=v, ks=ks, vs=vs, out=out, B=B, kind=kind: k3(
          q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr() if ks is not None else None, vs.data_ptr() if vs is not None else None,
          bt.data_ptr(), lens.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, cs.PAGE, mp, kind, cluster, range_, stream_ptr(q.device)
        ),
        check, lib,
      )
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "attn_sweep.json").write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
  return 0


if __name__ == "__main__":
  sys.exit(main())
