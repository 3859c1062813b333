"""Time the batched decode paths on one card at llama-3.2-1b's shapes and
derive the H100 decode-path table (``inference/paging.py
_H100_DECODE_PATH_TABLE``).

    python3 scripts/decode_paths.py [--runs N] [--steps N]

For every point of B ∈ {1, 4, 8, 16, 32, 64} rows, a per-row window of
1024, 4096 or 8192 slots and bf16 / int8 KV (int4 KV on the paged paths
only), one captured batched decode chunk (``BatchedPrograms``: a CUDA
graph of ``--steps`` steps over every row, seeded random bf16 weights of
llama-3.2-1b's published shapes, 16 layers) is timed on each path:

- "dense": the slot cache (``decode.batch``; the plain attention, as
  ``flash_decode_supported`` answers at the default knobs), and, for the
  record, "dense_k2" with ``XOT_TPU_FLASH_DECODE=1`` (K2 at any window);
- "kernel": the page pool through K3 (``decode.paged_batch``,
  ``XOT_TPU_PAGED_KERNEL=1``);
- "gather": the page pool through the gathered windows
  (``XOT_TPU_PAGED_KERNEL=0``).

Rows sit at positions spread evenly over the second half of the window
(a served batch mid-answer). Each path is replayed ``--runs`` times after
its capture (CUDA events around each replay); the median and the spread
(max − min) per token are kept. A point's verdict is "kernel" unless
another path's median beat kernel's by more than the two spreads together.
The table rows that reproduce the verdicts under the first-row-wins walk
are printed, each with its measurement, and ``chiprun_out/decode_paths.json``
keeps the record.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402 — after the path is set

BATCHES = (1, 4, 8, 16, 32, 64)
WINDOWS = (1024, 4096, 8192)
KVS = ("", "int8", "int4")
PAGE = 64
DEVICE = "cuda"


def _positions(B: int, window: int):
  import numpy as np

  return np.linspace(window // 2, window - 2 * 64, B).astype(np.int32) if B > 1 else np.array([window * 3 // 4], np.int32)


def _time_chunk(torch, run, runs: int, steps: int, B: int) -> dict:
  """Capture (the first call builds the graph), one warm replay, then
  ``runs`` timed replays: ms per token, median and spread."""
  run()
  run()
  torch.cuda.synchronize()
  times = []
  for _ in range(runs):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b) / (steps * B))
  return {"median": statistics.median(times), "spread": max(times) - min(times), "runs": times}


def _measure(torch, cfg, shard, params, B: int, window: int, kv: str, path: str, runs: int, steps: int) -> dict:
  import numpy as np

  from xotorch_support_jetson_tpu_torch.models.decoder import BatchedPrograms, init_kv_cache
  from xotorch_support_jetson_tpu_torch.ops.paged import init_paged_pool

  env = {"XOT_TPU_PAGED_KERNEL": {"kernel": "1", "gather": "0"}.get(path), "XOT_TPU_FLASH_DECODE": "1" if path == "dense_k2" else None, "XOT_TPU_FLASH_DECODE_MIN": "1" if path == "dense_k2" else None}
  saved = {k: os.environ.get(k) for k in env}
  for k, v in env.items():
    if v is None:
      os.environ.pop(k, None)
    else:
      os.environ[k] = v
  progs = None
  try:
    pos = _positions(B, window)
    token = np.full((B, 1), 7, np.int32)
    active, temps, top_ks = np.ones(B, bool), np.zeros(B, np.float32), np.ones(B, np.int32)
    if path.startswith("dense"):
      store = init_kv_cache(cfg, cfg.n_layers, B, window, quant=kv, device=DEVICE)
      progs = BatchedPrograms(params, cfg, shard, store, dense=True)
      run = lambda: progs.batch_decode(token, pos, active, temps, top_ks, steps, 64, 1)  # noqa: E731
    else:
      mp = window // PAGE
      store = init_paged_pool(cfg, cfg.n_layers, B * mp + 1, PAGE, quant=kv, device=DEVICE)
      bt = (1 + np.arange(B * mp, dtype=np.int32)).reshape(B, mp)
      progs = BatchedPrograms(params, cfg, shard, store)
      run = lambda: progs.decode(token, bt, pos, active, temps, top_ks, steps, 64, PAGE, 1)  # noqa: E731
    for leaf in store.values():
      if leaf.dtype == torch.int8:
        leaf.random_(-64, 64)
      else:
        leaf.normal_(0, 0.5 if leaf.shape[-1] > 1 else 0.01)
    return _time_chunk(torch, run, runs, steps, B)
  finally:
    if progs is not None:
      progs.close()
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
    torch.cuda.empty_cache()


def verdict(point: dict) -> str:
  """'kernel' unless another timed path (dense_k2 is the record's only)
  beat it by more than both spreads together."""
  k = point["kernel"]
  best, best_ms = "kernel", k["median"]
  for path in ("dense", "gather"):
    p = point.get(path)
    if p is not None and k["median"] - p["median"] > k["spread"] + p["spread"] and p["median"] < best_ms:
      best, best_ms = path, p["median"]
  return best


def table_rows(points: dict) -> list:
  """Rows (max_batch, max_context, kv_quant, path, note) that reproduce
  every point's verdict under the first-row-wins walk: per KV mode in
  ascending batch, one row per batch when its windows agree, else one per
  window; a KV mode whose every point is "kernel" gets no rows, and the
  last row answers "kernel" for everything else (wider batches, longer
  windows)."""
  rows = []
  for kv in KVS:
    cells = {(B, W): points[f"{B}/{W}/{kv or 'bf16'}"] for B in BATCHES for W in WINDOWS}
    if all(verdict(c) == "kernel" for c in cells.values()):
      continue
    for B in BATCHES:
      vs = [verdict(cells[(B, W)]) for W in WINDOWS]
      if len(set(vs)) == 1:
        rows.append((B, WINDOWS[-1], kv, vs[0], _note(cells, B, WINDOWS)))
      else:
        rows += [(B, W, kv, v, _note(cells, B, (W,))) for W, v in zip(WINDOWS, vs)]
  rows.append((None, None, None, "kernel", "every other point"))
  return rows


def _note(cells: dict, B: int, windows) -> str:
  parts = []
  for W in windows:
    c = cells[(B, W)]
    timed = " ".join(f"{p} {c[p]['median'] * 1e3:.1f}±{c[p]['spread'] * 1e3:.1f}" for p in ("kernel", "dense", "gather") if p in c)
    parts.append(f"B={B} W={W}: {timed} us/token")
  return "; ".join(parts)


def main() -> int:
  import torch

  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--runs", type=int, default=7)
  parser.add_argument("--steps", type=int, default=8)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("decode_paths: needs an NVIDIA GPU", file=sys.stderr)
    return 2
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models.config import config_from_hf
  from xotorch_support_jetson_tpu_torch.models.decoder import init_shard_params

  smi = cs.phase_device(torch)
  cs.phase_build()
  t0 = time.perf_counter()
  cfg = config_from_hf(dict(cs.LLAMA_3_2_1B), dtype=torch.bfloat16)
  shard = Shard("llama-3.2-1b", 0, cfg.n_layers - 1, cfg.n_layers)
  params = init_shard_params(cfg, shard, generator=torch.Generator(device="cuda").manual_seed(cs.SEED), device="cuda")
  points: dict = {}
  for kv in KVS:
    paths = ("kernel", "gather") if kv == "int4" else ("kernel", "gather", "dense", "dense_k2") if kv == "" else ("kernel", "gather", "dense")
    for B in BATCHES:
      for W in WINDOWS:
        key = f"{B}/{W}/{kv or 'bf16'}"
        point = points[key] = {p: _measure(torch, cfg, shard, params, B, W, kv, p, args.runs, args.steps) for p in paths}
        point["verdict"] = verdict(point)
        cs.log(f"[paths] B={B} window={W} kv={kv or 'bf16'}: " + " | ".join(f"{p} {point[p]['median'] * 1e3:.2f} ± {point[p]['spread'] * 1e3:.2f} us/token" for p in paths) + f" -> {point['verdict']}")
  rows = table_rows(points)
  cs.log(f"[paths] table ({len(rows)} rows), {smi}:")
  for row in rows:
    cs.log(f"[paths]   {row[:4]!r},  # {row[4]}")
  cs.log(f"[time] paths: {time.perf_counter() - t0:.1f} s")
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "decode_paths.json").write_text(json.dumps({"card": smi, "runs": args.runs, "steps": args.steps, "points": points, "rows": rows}, indent=1, default=float))
  print(smi, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
