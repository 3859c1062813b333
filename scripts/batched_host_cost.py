"""Host time per batched decode chunk on the scheduler's side, for comparing
two checkouts of the port in turns on one NVIDIA GPU.

Serves ``chip_smoke.py``'s batched traffic (16 streaming greedy requests
sharing a 128-token system prefix, prompts 166-550 tokens, answers 29-64
tokens, in two waves of 8; 8 slots, 64-token pages) through the checkout's
daemon (``main.build_components``, ``node.start``, the HTTP API) on a seeded
random bf16 checkpoint at llama-3.2-1b's published shapes, ``ROUNDS`` times
after one warm-up request, each round on other text of the same lengths
(``batched_bodies`` variants: the same dispatch shapes, no prompt page but
the system prefix cached from an earlier round), so on a checkout with
captured programs the first rounds build them and the last mostly
replays. It reports
each round's aggregate tok/s and TTFT p50 / p95 (client clock). Per chunk
it times

- ``dispatch``: the scheduler's ``_dispatch_decode`` (the chunk's enqueue on
  the engine's executor);
- ``settle_bookkeeping``: the scheduler's ``_settle`` with its wait for the
  device (the copy event's ``synchronize``) taken out: the emits, finishes
  and page release, and whatever accounting the checkout adds there.

These are private names of ``inference/batch_scheduler.py`` that every
checkout since the batched slice has (with ``to_host_async`` imported into
that module), so the script wraps them from outside and runs unchanged
against an older checkout, which has no metrics registry to read. The
traffic, checkpoint and tokenizer come from this repository's
``chip_smoke.py``; the server and kernels from the checkout. Unpack the
parent with ``git archive`` into a git-ignored directory (``build/parent``)
and run parent, change, change, parent in one call, each in its own process:

    python3 scripts/batched_host_cost.py [checkout root, default: this repository] [KNOB=VALUE ...]

The knobs are set before the daemon starts (an older checkout refuses the
scheduling knobs it does not know). The checkpoint is written once to
``build/host_cost_ckpt`` and reused; ``--remove-ckpt`` deletes it at the
end. Writes chiprun_out/batched_host_cost-<checkout name>-<n>.json.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROUNDS = 3


class _TimedEvent:
  """A chunk's copy event whose ``synchronize`` (the settle's wait for the
  device) adds its duration to ``rec``."""

  def __init__(self, event, rec) -> None:
    self.event, self.rec = event, rec

  def synchronize(self) -> None:
    t = time.perf_counter()
    self.event.synchronize()
    self.rec["wait_s"] += time.perf_counter() - t


def _time_chunks(bs, bserver, rec):
  """Wrap the server's dispatch and settle (and the module's copy helper)
  so that ``rec`` sums their host time; returns the function that removes
  the wrappers."""
  plain_host, dispatch, settle = bs.to_host_async, bserver._dispatch_decode, bserver._settle

  def host_async(*ts):
    host, event = plain_host(*ts)
    return host, _TimedEvent(event, rec) if event is not None else None

  async def timed_dispatch(plan, inflight):
    t = time.perf_counter()
    out = await dispatch(plan, inflight)
    rec["dispatch_s"] += time.perf_counter() - t
    return out

  async def timed_settle(record):
    t = time.perf_counter()
    await settle(record)
    rec["settle_s"] += time.perf_counter() - t
    rec["chunks"] += 1

  bs.to_host_async, bserver._dispatch_decode, bserver._settle = host_async, timed_dispatch, timed_settle

  def restore():
    bs.to_host_async = plain_host
    del bserver._dispatch_decode, bserver._settle

  return restore


async def _serve(cs, tmain, bs, args, port):
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.inference.shard import Shard

  node, api, engine, _ = tmain.build_components(args, tokenizer=cs.ByteTokenizer())
  await node.start()
  server = await api.run(host="127.0.0.1", port=port)
  clients = ThreadPoolExecutor(max_workers=16)
  loop = asyncio.get_running_loop()
  ids: dict[str, list[int]] = {}
  node.on_token.register("host_cost").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
  rounds = []
  try:
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    warm = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "warm up"}], "stream": True, "temperature": 0, "max_tokens": 9}
    await loop.run_in_executor(clients, cs._post, port, warm)
    bserver = engine.get_batched_server()
    for i in range(ROUNDS):
      rec = dict(dispatch_s=0.0, settle_s=0.0, wait_s=0.0, chunks=0)
      restore = _time_chunks(bs, bserver, rec)
      bodies = cs.batched_bodies(variant=i)
      t0 = time.perf_counter()
      before = set(ids)
      first = [loop.run_in_executor(clients, cs._post, port, b) for b in bodies[:8]]
      while sum(1 for rid, t in ids.items() if t and rid not in before) < cs.BATCH_SLOTS:
        if time.perf_counter() - t0 > 120 or any(f.done() for f in first):
          raise SystemExit("batched_host_cost: the first wave's rows did not all stream")
        await asyncio.sleep(0.005)
      replies = await asyncio.gather(*first, *(loop.run_in_executor(clients, cs._post, port, b) for b in bodies[8:]))
      wall = time.perf_counter() - t0
      restore()
      tokens = [len(ids.get(rid, [])) for *_, rid in replies]
      ttfts = sorted(r[2] for r in replies)
      if any(n == 0 or n > b["max_tokens"] for n, b in zip(tokens, bodies)) or bserver.busy():
        raise SystemExit(f"batched_host_cost: tokens per request {tokens}")
      n = max(rec["chunks"], 1)
      rounds.append(dict(
        chunks=rec["chunks"], dispatch_ms=rec["dispatch_s"] * 1e3 / n, settle_bookkeeping_ms=(rec["settle_s"] - rec["wait_s"]) * 1e3 / n,
        device_wait_ms=rec["wait_s"] * 1e3 / n, wall_s=wall, tokens=sum(tokens), aggregate_tok_s=sum(tokens) / wall,
        ttft_p50_s=cs._pctl(ttfts, 0.5), ttft_p95_s=cs._pctl(ttfts, 0.95),
      ))
    return rounds
  finally:
    node.on_token.deregister("host_cost")
    await node.stop()
    clients.shutdown(wait=True)
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


def main() -> int:
  argv = [a for a in sys.argv[1:] if a != "--remove-ckpt"]
  root = Path(argv[0]).resolve() if argv and "=" not in argv[0] else HERE
  knobs = dict(a.split("=", 1) for a in argv if "=" in a)
  sys.path.insert(0, str(root))  # the checkout's package
  spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import torch

  from xotorch_support_jetson_tpu_torch import main as tmain
  from xotorch_support_jetson_tpu_torch.inference import batch_scheduler as bs
  from xotorch_support_jetson_tpu_torch.ops import kernels

  if not torch.cuda.is_available():
    raise SystemExit("batched_host_cost: no CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
  kernels.build_all()
  ckpt = HERE / "build" / "host_cost_ckpt"
  if not (ckpt / "model.safetensors").exists():
    cs.write_checkpoint(torch, ckpt)
  args, port = cs._daemon_args(tmain, ckpt)
  os.environ.update(XOT_TPU_BATCHED="1", XOT_TPU_BATCH_SLOTS=str(cs.BATCH_SLOTS), XOT_TPU_PAGE_SIZE=str(cs.PAGE), **knobs)
  rounds = asyncio.run(_serve(cs, tmain, bs, args, port))
  record = dict(card=smi, checkout=str(root), knobs=knobs, rounds=rounds)
  for i, r in enumerate(rounds):
    print(f"[host_cost] {root.name} {knobs or 'defaults'} round {i}: {r['chunks']} chunks | dispatch {r['dispatch_ms']:.4f} ms, settle bookkeeping {r['settle_bookkeeping_ms']:.4f} ms, device wait {r['device_wait_ms']:.3f} ms per chunk | {r['tokens']} tokens in {r['wall_s']:.3f} s ({r['aggregate_tok_s']:.1f} tok/s), TTFT p50 {r['ttft_p50_s']:.4f} s p95 {r['ttft_p95_s']:.4f} s | {smi}", flush=True)
  out = HERE / "chiprun_out"
  out.mkdir(exist_ok=True)
  n = len(list(out.glob(f"batched_host_cost-{root.name}-*.json")))
  (out / f"batched_host_cost-{root.name}-{n}.json").write_text(json.dumps(record, indent=1))
  if "--remove-ckpt" in sys.argv:
    shutil.rmtree(ckpt, ignore_errors=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
