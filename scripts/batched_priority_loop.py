"""Run ``chip_smoke.py``'s batched priority pass in a loop on one card.

    python3 scripts/batched_priority_loop.py [passes]   # default 20

The batched daemon at its defaults (8 slots, 64-token pages, llama-3.2-1b's
published shapes with seeded random bf16 weights, as in ``chip_smoke.py``)
serves the priority pass ``passes`` times, each on a fresh server as
``chip_smoke.py`` builds one per pass: 12 ``batch`` requests (answers of
``chip_smoke.PRIORITY_BATCH_TOKENS``), then 4 ``interactive`` ones once
eight rows stream. A pass fails when a request
answers an HTTP error, a row ends short of its tokens, or no row was
preempted. The server's error bodies and, with ``DEBUG=1`` (set here unless
the caller sets it), the tracebacks the API and the scheduler print go to
the output; ``chiprun_out/priority_loop.json`` keeps every pass. Exits 1 if
any pass failed.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("DEBUG", "1")

import chip_smoke as cs  # noqa: E402 — after the path and DEBUG are set


async def _loop(torch, ckpt: Path, n_passes: int) -> list[dict]:
  from xotorch_support_jetson_tpu_torch import main as tmain
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics, snapshot_delta

  args, port = cs._daemon_args(tmain, ckpt, max_tokens=cs.PRIORITY_BATCH_TOKENS)
  os.environ.update(XOT_TPU_BATCHED="1", XOT_TPU_BATCH_SLOTS=str(cs.BATCH_SLOTS), XOT_TPU_PAGE_SIZE=str(cs.PAGE))
  node, api, engine, _ = tmain.build_components(args, tokenizer=cs.ByteTokenizer())
  await node.start()
  server = await api.run(host="127.0.0.1", port=port)
  clients = ThreadPoolExecutor(max_workers=16)
  loop = asyncio.get_running_loop()
  ids: dict[str, list[int]] = {}
  passes = []
  try:
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    node.on_token.register("priority_loop").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    warm = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "warm up"}], "stream": True, "temperature": 0, "max_tokens": 9}
    for i in range(n_passes):
      engine._drop_batched_server()
      await loop.run_in_executor(clients, cs._post, port, warm)
      waves = (cs.batched_bodies(12, "batch"), cs.batched_bodies(4, "interactive"))
      snap0 = metrics.snapshot()
      before = set(ids)
      t0 = time.perf_counter()
      first = [loop.run_in_executor(clients, cs._post, port, b) for b in waves[0]]
      early = None
      while sum(1 for rid, t in ids.items() if t and rid not in before) < cs.BATCH_SLOTS:
        if time.perf_counter() - t0 > 120 or any(f.done() for f in first):
          early = "the first wave's rows did not all stream"
          break
        await asyncio.sleep(0.005)
      second = [loop.run_in_executor(clients, cs._post, port, b) for b in waves[1]]
      replies = await asyncio.gather(*first, *second, return_exceptions=True)
      wall = time.perf_counter() - t0
      delta = snapshot_delta(snap0, metrics.snapshot())
      errors, short = [], []
      for r, b in zip(replies, waves[0] + waves[1]):
        if isinstance(r, BaseException):
          errors.append(f"{b['priority']}: {r!r}"[:700])
          continue
        toks = ids.get(r[5], [])
        if len(toks) != b["max_tokens"] and r[1] != "stop":
          short.append((b["priority"], len(toks), r[1]))
      preemptions = int(delta["counters"].get("qos_preemptions_total", 0))
      ok = not errors and not short and preemptions >= 1 and early is None
      rec = dict(index=i, ok=ok, wall_s=wall, early=early, errors=errors, short=short, preemptions=preemptions)
      passes.append(rec)
      cs.log(f"[priority-loop] pass {i}: {'ok' if ok else 'FAILED'} in {wall:.3f} s, {preemptions} preemptions{'' if early is None else ' | ' + early}{'' if not errors else ' | errors ' + str(errors)}{'' if not short else ' | short rows ' + str(short)}")
  finally:
    node.on_token.deregister("priority_loop")
    await node.stop()
    clients.shutdown(wait=True)
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)
  return passes


def main() -> int:
  import torch

  n_passes = int(sys.argv[1]) if len(sys.argv) > 1 else 20
  smi = cs.phase_device(torch)
  cs.phase_build()
  ckpt = ROOT / "build" / "priority_loop_ckpt"
  try:
    cs.write_checkpoint(torch, ckpt)
    passes = asyncio.run(_loop(torch, ckpt, n_passes))
  finally:
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
  failed = [p["index"] for p in passes if not p["ok"]]
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "priority_loop.json").write_text(json.dumps(dict(card=smi, passes=passes), indent=1))
  cs.log(f"[priority-loop] {len(passes) - len(failed)} of {len(passes)} passes ok; failed: {failed} | {smi}")
  return 1 if failed else 0


if __name__ == "__main__":
  sys.exit(main())
