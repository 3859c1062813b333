"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device — the card's name, power limit and compute capability;
2. build — both CUDA kernels from the checkout's sources, one nvcc each,
   in parallel (xotorch_support_jetson_tpu_torch/ops/kernels.py);
3. kernels — K1 (flash prefill) and K2 (flash decode) against their plain
   PyTorch versions at llama-3.2-1b's attention shapes (Hq 32, Hkv 8, hd 64,
   bf16, cache 4096): error, kernel / plain / SDPA time and the card's bound;
4. serving — a seeded random-weight bf16 checkpoint with llama-3.2-1b's
   published shapes is written with the port's safetensors writer, and the
   port's daemon path (main → node → API) serves blocking and streaming
   chat completions on it, greedy and sampled, then again with
   XOT_TPU_FLASH_DECODE=1 XOT_TPU_FLASH_DECODE_MIN=4096. The launch counters
   are zeroed just before these requests and read just after: both kernels
   must have run. Blocking and streaming greedy token ids must be equal, and
   the served model's prefill and decode logits must agree with the plain
   attention path on the same weights. Last, ``torch.profiler`` splits one
   prefill and eight decode steps into host and device time.

The last two lines are the card as ``nvidia-smi`` reports it and
``{"ok": true, "device": {...}}``; the line before them is the kernels' JSON
summary. A full record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import shutil
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
K1_ATOL = 3e-2  # bf16 output + bf16-rounded probabilities in the P·V product
K2_ATOL = 1e-2  # bf16 output; f32 math inside
# llama-3.2-1b: meta-llama/Llama-3.2-1B config.json (published values).
LLAMA_3_2_1B = {
  "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
  "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
  "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "max_position_embeddings": 131072, "tie_word_embeddings": True,
  "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
  "bos_token_id": 128000, "eos_token_id": [128001, 128008, 128009], "torch_dtype": "bfloat16",
}
CACHE = 4096  # the serving cap (XOT_TPU_MAX_SEQ default)
MAX_TOKENS = 64


def log(msg: str) -> None:
  print(msg, flush=True)


# ---------------------------------------------------------------- 1. device


def phase_device(torch):
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device visible (torch.cuda.is_available() is false)")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
  cap = torch.cuda.get_device_capability(0)
  log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | compute capability {cap[0]}.{cap[1]} | torch {torch.__version__} cuda {torch.version.cuda}")
  if cap < (9, 0):
    raise SystemExit(f"chip_smoke: the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
  return smi


# ---------------------------------------------------------------- 2. build


def phase_build():
  from xotorch_support_jetson_tpu_torch.ops import kernels

  t0 = time.perf_counter()
  libs = kernels.build_all()
  dt = time.perf_counter() - t0
  for name, lib in libs.items():
    regs = [ln.split("info    : ")[-1] for ln in lib.with_suffix(".log").read_text().splitlines() if "registers" in ln or "spill" in ln]
    log(f"[build] {name}: {lib.name}; ptxas: {' | '.join(sorted(set(regs)))[:400]}")
  log(f"[build] both kernels built in {dt:.2f} s (parallel nvcc)")
  return dt


# ---------------------------------------------------------------- 3. kernels


def _cuda_ms(torch, fn, iters=30, warmup=3):
  """Mean device time of ``fn`` over ``iters`` calls, each timed with CUDA
  events after a 64 MB write that evicts the 50 MB L2 (a serving step finds
  a layer's cache cold: the other layers' weights pass through L2 between).
  A ~1 ms spin kernel ahead of each call lets the host enqueue the call
  before the card reaches it, so the events time the device work and not
  the wrapper's host-side cost."""
  flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
  for _ in range(warmup):
    fn()
  total = 0.0
  for _ in range(iters):
    flush.zero_()
    torch.cuda._sleep(2_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / iters


def _rand(torch, shape, gen, dtype):
  return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def phase_kernels(torch):
  import torch.nn.functional as F

  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa

  gen = torch.Generator(device="cuda").manual_seed(SEED)
  Hq, Hkv, hd = 32, 8, 64
  results = {"flash_prefill": [], "flash_decode": []}

  for Sq, off, quant in [(128, 0, False), (512, 0, False), (128, 128, False), (512, 128, False), (128, 0, True), (512, 0, True), (128, 128, True), (512, 128, True)]:
    q = _rand(torch, (1, Sq, Hq, hd), gen, torch.bfloat16)
    k = _rand(torch, (1, CACHE, Hkv, hd), gen, torch.bfloat16)
    v = _rand(torch, (1, CACHE, Hkv, hd), gen, torch.bfloat16)
    k[:, off + Sq :] = 1e4  # stale slots past the prompt: masked by position
    v[:, off + Sq :] = 1e4
    # The offset is a device tensor, as the decoder passes it.
    kw = {"q_offset": torch.full((1,), off, dtype=torch.int32, device="cuda")}
    if quant:
      kq, ks = quantize_kv(k)
      vq, vs = quantize_kv(v)
      k, v = kq, vq
      kw.update(k_scale=ks, v_scale=vs)
    got = fa.flash_attention_prefill(q, k, v, **kw)
    want = fa.flash_attention_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got).all() or not err <= K1_ATOL:
      raise SystemExit(f"chip_smoke: flash_prefill disagrees with its plain version (Sq={Sq} offset={off} int8={quant}): max|err| {err} > {K1_ATOL}")
    live = off + Sq  # kv slots any query reads
    pairs = sum(off + i + 1 for i in range(Sq))  # causal (query, key) pairs per q head
    flops = 4 * hd * Hq * pairs
    kv_bytes = 2 * live * Hkv * hd * (1 if quant else 2) + (2 * live * Hkv * 4 if quant else 0)
    nbytes = 2 * (Sq * Hq * hd * 2) + kv_bytes
    bound_flops, bound_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    lib_ms = None
    if not quant:
      qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
      mask = (torch.arange(CACHE, device="cuda")[None, :] <= off + torch.arange(Sq, device="cuda")[:, None])[None, None]
      lib_ms = _cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    row = dict(
      Sq=Sq, q_offset=off, kv="int8" if quant else "bf16", max_abs_err=err, tol=K1_ATOL,
      ms=_cuda_ms(torch, lambda: fa.flash_attention_prefill(q, k, v, **kw)),
      plain_ms=_cuda_ms(torch, lambda: fa.flash_attention_prefill_ref(q, k, v, **kw), iters=10),
      library_ms=lib_ms, bound_ms=max(bound_flops, bound_bytes), bound_by="operations" if bound_flops >= bound_bytes else "bytes",
    )
    results["flash_prefill"].append(row)
    log(f"[kernels] flash_prefill B=1 Sq={Sq} q_offset={off} kv={row['kv']} cache={CACHE}: max|err| {err:.3e} (tol {K1_ATOL}) | kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | sdpa {lib_ms if lib_ms is None else round(lib_ms, 4)} ms | bound {row['bound_ms']:.5f} ms ({row['bound_by']})")

  for positions in ([4095], [127], [0], [0, 1000, 2047, 4095]):
    B = len(positions)
    q = _rand(torch, (B, 1, Hq, hd), gen, torch.bfloat16)
    k = _rand(torch, (B, CACHE, Hkv, hd), gen, torch.bfloat16)
    v = _rand(torch, (B, CACHE, Hkv, hd), gen, torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")[:, None]
    got = fa.flash_decode_attention(q, k, v, pos)
    want = fa.flash_decode_attention_ref(q, k, v, pos)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got).all() or not err <= K2_ATOL:
      raise SystemExit(f"chip_smoke: flash_decode disagrees with its plain version (positions={positions}): max|err| {err} > {K2_ATOL}")
    live = sum(p + 1 for p in positions)
    nbytes = 2 * live * Hkv * hd * 2 + 2 * B * Hq * hd * 2
    flops = 4 * hd * Hq * live
    bound_flops, bound_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(CACHE, device="cuda")[None, :] <= pos)[:, None, None, :]
    row = dict(
      B=B, positions=positions, max_abs_err=err, tol=K2_ATOL,
      ms=_cuda_ms(torch, lambda: fa.flash_decode_attention(q, k, v, pos)),
      plain_ms=_cuda_ms(torch, lambda: fa.flash_decode_attention_ref(q, k, v, pos)),
      library_ms=_cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
      bound_ms=max(bound_flops, bound_bytes), bound_by="operations" if bound_flops >= bound_bytes else "bytes",
    )
    results["flash_decode"].append(row)
    log(f"[kernels] flash_decode B={B} positions={positions} cache={CACHE}: max|err| {err:.3e} (tol {K2_ATOL}) | kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | sdpa {row['library_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
  return results


# ---------------------------------------------------------------- 4. serving


class ByteTokenizer:
  """Script glue: a byte-level tokenizer for the random-weight model (ids
  0-255 are bytes; other ids render as ``[id]`` so transcripts keep them)."""

  bos_token_id = 128000
  eos_token_id = 128009

  def encode(self, text: str) -> list[int]:
    return [self.bos_token_id] + list(text.encode("utf-8"))

  def decode(self, ids) -> str:
    return "".join(chr(t) if t < 256 else f"[{t}]" for t in ids)

  def apply_chat_template(self, conversation, tokenize=False, add_generation_prompt=True) -> str:
    text = "".join(f"<|{m['role']}|>{m['content']}\n" for m in conversation)
    return text + ("<|assistant|>" if add_generation_prompt else "")


def write_checkpoint(torch, path: Path) -> float:
  """Seeded random bf16 weights at llama-3.2-1b's shapes, HF names, one
  .safetensors file (tied embeddings: no lm_head)."""
  from xotorch_support_jetson_tpu_torch.models.loader import save_safetensors

  t0 = time.perf_counter()
  c = LLAMA_3_2_1B
  D, F_, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
  qd, kd = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
  gen = torch.Generator(device="cuda").manual_seed(SEED)

  def w(out_f, in_f, scale=None):
    return (torch.randn((out_f, in_f), generator=gen, device="cuda") * (scale or in_f**-0.5)).to(torch.bfloat16).cpu()

  ones = torch.ones(D, dtype=torch.bfloat16)
  tensors = {"model.embed_tokens.weight": w(V, D, scale=0.02), "model.norm.weight": ones}
  for i in range(L):
    p = f"model.layers.{i}."
    tensors.update({
      p + "input_layernorm.weight": ones, p + "post_attention_layernorm.weight": ones,
      p + "self_attn.q_proj.weight": w(qd, D), p + "self_attn.k_proj.weight": w(kd, D),
      p + "self_attn.v_proj.weight": w(kd, D), p + "self_attn.o_proj.weight": w(D, qd),
      p + "mlp.gate_proj.weight": w(F_, D), p + "mlp.up_proj.weight": w(F_, D), p + "mlp.down_proj.weight": w(D, F_),
    })
  path.mkdir(parents=True, exist_ok=True)
  (path / "config.json").write_text(json.dumps(c, indent=1))
  save_safetensors(path / "model.safetensors", tensors)
  return time.perf_counter() - t0


def _post(port: int, body: dict):
  """One chat completion; returns (text, finish_reason, ttft_s, total_s, n_events)."""
  req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
  t0 = time.perf_counter()
  with urllib.request.urlopen(req, timeout=600) as resp:
    if resp.status != 200:
      raise SystemExit(f"chip_smoke: HTTP {resp.status}")
    if not body.get("stream"):
      data = json.loads(resp.read())
      dt = time.perf_counter() - t0
      return data["choices"][0]["message"]["content"], data["choices"][0]["finish_reason"], None, dt, 1
    text, finish, ttft, n = "", None, None, 0
    for raw in resp:
      line = raw.decode().strip()
      if not line.startswith("data: ") or line == "data: [DONE]":
        continue
      ev = json.loads(line[6:])
      if "error" in ev:
        raise SystemExit(f"chip_smoke: streaming error {ev['error']}")
      ttft = ttft if ttft is not None else time.perf_counter() - t0
      choice = ev["choices"][0]
      if choice["delta"].get("content"):
        text += choice["delta"]["content"]
        n += 1
      finish = choice["finish_reason"] or finish
    return text, finish, ttft, time.perf_counter() - t0, n


async def _serve_requests(torch, node, engine, port, plan):
  """Send ``plan`` [(label, body)] one after another; collect token ids via
  the node's token callbacks (requests are sequential)."""
  ids: dict[str, list[int]] = {}
  node.on_token.register("chip_smoke").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
  out = []
  for label, body in plan:
    before = set(ids)
    text, finish, ttft, total, n_events = await asyncio.to_thread(_post, port, body)
    new = [rid for rid in ids if rid not in before]
    if len(new) != 1:
      raise SystemExit(f"chip_smoke: expected one request's tokens for {label}, saw {len(new)}")
    toks = ids[new[0]]
    if not toks or len(toks) > body["max_tokens"] or engine.sessions:
      raise SystemExit(f"chip_smoke: {label}: {len(toks)} tokens, {len(engine.sessions)} open sessions")
    out.append(dict(label=label, stream=body["stream"], temperature=body["temperature"], tokens=toks, text=text, finish_reason=finish, ttft_s=ttft, total_s=total))
  node.on_token.deregister("chip_smoke")
  return out


def _decode_rate(r) -> float:
  """Streaming decode rate: tokens after the first over the time after the first event."""
  return (len(r["tokens"]) - 1) / max(r["total_s"] - r["ttft_s"], 1e-9)


def _rel_err(a, b) -> float:
  return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_against_plain(torch, engine):
  """The served weights through the kernel path vs the plain attention path
  (XOT_TPU_NO_FLASH): prefill logits and one K2 decode step, full width."""
  from xotorch_support_jetson_tpu_torch.models.decoder import init_kv_cache, shard_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  toks = torch.tensor([ByteTokenizer().encode("<|user|>The quick brown fox jumps over the lazy dog.\n<|assistant|>")], dtype=torch.int32, device="cuda")
  S = toks.shape[1]
  pos = torch.arange(S, dtype=torch.int32, device="cuda")[None]
  out = {}
  for mode in ("kernel", "plain"):
    # kernel: K1 for the prefill and K2 for the decode step; plain: neither.
    os.environ.update({"XOT_TPU_NO_FLASH": "1"} if mode == "plain" else {"XOT_TPU_FLASH_DECODE": "1", "XOT_TPU_FLASH_DECODE_MIN": str(CACHE)})
    cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
    pre, cache = shard_forward(params, cfg, shard, toks, pos, cache)
    step, _ = shard_forward(params, cfg, shard, toks[:, -1:], torch.tensor([[S]], dtype=torch.int32, device="cuda"), cache)
    out[mode] = (pre, step)
    for knob in ("XOT_TPU_NO_FLASH", "XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN"):
      os.environ.pop(knob, None)
  (pk, sk), (pp, sp) = out["kernel"], out["plain"]
  if tuple(pk.shape) != (1, S, cfg.vocab_size) or not (torch.isfinite(pk).all() and torch.isfinite(sk).all()):
    raise SystemExit(f"chip_smoke: bad logits shape {tuple(pk.shape)} or non-finite values")
  res = dict(prefill_rel_err=_rel_err(pk, pp), decode_rel_err=_rel_err(sk, sp), prefill_argmax_agree=float((pk.argmax(-1) == pp.argmax(-1)).float().mean()))
  # bf16 through 16 layers: the two paths round differently (bf16
  # probabilities in K1's P·V product, other accumulation orders), and the
  # difference compounds layer by layer; 5e-2 relative bounds that drift
  # while a wrong mask or head mapping gives O(1).
  if not (res["prefill_rel_err"] < 5e-2 and res["decode_rel_err"] < 5e-2):
    raise SystemExit(f"chip_smoke: kernel path disagrees with the plain path: {res}")
  return res


def _profile(torch, label, fn, reps):
  """Where ``fn``'s time goes: host wall time per call with the profiler
  off, and ``torch.profiler``'s device time per call (device-side kernel
  and copy events only: the aten op rows repeat their kernels' time)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  fn()  # warm
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3 / reps
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  events = prof.key_averages()
  device = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=lambda e: e.self_device_time_total, reverse=True)
  host = sorted((e for e in events if e.device_type == DeviceType.CPU), key=lambda e: e.self_cpu_time_total, reverse=True)
  device_ms = sum(e.self_device_time_total for e in device) / 1e3 / reps
  res = dict(
    label=label, reps=reps, wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
    launches=sum(e.count for e in host if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")) / reps,
    top_host_ops=[(e.key, round(e.count / reps, 1), round(e.self_cpu_time_total / 1e3 / reps, 4)) for e in host[:10]],
    top_device_ops=[(e.key[:70], round(e.count / reps, 1), round(e.self_device_time_total / 1e3 / reps, 4)) for e in device[:10]],
  )
  busy = "not measured (the profiler saw no device events)" if not device else f"{res['device_busy_share']:.3f}"
  log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiler off), device {device_ms:.3f} ms, device busy {busy}, {res['launches']:.0f} launches")
  log(f"[profile] {label}: host ms by op (calls, ms; profiler on): {res['top_host_ops']}")
  log(f"[profile] {label}: device ms by kernel (calls, ms): {res['top_device_ops']}")
  return res


def profile_serving(torch, engine, steps=8):
  """The served model's prefill (the engine's 128-bucket path, logits to
  the host) and its decode steps, default and with K2."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_decode, init_kv_cache

  cfg, shard = engine.cfg, engine._effective_shard
  prompt = np.asarray([ByteTokenizer().encode("<|user|>Write a short poem about a fox who learns to fly.\n<|assistant|>")], dtype=np.int32)

  def prefill():
    engine._infer_tensor_sync("profile", prompt, None)
    engine.end_request("profile")

  cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  tok = torch.full((1, 1), 65, dtype=torch.int32, device="cuda")
  start = torch.tensor([100], dtype=torch.int32, device="cuda")

  def decode():
    fused_decode(engine.params, cfg, shard, tok, cache, start, steps)

  out = {"prefill": _profile(torch, "prefill (128-token bucket)", prefill, 5)}
  out["decode"] = _profile(torch, f"decode, {steps} steps", decode, 3)
  os.environ.update(XOT_TPU_FLASH_DECODE="1", XOT_TPU_FLASH_DECODE_MIN=str(CACHE))
  try:
    out["decode_flash"] = _profile(torch, f"decode with K2, {steps} steps", decode, 3)
  finally:
    os.environ.pop("XOT_TPU_FLASH_DECODE"), os.environ.pop("XOT_TPU_FLASH_DECODE_MIN")
  return out


def phase_serving(torch):
  from xotorch_support_jetson_tpu_torch import main as tmain
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa
  from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

  ckpt = ROOT / "build" / "smoke_ckpt"
  try:
    write_s = write_checkpoint(torch, ckpt)
    log(f"[serving] wrote a random bf16 llama-3.2-1b checkpoint ({sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9:.2f} GB) in {write_s:.1f} s")
    os.environ["XOT_TPU_MODEL_DIR"] = str(ckpt)
    for knob in ("XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN", "XOT_TPU_NO_FLASH", "XOT_TPU_KV_QUANT", "XOT_TPU_PLATFORM"):
      os.environ.pop(knob, None)
    port = find_available_port("127.0.0.1")
    args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--default-model", "llama-3.2-1b", "--max-generate-tokens", str(MAX_TOKENS), "--node-id", "chip-smoke"])
    return asyncio.run(_serve(torch, tmain, Shard, fa, args, port))
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)


async def _serve(torch, tmain, Shard, fa, args, port):
  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  if engine.device.type != "cuda":
    raise SystemExit("chip_smoke: the engine did not choose the card")
  server = await api.run(host="127.0.0.1", port=port)
  try:
    t0 = time.perf_counter()
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[serving] daemon up on 127.0.0.1:{port}; weights loaded to the card in {load_s:.1f} s")
    msg = [{"role": "user", "content": "Write a short poem about a fox who learns to fly."}]

    def body(stream, temp):
      return {"model": "llama-3.2-1b", "messages": msg, "stream": stream, "temperature": temp, "max_tokens": MAX_TOKENS}

    await _serve_requests(torch, node, engine, port, [("warmup", body(False, 0))])  # first CUDA/cuBLAS work off the clock
    fa.reset_launch_counts()  # ---- the main path, counted
    run_a = await _serve_requests(torch, node, engine, port, [
      ("greedy blocking", body(False, 0)), ("greedy streaming", body(True, 0)),
      ("sampled blocking", body(False, 0.8)), ("sampled streaming", body(True, 0.8)),
    ])
    launches_a = dict(fa.LAUNCHES)
    os.environ["XOT_TPU_FLASH_DECODE"], os.environ["XOT_TPU_FLASH_DECODE_MIN"] = "1", str(CACHE)
    run_b = await _serve_requests(torch, node, engine, port, [("flash-decode greedy blocking", body(False, 0)), ("flash-decode greedy streaming", body(True, 0))])
    launches = dict(fa.LAUNCHES)  # ---- read just after the main path
    os.environ.pop("XOT_TPU_FLASH_DECODE"), os.environ.pop("XOT_TPU_FLASH_DECODE_MIN")
    for r in run_a + run_b:
      log(f"[serving] {r['label']}: {len(r['tokens'])} tokens, finish {r['finish_reason']}, ttft {r['ttft_s'] if r['ttft_s'] is None else round(r['ttft_s'], 4)} s, total {r['total_s']:.4f} s")
    for a, b, what in ((run_a[0], run_a[1], "default"), (run_b[0], run_b[1], "flash-decode")):
      if a["tokens"] != b["tokens"] or a["text"] != b["text"]:
        raise SystemExit(f"chip_smoke: {what} greedy blocking and streaming differ:\n{a['tokens']}\n{b['tokens']}")
    if launches["flash_prefill"] == 0 or launches["flash_decode"] == 0:
      raise SystemExit(f"chip_smoke: a kernel of the main path never launched: {launches}")
    n_layers = engine.cfg.n_layers
    if launches_a["flash_decode"] != 0 or launches["flash_prefill"] != n_layers * (len(run_a) + len(run_b)):
      raise SystemExit(f"chip_smoke: unexpected launch counts {launches_a} then {launches} for {len(run_a) + len(run_b)} prefills of {n_layers} layers")
    common = next((i for i, (x, y) in enumerate(zip(run_a[0]["tokens"], run_b[0]["tokens"])) if x != y), min(len(run_a[0]["tokens"]), len(run_b[0]["tokens"])))
    stream_a, stream_b = run_a[1], run_b[1]
    summary = dict(
      load_s=load_s, launches=launches, launches_default_run=launches_a, n_layers=n_layers,
      greedy_tokens_default=run_a[0]["tokens"], greedy_tokens_flash_decode=run_b[0]["tokens"], greedy_common_prefix=common,
      ttft_s=stream_a["ttft_s"], decode_tok_s=_decode_rate(stream_a),
      ttft_s_flash_decode=stream_b["ttft_s"], decode_tok_s_flash_decode=_decode_rate(stream_b),
      blocking_s=run_a[0]["total_s"], blocking_tokens=len(run_a[0]["tokens"]),
      requests=[{k: v for k, v in r.items() if k != "text"} for r in run_a + run_b],
    )
    log(f"[serving] launches on the main path {launches} ({n_layers} layers: K1 once per layer per prefill, K2 once per layer per decode step with XOT_TPU_FLASH_DECODE=1)")
    log(f"[serving] greedy blocking == streaming in both runs; default vs flash-decode greedy agree on the first {common} tokens")
    log(f"[serving] streaming TTFT {summary['ttft_s']:.4f} s, decode {summary['decode_tok_s']:.1f} tok/s; with flash decode: TTFT {summary['ttft_s_flash_decode']:.4f} s, decode {summary['decode_tok_s_flash_decode']:.1f} tok/s")
    summary["check"] = check_against_plain(torch, engine)
    log(f"[serving] kernel path vs plain path on the served weights: {summary['check']}")
    summary["profile"] = profile_serving(torch, engine)
    return summary
  finally:
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


# ---------------------------------------------------------------- main


def main() -> int:
  try:
    import torch

    from xotorch_support_jetson_tpu_torch.ops import flash_attention  # noqa: F401 — the port must be importable here
  except ImportError as e:
    print(f"chip_smoke: cannot import the PyTorch port ({e}); run from the repository root", file=sys.stderr)
    return 2
  smi = phase_device(torch)
  build_s = phase_build()
  kern = phase_kernels(torch)
  serving = phase_serving(torch)

  def entry(name, source, replaces, rows, head):
    r = rows[head]
    return {
      "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": serving["launches"][name],
      "max_abs_err": max(x["max_abs_err"] for x in rows), "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
      "bound_by": r["bound_by"], "library_ms": r["library_ms"], "at": {k: r[k] for k in r if k in ("Sq", "q_offset", "kv", "B", "positions")},
    }

  kernels_line = {"kernels": [
    entry("flash_prefill", "xotorch_support_jetson_tpu_torch/csrc/flash_prefill.cu", "xotorch_support_jetson_tpu/ops/pallas_attention.py:32", kern["flash_prefill"], 0),
    entry("flash_decode", "xotorch_support_jetson_tpu_torch/csrc/flash_decode.cu", "xotorch_support_jetson_tpu/ops/pallas_attention.py:190", kern["flash_decode"], 0),
  ]}
  record = dict(card=smi, build_s=build_s, kernels=kern, serving=serving, summary=kernels_line)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=float))
  if not all(math.isfinite(x["ms"]) for x in kernels_line["kernels"]):
    raise SystemExit("chip_smoke: non-finite kernel time")
  print(json.dumps(kernels_line), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
