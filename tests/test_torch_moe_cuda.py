"""The port's MoE FFN on the card (ops/moe.py): its two paths agree at
Qwen3-30B-A3B's expert shapes (128 experts of 2048 → 768, top-8, bf16 and
int8 / int4 experts), each call counted under its path, and a small MoE
model's captured solo programs (a prefill bucket and decode steps, both
paths inside the replays) equal the uncaptured functions.

Needs an NVIDIA GPU; every test here is marked ``cuda`` and skips without a
card. This file imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_moe_cuda.py``. Tolerance: both paths run bf16 products
with f32 routing and f32 combine sums, in another order, so they agree to
a few bf16 rounding steps: relative L2 within 1e-2.
"""

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import decoder as tdec
from xotorch_support_jetson_tpu_torch.models.config import tiny_test_config
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params
from xotorch_support_jetson_tpu_torch.ops import moe
from xotorch_support_jetson_tpu_torch.utils import programs

pytestmark = pytest.mark.cuda
REL_L2 = 1e-2
D, E, F, K = 2048, 128, 768, 8  # Qwen/Qwen3-30B-A3B: hidden, experts, expert width, top-k


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU")
  return torch.device("cuda")


def _rel(a, b):
  return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("weights", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("T", [1, 8, 72])
def test_gather_and_einsum_paths_agree(dev, monkeypatch, T, weights):
  gen = torch.Generator(device=dev).manual_seed(0)

  def rand(*shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

  router, x = rand(D, E, scale=D**-0.5), rand(T, D)
  w = {"w_experts_gate": rand(E, D, F, scale=D**-0.5), "w_experts_up": rand(E, D, F, scale=D**-0.5), "w_experts_down": rand(E, F, D, scale=F**-0.5)}
  scales = {}
  if weights != "bf16":
    q = quantize_params({"moe_layers": {k: v[None] for k, v in w.items()}}, weights)["moe_layers"]
    w = {k: q[k][0] for k in w}
    scales = dict(gate_scale=q["w_experts_gate_scale"][0], up_scale=q["w_experts_up_scale"][0], down_scale=q["w_experts_down_scale"][0])
  outs = {}
  monkeypatch.setattr(moe, "REFERENCE_GATHER_MAX", 1 << 20)  # the gather path at any T when the knob is on
  for path, knob in (("gather", "1"), ("einsum", "0")):
    monkeypatch.setenv("XOT_TPU_MOE_GATHER", knob)
    moe.reset_path_counts()
    outs[path] = moe.moe_ffn(x, router, w["w_experts_gate"], w["w_experts_up"], w["w_experts_down"], k=K, norm_topk=True, hidden_dim=F, **scales)
    assert dict(moe.PATHS) == {f"{path}@{T}": 1}
  assert outs["gather"].dtype == torch.bfloat16 and outs["gather"].shape == (T, D)
  assert _rel(outs["gather"], outs["einsum"]) < REL_L2


@pytest.mark.parametrize("knob", ["1", "0"], ids=["gather", "einsum"])
def test_captured_moe_programs_equal_eager(dev, monkeypatch, knob):
  """A 3-layer MoE model (hd 64, so K1 runs its prefills): the captured
  128 bucket's logits and 12 captured greedy steps against the uncaptured
  functions on a fresh cache; the MoE path calls of the replays are
  counted (``REPLAYED``)."""
  monkeypatch.setenv("XOT_TPU_MOE_GATHER", knob)
  cfg = tiny_test_config(vocab_size=512, dim=256, n_heads=4, n_kv_heads=2, hidden_dim=256, n_layers=3, max_seq_len=512, dtype=torch.bfloat16, n_experts=16, n_active_experts=4, moe_hidden_dim=128, norm_topk_prob=True, qk_norm=True)
  shard = Shard("tiny-moe", 0, 2, 3)
  params = tdec.init_shard_params(cfg, shard, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
  assert "moe_layers" in params and "layers" not in params
  prompt = np.random.default_rng(2).integers(0, 512, (1, 40)).astype(np.int32)
  x = np.zeros((1, 128), np.int32)
  x[0, :40] = prompt

  def run(captured: bool):
    cache = tdec.init_kv_cache(cfg, 3, 1, 512, device=dev)
    if captured:
      progs = tdec.SoloPrograms(params, cfg, shard, cache)
      logits = progs.prefill(x, 40)
      first = int(logits[0].argmax())
      toks = tdec.fused_decode(params, cfg, shard, first, cache, 40, 6, programs=progs)[0]
      toks2 = tdec.fused_decode(params, cfg, shard, int(toks[0, -1]), cache, 46, 6, programs=progs)[0]  # replays only
      return logits, torch.cat([toks, toks2], 1)
    out, _ = tdec.shard_forward(params, cfg, shard, torch.from_numpy(x).to(dev), torch.arange(128, dtype=torch.int32, device=dev)[None], cache, head_pos=torch.tensor([39], device=dev))
    first = int(out[0, 0].argmax())
    toks = tdec.fused_decode(params, cfg, shard, torch.full((1, 1), first, dtype=torch.int32, device=dev), cache, torch.tensor([40], dtype=torch.int32, device=dev), 12)[0]
    return out[:, 0], toks

  want_logits, want = run(False)
  programs.reset_replayed()
  moe.reset_path_counts()
  got_logits, got = run(True)
  assert _rel(got_logits, want_logits) < REL_L2
  assert got.tolist() == want.tolist()
  path = "gather" if knob == "1" else "einsum"
  assert programs.REPLAYED.get(f"{path}@1", 0) == 3 * 11  # steps 2..12 replay the captured step (3 layers)
