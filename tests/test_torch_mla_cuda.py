"""MLA (deepseek-v2/v3) on the card: the absorbed op against the naive
per-head form at DeepSeek-Coder-V2-Lite's and DeepSeek-V3's attention
widths, a small MLA model's captured solo programs against the uncaptured
functions (K1–K3 launch no time on it), and K4 at DeepSeek-Coder-V2-Lite's
two-dimensional weight products against its plain version.

Needs an NVIDIA GPU; every test here is marked ``cuda`` and skips without a
card. This file imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_mla_cuda.py``. Tolerances: the absorbed op runs in f32 on
bf16 inputs and rounds its output to bf16, the naive form stays in f32 on
the same bf16 values, so they differ by that rounding (at most 2^-8 of
each element, so of the relative L2) and the order of their f32 sums:
relative L2 within 4e-3. A bf16 model's
captured and uncaptured logits within 5e-2 relative L2 (the rounding of one
bf16 forward against another), and its greedy ids identical. K4 within its
``chip_smoke.py`` bound, ``1e-4 + 2^-7·|ref|`` elementwise.
"""

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import decoder as tdec
from xotorch_support_jetson_tpu_torch.models.config import tiny_test_config
from xotorch_support_jetson_tpu_torch.models.quantize import quantize_weight_int4
from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged
from xotorch_support_jetson_tpu_torch.ops.attention import gqa_attention, mla_absorbed_attention

pytestmark = pytest.mark.cuda
# (heads, kv_lora_rank, nope, rope, v): DeepSeek-Coder-V2-Lite, DeepSeek-V3
WIDTHS = {"v2-lite": (16, 512, 128, 64, 128), "v3": (128, 512, 128, 64, 128)}
# DeepSeek-Coder-V2-Lite's products under int4 weights, (in, out)
PRODUCTS = [(2048, 3072), (2048, 576), (2048, 2048), (2048, 10944), (10944, 2048), (2048, 2816), (2816, 2048), (2048, 102400)]


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU")
  return torch.device("cuda")


def _rel(a, b):
  return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("Sq", [1, 128])
@pytest.mark.parametrize("model", sorted(WIDTHS))
def test_absorbed_equals_naive_on_the_card(dev, model, Sq):
  """Sq queries at the end of a 4,096-slot bf16 latent cache: the absorbed
  op against per-head K/V built from the same latents through kv_b and
  ``gqa_attention`` at the same 1/sqrt(nope + rope) scale, in f32."""
  H, rank, nope, rope, vd = WIDTHS[model]
  S = 4096
  gen = torch.Generator(device=dev).manual_seed(3)

  def rand(*shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

  q_nope, q_pe, ckv, kpe, w = rand(1, Sq, H, nope), rand(1, Sq, H, rope), rand(1, S, rank), rand(1, S, rope), rand(rank, H * (nope + vd), scale=rank**-0.5)
  qpos = torch.arange(S - Sq, S, dtype=torch.int32, device=dev)[None]
  kvpos = torch.arange(S, dtype=torch.int32, device=dev)
  got = mla_absorbed_attention(q_nope, q_pe, ckv, kpe, w, qpos, kvpos, vd)
  kv = (ckv.float() @ w.float()).view(1, S, H, nope + vd)
  q = torch.cat([q_nope.float(), q_pe.float()], dim=-1)
  k = torch.cat([kv[..., :nope], kpe.float()[:, :, None, :].expand(1, S, H, rope)], dim=-1)
  want = gqa_attention(q, k, kv[..., nope:], qpos, kvpos)
  assert got.dtype == torch.bfloat16 and got.shape == (1, Sq, H, vd)
  assert _rel(got, want) < 4e-3


def test_captured_mla_programs_equal_eager(dev):
  """A 3-layer MLA model (layer 0 dense, two MoE layers, no q LoRA): the
  captured 128 bucket's logits and 12 captured greedy steps against the
  uncaptured functions on a fresh latent cache; K1, K2 and K3 never
  launch."""
  cfg = tiny_test_config(
    vocab_size=512, dim=256, n_heads=4, n_kv_heads=4, hidden_dim=256, n_layers=3, max_seq_len=512, dtype=torch.bfloat16, n_experts=16, n_active_experts=4,
    moe_hidden_dim=128, shared_expert_dim=128, first_k_dense=1, kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
  )
  shard = Shard("tiny-mla", 0, 2, 3)
  params = tdec.init_shard_params(cfg, shard, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
  assert "wkv_b" in params["layers"] and "wkv_b" in params["moe_layers"]
  prompt = np.random.default_rng(2).integers(0, 512, (1, 40)).astype(np.int32)
  x = np.zeros((1, 128), np.int32)
  x[0, :40] = prompt

  def run(captured: bool):
    cache = tdec.init_kv_cache(cfg, 3, 1, 512, device=dev)
    assert cache["k"].shape == (3, 1, 512, 1, 64) and cache["v"].shape == (3, 1, 512, 1, 16)
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

  fa.reset_launch_counts()
  paged.reset_launch_counts()
  want_logits, want = run(False)
  got_logits, got = run(True)
  assert _rel(got_logits, want_logits) < 5e-2
  assert got.tolist() == want.tolist()
  assert not any(fa.LAUNCHES.values()) and not any(paged.LAUNCHES.values())


@pytest.mark.parametrize("d_in,d_out", PRODUCTS)
def test_k4_at_deepseek_coder_v2_lite_products(dev, d_in, d_out):
  gen = torch.Generator(device=dev).manual_seed(5)
  packed, scale = quantize_weight_int4(torch.randn((d_in, d_out), generator=gen, device=dev) * d_in**-0.5)
  x = torch.randn((1, d_in), generator=gen, device=dev).to(torch.bfloat16)
  n0 = k4.LAUNCHES["int4_matmul"]
  got = k4.int4_matmul(x, packed, scale)
  want = k4.int4_matmul_ref(x, packed, scale)
  assert k4.LAUNCHES["int4_matmul"] == n0 + 1
  diff = (got.float() - want.float()).abs()
  assert bool((diff <= 1e-4 + 2**-7 * want.float().abs()).all())
