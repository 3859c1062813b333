"""The port's weight quantization against the JAX package's, on the CPU:
the quantizers give identical codes, scales and leaf sets (the arithmetic
is the same f32); ``qdot`` in its three modes (w8a16, w8a8, packed int4)
agrees within 1e-5 relative; K4's plain version agrees with the Pallas
kernel run in interpret mode; ``params_from_jax`` carries a quantized tree
across; and the quantized decoder's logits agree within rtol = atol = 2e-4
for tied and untied heads. K4 on the card is in
tests/test_torch_kernels_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec, quantize as jq
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec, quantize as tq
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.models.loader import check_shard_params
from xotorch_support_jetson_tpu_torch.ops import int4_matmul as k4

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
MODES = {"int8": ("int8", "w8a16"), "w8a8": ("int8", "w8a8"), "int4": ("int4", "w8a16")}


def _f32(shape, seed, scale=1.0):
  return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bf16_exact(shape, seed):
  """f32 values that bf16 represents exactly (the Pallas kernel casts x to bf16)."""
  return torch.from_numpy(_f32(shape, seed)).to(torch.bfloat16).float().numpy()


def test_leaf_tables_match_jax():
  assert tq.QUANT_STACK_LEAVES == jq.QUANT_STACK_LEAVES
  assert tq.QUANT_TOP_LEAVES == jq.QUANT_TOP_LEAVES


@pytest.mark.parametrize("shape", [(64, 32), (3, 48, 40), (2, 128, 8)])
def test_weight_quantizers_are_bit_identical_to_jax(shape):
  w = _f32(shape, 1, 0.3)
  w[..., 0] = 0.0  # an all-zero output channel takes scale 1
  for port, ref in ((tq.quantize_weight, jq.quantize_weight), (tq.quantize_weight_int4, jq.quantize_weight_int4)):
    q, s = port(torch.from_numpy(w))
    jq_, js = ref(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.is_contiguous()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
  packed, _ = tq.quantize_weight_int4(torch.from_numpy(w))
  np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), np.asarray(jq.unpack_int4(jnp.asarray(packed.numpy()))))


def test_int4_quantizer_rejects_an_odd_in_dim():
  with pytest.raises(ValueError, match="even in-dim"):
    tq.quantize_weight_int4(torch.zeros(5, 4))


def _pair(tied: bool, n_layers=2):
  kw = dict(n_layers=n_layers, max_seq_len=128, tied_embedding=tied, vocab_size=256, rope_theta=500000.0)
  jc, tc = jconfig.tiny_test_config(**kw), tconfig.tiny_test_config(**kw)
  js, ts = JShard("tiny", 0, n_layers - 1, n_layers), Shard("tiny", 0, n_layers - 1, n_layers)
  jp = jdec.init_shard_params(jax.random.PRNGKey(5), jc, js)
  return jc, tc, js, ts, jp


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_matches_jax(mode, tied):
  jc, tc, js, ts, jp = _pair(tied)
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, ts)
  got = tq.quantize_params(tp, mode)
  want = jax.tree.map(np.asarray, jq.quantize_params(jp, mode))
  assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
  assert "lm_head_scale" in got and ("lm_head" not in tp) == tied  # a tied head is materialised from embed.T
  for key, val in [*((f"layers/{k}", v) for k, v in got["layers"].items()), *((k, v) for k, v in got.items() if k != "layers")]:
    ref = want["layers"][key[7:]] if key.startswith("layers/") else want[key]
    assert val.shape == ref.shape, key
    np.testing.assert_array_equal(val.numpy(), ref, err_msg=key)
  assert got["layers"]["attn_norm"] is tp["layers"]["attn_norm"] and got["embed"] is tp["embed"]  # untouched leaves are shared
  check_shard_params(got, tc, ts)


def test_quantize_params_refuses_what_the_port_does_not_load():
  _, tc, _, ts, jp = _pair(False)
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, ts)
  with pytest.raises(ValueError, match="unsupported quantization mode"):
    tq.quantize_params(tp, "fp8")
  with pytest.raises(NotImplementedError, match="parameter groups"):
    tq.quantize_params({**tp, "unet": {}}, "int8")
  tower = {"vision": {"patch_embed": tp["embed"][:4]}, "projector": {"w1": tp["layers"]["wq"][0]}}
  kept = tq.quantize_params({**tp, **tower}, "int8")  # llava's tower and projector stay as they are, as the reference's
  assert kept["vision"] is tower["vision"] and kept["projector"] is tower["projector"]
  assert "moe_layers" in tq.quantize_params({**tp, "moe_layers": {}}, "int8")  # the MoE stack is quantized
  q = tq.quantize_params(tp, "int8")
  assert tq.quantize_params(q, "int8")["layers"]["wq"] is q["layers"]["wq"]  # already int8: left as it is


def test_check_shard_params_validates_quantized_leaves():
  _, tc, _, ts, jp = _pair(False)
  q = tq.quantize_params(params_from_jax(jax.tree.map(np.asarray, jp), tc, ts), "int4")
  check_shard_params(q, tc, ts)
  bad = {**q, "layers": {**q["layers"], "wq_scale": q["layers"]["wq_scale"][:, :-1]}}
  with pytest.raises(ValueError, match="wq_scale"):
    check_shard_params(bad, tc, ts)
  bad = {**q, "layers": {**q["layers"], "wk": q["layers"]["wk"].float()}}
  with pytest.raises(ValueError, match="layers/wk"):
    check_shard_params(bad, tc, ts)


@pytest.mark.parametrize("mode,kernel", [("int8", "1"), ("w8a8", "1"), ("int4", "1"), ("int4", "0")], ids=["int8", "w8a8", "int4", "int4-two-dot"])
def test_qdot_matches_jax(mode, kernel, monkeypatch):
  monkeypatch.setenv("XOT_TPU_INT4_KERNEL", kernel)
  layout, compute = MODES[mode]
  x = _f32((3, 5, 96), 2)
  w = _f32((96, 40), 3, 0.1)
  quant = jq.quantize_weight_int4 if layout == "int4" else jq.quantize_weight
  q, s = quant(jnp.asarray(w))
  want = np.asarray(jq.qdot(jnp.asarray(x), q, s, compute))
  got = tq.qdot(torch.from_numpy(x), torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)), compute)
  assert got.shape == want.shape and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int4_plain_version_matches_the_pallas_kernel():
  """K4's plain version against the JAX kernel in interpret mode (as
  tests/test_quantize.py runs it), T=4, in=1024, out=512. x is drawn from
  bf16-representable values, so the kernel's bf16 cast of x is lossless and
  both sides sum exact products in f32: they agree to 1e-5 relative."""
  from xotorch_support_jetson_tpu.ops.pallas_int4 import int4_matmul as jax_int4_matmul

  x = _bf16_exact((4, 1024), 4)
  packed, scale = jq.quantize_weight_int4(jnp.asarray(_f32((1024, 512), 5, 0.05)))
  want = np.asarray(jax_int4_matmul(jnp.asarray(x), packed, scale, interpret=True))
  got = k4.int4_matmul_ref(torch.from_numpy(x), torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale)))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_plain_version_matches_the_pallas_kernel_past_256_rows(dtype):
  """The kernel gate no longer caps rows at 256: the plain version against
  the JAX kernel in interpret mode at T=300 (in 1024, out 512), x drawn from
  bf16-representable values. In f32 both sum exact products in f32 (1e-5
  relative); in bf16 both round the f32 sum once to bf16, so they may differ
  by one rounding step (2^-7 of the value) where the two summation orders
  straddle a rounding boundary."""
  from xotorch_support_jetson_tpu.ops.pallas_int4 import int4_matmul as jax_int4_matmul

  x = _bf16_exact((300, 1024), 10)
  packed, scale = jq.quantize_weight_int4(jnp.asarray(_f32((1024, 512), 11, 0.05)))
  want = jax_int4_matmul(jnp.asarray(x, dtype=getattr(jnp, dtype)), packed, scale, interpret=True)
  got = k4.int4_matmul_ref(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale)))
  assert got.shape == (300, 512) and got.dtype == getattr(torch, dtype)
  want = np.asarray(want.astype(jnp.float32))
  if dtype == "float32":
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
  else:
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-5 * np.abs(want).max())


def test_int4_matmul_on_the_cpu_takes_the_plain_version():
  x = torch.from_numpy(_bf16_exact((3, 64), 6)).to(torch.bfloat16)
  packed, scale = tq.quantize_weight_int4(torch.from_numpy(_f32((64, 24), 7)))
  before = k4.LAUNCHES["int4_matmul"]
  got = k4.int4_matmul(x, packed, scale)
  assert k4.LAUNCHES["int4_matmul"] == before and got.dtype == torch.bfloat16
  torch.testing.assert_close(got, k4.int4_matmul_ref(x, packed, scale), rtol=0, atol=0)
  with pytest.raises(ValueError, match="no kernel for device"):
    k4.int4_matmul(x.to("meta"), packed.to("meta"), scale.to("meta"))


def test_int4_kernel_gate(monkeypatch):
  monkeypatch.delenv("XOT_TPU_INT4_KERNEL", raising=False)
  assert k4.int4_kernel_supported((1, 2048), (1024, 128256))
  assert k4.int4_kernel_supported((256, 1536), (768, 1000))  # no tile constraints: ragged edges are masked
  assert k4.int4_kernel_supported((257, 2048), (1024, 512))  # no row cap: batched prefills past 256 rows run the kernel
  assert k4.int4_kernel_supported((4000, 2048), (1024, 8192))
  assert not k4.int4_kernel_supported((4, 2048), (2048, 512))  # int8 layout
  assert not k4.int4_kernel_supported((2, 4, 2048), (1024, 512))
  monkeypatch.setenv("XOT_TPU_INT4_KERNEL", "0")
  assert not k4.int4_kernel_supported((1, 2048), (1024, 128256))


@pytest.mark.parametrize("T", [1, 2, 3, 8, 17, 128, 256, 300, 1000])
@pytest.mark.parametrize("d_in,d_out", [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256), (2048, 1000), (1536, 512), (64, 24)])
def test_int4_launch_plan_covers_the_in_axis(T, d_in, d_out):
  """The kernel's launch geometry: the cluster's blocks cover every packed
  row once, the cluster stays within its limit, and the token and channel
  tiles cover T and out — on an H100 SXM (132 SMs) with and without the
  wgmma tile (f32 or unaligned x), and on a card with 114 SMs."""
  K = d_in // 2
  for sms, wide in ((132, True), (132, False), (114, True)):
    cfg, split = k4.plan(T, d_in, d_out, sms, wide)
    assert cfg in (0, 1, 2) and 1 <= split <= k4.MAX_SPLIT and split & (split - 1) == 0
    ranges = k4.k_ranges(K, cfg, split)
    assert len(ranges) == split and ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(split - 1))  # each packed row once
    assert all(b > a for a, b in ranges)  # no block of the cluster idles
    tile_t = k4.TILE_T[cfg]
    assert tile_t >= min(T, k4.TILE_T[1]) and (cfg == 0 or T > k4.TILE_T[0])  # a tile that holds T, or 32 rows and more
    assert (cfg == 2) == (wide and T > k4.TILE_T[1] and T * d_in * d_out >= k4.WIDE_MACS)  # the wgmma tile for long products it takes
    block_out = k4.BLOCK_OUT[cfg]
    assert -(-T // tile_t) * tile_t >= T and -(-d_out // block_out) * block_out >= d_out
    blocks = -(-T // tile_t) * -(-d_out // block_out) * split
    full = blocks >= sms or (cfg == 2 and 2 * blocks > sms)  # the grid covers the card (the wide tile: one block per SM)
    assert full or split == k4.MAX_SPLIT or 2 * split > -(-K // k4.STAGE_ROWS[cfg])
    assert split == 1 or blocks <= 8 * sms  # a split never makes more than a few blocks per SM


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantized_decoder_matches_jax(mode, tied):
  """``params_from_jax`` on a JAX-quantized tree, then prefill and greedy
  decode through both decoders: the codes arrive bit for bit, logits agree
  within 2e-4 and greedy tokens are identical."""
  layout, compute = MODES[mode]
  jc, tc, js, ts, jp = _pair(tied)
  jc, tc = dataclasses.replace(jc, quant_compute=compute), dataclasses.replace(tc, quant_compute=compute)
  jqp = jq.quantize_params(jp, layout)
  tp = params_from_jax(jax.tree.map(np.asarray, jqp), tc, ts)
  for key, val in tp["layers"].items():
    assert val.dtype == (torch.int8 if np.asarray(jqp["layers"][key]).dtype == np.int8 else torch.float32), key
    np.testing.assert_array_equal(val.numpy(), np.asarray(jqp["layers"][key]), err_msg=key)
  assert tp["lm_head"].dtype == torch.int8 and tp["lm_head_scale"].dtype == torch.float32
  toks = np.random.default_rng(8).integers(0, 256, (2, 9)).astype(np.int32)
  pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
  jl, jcache = jdec.shard_forward(jqp, jc, js, jnp.asarray(toks), jnp.asarray(pos), jdec.init_kv_cache(jc, 2, 2, 48))
  tl, tcache = tdec.shard_forward(tp, tc, ts, torch.from_numpy(toks), torch.from_numpy(pos), tdec.init_kv_cache(tc, 2, 2, 48))
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
  first = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
  jt, _ = jdec.fused_decode(jqp, jc, js, jnp.asarray(first), jcache, jnp.full((2,), 9, jnp.int32), 8)
  tt, _ = tdec.fused_decode(tp, tc, ts, torch.from_numpy(first), tcache, torch.full((2,), 9, dtype=torch.int32), 8)
  np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_dequantize_leaf_matches_jax():
  w = _f32((2, 32, 24), 9, 0.2)
  for quant_t, quant_j in ((tq.quantize_weight, jq.quantize_weight), (tq.quantize_weight_int4, jq.quantize_weight_int4)):
    q, s = quant_t(torch.from_numpy(w))
    jqq, jss = quant_j(jnp.asarray(w))
    np.testing.assert_array_equal(tq.dequantize_leaf(q, s, 32, torch.float32).numpy(), np.asarray(jq.dequantize_leaf(jqq, jss, 32, jnp.float32)))
  assert tq.is_quantized({"wq_scale": None}, "wq") and not tq.is_quantized({"wq": None}, "wq")
