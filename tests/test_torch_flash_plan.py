"""K1's launch plan (``ops/kernels.py prefill_plan`` / ``prefill_item``, the
host side of ``csrc/flash_prefill.cu``) on the CPU, and K1's plain version
against the JAX package's Pallas kernel in interpret mode at the GQA groups
and head dims the redesigned kernel takes (f32, the reference's own
tolerance rtol = atol = 2e-5, tests/test_pallas_attention.py). The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.ops import pallas_attention as jpa
from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa
from xotorch_support_jetson_tpu_torch.ops.kernels import PREFILL_ROWS, SMEM_LIMIT, prefill_item, prefill_plan

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
H100_SMS = 132
# (B, Sq, Hq, Hkv, hd): llama-3.2-1b's solo bucket and long prompts, the
# batched path's four rows, every GQA group the kernel takes, hd 128 / 256.
GRIDS = [
  (1, 128, 32, 8, 64), (1, 4096, 32, 8, 64), (1, 3000, 32, 8, 64), (4, 512, 32, 8, 64), (1, 1, 32, 8, 64),
  (2, 777, 8, 8, 64), (1, 300, 24, 2, 64), (1, 65, 64, 1, 64), (1, 2048, 32, 8, 128), (3, 130, 16, 4, 256),
]


@pytest.mark.parametrize("B,Sq,Hq,Hkv,hd", GRIDS)
@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_plan_covers_every_item_once_heaviest_first(B, Sq, Hq, Hkv, hd, quantized):
  """Blocks 0 … blocks-1 decode (as the kernel does) to every (q tile,
  batch row, kv head) exactly once; the q tiles cover every position and
  no tile lies wholly past Sq; and at equal offsets no block has a longer
  causal range than one launched before it."""
  plan = prefill_plan(hd, quantized, B, Sq, Hq, Hkv, H100_SMS)
  bq, n_qt, span = plan["bq"], plan["n_qt"], plan["consumers"] * plan["bq"]
  assert bq * (Hq // Hkv) <= PREFILL_ROWS and (n_qt - 1) * span < Sq <= n_qt * span
  items = [prefill_item(i, B, Hkv, n_qt) for i in range(plan["blocks"])]
  assert sorted(items) == sorted((qt, b, g) for qt in range(n_qt) for b in range(B) for g in range(Hkv))
  horizons = [min(Sq, (qt + 1) * span) - 1 for qt, _, _ in items]  # last position a block holds, offset 0
  assert horizons == sorted(horizons, reverse=True)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Sq", [1, 128, 4096])
def test_prefill_plan_fits_the_card(hd, quantized, Sq):
  """Shared memory stays within what one H100 block can opt into for every
  head dim, KV type and consumer count; the ring holds at least two stages
  (a consumer keeps one tile while the next lands); a block's threads are
  one producer and its consumers."""
  plan = prefill_plan(hd, quantized, 1, Sq, 32, 8, H100_SMS)
  assert plan["smem"] <= SMEM_LIMIT
  assert plan["stages"] >= 2 and plan["raw_stages"] == ((2 if hd == 64 else 1) if quantized else 0)
  assert plan["threads"] == 128 * (plan["consumers"] + 1)
  assert plan["block_k"] in (64, 128) and plan["block_k"] % 16 == 0


def test_prefill_plan_takes_three_consumers_only_where_they_pay():
  """Three consumer warpgroups (192 rows share a tile) only at hd 64 and only
  once such a grid covers the card more than once; short prompts keep two
  (more, smaller blocks for a fixed-cost-bound call)."""
  assert prefill_plan(64, False, 1, 128, 32, 8, H100_SMS)["consumers"] == 2
  assert prefill_plan(64, False, 1, 512, 32, 8, H100_SMS)["consumers"] == 2
  assert prefill_plan(64, False, 1, 1024, 32, 8, H100_SMS)["consumers"] == 3
  assert prefill_plan(64, True, 1, 4096, 32, 8, H100_SMS)["consumers"] == 3
  assert prefill_plan(64, False, 4, 512, 32, 8, H100_SMS)["consumers"] == 3
  assert prefill_plan(128, False, 1, 4096, 32, 8, H100_SMS)["consumers"] == 2
  assert prefill_plan(256, True, 1, 4096, 32, 8, H100_SMS)["consumers"] == 2
  assert prefill_plan(64, False, 1, 1024, 32, 8, 1000)["consumers"] == 2  # a card with more SMs


def _qkv(B, Sq, Skv, Hq, Hkv, hd, seed):
  rng = np.random.default_rng(seed)
  return tuple(rng.standard_normal(s).astype(np.float32) for s in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))


@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 8, 64), (16, 2, 64), (8, 1, 64), (8, 2, 128), (4, 4, 128)])
def test_prefill_plain_matches_jax_flash_groups_and_head_dims(Hq, Hkv, hd):
  """GQA groups 1, 4 and 8 at hd 64, groups 4 and 1 at hd 128, per-row
  offsets, junk past each row's last position."""
  q, k, v = _qkv(2, 128, 384, Hq, Hkv, hd, seed=hd + Hq)
  off = np.asarray([0, 256], np.int32)
  for b in range(2):
    k[b, off[b] + 128 :] = 1e4
    v[b, off[b] + 128 :] = 1e4
  want = np.asarray(jpa.flash_attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(off), interpret=True))
  got = fa.flash_attention_prefill_ref(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=torch.from_numpy(off)).numpy()
  assert np.isfinite(got).all()
  np.testing.assert_allclose(got, want, **TOL)
