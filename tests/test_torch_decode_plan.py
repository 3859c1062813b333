"""The host side of the port's decode attention kernels (K2 flash decode, K3
paged decode), on the CPU. The launch plan (``ops/kernels.py
decode_plan``): for any window, number of (row, kv head) clusters and SM
count it gives what the kernel's launch accepts (a cluster that is a power
of two of at most 16 blocks, and cluster·range ≥ window: block r reads
window slots [r·range, (r+1)·range), so every slot is read by exactly one
block), never a block that starts past the window, and a grid within one
block per SM. The build (``ops/kernels.py``): both kernels share a header,
so a library's name hashes the headers its source includes."""

import pytest

from xotorch_support_jetson_tpu_torch.ops import kernels as kn


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [1, 8, 32, 64, 256])
@pytest.mark.parametrize("window", [1, 7, 64, 65, 100, 1000, 4096, 4097, 8192, 16384, 131072])
def test_decode_plan_covers_every_slot_once(window, rows, sms):
  cluster, range_ = kn.decode_plan(window, rows, sms)
  assert 1 <= cluster <= 16 and cluster & (cluster - 1) == 0 and range_ >= 1  # the launch refuses anything else
  assert cluster * range_ >= window  # the blocks' ranges reach the window's end
  assert (cluster - 1) * range_ < window  # the last block starts inside the window
  if cluster > 1:
    assert cluster <= kn.MAX_CLUSTER and rows * cluster <= sms  # one block per SM
    assert window > cluster // 2 * kn.MIN_RANGE  # doubled only while a block kept more than MIN_RANGE slots


@pytest.mark.parametrize("B,Hq,Hkv,want", [(1, 32, 8, 8), (4, 32, 8, 32), (8, 32, 8, 64), (2, 16, 2, 4), (1, 8, 8, 8), (3, 64, 4, 24)])
def test_decode_rows_counts_clusters(B, Hq, Hkv, want):
  """One cluster per (batch row, kv head, group of up to 8 q heads)."""
  assert kn.decode_rows(B, Hq, Hkv) == want


def test_decode_plan_fills_the_card_once():
  """At llama-3.2-1b's decode shapes on an H100 (132 SMs): the cluster
  grows while the grid keeps within one block per SM, up to 8."""
  assert kn.decode_plan(4096, kn.decode_rows(1, 32, 8), 132) == (8, 512)
  assert kn.decode_plan(4096, kn.decode_rows(4, 32, 8), 132) == (4, 1024)
  assert kn.decode_plan(4096, kn.decode_rows(8, 32, 8), 132) == (2, 2048)
  assert kn.decode_plan(16384, kn.decode_rows(1, 32, 8), 132) == (8, 2048)
  assert kn.decode_plan(100, 8, 132) == (2, 50)  # 100 slots are more than MIN_RANGE for one block: split once


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
  for name in ("flash_decode", "paged_decode"):
    assert [p.name for p in kn.sources(name)] == [f"{name}.cu", "decode_attention.cuh"]
  (tmp_path / "x.cu").write_text('#include "h.cuh"\n#include <cuda_runtime.h>\n')
  (tmp_path / "h.cuh").write_text('#include "g.cuh"\n')
  (tmp_path / "g.cuh").write_text("// one\n")
  monkeypatch.setattr(kn, "CSRC", tmp_path)
  before = kn.library_path("x")
  assert kn.library_path("x") == before
  (tmp_path / "g.cuh").write_text("// two\n")  # a header two includes deep
  assert kn.library_path("x") != before
