"""The decode-path dispatch (``inference/paging.py``) against the JAX
package's: the first-row-wins walk on the reference's own tables,
``XOT_TPU_PAGED_KERNEL`` forcing, the CPU's "gather" answer (the
reference's off-TPU one), the H100 table's walk on a CUDA device and
``resolved_decode_path``; the paged programs' ``use_kernel=None``
resolution through it, the batched server's ``decode_chunks_total{path=}``
label and its ``paged_kernel_tile`` gauge (``ops/paged.py``: 0 where K3
does not run, else the pages one K3 block covers)."""

import itertools

import pytest
import torch

from xotorch_support_jetson_tpu.inference import paging as jpaging
from xotorch_support_jetson_tpu.models import config as jconfig
from xotorch_support_jetson_tpu_torch.inference import paging as tpaging
from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.ops import kernels, paged as tpaged

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

BATCHES = (1, 2, 4, 5, 16, 17, 48, 49, 96)
CONTEXTS = (1, 1024, 4096, 4097, 8192, 8193, 65536)
QUANTS = ("", "int8", "int4")
GRID = list(itertools.product(BATCHES, CONTEXTS, QUANTS))


@pytest.fixture
def knobs(monkeypatch):
  monkeypatch.delenv("XOT_TPU_PAGED_KERNEL", raising=False)
  return monkeypatch


@pytest.mark.parametrize("table", ["_DECODE_PATH_TABLE", "_PAGE_TILE_TABLE"])
def test_table_walk_matches_the_reference_on_its_tables(table):
  """The port's walk answers the reference's own tables as the
  reference's walk does at every grid point (bounds inclusive, None any,
  first row wins, the last row's verdict past every row)."""
  rows = getattr(jpaging, table)
  for b, c, q in GRID:
    assert tpaging._table_match(rows, b, c, q) == jpaging._table_match(rows, b, c, q), (b, c, q)
  assert tpaging._table_match(((1, 1, "x", "a"),), 5, 5, "") == jpaging._table_match(((1, 1, "x", "a"),), 5, 5, "") == "a"


@pytest.mark.parametrize("forced,want", [("1", "kernel"), ("true", "kernel"), ("0", "gather"), ("false", "gather"), ("", "gather")])
def test_forcing_matches_the_reference(knobs, forced, want):
  """``XOT_TPU_PAGED_KERNEL`` forces the path on every platform, the
  reference's parse (set to anything env_flag reads as true: "kernel")."""
  knobs.setenv("XOT_TPU_PAGED_KERNEL", forced)
  for b, c, q in GRID[::7]:
    got = {tpaging.select_decode_path(b, c, q, platform=p) for p in ("cpu", "gpu")}
    assert got == {jpaging.select_decode_path(b, c, q, platform="tpu")} == {want}


def test_cpu_answers_gather_as_the_reference_does_off_tpu(knobs):
  for b, c, q in GRID:
    assert tpaging.select_decode_path(b, c, q, device=torch.device("cpu")) == jpaging.select_decode_path(b, c, q, platform="cpu") == "gather"
    assert tpaging.select_decode_path(b, c, q) == "gather"  # no device: the CPU


def test_cuda_walks_the_h100_table(knobs, monkeypatch):
  """On a CUDA device (or ``platform="gpu"``) the answer is the H100
  table's, never the reference's TPU table; swapping the table in changes
  the answer, so nothing else decides it."""
  for b, c, q in GRID:
    want = tpaging._table_match(tpaging._H100_DECODE_PATH_TABLE, b, c, q)
    assert tpaging.select_decode_path(b, c, q, device=torch.device("cuda", 0)) == tpaging.select_decode_path(b, c, q, platform="gpu") == want
  monkeypatch.setattr(tpaging, "_H100_DECODE_PATH_TABLE", ((4, 4096, "", "dense"), (None, None, None, "gather")))
  assert tpaging.select_decode_path(4, 4096, "", platform="gpu") == "dense"
  assert tpaging.select_decode_path(5, 4096, "", platform="gpu") == tpaging.select_decode_path(4, 4096, "int8", platform="gpu") == "gather"
  assert tpaging._H100_DECODE_PATH_TABLE[-1][:3] == (None, None, None)


def test_h100_table_rows_are_well_formed():
  rows = tpaging._H100_DECODE_PATH_TABLE
  assert rows[-1] == (None, None, None, "kernel")  # "kernel" wherever no measured point says otherwise
  for max_b, max_ctx, quant, path in rows:
    assert path in ("kernel", "gather", "dense") and quant in (None, "", "int8", "int4")
    assert not (quant == "int4" and path == "dense")  # no int4 dense layout in the table


@pytest.mark.parametrize("cfg_kind", ["plain", "gemma2", "mla"])
@pytest.mark.parametrize("paged", [True, False])
def test_resolved_path_matches_the_reference(knobs, cfg_kind, paged):
  """The label of ``decode_chunks_total{path=}``: "dense" off the paged
  layout; inside it the table's answer, "dense" degraded to "kernel", and
  "gather" for a config K3 cannot serve — the reference's resolution on
  the CPU (gather everywhere, also with "gather" forced). Forced to
  "kernel", the port runs K3's route wherever K3 serves the config (its
  plain version on the CPU), where the reference's kernel exists on a TPU
  only: the label says "kernel" for the plain config, "gather" otherwise."""
  kw = {"plain": {}, "gemma2": dict(attn_logit_softcap=50.0), "mla": dict(kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)}[cfg_kind]
  jc, tc = jconfig.tiny_test_config(**kw), tconfig.tiny_test_config(**kw)
  for forced in (None, "0", "1"):
    if forced is not None:
      knobs.setenv("XOT_TPU_PAGED_KERNEL", forced)
    for b, c, q in GRID[::5]:
      got = tpaging.resolved_decode_path(b, c, q, paged=paged, cfg=tc, platform="cpu")
      want = jpaging.resolved_decode_path(b, c, q, paged=paged, cfg=jc, platform="cpu")
      if forced == "1" and paged and cfg_kind == "plain":
        want = "kernel"
      assert got == want, (cfg_kind, forced, b, c, q)


def test_paged_programs_resolve_use_kernel_through_the_table(knobs, monkeypatch):
  """``use_kernel=None`` in the paged programs: "gather" from the table
  (the CPU, or the H100 table's verdict) takes the gather route, anything
  else K3's; a config K3 cannot serve never takes it."""
  cfg = tconfig.tiny_test_config()
  pool = {"k": torch.zeros(1), "v": torch.zeros(1)}
  assert not tdec.paged_use_kernel(cfg, 4, 1024, pool, torch.device("cpu"))
  calls = []
  monkeypatch.setattr(tpaging, "select_decode_path", lambda b, c, q, platform=None, device=None: calls.append((b, c, q)) or "dense")
  assert tdec.paged_use_kernel(cfg, 4, 1024, pool, torch.device("cpu")) and calls == [(4, 1024, "")]
  assert not tdec.paged_use_kernel(tconfig.tiny_test_config(attn_logit_softcap=50.0), 4, 1024, pool, torch.device("cpu"))


def test_paged_kernel_tile_gauge(monkeypatch):
  """0 off the card; on a card the pages of a row's window one K3 block
  covers, from K3's launch plan at the pool's shape."""
  cfg = tconfig.tiny_test_config(n_heads=32, n_kv_heads=8, dim=2048)
  assert tpaged.paged_kernel_tile(cfg, 8, 4096, 64, "cpu") == 0
  monkeypatch.setattr(tpaged, "sm_count", lambda index=None: 132)
  for B, ctx, ps in ((1, 4096, 64), (8, 4096, 64), (64, 8192, 64), (8, 1024, 16)):
    _, range_ = kernels.decode_plan(ctx, kernels.decode_rows(B, 32, 8), 132)
    assert tpaged.paged_kernel_tile(cfg, B, ctx, ps, "cuda") == -(-range_ // ps) >= 1


@pytest.mark.parametrize("B,ctx,ps", [(1, 1024, 16), (8, 4096, 64), (32, 4096, 16), (64, 8192, 64)])
def test_paged_kernel_tile_stays_within_the_window(monkeypatch, B, ctx, ps):
  """A block's pages cover its slot range and no more than the row's
  window: the tile is at least 1 and at most the window's pages."""
  cfg = tconfig.tiny_test_config(n_heads=32, n_kv_heads=8, dim=2048)
  monkeypatch.setattr(tpaged, "sm_count", lambda index=None: 132)
  _, range_ = kernels.decode_plan(ctx, kernels.decode_rows(B, 32, 8), 132)
  tile = tpaged.paged_kernel_tile(cfg, B, ctx, ps, "cuda")
  assert 1 <= tile <= -(-ctx // ps) and (tile - 1) * ps < range_ <= tile * ps
