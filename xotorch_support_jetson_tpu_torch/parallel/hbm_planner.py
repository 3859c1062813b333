"""Ahead-of-time memory budget of a ring (own copy of the ring part of the
reference's ``parallel/hbm_planner.py``).

The head of a ring checks the partition map against each member's
reported memory before any download or load starts, and refuses a map
that cannot hold the model (``RingBudgetError``; the API answers 507)
instead of running out of memory mid-prefill. Byte counts come from the
port's own constructors on the ``meta`` device (``init_shard_params``,
``init_kv_cache``, ``quantize_params``): the shapes and dtypes the engine
allocates, with nothing allocated. The reference's mesh plans (tp / pp /
sp on one host's chips) are not ported.
"""

from __future__ import annotations

from ..inference.shard import Shard
from ..models.config import ModelConfig

# Activations, graph pools and fragmentation: the share of a node's memory
# kept free of weights (the reference's figure).
DEFAULT_HEADROOM = 0.15


def _tree_bytes(tree) -> int:
  total = 0
  for v in tree.values():
    total += _tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
  return total


def param_shapes(cfg: ModelConfig, shard: Shard | None = None, quant: str | None = None) -> dict:
  """The shard's parameter tree on the ``meta`` device: shapes and dtypes,
  no storage."""
  from ..models.decoder import init_shard_params

  shard = shard or Shard("planner", 0, cfg.n_layers - 1, cfg.n_layers)
  params = init_shard_params(cfg, shard, device="meta")
  if quant:
    from ..models.quantize import quantize_params

    params = quantize_params(params, quant)
  return params


def model_bytes(cfg: ModelConfig, shard: Shard | None = None, quant: str | None = None) -> int:
  """Weight bytes of a shard."""
  return _tree_bytes(param_shapes(cfg, shard, quant))


def kv_cache_bytes(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int | None = None) -> int:
  """Bytes of a dense slot cache for ``n_layers`` layers (default all)."""
  from ..models.decoder import init_kv_cache

  return _tree_bytes(init_kv_cache(cfg, n_layers if n_layers is not None else cfg.n_layers, batch, max_seq, device="meta"))


class RingBudgetError(RuntimeError):
  """A ring's partition map cannot hold the model: raised by the node
  before any download or weight load begins (orchestration/node.py
  ``_ring_budget_problems``)."""


def ring_partition_fits(cfg: ModelConfig, shards: list[Shard], memories_bytes: list[int], quant: str | None = None, headroom: float = DEFAULT_HEADROOM) -> list[str]:
  """Each span's weight bytes against its node's memory less the headroom:
  the problems found, one line each (empty: the ring fits)."""

  def fmt(n: int) -> str:
    return f"{n / 1024**3:.2f} GiB" if n >= 1024**3 else f"{n / 1024**2:.1f} MiB"

  problems = []
  for shard, mem in zip(shards, memories_bytes):
    need = model_bytes(cfg, shard, quant)
    if need > mem * (1.0 - headroom):
      problems.append(f"node span [{shard.start_layer}-{shard.end_layer}] needs {fmt(need)} weights but has {fmt(mem)}")
  return problems
