"""The unit of model partitioning: a contiguous, inclusive layer range.

Own copy of the reference's ``inference/shard.py``. The solo slice always
serves the full-model shard; the type stays so engine and registry keep
the reference's contract.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(order=True, frozen=True)
class Shard:
  model_id: str
  start_layer: int
  end_layer: int  # inclusive
  n_layers: int

  @property
  def is_first_layer(self) -> bool:
    return self.start_layer == 0

  @property
  def is_last_layer(self) -> bool:
    return self.end_layer == self.n_layers - 1

  @property
  def n_shard_layers(self) -> int:
    return self.end_layer - self.start_layer + 1
