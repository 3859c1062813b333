"""Placement policy: layer-space partitions and memory-weighted assignment
(own copy of the reference's ``topology/partitioning.py``).

Placement is a deterministic function of the topology view (memory
descending, then node id), so every peer that has merged the same view
computes the same partitions without a consensus round. Layer ranges are
contiguous, non-overlapping and cover ``[0, n_layers)`` exactly whatever
the float rounding: the cumulative boundaries are rounded, not each
node's width.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass

from ..inference.shard import Shard
from .topology import Topology


@dataclass(frozen=True)
class Partition:
  node_id: str
  start: float  # fraction of layer space, [0, 1)
  end: float

  def to_dict(self) -> dict:
    return {"node_id": self.node_id, "start": self.start, "end": self.end}


class PartitioningStrategy(ABC):
  @abstractmethod
  def partition(self, topology: Topology) -> list[Partition]:
    ...


def map_partitions_to_shards(partitions: list[Partition], n_layers: int, model_id: str) -> list[Shard]:
  """Fractional partitions → contiguous inclusive layer-range shards.

  Boundaries are ``round(p.end * n_layers)`` clamped monotonic, the last
  forced to ``n_layers``: coverage is exact even when the fractions do not
  sum to 1.0 bit-exactly. A partition too thin to own a layer gets no
  shard."""
  shards: list[Shard] = []
  prev_boundary = 0
  for i, partition in enumerate(partitions):
    boundary = round(partition.end * n_layers) if i < len(partitions) - 1 else n_layers
    boundary = max(prev_boundary, min(boundary, n_layers))
    if i == len(partitions) - 1:
      boundary = n_layers
    if boundary > prev_boundary:
      shards.append(Shard(model_id, prev_boundary, boundary - 1, n_layers))
    prev_boundary = boundary
  return shards


class RingMemoryWeightedPartitioningStrategy(PartitioningStrategy):
  """Each node gets a contiguous fraction of the layers proportional to its
  memory. Ring order: memory descending, then node id descending."""

  def partition(self, topology: Topology) -> list[Partition]:
    nodes = sorted(topology.all_nodes(), key=lambda kv: (kv[1].memory, kv[0]), reverse=True)
    total_memory = sum(caps.memory for _, caps in nodes)
    if total_memory == 0:
      # Every memory unknown: an equal split.
      n = len(nodes)
      return [Partition(node_id, i / n, (i + 1) / n) for i, (node_id, _) in enumerate(nodes)]
    partitions: list[Partition] = []
    start = 0.0
    for node_id, caps in nodes:
      end = round(start + caps.memory / total_memory, 5)
      partitions.append(Partition(node_id, start, end))
      start = end
    return partitions
