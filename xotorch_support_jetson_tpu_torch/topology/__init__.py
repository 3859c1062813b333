from .device_capabilities import (
  DeviceCapabilities,
  DeviceFlops,
  UNKNOWN_DEVICE_CAPABILITIES,
  device_capabilities,
)
from .partitioning import (
  Partition,
  PartitioningStrategy,
  RingMemoryWeightedPartitioningStrategy,
  map_partitions_to_shards,
)
from .topology import PeerConnection, Topology

__all__ = [
  "DeviceCapabilities",
  "DeviceFlops",
  "UNKNOWN_DEVICE_CAPABILITIES",
  "device_capabilities",
  "Partition",
  "PartitioningStrategy",
  "RingMemoryWeightedPartitioningStrategy",
  "map_partitions_to_shards",
  "PeerConnection",
  "Topology",
]
