"""Cluster topology graph (own copy of the reference's ``topology/topology.py``).

``nodes`` maps node id → DeviceCapabilities, ``peer_graph`` is a directed
adjacency of observed connections, and ``merge()`` folds a peer's
transitive view into ours: the ring agrees on membership without
consensus, because placement is a deterministic function of the merged
view (topology/partitioning.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from .device_capabilities import DeviceCapabilities


@dataclass(frozen=True)
class PeerConnection:
  from_id: str
  to_id: str
  description: str | None = None

  def to_dict(self) -> dict:
    return {"from_id": self.from_id, "to_id": self.to_id, "description": self.description}


class Topology:
  def __init__(self) -> None:
    self.nodes: dict[str, DeviceCapabilities] = {}
    self.peer_graph: dict[str, set[PeerConnection]] = {}
    self.active_node_id: str | None = None

  def update_node(self, node_id: str, device_capabilities: DeviceCapabilities) -> None:
    self.nodes[node_id] = device_capabilities

  def get_node(self, node_id: str) -> DeviceCapabilities | None:
    return self.nodes.get(node_id)

  def all_nodes(self):
    return self.nodes.items()

  def add_edge(self, from_id: str, to_id: str, description: str | None = None) -> None:
    conn = PeerConnection(from_id, to_id, description)
    self.peer_graph.setdefault(from_id, set()).add(conn)

  def get_neighbors(self, node_id: str) -> set[str]:
    return {conn.to_id for conn in self.peer_graph.get(node_id, set())}

  def merge(self, peer_node_id: str, other: "Topology") -> None:
    """Fold a peer's (transitive) topology view into ours."""
    for node_id, caps in other.nodes.items():
      self.update_node(node_id, caps)
    for node_id, connections in other.peer_graph.items():
      for conn in connections:
        self.add_edge(conn.from_id, conn.to_id, conn.description)

  def to_json(self) -> dict:
    return {
      "nodes": {node_id: caps.to_dict() for node_id, caps in self.nodes.items()},
      "peer_graph": {node_id: [c.to_dict() for c in conns] for node_id, conns in self.peer_graph.items()},
      "active_node_id": self.active_node_id,
    }

  @classmethod
  def from_json(cls, data: dict) -> "Topology":
    topology = cls()
    for node_id, caps in data.get("nodes", {}).items():
      topology.update_node(node_id, DeviceCapabilities.from_dict(caps))
    for node_id, conns in data.get("peer_graph", {}).items():
      for conn in conns:
        topology.add_edge(conn["from_id"], conn["to_id"], conn.get("description"))
    topology.active_node_id = data.get("active_node_id")
    return topology

  def __str__(self) -> str:
    nodes_str = ", ".join(f"{node_id}: {caps}" for node_id, caps in self.nodes.items())
    return f"Topology(nodes: {{{nodes_str}}}, edges: {self.peer_graph})"
