"""Discovery contract (own copy of the reference's ``networking/discovery.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from .peer_handle import PeerHandle


class Discovery(ABC):
  @abstractmethod
  async def start(self) -> None:
    ...

  @abstractmethod
  async def stop(self) -> None:
    ...

  @abstractmethod
  async def discover_peers(self, wait_for_peers: int = 0) -> list[PeerHandle]:
    ...


class NoDiscovery(Discovery):
  """``--discovery-module none``: a node with no peers."""

  async def start(self) -> None:
    pass

  async def stop(self) -> None:
    pass

  async def discover_peers(self, wait_for_peers: int = 0) -> list[PeerHandle]:
    return []
