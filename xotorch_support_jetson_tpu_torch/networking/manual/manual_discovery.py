"""Static-topology discovery from a JSON config file, hot-reloaded (own copy
of the reference's ``networking/manual/manual_discovery.py``).

The config is polled every ``poll_interval`` seconds and re-read when its
mtime changes, so edits take effect without a restart. A listed peer is
adopted once it passes a health check, and dropped when the config stops
listing it or after ``XOT_TPU_HEALTH_FAILS`` failed checks in a row.
"""

from __future__ import annotations

import asyncio
import os
from typing import Callable

from ...topology.device_capabilities import DeviceCapabilities
from ...utils.helpers import DEBUG_DISCOVERY
from ..discovery import Discovery
from ..peer_handle import PeerHandle
from ..retry import peer_health
from .network_topology_config import NetworkTopology, peer_device_capabilities


class ManualDiscovery(Discovery):
  def __init__(
    self,
    network_config_path: str,
    node_id: str,
    create_peer_handle: Callable[[str, str, str, DeviceCapabilities], PeerHandle],
    poll_interval: float = 5.0,
  ) -> None:
    self.network_config_path = network_config_path
    self.node_id = node_id
    self.create_peer_handle = create_peer_handle
    self.poll_interval = poll_interval
    self.known_peers: dict[str, PeerHandle] = {}
    self._cached_mtime: float | None = None
    self._cached_config: NetworkTopology | None = None
    self._task: asyncio.Task | None = None

  async def start(self) -> None:
    await self._refresh_peers()
    self._task = asyncio.create_task(self._poll_loop())

  async def stop(self) -> None:
    if self._task is not None:
      self._task.cancel()
      try:
        await self._task
      except asyncio.CancelledError:
        pass
      self._task = None

  async def discover_peers(self, wait_for_peers: int = 0) -> list[PeerHandle]:
    if wait_for_peers > 0:
      while len(self.known_peers) < wait_for_peers:
        await asyncio.sleep(0.1)
    return list(self.known_peers.values())

  async def _poll_loop(self) -> None:
    while True:
      await asyncio.sleep(self.poll_interval)
      try:
        await self._refresh_peers()
      except Exception as e:  # noqa: BLE001 — keep polling through bad edits
        if DEBUG_DISCOVERY >= 1:
          print(f"[manual] config refresh failed: {e}")

  def _load_config(self) -> NetworkTopology | None:
    try:
      mtime = os.path.getmtime(self.network_config_path)
    except OSError:
      return None
    if self._cached_config is not None and self._cached_mtime == mtime:
      return self._cached_config
    config = NetworkTopology.from_path(self.network_config_path)
    self._cached_mtime, self._cached_config = mtime, config
    return config

  async def _refresh_peers(self) -> None:
    config = self._load_config()
    if config is None:
      return
    wanted = {peer_id: peer for peer_id, peer in config.peers.items() if peer_id != self.node_id}

    for peer_id, peer in wanted.items():
      address = f"{peer.address}:{peer.port}"
      existing = self.known_peers.get(peer_id)
      if existing is not None and existing.addr() == address:
        continue
      handle = self.create_peer_handle(peer_id, address, "manual", peer_device_capabilities(peer))
      if await handle.health_check():
        self.known_peers[peer_id] = handle
        if DEBUG_DISCOVERY >= 1:
          print(f"[manual] adopted peer {peer_id} at {address}")

    for peer_id in list(self.known_peers):
      if peer_id not in wanted:
        handle = self.known_peers.pop(peer_id)
        try:
          await handle.disconnect()
        except Exception:  # noqa: BLE001
          pass
      else:
        # Flap damping (networking/retry.py): drop a configured peer only
        # after XOT_TPU_HEALTH_FAILS consecutive failed checks, not one.
        await self.known_peers[peer_id].health_check()
        if peer_health.is_dead(peer_id):
          peer_health.forget(peer_id)  # the next adoption probes fresh
          self.known_peers.pop(peer_id, None)
