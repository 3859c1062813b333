"""UDP-broadcast peer discovery (own copy of the reference's
``networking/udp/udp_discovery.py``).

Every ``broadcast_interval`` a node sends a presence beacon (its id, its
peer server's port, its capabilities and the interface's rank) from each
IPv4 interface to ``broadcast_port``; it listens on ``listen_port``. A
beacon's sender is adopted after a health check, unless
``allowed_node_ids`` or ``allowed_interface_types`` filter it out; a peer
seen on a better-ranked interface replaces the worse link. A sweep evicts
peers whose beacons stopped for ``discovery_timeout`` seconds, or that
failed ``XOT_TPU_HEALTH_FAILS`` health checks in a row. A loopback
interface beacons to 127.255.255.255, which stays on the host; any other
to the segment's broadcast address. The interfaces come from the kernel
(utils/helpers.py ``get_all_ip_addresses_and_interfaces``), with no name
resolution.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
import traceback
from typing import Callable

from ...topology.device_capabilities import DeviceCapabilities, UNKNOWN_DEVICE_CAPABILITIES, device_capabilities
from ...utils.helpers import DEBUG_DISCOVERY, get_all_ip_addresses_and_interfaces, get_interface_priority_and_type
from ..discovery import Discovery
from ..peer_handle import PeerHandle
from ..retry import peer_health


class ListenProtocol(asyncio.DatagramProtocol):
  def __init__(self, on_message: Callable[[bytes, tuple[str, int]], None]) -> None:
    self.on_message = on_message

  def connection_made(self, transport):
    self.transport = transport

  def datagram_received(self, data, addr):
    asyncio.create_task(self.on_message(data, addr))


class BroadcastProtocol(asyncio.DatagramProtocol):
  def __init__(self, message: str, broadcast_port: int, source_ip: str) -> None:
    self.message = message
    self.broadcast_port = broadcast_port
    self.source_ip = source_ip

  def connection_made(self, transport):
    sock = transport.get_extra_info("socket")
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    target = "127.255.255.255" if self.source_ip.startswith("127.") else "<broadcast>"
    transport.sendto(self.message.encode("utf-8"), (target, self.broadcast_port))
    transport.close()


class UDPDiscovery(Discovery):
  def __init__(
    self,
    node_id: str,
    node_port: int,
    listen_port: int,
    broadcast_port: int,
    create_peer_handle: Callable[[str, str, str, DeviceCapabilities], PeerHandle],
    broadcast_interval: float = 2.5,
    discovery_timeout: float = 30.0,
    device_capabilities: DeviceCapabilities | None = None,
    allowed_node_ids: list[str] | None = None,
    allowed_interface_types: list[str] | None = None,
  ) -> None:
    self.node_id = node_id
    self.node_port = node_port
    self.listen_port = listen_port
    self.broadcast_port = broadcast_port
    self.create_peer_handle = create_peer_handle
    self.broadcast_interval = broadcast_interval
    self.discovery_timeout = discovery_timeout
    self.device_capabilities = device_capabilities
    self.allowed_node_ids = allowed_node_ids
    self.allowed_interface_types = allowed_interface_types
    # peer_id → (handle, connected_at, last_seen, priority, interface_type)
    self.known_peers: dict[str, tuple[PeerHandle, float, float, int, str]] = {}
    self._tasks: list[asyncio.Task] = []

  async def start(self) -> None:
    if self.device_capabilities is None:
      self.device_capabilities = await device_capabilities()
    self._tasks = [
      asyncio.create_task(self.task_broadcast_presence()),
      asyncio.create_task(self.task_listen_for_peers()),
      asyncio.create_task(self.task_cleanup_peers()),
    ]

  async def stop(self) -> None:
    for task in self._tasks:
      task.cancel()
    await asyncio.gather(*self._tasks, return_exceptions=True)
    self._tasks = []

  async def discover_peers(self, wait_for_peers: int = 0) -> list[PeerHandle]:
    if wait_for_peers > 0:
      while len(self.known_peers) < wait_for_peers:
        if DEBUG_DISCOVERY >= 2:
          print(f"[udp] waiting for peers: {len(self.known_peers)}/{wait_for_peers}")
        await asyncio.sleep(0.1)
    return [handle for handle, *_ in self.known_peers.values()]

  # ------------------------------------------------------------------ tasks

  async def task_broadcast_presence(self) -> None:
    while True:
      try:
        for addr, interface_name in get_all_ip_addresses_and_interfaces():
          priority, if_type = get_interface_priority_and_type(interface_name)
          message = json.dumps(
            {
              "type": "discovery",
              "node_id": self.node_id,
              "node_port": self.node_port,
              "device_capabilities": self.device_capabilities.to_dict(),
              "priority": priority,
              "interface_name": interface_name,
              "interface_type": if_type,
            }
          )
          transport = None
          try:
            transport, _ = await asyncio.get_running_loop().create_datagram_endpoint(
              lambda: BroadcastProtocol(message, self.broadcast_port, addr),
              local_addr=(addr, 0),
              family=socket.AF_INET,
            )
          except Exception:  # noqa: BLE001 — interface may be down
            if DEBUG_DISCOVERY >= 3:
              traceback.print_exc()
          finally:
            if transport is not None:
              try:
                transport.close()
              except Exception:  # noqa: BLE001
                pass
      except Exception:  # noqa: BLE001
        if DEBUG_DISCOVERY >= 2:
          traceback.print_exc()
      await asyncio.sleep(self.broadcast_interval)

  async def on_listen_message(self, data: bytes, addr: tuple[str, int]) -> None:
    if not data:
      return
    decoded = data.decode("utf-8", errors="ignore")
    try:
      message = json.loads(decoded)
    except json.JSONDecodeError:
      return
    if not isinstance(message, dict) or message.get("type") != "discovery":
      return
    peer_id = message.get("node_id")
    if not peer_id or peer_id == self.node_id:
      return
    if self.allowed_node_ids and peer_id not in self.allowed_node_ids:
      if DEBUG_DISCOVERY >= 2:
        print(f"[udp] ignoring peer {peer_id}: not in allowed list")
      return
    peer_interface_type = message.get("interface_type", "other")
    if self.allowed_interface_types and peer_interface_type not in self.allowed_interface_types:
      return

    peer_host = addr[0]
    peer_port = message.get("node_port")
    peer_priority = message.get("priority", 0)
    peer_address = f"{peer_host}:{peer_port}"
    now = time.time()

    existing = self.known_peers.get(peer_id)
    if existing is not None:
      handle, connected_at, _, prio, if_type = existing
      if handle.addr() == peer_address or prio >= peer_priority:
        # Same address or an equal/better link already known: refresh last_seen.
        self.known_peers[peer_id] = (handle, connected_at, now, prio, if_type)
        return
      # Better link: replace below.

    caps = DeviceCapabilities.from_dict(message.get("device_capabilities", {})) if message.get("device_capabilities") else UNKNOWN_DEVICE_CAPABILITIES
    handle = self.create_peer_handle(peer_id, peer_address, f"{peer_interface_type} ({peer_priority})", caps)
    if not await handle.health_check():
      if DEBUG_DISCOVERY >= 1:
        print(f"[udp] peer {peer_id} at {peer_address} failed health check; not adopting")
      return
    self.known_peers[peer_id] = (handle, now, now, peer_priority, peer_interface_type)
    if DEBUG_DISCOVERY >= 1:
      print(f"[udp] adopted peer {peer_id} at {peer_address}")

  async def task_listen_for_peers(self) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
      sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):
      pass
    sock.bind(("", self.listen_port))
    transport, _ = await asyncio.get_running_loop().create_datagram_endpoint(lambda: ListenProtocol(self.on_listen_message), sock=sock)
    try:
      while True:
        await asyncio.sleep(3600)
    finally:
      transport.close()

  async def task_cleanup_peers(self) -> None:
    while True:
      try:
        now = time.time()
        dead: list[str] = []
        for peer_id, (handle, connected_at, last_seen, *_rest) in list(self.known_peers.items()):
          stale = now - last_seen > self.discovery_timeout
          # Flap damping (networking/retry.py): one failed health check
          # (e.g. a 5 s GC stall on the peer) must NOT trigger eviction —
          # and with it replay/repartition churn. The handle's health_check
          # records the outcome centrally; eviction needs
          # XOT_TPU_HEALTH_FAILS consecutive failures. The stale-beacon
          # timeout short-circuits (same as before this layer existed): a
          # stale peer is usually a dead one, and probing it would block
          # the sweep for the full connect timeout per corpse.
          if stale or (not await handle.health_check() and peer_health.is_dead(peer_id)):
            dead.append(peer_id)
        for peer_id in dead:
          entry = self.known_peers.pop(peer_id, None)
          if entry is not None:
            if DEBUG_DISCOVERY >= 1:
              print(f"[udp] evicting peer {peer_id}")
            # Reset the damping state: a re-adopted incarnation starts fresh.
            peer_health.forget(peer_id)
            try:
              await entry[0].disconnect()
            except Exception:  # noqa: BLE001
              pass
      except Exception:  # noqa: BLE001
        if DEBUG_DISCOVERY >= 2:
          traceback.print_exc()
      await asyncio.sleep(self.broadcast_interval)
