"""Cross-cutting helpers: debug level, the framework's home directory,
boolean and float env knobs, node identity, free-port probing, named
callback channels (``AsyncCallbackSystem``), the host's IPv4 interfaces
and their ranking for UDP discovery, and the on-device placement rule of
the port's entry points. Own copy of the subset of the reference's
``utils/helpers.py`` the serving slice uses."""

from __future__ import annotations

import os
import random
import socket
import uuid
from pathlib import Path
from typing import Callable

DEBUG = int(os.getenv("DEBUG", "0"))
DEBUG_DISCOVERY = int(os.getenv("DEBUG_DISCOVERY", "0"))


def xot_home() -> Path:
  """The framework's home directory: ``XOT_TPU_HOME``, default
  ``~/.cache/xot_tpu``. Read at each call, so a process that sets it after
  import (a test, a smoke run) finds its own."""
  return Path(os.getenv("XOT_TPU_HOME", Path.home() / ".cache" / "xot_tpu"))


def env_flag(name: str, default: bool = False) -> bool:
  """Boolean env var: unset → default; '', '0', 'false', 'no', 'off' (any
  case) → False; anything else ('1', 'true', 'yes', ...) → True."""
  val = os.getenv(name)
  if val is None:
    return default
  return val.strip().lower() not in ("", "0", "false", "no", "off")


def env_float(name: str, default: float) -> float:
  """Float env var: unset, empty, or malformed → default (a typo'd knob
  degrades to the shipped behaviour, never crashes a policy read)."""
  try:
    return float(os.getenv(name, "") or default)
  except ValueError:
    return default


class _Channel:
  def __init__(self) -> None:
    self.observers: list[Callable] = []

  def on_next(self, callback: Callable) -> None:
    self.observers.append(callback)


class AsyncCallbackSystem:
  """Named observer channels (the reference's ``AsyncCallbackSystem``):
  ``register(name).on_next(callback)``; ``trigger_all(*args)`` calls every
  observer of every channel."""

  def __init__(self) -> None:
    self._channels: dict[str, _Channel] = {}

  def register(self, name: str) -> _Channel:
    return self._channels.setdefault(name, _Channel())

  def deregister(self, name: str) -> None:
    self._channels.pop(name, None)

  def trigger_all(self, *args) -> None:
    for channel in list(self._channels.values()):
      for observer in channel.observers:
        observer(*args)


def find_available_port(host: str = "", min_port: int = 49152, max_port: int = 65535) -> int:
  """Pick a free TCP port by bind-probing random candidates."""
  for _ in range(100):
    port = random.randint(min_port, max_port)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
      try:
        s.bind((host, port))
        return port
      except OSError:
        continue
  raise RuntimeError("no available port found")


def get_or_create_node_id() -> str:
  """Stable node identity persisted under the framework cache dir
  (``XOT_TPU_UUID`` pins it)."""
  if env_id := os.getenv("XOT_TPU_UUID"):
    return env_id
  id_file = xot_home() / ".node_id"
  try:
    if id_file.is_file():
      stored = id_file.read_text().strip()
      if stored:
        return stored
    node_id = str(uuid.uuid4())
    id_file.parent.mkdir(parents=True, exist_ok=True)
    id_file.write_text(node_id)
    return node_id
  except OSError:
    return str(uuid.uuid4())


def resolve_device(device=None):
  """The device an entry point runs on.

  Default is ``cuda``; ``XOT_TPU_PLATFORM=cpu`` (the reference's own device
  override) or an explicit ``device="cpu"`` selects the CPU. A CUDA device
  with no card visible raises — there is no silent fallback to the CPU.
  """
  import torch

  if device is None:
    device = "cpu" if os.getenv("XOT_TPU_PLATFORM", "").lower() == "cpu" else "cuda"
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device is visible; pass device='cpu' (or set XOT_TPU_PLATFORM=cpu) to run on the CPU")
  return device


# UDP discovery's interface ranking (the reference's table): a peer seen on
# several interfaces is kept on the best one.
INTERFACE_PRIORITY = {
  "ici": 50,
  "thunderbolt": 40,
  "ethernet": 30,
  "wifi": 20,
  "other": 10,
  "loopback": 5,
}


def get_interface_priority_and_type(interface_name: str) -> tuple[int, str]:
  name = interface_name.lower()
  if name.startswith("lo"):
    return INTERFACE_PRIORITY["loopback"], "loopback"
  if name.startswith(("eth", "en", "eno", "ens", "enp")):
    return INTERFACE_PRIORITY["ethernet"], "ethernet"
  if name.startswith(("wlan", "wl", "wifi")):
    return INTERFACE_PRIORITY["wifi"], "wifi"
  if "thunderbolt" in name or name.startswith("tb"):
    return INTERFACE_PRIORITY["thunderbolt"], "thunderbolt"
  return INTERFACE_PRIORITY["other"], "other"


def get_all_ip_addresses_and_interfaces() -> list[tuple[str, str]]:
  """(IPv4 address, interface name) of every local interface that has one,
  read from the kernel (``SIOCGIFADDR``): no name resolution and no packet
  sent. Loopback alone when nothing else answers."""
  import fcntl
  import struct

  results: list[tuple[str, str]] = []
  try:
    interfaces = socket.if_nameindex()
  except OSError:
    interfaces = []
  with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
    for _, name in interfaces:
      try:
        packed = fcntl.ioctl(s.fileno(), 0x8915, struct.pack("256s", name.encode()[:15]))  # SIOCGIFADDR
      except OSError:
        continue  # no IPv4 address on this interface
      results.append((socket.inet_ntoa(packed[20:24]), name))
  return results or [("127.0.0.1", "lo")]
