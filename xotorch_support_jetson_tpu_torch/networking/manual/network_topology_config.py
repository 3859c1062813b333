"""Static network topology config (own copy of the reference's
``networking/manual/network_topology_config.py``, validated by hand: the
card's machine has no pydantic).

The file is a JSON object ``{"peers": {node_id: {"address": str, "port":
int, "device_capabilities": {...}}}}``; other keys are ignored. The rules
follow the reference's pydantic model in its lax mode, so both packages
accept and refuse the same files: ``port`` takes an integer, a bool, an
integral finite float, or a string holding an integer (spaces, a sign,
underscores and a ``.0`` fraction allowed); ``address`` must be a string
and ``device_capabilities`` an object. A refusal raises ``ValueError``, a
missing file ``FileNotFoundError``.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass

from ...topology.device_capabilities import DeviceCapabilities

_INTEGRAL_TEXT = re.compile(r"^[+-]?\d(?:_?\d)*\.0*$")


@dataclass(frozen=True)
class PeerConfig:
  address: str
  port: int
  device_capabilities: dict


def _lax_int(v, where: str) -> int:
  if isinstance(v, bool):
    return int(v)
  if isinstance(v, int):
    return v
  if isinstance(v, float) and math.isfinite(v) and v == int(v):
    return int(v)
  if isinstance(v, str):
    s = v.strip()
    try:
      return int(s)
    except ValueError:
      if _INTEGRAL_TEXT.match(s):
        return int(s.split(".")[0].replace("_", ""))
  raise ValueError(f"{where}: an integer is required, got {v!r}")


@dataclass(frozen=True)
class NetworkTopology:
  peers: dict[str, PeerConfig]

  @classmethod
  def from_dict(cls, data) -> "NetworkTopology":
    if not isinstance(data, dict) or "peers" not in data:
      raise ValueError("the config must be an object with a 'peers' field")
    if not isinstance(data["peers"], dict):
      raise ValueError("'peers' must be an object of node id → peer")
    peers = {}
    for node_id, peer in data["peers"].items():
      where = f"peers.{node_id}"
      if not isinstance(peer, dict):
        raise ValueError(f"{where}: a peer must be an object")
      missing = [k for k in ("address", "port", "device_capabilities") if k not in peer]
      if missing:
        raise ValueError(f"{where}: missing {missing}")
      if not isinstance(peer["address"], str):
        raise ValueError(f"{where}.address: a string is required")
      if not isinstance(peer["device_capabilities"], dict):
        raise ValueError(f"{where}.device_capabilities: an object is required")
      peers[node_id] = PeerConfig(peer["address"], _lax_int(peer["port"], f"{where}.port"), peer["device_capabilities"])
    return cls(peers)

  @classmethod
  def from_path(cls, path: str) -> "NetworkTopology":
    try:
      with open(path) as f:
        text = f.read()
    except FileNotFoundError as e:
      raise FileNotFoundError(f"Config file not found at {path}") from e
    try:
      return cls.from_dict(json.loads(text))
    except (json.JSONDecodeError, ValueError) as e:
      raise ValueError(f"Error validating network topology config from {path}: {e}") from e


def peer_device_capabilities(peer: PeerConfig) -> DeviceCapabilities:
  return DeviceCapabilities.from_dict(peer.device_capabilities)
