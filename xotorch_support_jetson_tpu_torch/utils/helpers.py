"""Cross-cutting helpers: debug level, boolean env knobs, node identity,
free-port probing, and the on-device placement rule of the port's entry
points. Own copy of the subset of the reference's ``utils/helpers.py`` the
serving slice uses."""

from __future__ import annotations

import os
import random
import socket
import uuid
from pathlib import Path

DEBUG = int(os.getenv("DEBUG", "0"))

XOT_HOME = Path(os.getenv("XOT_TPU_HOME", Path.home() / ".cache" / "xot_tpu"))


def env_flag(name: str, default: bool = False) -> bool:
  """Boolean env var: unset → default; '', '0', 'false', 'no', 'off' (any
  case) → False; anything else ('1', 'true', 'yes', ...) → True."""
  val = os.getenv(name)
  if val is None:
    return default
  return val.strip().lower() not in ("", "0", "false", "no", "off")


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
  id_file = XOT_HOME / ".node_id"
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
