"""Layering of the PyTorch port: no module of ``xotorch_support_jetson_tpu_torch``
and not ``chip_smoke.py`` imports ``jax`` or anything of the JAX package
(not even its JAX-free modules); the entry points run on CUDA by default,
and without a card they raise unless the CPU is asked for."""

import ast
from pathlib import Path

import pytest
import torch

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "xotorch_support_jetson_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "xotorch_support_jetson_tpu")
# Not installed on the card's machine: the ring carries its RPCs over
# asyncio streams and validates its config by hand.
FORBIDDEN_ON_THE_CARD = ("grpc", "google.protobuf", "pydantic", "rich")


def _forbidden(module: str) -> bool:
  return any(module == f or module.startswith(f + ".") for f in FORBIDDEN + FORBIDDEN_ON_THE_CARD)


def _imports(path: Path):
  for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
      yield node.module


@pytest.mark.parametrize("path", sorted([*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
  bad = [m for m in _imports(path) if _forbidden(m)]
  assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_own_copies():
  """The port's own copies of JAX-free reference modules are scanned too."""
  scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
  assert {"inference/ngram.py", "inference/paging.py", "inference/kv_tier.py", "inference/qos.py", "inference/adapters.py", "utils/synthetic.py", "download/hf_utils.py", "download/progress.py"} <= scanned
  assert {
    "topology/device_capabilities.py", "topology/topology.py", "topology/partitioning.py", "parallel/hbm_planner.py",
    "networking/peer_handle.py", "networking/discovery.py", "networking/server.py", "networking/retry.py",
    "networking/tcp/serialization.py", "networking/tcp/tcp_server.py", "networking/tcp/tcp_peer_handle.py",
    "networking/manual/network_topology_config.py", "networking/manual/manual_discovery.py", "networking/udp/udp_discovery.py",
    "inference/dummy_engine.py",
  } <= scanned


def test_forbidden_matcher():
  assert _forbidden("xotorch_support_jetson_tpu.models.config")
  assert _forbidden("jax.numpy")
  assert _forbidden("grpc.aio") and _forbidden("google.protobuf.message") and _forbidden("pydantic") and _forbidden("rich.console")
  assert not _forbidden("google") and not _forbidden("richer")
  assert not _forbidden("xotorch_support_jetson_tpu_torch.models.config")
  assert not _forbidden("jaxtyping_free_name")


def test_default_device_is_cuda(monkeypatch):
  from xotorch_support_jetson_tpu_torch.utils.helpers import resolve_device

  monkeypatch.delenv("XOT_TPU_PLATFORM", raising=False)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  assert resolve_device().type == "cuda"
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  assert resolve_device().type == "cpu"


def test_no_card_raises_unless_cpu_is_asked_for(monkeypatch):
  from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine

  monkeypatch.delenv("XOT_TPU_PLATFORM", raising=False)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    TorchShardedInferenceEngine()
  assert TorchShardedInferenceEngine(device="cpu").device.type == "cpu"
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  assert TorchShardedInferenceEngine().device.type == "cpu"
