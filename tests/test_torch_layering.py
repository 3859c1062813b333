"""Layering of the PyTorch port: no module of ``xotorch_support_jetson_tpu_torch``
and not ``chip_smoke.py`` imports ``jax`` or anything of the JAX package
(not even its JAX-free modules); the entry points run on CUDA by default,
and without a card they raise unless the CPU is asked for."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "xotorch_support_jetson_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "xotorch_support_jetson_tpu")


def _forbidden(module: str) -> bool:
  return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


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


def test_forbidden_matcher():
  assert _forbidden("xotorch_support_jetson_tpu.models.config")
  assert _forbidden("jax.numpy")
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
