"""Client-side peer contract (own copy of the reference's
``networking/peer_handle.py``).

Hidden states cross a hop as a torch tensor in the model's dtype
(numpy has no bfloat16); token ids and the dummy engine's values as numpy
arrays. ``send_example`` (the training ring) is declared and not ported.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..inference.shard import Shard
from ..inference.state import InferenceState
from ..topology.device_capabilities import DeviceCapabilities
from ..topology.topology import Topology


class PeerHandle(ABC):
  @abstractmethod
  def id(self) -> str:
    ...

  @abstractmethod
  def addr(self) -> str:
    ...

  @abstractmethod
  def description(self) -> str:
    ...

  @abstractmethod
  def device_capabilities(self) -> DeviceCapabilities:
    ...

  @abstractmethod
  async def connect(self) -> None:
    ...

  @abstractmethod
  async def is_connected(self) -> bool:
    ...

  @abstractmethod
  async def disconnect(self) -> None:
    ...

  @abstractmethod
  async def health_check(self) -> bool:
    ...

  @abstractmethod
  async def send_prompt(self, shard: Shard, prompt: str, request_id: str, inference_state: InferenceState | None = None) -> None:
    ...

  @abstractmethod
  async def send_tensor(self, shard: Shard, tensor, request_id: str, inference_state: InferenceState | None = None) -> None:
    ...

  async def send_example(self, shard: Shard, example, target, length, train: bool, request_id: str):
    """The training ring's hop: not ported (training waits for its slice)."""
    raise NotImplementedError("SendExample: the training ring is not ported to the PyTorch package yet")

  @abstractmethod
  async def send_result(self, request_id: str, result, is_finished: bool, start_pos: int | None = None) -> None:
    ...

  @abstractmethod
  async def send_opaque_status(self, request_id: str, status: str) -> None:
    ...

  @abstractmethod
  async def collect_topology(self, visited: set[str], max_depth: int) -> Topology:
    ...
