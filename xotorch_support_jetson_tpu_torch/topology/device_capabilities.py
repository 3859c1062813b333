"""Device capability probing (own copy of the reference's
``topology/device_capabilities.py`` for the port's hosts).

A node reports its chip, its memory in MB and a TFLOPS estimate; the ring
weights its layer split by the memory (topology/partitioning.py) and the
head checks each span's weights against it (parallel/hbm_planner.py).
The probe order is the reference's: Jetson, then the CUDA card
(``torch.cuda.get_device_properties``, skipped under
``XOT_TPU_PLATFORM=cpu``), then the host's CPU and RAM. The reference's
TPU and Apple probes find nothing on the port's hosts and are left out,
with their tables. ``XOT_TPU_MEMORY_MB`` overrides the
probed memory (a drill stands up an undersized ring member with it, or
sets a ring's split ratio on one card).
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass

from ..utils.helpers import DEBUG


@dataclass(frozen=True)
class DeviceFlops:
  # units: TFLOPS
  fp32: float
  fp16: float
  int8: float

  def to_dict(self) -> dict:
    return asdict(self)


@dataclass
class DeviceCapabilities:
  model: str
  chip: str
  memory: int  # MB
  flops: DeviceFlops

  def __str__(self) -> str:
    return f"Model: {self.model}. Chip: {self.chip}. Memory: {self.memory}MB. Flops: fp32 {self.flops.fp32:.2f} TFLOPS, fp16 {self.flops.fp16:.2f} TFLOPS, int8 {self.flops.int8:.2f} TFLOPS"

  def model_dump(self) -> dict:
    return {"model": self.model, "chip": self.chip, "memory": self.memory, "flops": self.flops.to_dict()}

  def to_dict(self) -> dict:
    return self.model_dump()

  @classmethod
  def from_dict(cls, data: dict) -> "DeviceCapabilities":
    flops = data.get("flops", {})
    if not isinstance(flops, DeviceFlops):
      flops = DeviceFlops(fp32=flops.get("fp32", 0), fp16=flops.get("fp16", 0), int8=flops.get("int8", 0))
    return cls(model=data.get("model", "Unknown"), chip=data.get("chip", "Unknown"), memory=data.get("memory", 0), flops=flops)


UNKNOWN_DEVICE_CAPABILITIES = DeviceCapabilities(model="Unknown Model", chip="Unknown Chip", memory=0, flops=DeviceFlops(fp32=0, fp16=0, int8=0))

# Public-spec peak compute (fp16 dense TFLOPS), estimates for placement
# weighting and display only.
GPU_CHIP_FLOPS: dict[str, DeviceFlops] = {
  "nvidia h100": DeviceFlops(fp32=67.0, fp16=989.0, int8=1979.0),
  "nvidia a100": DeviceFlops(fp32=19.5, fp16=312.0, int8=624.0),
  "nvidia geforce rtx 4090": DeviceFlops(fp32=82.6, fp16=165.2, int8=660.6),
  "nvidia geforce rtx 4080": DeviceFlops(fp32=48.7, fp16=97.5, int8=390.0),
  "nvidia geforce rtx 3090": DeviceFlops(fp32=35.6, fp16=71.0, int8=284.0),
  "nvidia geforce rtx 3080": DeviceFlops(fp32=29.8, fp16=59.5, int8=238.0),
  "jetson agx orin": DeviceFlops(fp32=5.3, fp16=10.6, int8=170.0),
  "jetson orin nano": DeviceFlops(fp32=1.3, fp16=2.6, int8=20.0),
  "jetson": DeviceFlops(fp32=1.0, fp16=2.0, int8=10.0),  # an unlisted board's floor
}


def _match_flops(table: dict[str, DeviceFlops], name: str) -> DeviceFlops:
  name = name.lower().strip()
  for key in sorted(table, key=len, reverse=True):  # most specific first
    if key in name:
      return table[key]
  return DeviceFlops(fp32=0, fp16=0, int8=0)


def cuda_caps_from(name: str, total_memory_bytes: int, n_devices: int = 1) -> DeviceCapabilities:
  flops = _match_flops(GPU_CHIP_FLOPS, name)
  return DeviceCapabilities(
    model=f"GPU host ({n_devices}x {name})",
    chip=name,
    memory=int(total_memory_bytes / (1024 * 1024)) * n_devices,
    flops=DeviceFlops(fp32=flops.fp32 * n_devices, fp16=flops.fp16 * n_devices, int8=flops.int8 * n_devices),
  )


def jetson_caps_from(model: str, meminfo: str) -> DeviceCapabilities:
  """Jetson boards share system RAM with the GPU: memory is /proc/meminfo's
  MemTotal."""
  mem_mb = 0
  for line in meminfo.splitlines():
    if line.startswith("MemTotal:"):
      mem_mb = int(line.split()[1]) // 1024
      break
  return DeviceCapabilities(model=model, chip=model.lower(), memory=mem_mb, flops=_match_flops(GPU_CHIP_FLOPS, model))


def _host_memory_mb() -> int:
  try:
    return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / (1024 * 1024))
  except (ValueError, OSError):
    return 0


def _jetson_device_capabilities() -> DeviceCapabilities | None:
  try:
    if not os.path.exists("/etc/nv_tegra_release"):
      return None
    model = "Jetson"
    try:
      with open("/proc/device-tree/model") as f:
        model = f.read().strip("\x00 \n")
    except OSError:
      pass
    with open("/proc/meminfo") as f:
      return jetson_caps_from(model, f.read())
  except Exception:  # noqa: BLE001
    return None


def _cuda_device_capabilities() -> DeviceCapabilities | None:
  if os.getenv("XOT_TPU_PLATFORM", "").lower() == "cpu":
    return None
  try:
    import torch

    if not torch.cuda.is_available():
      return None
    props = torch.cuda.get_device_properties(0)
    return cuda_caps_from(props.name, props.total_memory, torch.cuda.device_count())
  except Exception:  # noqa: BLE001 — a broken CUDA runtime reads as no card
    return None


def _probe() -> DeviceCapabilities:
  caps = None
  for probe in (_jetson_device_capabilities, _cuda_device_capabilities):
    caps = probe()
    if caps is not None:
      break
  if caps is None:
    caps = DeviceCapabilities(
      model=f"CPU host ({os.uname().machine})" if hasattr(os, "uname") else "CPU host",
      chip="cpu",
      memory=_host_memory_mb(),
      flops=DeviceFlops(fp32=0.1, fp16=0.1, int8=0.2),
    )
  override = os.getenv("XOT_TPU_MEMORY_MB")
  if override:
    caps = DeviceCapabilities(model=caps.model, chip=caps.chip, memory=int(override), flops=caps.flops)
  return caps


async def device_capabilities() -> DeviceCapabilities:
  """Probe this host (Jetson → CUDA → CPU)."""
  caps = _probe()
  if DEBUG >= 2:
    print(f"[device_capabilities] {caps}")
  return caps
