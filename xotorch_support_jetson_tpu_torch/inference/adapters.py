"""Multi-LoRA serving: named adapters in device slots over a host-RAM tier.
Own copy of the reference's ``inference/adapters.py``.

One resident base model serves many fine-tuned variants. A batched
dispatch applies a DIFFERENT adapter to every row (models/decoder.py
``_alora_delta``, behind a ``[B]`` int32 slot index filled per dispatch, so
the adapter mix never changes a captured graph), and the adapter pool gets
the budget and LRU treatment the KV pages get (``kv_tier.py``). This module
is the pool-management half:

- **Device slots**: the engine holds STACKED low-rank factors
  ``{wq,wv}_alora_{a,b}`` shaped ``[L, n_slots, ...]`` among its params
  (``torch_engine.enable_multi_lora``). ``n_slots`` is a power-of-two
  CAPACITY (``XOT_TPU_LORA_SLOTS``) allocated once, so every captured graph
  keeps reading the same addresses as adapters come and go; slot 0 stays
  all-zero = the base model. Installing an adapter into a slot is an
  in-place copy into ``[:, slot]`` of the stacked leaves — content changes,
  addresses and shapes never.

- **Host tier**: every registered adapter's factors live host-side under a
  byte-budgeted LRU (``XOT_TPU_LORA_HOST_MB``). Device slots are a CACHE
  over this tier: a cold adapter's slot is reassigned (LRU, never while
  pinned) and re-acquiring it restores from host RAM, or reloads from its
  checkpoint path when the host copy was itself evicted. A miss is a swap,
  never a new graph.

- **Pins**: every in-flight request pins its adapter's slot
  (``acquire(name, holder)`` / ``unpin(holder)``), so the LRU never
  reassigns a slot some resident batch row still indexes.

The checkpoint format is the reference's ``train/lora.py`` one: adapters
are the ``{target}_lora_a [L, D, r]`` / ``{target}_lora_b [L, r, O]``
leaves of a params tree (per stack: ``layers`` and, for MoE models,
``moe_layers``), so a file either package writes loads in the other.
``load_adapter`` reads either a dedicated adapter npz (``save_adapter``) or
a full training-checkpoint npz (the LoRA leaves are filtered out of its
flat keystr keys). Ranks up to the registry rank are zero-padded; larger
ranks are refused (the rank is a shape the graphs hold).

This module imports no scheduler or transport: the registry stays usable
against any executor.

TRUST: adapter names are CLIENT-ASSERTED (the ``model`` field / the
``x-adapter`` header), like tenant keys: an unauthenticated client can name
any registered adapter. Per-tenant adapter policy belongs behind a gateway
that pins the header; the registry only bounds resource use (capacity,
byte budget, pins).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ..utils.metrics import metrics
from .engine import ServerOverloadedError

# The projections adapters attach to (train/lora.py LORA_TARGETS); MLA
# models are refused at enable time (their map lands on wq_b/wkv_b, which
# the per-row hook does not cover).
ADAPTER_TARGETS = ("wq", "wv")
_STACKS = ("layers", "moe_layers")


def lora_enabled() -> bool:
  """``XOT_TPU_LORA=0`` disables multi-LoRA serving entirely: no registry is
  built, no ``*_alora_*`` leaves enter the params, and the decoder hook is
  never called — base serving byte for byte."""
  return os.getenv("XOT_TPU_LORA", "1") not in ("0", "false")


def round_pow2(n: int, floor: int = 2) -> int:
  """Round ``n`` up to a power of two (>= ``floor``) — the ONE rounding
  rule for slot capacity (a captured shape must not wobble with the adapter
  count); ``enable_multi_lora`` routes explicit capacities through it too."""
  cap = floor
  while cap < max(int(n), floor):
    cap *= 2
  return cap


def lora_capacity() -> int:
  """Device slot capacity incl. the reserved base slot 0
  (``XOT_TPU_LORA_SLOTS``, default 8), rounded UP to a power of two."""
  try:
    n = int(os.getenv("XOT_TPU_LORA_SLOTS", "8") or 8)
  except ValueError:
    n = 8
  return round_pow2(n)


def lora_rank() -> int:
  """Registry rank (``XOT_TPU_LORA_RANK``, default 8): the stacked factors'
  width. Adapters of smaller rank zero-pad into it."""
  try:
    return max(int(os.getenv("XOT_TPU_LORA_RANK", "8") or 8), 1)
  except ValueError:
    return 8


def lora_host_budget_bytes() -> int:
  try:
    mb = int(os.getenv("XOT_TPU_LORA_HOST_MB", "256") or 256)
  except ValueError:
    mb = 256
  return max(mb, 1) * (1 << 20)


class UnknownAdapterError(ValueError):
  """A request named an adapter the registry has never seen — a client
  error (the API maps it to a 400), never a server fault."""

  error_type = "unknown_adapter"


class AdapterSlotsPinnedError(ServerOverloadedError):
  """Every usable device slot is pinned by an in-flight request — the
  multi-LoRA analogue of page-pool exhaustion. Subclasses
  ServerOverloadedError so the API maps it to the retryable structured
  429, not a 500."""


def lora_tenant_map() -> dict:
  """``XOT_TPU_LORA_TENANTS`` — JSON ``{tenant: adapter}`` mapping QoS
  tenant keys to a default adapter when the request names none (the
  per-request ``x-adapter`` header / ``model`` field always win). Tenant
  keys are client-asserted, so this is a serving
  default, not an authorization boundary."""
  import json

  raw = os.getenv("XOT_TPU_LORA_TENANTS", "")
  if not raw:
    return {}
  try:
    m = json.loads(raw)
  except ValueError:
    return {}
  return {str(k): str(v) for k, v in m.items()} if isinstance(m, dict) else {}


def check_known(registry, name: str) -> None:
  """The ONE unknown-adapter validation (API resolve, engine solo select,
  scheduler admission all call it): raises the client-error type when
  multi-LoRA is off or ``name`` was never registered."""
  if registry is None:
    raise UnknownAdapterError(f"unknown adapter {name!r}: multi-LoRA serving is not enabled on this node")
  if not registry.known(name):
    raise UnknownAdapterError(f"unknown adapter {name!r} (see GET /v1/adapters)")


# ------------------------------------------------------- checkpoint formats


def extract_adapter(params: dict, targets: tuple = ADAPTER_TARGETS) -> dict:
  """Pull the ``train/lora.py``-format adapter leaves out of a params tree:
  ``{stack: {target: (a [L,D,r], b [L,r,O])}}`` as numpy arrays."""
  out: dict = {}
  for stack in _STACKS:
    layers = params.get(stack)
    if not isinstance(layers, dict):
      continue
    per: dict = {}
    for t in targets:
      a, b = layers.get(f"{t}_lora_a"), layers.get(f"{t}_lora_b")
      if a is not None and b is not None:
        per[t] = (np.asarray(a), np.asarray(b))
    if per:
      out[stack] = per
  return out


def save_adapter(path: str | Path, arrays: dict) -> Path:
  """Write an adapter-only npz (``{stack}/{target}.a`` / ``.b`` keys) — the
  registry's native on-disk form; ``load_adapter`` also reads full
  training-checkpoint npz files directly."""
  path = Path(path).with_suffix(".npz")
  path.parent.mkdir(parents=True, exist_ok=True)
  flat = {}
  for stack, per in arrays.items():
    for t, (a, b) in per.items():
      flat[f"{stack}/{t}.a"] = np.asarray(a)
      flat[f"{stack}/{t}.b"] = np.asarray(b)
  np.savez(str(path), **flat)
  return path


def load_adapter(path: str | Path, targets: tuple = ADAPTER_TARGETS) -> dict:
  """Read adapter factors from ``path``: the native adapter npz, or a full
  training-checkpoint npz (flat keystr keys — the LoRA leaves are filtered
  out). Raises ``FileNotFoundError`` /
  ``ValueError`` on a file with no adapter leaves."""
  p = Path(path)
  if not p.exists() and p.suffix != ".npz":
    p = p.with_suffix(".npz")
  if not p.exists():
    raise FileNotFoundError(f"no adapter checkpoint at {path}")
  data = np.load(str(p))
  out: dict = {}
  for key in data.files:
    if "/" in key and (key.endswith(".a") or key.endswith(".b")):  # native form
      stack, rest = key.split("/", 1)
      t = rest[:-2]
      per = out.setdefault(stack, {})
      a, b = per.get(t, (None, None))
      if key.endswith(".a"):
        per[t] = (data[key], b)
      else:
        per[t] = (a, data[key])
    elif "_lora_a" in key or "_lora_b" in key:  # a training checkpoint's keystr form
      # keystr renders as ['layers']['wq_lora_a']
      parts = [s for s in key.replace("]", "").split("[") if s]
      parts = [s.strip("'\"") for s in parts]
      if len(parts) != 2:
        continue
      stack, leaf = parts
      t, kind = leaf.rsplit("_lora_", 1)
      per = out.setdefault(stack, {})
      a, b = per.get(t, (None, None))
      per[t] = (data[key], b) if kind == "a" else (a, data[key])
  out = {
    stack: {t: (a, b) for t, (a, b) in per.items() if a is not None and b is not None and t in targets}
    for stack, per in out.items()
  }
  out = {stack: per for stack, per in out.items() if per}
  if not out:
    raise ValueError(f"{p} holds no LoRA adapter leaves")
  return out


def adapter_nbytes(arrays: dict) -> int:
  return sum(int(a.nbytes) + int(b.nbytes) for per in arrays.values() for a, b in per.values())


def adapter_rank(arrays: dict) -> int:
  for per in arrays.values():
    for a, _ in per.values():
      return int(a.shape[-1])
  return 0


class _HostEntry:
  __slots__ = ("arrays", "nbytes", "path")

  def __init__(self, arrays: dict | None, nbytes: int, path: str | None) -> None:
    self.arrays = arrays
    self.nbytes = nbytes
    self.path = path


class AdapterRegistry:
  """Named adapters over device slots + a byte-budgeted host LRU tier.

  ``geometry`` is ``{stack: {target: (L, d_in, d_out)}}`` of the serving
  model (the engine derives it from its params); ``install(slot, arrays)``
  is the engine-provided device write (``arrays=None`` zeroes the slot).
  It returns None when the write is done, or a ``concurrent.futures.Future``
  when it is queued for the engine's device thread (the batched server's
  admission runs on the event loop, which must not wait on the card): the
  future's result is the write's own seconds (``lora_swap_seconds``), and
  ``pending_install(slot)`` hands it to the admission's prefill dispatch,
  which fails if the write did. A failed queued write frees its slot.
  Thread-safe: ``acquire`` runs from the scheduler's event loop AND the
  engine's executor thread (solo sessions)."""

  def __init__(self, *, geometry: dict, rank: int, capacity: int, install, host_budget_bytes: int | None = None, clock=time.monotonic) -> None:
    if not geometry:
      raise ValueError("adapter registry needs at least one LoRA target stack")
    self.geometry = geometry
    self.rank = int(rank)
    self.capacity = int(capacity)
    if self.capacity < 2:
      raise ValueError("adapter capacity must hold the base slot 0 plus at least one adapter")
    self._install = install
    self.host_budget_bytes = lora_host_budget_bytes() if host_budget_bytes is None else int(host_budget_bytes)
    self._clock = clock
    self._lock = threading.RLock()
    self._host: "OrderedDict[str, _HostEntry]" = OrderedDict()
    self._host_bytes = 0
    self._device: "OrderedDict[str, int]" = OrderedDict()  # name -> slot, LRU order
    self._free: list[int] = list(range(1, self.capacity))
    self._pins: dict[object, str] = {}  # holder -> name
    self._pin_counts: dict[str, int] = {}
    self._pending: dict[int, object] = {}  # slot -> the queued install's Future
    self._update_gauges()

  # ------------------------------------------------------------ host tier

  def register(self, name: str, arrays: dict | None = None, path: str | None = None) -> None:
    """Add (or refresh) a named adapter: in-memory factors, a checkpoint
    path, or both. Shapes validate against the model geometry up front —
    a client must never discover a bad adapter at admission time. A
    refresh of a DEVICE-RESIDENT adapter reinstalls its slot in place
    (pins stay valid; in-flight rows pick up the new factors at their
    next dispatch — a refresh means the operator wants the new weights,
    never a stale slot served indefinitely)."""
    if arrays is None and path is None:
      raise ValueError("register() needs arrays or a checkpoint path")
    if arrays is None:
      arrays = load_adapter(path)
      metrics.inc("lora_swaps_total", labels={"direction": "load"})
    self._validate(name, arrays)
    nbytes = adapter_nbytes(arrays)
    with self._lock:
      old = self._host.pop(name, None)
      if old is not None and old.arrays is not None:
        self._host_bytes -= old.nbytes
      self._host[name] = _HostEntry(arrays, nbytes, path or (old.path if old else None))
      self._host_bytes += nbytes
      self._enforce_host_budget_locked()
      slot = self._device.get(name)
      if slot is not None:
        self._run_install(name, slot, arrays)
    self._update_gauges()

  def _validate(self, name: str, arrays: dict) -> None:
    if not name or len(name) > 128:
      raise ValueError(f"bad adapter name {name!r}")
    r = adapter_rank(arrays)
    if r > self.rank:
      raise ValueError(f"adapter {name!r} rank {r} exceeds the registry rank {self.rank} (XOT_TPU_LORA_RANK)")
    for stack, per in arrays.items():
      geo = self.geometry.get(stack)
      if geo is None:
        raise ValueError(f"adapter {name!r} targets stack {stack!r} the serving model lacks")
      for t, (a, b) in per.items():
        if t not in geo:
          raise ValueError(f"adapter {name!r} targets {stack}/{t} the serving model lacks")
        L, d_in, d_out = geo[t]
        if tuple(a.shape) != (L, d_in, a.shape[-1]) or tuple(b.shape) != (L, b.shape[1], d_out) or a.shape[-1] != b.shape[1]:
          raise ValueError(
            f"adapter {name!r} {stack}/{t} shapes {tuple(a.shape)}/{tuple(b.shape)} do not fit model geometry (L={L}, d_in={d_in}, d_out={d_out})"
          )

  def _enforce_host_budget_locked(self) -> None:
    """LRU host eviction under the byte budget — only entries that can be
    RELOADED (a checkpoint path) drop their arrays; an in-memory-only
    adapter keeps its host copy even while device-resident (the device
    slot is an evictable CACHE, so dropping the host copy there would make
    the adapter unrecoverable one slot eviction later). The budget is soft
    when everything left is path-less — documented."""
    if self._host_bytes <= self.host_budget_bytes:
      return
    for name in list(self._host):
      if self._host_bytes <= self.host_budget_bytes:
        break
      entry = self._host[name]
      if entry.arrays is None or entry.path is None:
        continue
      self._host_bytes -= entry.nbytes
      entry.arrays = None
      metrics.inc("lora_swaps_total", labels={"direction": "host_evict"})

  def _host_arrays_locked(self, name: str) -> dict:
    entry = self._host.get(name)
    if entry is None:
      raise UnknownAdapterError(f"unknown adapter {name!r} (see GET /v1/adapters)")
    self._host.move_to_end(name)
    if entry.arrays is not None:
      return entry.arrays
    if entry.path is None:
      raise UnknownAdapterError(f"adapter {name!r} was evicted host-side and has no checkpoint path to reload from")
    arrays = load_adapter(entry.path)
    metrics.inc("lora_swaps_total", labels={"direction": "load"})
    entry.arrays = arrays
    entry.nbytes = adapter_nbytes(arrays)
    self._host_bytes += entry.nbytes
    self._enforce_host_budget_locked()
    return arrays

  # ---------------------------------------------------------- device slots

  def acquire(self, name: str, holder: object | None = None) -> int:
    """Resolve ``name`` to a device slot, installing it (host restore or
    checkpoint load — a SWAP, never a new graph) when cold. ``holder`` pins
    the slot until ``unpin(holder)``; the pin is what keeps the LRU from
    reassigning a slot an in-flight batch row still indexes."""
    with self._lock:
      slot = self._device.get(name)
      if slot is None:
        arrays = self._host_arrays_locked(name)
        if self._free:
          slot = self._free.pop()
        else:
          victim = next((n for n in self._device if not self._pin_counts.get(n)), None)
          if victim is None:
            raise AdapterSlotsPinnedError(
              f"all {self.capacity - 1} adapter slots are pinned by in-flight requests"
            )
          slot = self._device.pop(victim)
          metrics.inc("lora_swaps_total", labels={"direction": "out"})
        try:
          self._run_install(name, slot, arrays)
        except BaseException:
          # A failed install (device OOM, bad factors) must not leak the
          # slot: it went nowhere, so it returns to the free list — usable
          # capacity never shrinks with failures.
          self._free.append(slot)
          raise
        self._device[name] = slot
      self._device.move_to_end(name)
      if holder is not None and self._pins.get(holder) != name:
        self._release_holder_locked(holder)
        self._pins[holder] = name
        self._pin_counts[name] = self._pin_counts.get(name, 0) + 1
        metrics.inc("lora_requests_total", labels={"adapter": name})
    self._update_gauges()
    return slot

  def _run_install(self, name: str, slot: int, arrays: dict) -> None:
    """Write ``arrays`` into ``slot`` through the engine's hook: timed here
    when the write ran inline, by the write itself when it was queued."""
    t0 = time.perf_counter()
    pending = self._install(slot, self._padded(arrays))
    metrics.inc("lora_swaps_total", labels={"direction": "in"})
    if pending is None:
      metrics.observe_hist("lora_swap_seconds", time.perf_counter() - t0)
      return
    self._pending[slot] = pending
    pending.add_done_callback(lambda fut: self._install_done(name, slot, fut))

  def _install_done(self, name: str, slot: int, fut) -> None:
    """A queued write finished (on the engine's device thread): its
    seconds into ``lora_swap_seconds``; on failure the slot leaves the
    resident set (the next acquire writes it again) and the admission's
    prefill raises the error (``pending_install``)."""
    with self._lock:
      if self._pending.get(slot) is fut:
        del self._pending[slot]
      err = fut.exception()
      if err is None:
        metrics.observe_hist("lora_swap_seconds", fut.result())
        return
      if self._device.get(name) == slot:
        del self._device[name]
        self._free.append(slot)
    self._update_gauges()

  def pending_install(self, slot: int):
    """The queued install of ``slot`` not finished yet (a Future), else None."""
    with self._lock:
      return self._pending.get(slot)

  def _padded(self, arrays: dict) -> dict:
    """Zero-pad the factors to the registry rank (the stacked width)."""
    out: dict = {}
    for stack, per in arrays.items():
      sp = {}
      for t, (a, b) in per.items():
        r = a.shape[-1]
        if r < self.rank:
          a = np.concatenate([a, np.zeros(a.shape[:-1] + (self.rank - r,), a.dtype)], axis=-1)
          b = np.concatenate([b, np.zeros((b.shape[0], self.rank - r, b.shape[2]), b.dtype)], axis=1)
        sp[t] = (a, b)
      out[stack] = sp
    return out

  def unpin(self, holder: object) -> None:
    """Drop ``holder``'s pin (idempotent — every release path calls it)."""
    with self._lock:
      self._release_holder_locked(holder)
    self._update_gauges()

  def _release_holder_locked(self, holder: object) -> None:
    name = self._pins.pop(holder, None)
    if name is None:
      return
    left = self._pin_counts.get(name, 1) - 1
    if left <= 0:
      self._pin_counts.pop(name, None)
    else:
      self._pin_counts[name] = left

  # ------------------------------------------------------------------ admin

  def pinned_holders(self) -> list:
    with self._lock:
      return list(self._pins)

  def known(self, name: str) -> bool:
    with self._lock:
      return name in self._host

  def names(self) -> list[str]:
    with self._lock:
      return list(self._host)

  def resident_names(self) -> list[str]:
    """Device-resident adapter names, hottest first."""
    with self._lock:
      return list(reversed(self._device))

  def slot_of(self, name: str) -> int | None:
    with self._lock:
      return self._device.get(name)

  def device_bytes(self) -> int:
    """Device bytes the stacked slots occupy (ALL slots — capacity is
    allocated up front), at f32 factor width, as the reference counts them;
    enters the scheduler's page-budget block math (inference/paging.py
    ``lora_pages_equivalent``)."""
    from .paging import lora_device_bytes

    per_stack = 0
    for per in self.geometry.values():
      per_stack += sum(lora_device_bytes(L, d_in, d_out, self.rank, self.capacity) for (L, d_in, d_out) in per.values())
    return per_stack

  def snapshot(self) -> dict:
    with self._lock:
      return {
        "capacity_slots": self.capacity - 1,
        "rank": self.rank,
        "adapters": {
          name: {
            "resident": name in self._device,
            "slot": self._device.get(name),
            "host_bytes": entry.nbytes if entry.arrays is not None else 0,
            "host_resident": entry.arrays is not None,
            "path": entry.path,
            "pins": self._pin_counts.get(name, 0),
          }
          for name, entry in self._host.items()
        },
        "host_bytes": self._host_bytes,
        "host_budget_bytes": self.host_budget_bytes,
        "device_bytes": self.device_bytes(),
      }

  def _update_gauges(self) -> None:
    with self._lock:
      resident, hb = len(self._device), self._host_bytes
    metrics.set_gauge("lora_adapters_resident", resident)
    metrics.set_gauge("lora_host_bytes", hb)
