"""KV memory hierarchy: a host-RAM second tier under the device page pool.

Own copy of the reference's ``inference/kv_tier.py``. The paged KV pool
(inference/paging.py + ops/paged.py) lives in device memory, so capacity
bounds admission: without a tier, a page evicted from the prefix-cache LRU
is gone, a QoS preemption throws away the victim's KV and recomputes its
prefill on resume, and an idle multi-turn session keeps nothing between
turns. This module is the second tier:

- ``KvTierManager`` owns a byte-budgeted host store of page COPIES, keyed by
  the prefix cache's content-addressed chain keys
  (``PageAllocator.chain_keys``). Pages evicted from the device LRU SPILL
  here instead of vanishing; admission RESTORES host-resident chain runs
  into freshly allocated device pages and skips the prefill of those
  tokens.
- A preempted row's KV (prompt and generated tokens) is a page-aligned
  prefix of its resumed incarnation's prompt, so one mechanism serves
  three workloads: a preempted row resumes by TRANSFER instead of
  recompute (``_Request.carry_tokens`` stays the correctness fallback: a
  host miss recomputes the prefill), an idle multi-turn session's history
  parks host-side between turns, and the prefix cache gains a host-backed
  second tier.
- Restores are COPY-ON-WRITE: the host bytes go into a fresh device page
  that is adopted into the device prefix cache (read-only: decode writes
  land only in a request's private pages); the host copy is retained, so
  later requests and turns can restore the same prefix again.
- ``PrefixRegistry`` is the bounded index of chain keys this node holds
  (either tier) and of each peer's advertisement. Advertised keys are hints
  for placement and are never dereferenced: a node restores only from its
  own host tier. The remote half has no caller until the ring's
  disaggregation (``SendKvPages``) is ported; it is host-only
  bookkeeping, held against the reference's.

The device side of the copies is the engine's batch ops
(inference/batch_ops.py ``read_pages`` / ``write_pages``): a spill gathers
the pages on the compute stream and copies them to pinned host memory on a
copy stream, without blocking the scheduler; per-key entries are pageable
copies, so only the staging buffers are pinned. A spill or restore that
fails is counted (``kv_tier_spill_failures_total`` /
``kv_tier_restore_failures_total``, labelled with the exception's class):
a failed spill degrades to plain eviction, a failed restore to recomputing
the prefill.

Everything rides ``XOT_TPU_KV_TIER`` (default on; ``0`` or ``false`` gives
the single-tier behaviour). Knobs: ``XOT_TPU_KV_TIER_HOST_MB`` (host byte
budget, default 1024), ``XOT_TPU_KV_TIER_EVICT`` (``lru``/``fifo`` host
eviction) and ``XOT_TPU_KV_TIER_INFLIGHT`` (spill batches whose host copy
may still be streaming before the oldest is forced to complete, default 4).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..utils.metrics import SIZE_BUCKETS, metrics

MAX_REGISTRY_KEYS = 4096  # per scope (local, and per remote node)


def kv_tier_enabled() -> bool:
  """``XOT_TPU_KV_TIER``: on unless set to exactly ``0`` or ``false`` (the
  reference's parse; ``""``, ``no`` and ``off`` leave it on)."""
  return os.getenv("XOT_TPU_KV_TIER", "1") not in ("0", "false")


def advert_ttl_s() -> float:
  """``XOT_TPU_PREFIX_ADVERT_TTL_S`` (default 120 s; <= 0 disables expiry):
  how long a peer's prefix advertisement stays trusted without a refresh."""
  try:
    return float(os.getenv("XOT_TPU_PREFIX_ADVERT_TTL_S", "120") or 120)
  except ValueError:
    return 120.0


def _host_tensor(arr) -> torch.Tensor:
  return arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))


def _page_nbytes(leaves: dict) -> int:
  """Host bytes of ONE page over every leaf of ``leaves`` (``[L, n, ...]``)."""
  return sum(int(np.prod(a.shape[2:], dtype=np.int64)) * int(a.shape[0]) * a.element_size() for a in leaves.values())


def _page_copy(arr: torch.Tensor, i: int) -> torch.Tensor:
  """Page ``i`` of a host leaf as its own contiguous pageable tensor, so that
  evicting one key frees its bytes and no staging buffer stays referenced."""
  return arr[:, i].clone(memory_format=torch.contiguous_format)


class _PendingBatch:
  """One spill whose host copy may still be streaming: the (pinned) host
  leaves and the event after which they are valid. It materializes lazily
  (restore hit, inflight cap or budget pressure); the spill itself never
  waits for the copy."""

  __slots__ = ("keys", "host", "ready")

  def __init__(self, keys: list[bytes], host: dict, ready) -> None:
    self.keys = keys
    self.host = host
    self.ready = ready


class KvTierManager:
  """Host page store and spill/restore engine for one BatchedServer.

  ``read_pages(pages) -> (host_leaves, ready)`` and ``write_pages(pages,
  data)`` are injected by the scheduler (they close over the live pool and
  the engine's batch ops). ``host_leaves`` maps each pool leaf to a host
  tensor ``[L, len(pages), ...]``, valid once ``ready`` (a CUDA event, or
  None when already valid) has fired; ``None`` leaves mean the pool is gone.
  ``data`` maps each leaf to the ``len(pages)`` host page tensors
  ``[L, ...]`` in ``pages`` order. Every entry point runs on the scheduler's
  event loop at dispatch boundaries, so device access is serialized; the
  lock guards against concurrent API and stats readers."""

  def __init__(self, *, page_size: int, read_pages, write_pages, budget_bytes: int, evict_policy: str = "lru", max_inflight: int = 4) -> None:
    self.page_size = page_size
    self._read = read_pages
    self._write = write_pages
    self.budget_bytes = max(int(budget_bytes), 0)
    self.evict_policy = evict_policy if evict_policy in ("lru", "fifo") else "lru"
    self.max_inflight = max(int(max_inflight), 1)
    # KV quant mode of the pool this tier backs ("" bf16 / "int8" / "int4");
    # None = unknown (standalone tiers, tests). ``adopt_wire`` refuses a
    # sender whose tagged mode disagrees before the byte-geometry guard.
    self.kv_quant: str | None = None
    self._entries: "OrderedDict[bytes, dict | _PendingBatch]" = OrderedDict()
    self._pending: list[_PendingBatch] = []
    self._bytes = 0
    self._page_nbytes: int | None = None  # host bytes per page (all leaves)
    self._lock = threading.Lock()
    self._update_gauges()

  @classmethod
  def from_env(cls, *, page_size: int, read_pages, write_pages) -> "KvTierManager":
    def _i(name: str, default: int) -> int:
      try:
        return int(os.getenv(name, "") or default)
      except ValueError:
        return default

    return cls(
      page_size=page_size, read_pages=read_pages, write_pages=write_pages,
      budget_bytes=_i("XOT_TPU_KV_TIER_HOST_MB", 1024) * (1 << 20),
      evict_policy=os.getenv("XOT_TPU_KV_TIER_EVICT", "lru"),
      max_inflight=_i("XOT_TPU_KV_TIER_INFLIGHT", 4),
    )

  # ------------------------------------------------------------------ spill

  def spill(self, evicted: list[tuple[bytes, int]]) -> None:
    """Device-LRU eviction hook (``PageAllocator.spill_hook``): copy the
    evicted cached pages host-side BEFORE their device pages are reused.
    The gather is enqueued on the compute stream ahead of any later write
    to those pages, and the host copy streams asynchronously."""
    if not evicted:
      return
    t0 = time.perf_counter()
    try:
      host, ready = self._read([p for _, p in evicted])
    except Exception as e:  # noqa: BLE001 — a failed spill degrades to plain eviction, counted
      metrics.inc("kv_tier_spill_failures_total", labels={"error": type(e).__name__})
      return
    if host is None:
      return
    keys = [k for k, _ in evicted]
    batch = _PendingBatch(keys, host, ready)
    with self._lock:
      if self._page_nbytes is None:
        self._page_nbytes = _page_nbytes(host)
      for key in keys:
        old = self._entries.pop(key, None)
        if isinstance(old, dict):
          self._bytes -= old["nbytes"]
        self._entries[key] = batch
      self._pending.append(batch)
      self._bytes += self._page_nbytes * len(keys)
      self._enforce_budget_locked()
      while len(self._pending) > self.max_inflight:
        self._materialize_locked(self._pending[0])
      dt = time.perf_counter() - t0
    metrics.inc("kv_tier_spilled_pages_total", len(keys))
    metrics.inc("kv_tier_spilled_bytes_total", self._page_nbytes * len(keys))
    metrics.observe_hist("kv_tier_spill_seconds", dt)
    prefix_registry.note(keys)
    self._update_gauges()

  def _materialize_locked(self, batch: _PendingBatch) -> None:
    """Wait for a pending batch's host copy and split it into per-key
    entries. A key REPLACED by a newer spill while this batch was pending
    still carries this batch's byte charge: it settles here."""
    if batch in self._pending:
      self._pending.remove(batch)
    if batch.ready is not None:
      batch.ready.synchronize()
    host, batch.host, batch.ready = batch.host, {}, None
    for i, key in enumerate(batch.keys):
      if self._entries.get(key) is not batch:
        self._bytes -= self._page_nbytes  # replaced while pending: the charge settles
        continue
      data = {name: _page_copy(arr, i) for name, arr in host.items()}
      self._entries[key] = {"data": data, "nbytes": self._page_nbytes}

  def _enforce_budget_locked(self) -> None:
    while self._bytes > self.budget_bytes and self._entries:
      key, entry = next(iter(self._entries.items()))
      if isinstance(entry, _PendingBatch):
        # Budget pressure forces the copy, so the eviction really frees
        # bytes and the accounting stays exact.
        self._materialize_locked(entry)
        entry = self._entries.get(key)
        if entry is None:
          continue
      self._entries.pop(key, None)
      self._bytes -= entry["nbytes"]
      metrics.inc("kv_tier_host_evictions_total")

  # ---------------------------------------------------------------- restore

  def host_run(self, chain_keys: list[bytes], start: int, limit: int) -> list[bytes]:
    """Longest contiguous host-resident run of ``chain_keys[start:limit]``:
    the keys a restore can extend the device prefix hit with."""
    run: list[bytes] = []
    with self._lock:
      for i in range(start, min(limit, len(chain_keys))):
        if chain_keys[i] not in self._entries:
          break
        run.append(chain_keys[i])
    return run

  def restore_into(self, keys: list[bytes], pages: list[int]) -> None:
    """Write the host copies of ``keys`` into freshly allocated device
    ``pages`` (one batched write). Copy-on-write: the host entries are
    retained and only LRU-touched. Raises on a missing entry or a failed
    device write; the caller then recomputes the prefill (the pages stay
    its private pages)."""
    t0 = time.perf_counter()
    with self._lock:
      for key in keys:
        entry = self._entries.get(key)
        if entry is None:
          raise KeyError("host entry evicted under the restore")
        if isinstance(entry, _PendingBatch):
          self._materialize_locked(entry)
      leaves = self._entries[keys[0]]["data"].keys()
      data = {name: [self._entries[k]["data"][name] for k in keys] for name in leaves}
      if self.evict_policy == "lru":
        for key in keys:
          self._entries.move_to_end(key)
      nbytes = sum(self._entries[k]["nbytes"] for k in keys)
    self._write(pages, data)
    dt = time.perf_counter() - t0
    metrics.inc("kv_tier_restored_pages_total", len(keys))
    metrics.inc("kv_tier_restored_bytes_total", nbytes)
    metrics.inc("kv_prefix_registry_hits_total", len(keys), labels={"scope": "local"})
    metrics.observe_hist("kv_tier_restore_seconds", dt)
    metrics.observe_hist("kv_tier_restore_pages_per_op", len(keys), buckets=SIZE_BUCKETS)

  # ------------------------------------------------------- wire adoption

  def adopt_wire(self, keys: list[bytes], leaves: dict, quant: str | None = None) -> int:
    """Adopt pages streamed from a peer (disaggregated prefill/decode):
    ``leaves`` maps each pool leaf to a host array or tensor ``[L, n, ...]``
    stacked in ``keys`` order. Returns the number of pages adopted; 0 when
    the sender's ``quant`` tag disagrees with this pool's mode (int8 and
    int4 pages can share a byte size, so the tag guard fires first) or when
    the page geometry differs from pages this tier already holds. No caller
    until the ring's ``SendKvPages`` is ported."""
    if not keys or not leaves:
      return 0
    if quant is not None and self.kv_quant is not None and quant != self.kv_quant:
      return 0  # mismatched KV quant mode: refuse, don't poison the store
    leaves = {name: _host_tensor(arr) for name, arr in leaves.items()}
    n = min(len(keys), min(int(arr.shape[1]) for arr in leaves.values()))
    if n <= 0:
      return 0
    per_page = _page_nbytes(leaves)
    with self._lock:
      if self._page_nbytes is None:
        self._page_nbytes = per_page
      elif per_page != self._page_nbytes:
        return 0  # foreign geometry: refuse, don't poison the store
      for i in range(n):
        key = keys[i]
        old = self._entries.pop(key, None)
        if isinstance(old, dict):
          self._bytes -= old["nbytes"]
        # (Replacing a pending spill's entry: its charge settles when the
        # batch materializes.)
        self._entries[key] = {"data": {name: _page_copy(arr, i) for name, arr in leaves.items()}, "nbytes": per_page}
        self._bytes += per_page
      self._enforce_budget_locked()
    metrics.inc("kv_stream_adopted_pages_total", n)
    prefix_registry.note(keys[:n])
    self._update_gauges()
    return n

  # ------------------------------------------------------------------ admin

  def host_has(self, key: bytes) -> bool:
    with self._lock:
      return key in self._entries

  def host_keys(self) -> list[bytes]:
    """Chain keys host-resident now, newest first: the host half of the
    server's prefix advertisement (``BatchedServer.prefix_hexes``)."""
    with self._lock:
      return list(reversed(self._entries))

  @property
  def host_pages(self) -> int:
    with self._lock:
      return len(self._entries)

  @property
  def host_bytes(self) -> int:
    with self._lock:
      return self._bytes

  def clear(self) -> None:
    with self._lock:
      self._entries.clear()
      self._pending.clear()
      self._bytes = 0
    self._update_gauges()

  def _update_gauges(self) -> None:
    with self._lock:
      pages, nbytes = len(self._entries), self._bytes
    metrics.set_gauge("kv_tier_host_pages", pages)
    metrics.set_gauge("kv_tier_host_bytes", nbytes)
    metrics.set_gauge("kv_tier_host_utilization", round(nbytes / self.budget_bytes, 6) if self.budget_bytes else 0.0)

  def stats(self) -> dict:
    with self._lock:
      return {
        "host_pages": len(self._entries),
        "host_bytes": self._bytes,
        "budget_bytes": self.budget_bytes,
        "page_nbytes": self._page_nbytes,
        "pending_batches": len(self._pending),
        "evict_policy": self.evict_policy,
      }


# ------------------------------------------------- cluster prefix registry


class PrefixRegistry:
  """Bounded index of WHERE page-aligned prefixes sit.

  Local side: chain keys resident on this node (device prefix cache or
  host tier), noted as they appear, LRU-bounded at ``max_keys``. Remote
  side: the latest advertisement from each peer (a snapshot that replaces
  the previous one), bounded the same way and trusted for
  ``advert_ttl_s()`` after it arrived. ``locate`` answers which fresh
  peers claim a prefix. Keys are hints only: a stale one costs a
  recomputed prefill, never correctness."""

  def __init__(self, max_keys: int = MAX_REGISTRY_KEYS, *, clock=time.monotonic) -> None:
    self.max_keys = max_keys
    self._clock = clock
    self._local: "OrderedDict[bytes, None]" = OrderedDict()
    self._remote: dict[str, "OrderedDict[bytes, None]"] = {}
    self._remote_ts: dict[str, float] = {}
    self._lock = threading.Lock()

  def _fresh_locked(self, node_id: str) -> bool:
    ttl = advert_ttl_s()
    if ttl <= 0:
      return True
    ts = self._remote_ts.get(node_id)
    return ts is not None and self._clock() - ts <= ttl

  def note(self, keys) -> None:
    """Record chain keys now resident locally (either tier)."""
    with self._lock:
      for key in keys:
        self._local.pop(key, None)
        self._local[key] = None
      while len(self._local) > self.max_keys:
        self._local.popitem(last=False)

  def local_hexes(self, limit: int | None = None) -> list[str]:
    """Most-recent-first hex digests (bounded reply size)."""
    with self._lock:
      keys = list(reversed(self._local))
    if limit is not None:
      keys = keys[:limit]
    return [k.hex() for k in keys]

  def update_remote(self, node_id: str, hexes) -> None:
    """Replace ``node_id``'s advertisement (a snapshot, not a delta)."""
    entries: "OrderedDict[bytes, None]" = OrderedDict()
    for h in list(hexes)[: self.max_keys]:
      try:
        entries[bytes.fromhex(h)] = None
      except (ValueError, TypeError):
        continue  # a malformed advert key is dropped, not fatal
    with self._lock:
      self._remote[str(node_id)] = entries
      self._remote_ts[str(node_id)] = self._clock()

  def forget_remote(self, node_id: str) -> None:
    with self._lock:
      self._remote.pop(str(node_id), None)
      self._remote_ts.pop(str(node_id), None)

  def locate(self, key: bytes) -> list[str]:
    """Peers advertising ``key`` whose advert is within ``advert_ttl_s()``."""
    with self._lock:
      return [nid for nid, entries in self._remote.items() if key in entries and self._fresh_locked(nid)]

  def stale_remote_ids(self) -> list[str]:
    """Peers whose advert is past the TTL (the re-pull worklist)."""
    with self._lock:
      return [nid for nid in self._remote if not self._fresh_locked(nid)]

  def snapshot(self) -> dict:
    with self._lock:
      now = self._clock()
      return {
        "local_keys": len(self._local),
        "remote": {nid: len(entries) for nid, entries in self._remote.items()},
        "remote_age_s": {nid: round(now - ts, 3) for nid, ts in self._remote_ts.items()},
        "stale": [nid for nid in self._remote if not self._fresh_locked(nid)],
      }

  def clear_local(self) -> None:
    """Drop this node's advertisement (model swap: the same token chains now
    hold another model's KV). Remote views stay."""
    with self._lock:
      self._local.clear()

  def clear(self) -> None:
    with self._lock:
      self._local.clear()
      self._remote.clear()
      self._remote_ts.clear()


prefix_registry = PrefixRegistry()
