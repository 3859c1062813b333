"""Admission layer of the batched scheduler: the request record, the FIFO
queue, parking of page-starved requests, backpressure and cancel
bookkeeping — everything that happens before a request touches the device.

Own copy of the FIFO half of the reference's ``inference/sched_admission.py``
(its behaviour with ``XOT_TPU_QOS=0``). QoS classes, rate limits, deadline
shedding and disaggregated placement are not ported yet. This module never
imports the device-execution module (``batch_scheduler.py``), which drains
it at dispatch boundaries.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .engine import ServerOverloadedError


@dataclass
class _Request:
  request_id: str
  tokens: np.ndarray  # [S] int32 prompt tokens
  max_tokens: int
  temp: float
  top_k: int
  eos_ids: tuple
  emit: Callable[[str, list, bool], None]  # (request_id, new_tokens, finished)
  future: asyncio.Future = None
  page_demand: int = 0  # pages still needed at the last failed paged admission


class AdmissionControl:
  """Queue-side half of the batched scheduler (FIFO).

  Owns the waiting state — the queue, the parked (page-starved) deque, the
  id→request side table — and the backpressure check ``submit`` runs. The
  device-execution layer drains this queue at dispatch boundaries; it may
  reach into this state freely, but never the reverse."""

  def __init__(self, *, max_queue: int) -> None:
    # Admission backpressure: beyond this many waiting requests, submit fails
    # fast (the API maps it to 429) instead of growing the queue unboundedly.
    self.max_queue = max_queue
    self.queue: asyncio.Queue[_Request] = asyncio.Queue()
    # Page-starved requests park HERE, ahead of the queue, and retry first
    # each tick: a large prompt keeps its position against later small
    # requests that would otherwise consume every freed page.
    self.parked: "deque[_Request]" = deque()
    self.queued: dict[str, _Request] = {}  # request_id → queued request (cancel lookup)
    self.cancelled_ids: set[str] = set()  # cancels racing mid-admission
    self.admitting: set[str] = set()  # ids currently inside the dispatch path

  def waiting(self) -> int:
    return self.queue.qsize() + len(self.parked)

  def admit(self) -> None:
    """Backpressure for one submit: raise ``ServerOverloadedError`` when
    ``max_queue`` requests already wait."""
    if self.waiting() >= self.max_queue:
      raise ServerOverloadedError(f"request queue full ({self.max_queue} waiting)")

  async def enqueue(self, req: _Request) -> None:
    self.queued[req.request_id] = req
    await self.queue.put(req)

  def fail_queued(self, exc: Exception) -> None:
    """Teardown: fail every still-waiting request (parked first, then the
    queue) — the execution layer fails its resident rows separately."""
    self.queued.clear()
    while self.parked:
      req = self.parked.popleft()
      if not req.future.done():
        req.future.set_exception(exc)
    while not self.queue.empty():
      req = self.queue.get_nowait()
      if not req.future.done():
        req.future.set_exception(exc)
