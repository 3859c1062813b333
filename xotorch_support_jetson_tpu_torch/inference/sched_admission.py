"""Admission layer of the batched scheduler: the request record, the queue
and its QoS policy (priority classes, tenant fair queueing, rate limits,
deadline shedding, overload sheds), parking of page-starved requests,
backpressure and cancel bookkeeping — everything that happens before a
request touches the device.

Own copy of the admission half of the reference's
``inference/sched_admission.py``. With ``qos=False`` (or ``XOT_TPU_QOS=0``)
the queue is a plain FIFO ``asyncio.Queue``. Disaggregated placement and
graceful drain are not ported. This module never imports the
device-execution module (``batch_scheduler.py``), which drains it at
dispatch boundaries.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..orchestration import slo
from ..utils.metrics import metrics
from .engine import ServerOverloadedError
from .qos import DeadlineUnmeetableError, QosPolicy, QosQueue, priority_rank, qos_enabled


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
  t_submit: float = 0.0  # perf_counter at submit (queue-wait / TTFT histograms)
  qos: object = None  # QosTicket (inference/qos.py) when the QoS layer is on
  # Tokens generated before a QoS preemption: the resumed incarnation's
  # prompt absorbs them, and every finish path reports carry + new.
  carry_tokens: list = field(default_factory=list)
  t_parked: float = 0.0  # perf_counter when the request first parked page-starved (0 = never)
  # Measured TTFT of the first incarnation: survives a preempt-resume (the
  # resumed incarnation zeroes t_submit), so goodput judges the latency the
  # client saw.
  slo_ttft_s: float | None = None
  # Multi-LoRA serving: the named adapter this request selected (None: the
  # base model) and the device slot it holds pinned while admitted
  # (inference/adapters.py). The name survives a preemption, so a resumed
  # row re-pins its adapter at its next admission. ``adapter_install`` is
  # the slot's install when admission queued it for the device thread (a
  # Future, read by the prefill dispatch: a failed install fails the row).
  adapter: str | None = None
  adapter_slot: int = 0
  adapter_install: object = None


class AdmissionControl:
  """Queue-side half of the batched scheduler.

  Owns the waiting state — the (QoS or FIFO) queue, the parked
  (page-starved) deque, the id→request side table — and the refusal ladder
  ``submit`` walks: rate limits / deadline shed, then backpressure with
  priority-aware overload shedding. The device-execution layer drains this
  queue at dispatch boundaries; it may reach into this state freely, but
  never the reverse."""

  def __init__(self, *, n_slots: int, max_queue: int, qos: "QosPolicy | bool | None" = None) -> None:
    self.n_slots = n_slots
    # Admission backpressure: beyond this many waiting requests, submit fails
    # fast (the API maps it to 429) instead of growing the queue unboundedly.
    self.max_queue = max_queue
    # ``qos=None`` resolves from the env (XOT_TPU_QOS, default on);
    # ``qos=False`` forces it off; a QosPolicy instance is used as-is (tests
    # inject clocks and configs). With QoS off the queue is a plain
    # asyncio.Queue and every QoS branch is skipped.
    if qos is None:
      self.qos = QosPolicy.from_env() if qos_enabled() else None
    elif qos is True:
      self.qos = QosPolicy.from_env()
    elif qos is False:
      self.qos = None
    else:
      self.qos = qos
    self.queue: asyncio.Queue[_Request] = QosQueue(self.qos) if self.qos is not None else asyncio.Queue()
    # Page-starved requests park HERE, ahead of the queue, and retry first
    # each tick: a large prompt keeps its position against later small
    # requests that would otherwise consume every freed page.
    self.parked: "deque[_Request]" = deque()
    self.queued: dict[str, _Request] = {}  # request_id → queued request (cancel lookup)
    self.cancelled_ids: set[str] = set()  # cancels racing mid-admission
    self.admitting: set[str] = set()  # ids currently inside the dispatch path

  # ------------------------------------------------------------ refusal ladder

  def waiting(self) -> int:
    return self.queue.qsize() + len(self.parked)

  def admit(self, request_id: str, prompt_tokens: int, max_tokens: int, priority, tenant, deadline_ms):
    """Walk the pre-queue refusal ladder for one submit. Returns the
    request's QosTicket (None with QoS off) or raises the typed refusal
    (rate/deadline first, then backpressure)."""
    ticket = None
    if self.qos is not None:
      ticket = self._qos_admit(request_id, prompt_tokens, max_tokens, priority, tenant, deadline_ms)
    if self.waiting() >= self.max_queue:
      # Under QoS, overload sheds strictly-lower-priority WAITING work first
      # (a batch request yields its queue spot to interactive traffic); only
      # when nothing outranked waits is the new request rejected.
      if self.qos is None or not self._shed_for(ticket):
        metrics.inc("scheduler_rejections_total")
        slo.note_bad(ticket.priority if ticket is not None else "standard", "rejected")
        err = ServerOverloadedError(f"request queue full ({self.max_queue} waiting)")
        if self.qos is not None:
          # No service was consumed: give the rate-bucket charges back, or
          # the compliant Retry-After retry would fail again as rate_limited.
          self.qos.refund(ticket.tenant, prompt_tokens)
          err.retry_after_ms = self.qos.retry_after_ms(self.waiting(), self.n_slots)
          metrics.inc("qos_rejected_total", labels={"class": ticket.priority})
        raise err
    return ticket

  def _qos_admit(self, request_id: str, prompt_tokens: int, max_tokens: int, priority, tenant, deadline_ms):
    """QoS admission pass (rate limits, deadline shedding) — runs before the
    request touches the queue, so refused work costs nothing downstream.
    Returns the request's QosTicket or raises a 429-mapped error."""
    qos = self.qos
    ticket = qos.ticket(priority, tenant, deadline_ms, prompt_tokens)
    metrics.inc("qos_submitted_total", labels={"class": ticket.priority})
    try:
      qos.check_rate(ticket.tenant, prompt_tokens)
    except ServerOverloadedError:
      metrics.inc("qos_rate_limited_total", labels={"tenant": ticket.tenant})
      slo.note_bad(ticket.priority, "rate_limited")
      raise
    if ticket.deadline_ms is not None:
      est = qos.estimate_completion_ms(queue_depth=self.queue_depth_ahead(ticket), n_slots=self.n_slots, max_tokens=max_tokens)
      if est is not None and qos.should_shed(ticket.deadline_ms, est):
        qos.refund(ticket.tenant, prompt_tokens)  # shed before any service
        metrics.inc("qos_shed_total", labels={"reason": "deadline"})
        slo.note_bad(ticket.priority, "shed")
        raise DeadlineUnmeetableError(
          f"deadline {ticket.deadline_ms:.0f} ms unmeetable (estimated {est:.0f} ms to last token)",
          retry_after_ms=qos.retry_after_ms(self.waiting(), self.n_slots),
        )
    return ticket

  def queue_depth_ahead(self, ticket) -> int:
    """Waiting work the QoS selection would serve at or before this
    request's class (an interactive deadline is not charged for draining a
    batch backlog it outranks). Parked requests always count: they retry
    ahead of the queue."""
    depths = self.queue.class_depths()
    ahead = sum(n for cls, n in depths.items() if priority_rank(cls) <= ticket.rank)
    return ahead + len(self.parked)

  def _shed_for(self, ticket) -> bool:
    """Overload policy: make queue room for ``ticket`` by shedding the
    youngest strictly-lower-priority WAITING request (its client gets a
    structured 429 with Retry-After). False when nothing outranked waits."""
    victim = self.queue.shed_lowest(ticket.rank)
    if victim is None:
      return False
    self.queued.pop(victim.request_id, None)
    vt = victim.qos
    if vt is not None:
      self.qos.refund(vt.tenant, int(victim.tokens.shape[0]))  # the victim consumed no service
    metrics.inc("qos_shed_total", labels={"reason": "overload"})
    slo.note_bad(vt.priority if vt is not None else "standard", "shed")
    err = ServerOverloadedError("shed under overload for higher-priority work")
    err.retry_after_ms = self.qos.retry_after_ms(self.waiting(), self.n_slots)
    if not victim.future.done():
      victim.future.set_exception(err)
    return True

  # ----------------------------------------------------------- queue plumbing

  async def enqueue(self, req: _Request) -> None:
    self.queued[req.request_id] = req
    metrics.inc("scheduler_submitted_total")
    await self.queue.put(req)

  def requeue_resumed(self, req: _Request) -> None:
    """Re-enqueue an extracted row for a local resume, front of its lane (it
    already paid its fair-queue charge at first admission)."""
    if req.qos is not None:
      req.qos.resumed = True
      if self.qos is not None:
        # Restart the ticket's aging clock: the row already received
        # service, and its original t_enqueue would let a long-resident
        # batch row out-score the very waiter that preempted it.
        req.qos.t_enqueue = self.qos.clock()
    self.queued[req.request_id] = req
    self.queue.put_nowait(req)

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
