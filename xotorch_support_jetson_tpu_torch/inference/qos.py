"""QoS layer of the batched scheduler: priority classes, per-tenant fair
queueing, token-bucket rate limits, and deadline-aware admission. Own copy
of the reference's ``inference/qos.py`` without its cross-node propagation
(``QosWire``/``qos_metadata``: not ported to the ring yet).

- PRIORITY CLASSES ``interactive`` / ``standard`` / ``batch``. Selection is
  priority-ordered with an AGING term: a class's effective score is
  ``rank - oldest_wait / aging_s``, so ``batch`` work can never starve.
- WEIGHTED-FAIR selection ACROSS TENANTS inside each class (start-time fair
  queueing): each tenant carries a virtual time advanced by
  ``prompt_tokens / weight`` per dequeue.
- PER-TENANT TOKEN BUCKETS for requests/s and prompt-tokens/s
  (``XOT_TPU_QOS_RPS`` / ``XOT_TPU_QOS_TPS``, per-tenant overrides via
  ``XOT_TPU_QOS_TENANTS`` JSON). Over-rate submissions fail fast with a
  ``RateLimitedError`` carrying ``retry_after_ms`` — the API answers a
  structured 429 with ``Retry-After``.
- DEADLINE-AWARE ADMISSION: a request may carry ``deadline_ms``; admission
  estimates queue drain + prefill + decode time from the live
  ``ttft_seconds`` / ``itl_seconds`` histograms and sheds requests whose
  deadline is already unmeetable (``DeadlineUnmeetableError``).

``QosQueue`` subclasses ``asyncio.Queue`` and overrides only the internal
container, so the scheduler's queue protocol (put/get/qsize/empty) is
untouched; with ``XOT_TPU_QOS=0`` the scheduler builds a plain
``asyncio.Queue`` and serves FIFO.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from ..utils.metrics import metrics
from .engine import ServerOverloadedError

PRIORITY_CLASSES = ("interactive", "standard", "batch")
_RANK = {name: i for i, name in enumerate(PRIORITY_CLASSES)}
DEFAULT_PRIORITY = "standard"

# Per-tenant bucket/fairness state is LRU-bounded: the tenant
# key is CLIENT-controlled (x-tenant-id header / Authorization hash), so an
# unbounded dict would let request spam with rotating tenant ids grow memory
# without limit. Evicting an idle tenant resets its buckets to full — the
# cost is forgiving a long-idle tenant's history, never correctness.
MAX_TENANTS = 4096


def qos_enabled() -> bool:
  return os.getenv("XOT_TPU_QOS", "1") not in ("0", "false")


def normalize_priority(priority) -> str:
  """Canonical class name; unknown/None values fall back to ``standard``
  (the API layer validates strictly — this is the lenient internal edge)."""
  p = str(priority or DEFAULT_PRIORITY).lower()
  return p if p in _RANK else DEFAULT_PRIORITY


def priority_rank(priority) -> int:
  return _RANK[normalize_priority(priority)]


class RateLimitedError(ServerOverloadedError):
  """Tenant exceeded its request- or token-rate budget; the API answers a
  structured 429 with ``Retry-After`` derived from the bucket refill math."""

  error_type = "rate_limited"

  def __init__(self, message: str, retry_after_ms: float | None = None) -> None:
    super().__init__(message)
    self.retry_after_ms = retry_after_ms


class DeadlineUnmeetableError(ServerOverloadedError):
  """The request's ``deadline_ms`` cannot be met given the measured queue
  drain + prefill + decode estimate — shed at admission instead of wasting
  prefill on a response nobody will wait for."""

  error_type = "deadline_unmeetable"

  def __init__(self, message: str, retry_after_ms: float | None = None) -> None:
    super().__init__(message)
    self.retry_after_ms = retry_after_ms


# ----------------------------------------------------------- token buckets


class TokenBucket:
  """Classic token bucket. ``rate <= 0`` means unlimited. A charge larger
  than the whole capacity is clamped to it (an oversized prompt drains the
  full bucket rather than being permanently unadmittable)."""

  def __init__(self, rate_per_s: float, capacity: float, clock=time.monotonic) -> None:
    self.rate = float(rate_per_s)
    self.capacity = max(float(capacity), 1.0) if self.rate > 0 else 0.0
    self.level = self.capacity
    self._clock = clock
    self._t_last: float | None = None

  def _refill(self, now: float) -> None:
    if self._t_last is None:
      self._t_last = now
      return
    self.level = min(self.capacity, self.level + (now - self._t_last) * self.rate)
    self._t_last = now

  def try_take(self, n: float = 1.0, now: float | None = None) -> bool:
    if self.rate <= 0:
      return True
    now = self._clock() if now is None else now
    self._refill(now)
    n = min(float(n), self.capacity)
    if self.level >= n:
      self.level -= n
      return True
    return False

  def give_back(self, n: float) -> None:
    """Undo a charge (a request rejected by a LATER bucket must not still
    pay this one)."""
    if self.rate > 0:
      self.level = min(self.capacity, self.level + float(n))

  def retry_after_s(self, n: float = 1.0, now: float | None = None) -> float:
    """Seconds until ``n`` tokens will be available (0 when already are)."""
    if self.rate <= 0:
      return 0.0
    now = self._clock() if now is None else now
    self._refill(now)
    n = min(float(n), self.capacity)
    return max(0.0, (n - self.level) / self.rate)


# ----------------------------------------------------------- configuration


@dataclass
class QosConfig:
  rps: float = 0.0  # per-tenant requests/s (0 = unlimited)
  tps: float = 0.0  # per-tenant prompt-tokens/s (0 = unlimited)
  burst_s: float = 2.0  # bucket capacity horizon (capacity = rate * burst_s)
  aging_s: float = 30.0  # anti-starvation aging constant (<= 0: strict priority)
  shed_margin: float = 1.0  # shed when estimate * margin > deadline
  preempt: bool = True  # preempt lower-priority resident rows under pressure
  # With the host KV tier on, a preemption victim's pages (prompt and
  # generated) are donated under extended chain keys, so its resume
  # transfers them back instead of recomputing the prefill. Off
  # (XOT_TPU_QOS_PREEMPT_SPILL=0) forces the recompute resume.
  preempt_spill: bool = True
  tenants: dict = field(default_factory=dict)  # name -> {rps, tps, weight}

  @classmethod
  def from_env(cls) -> "QosConfig":
    def _f(name: str, default: float) -> float:
      try:
        return float(os.getenv(name, "") or default)
      except ValueError:
        return default

    overrides: dict = {}
    raw = os.getenv("XOT_TPU_QOS_TENANTS", "")
    if raw:
      try:
        parsed = json.loads(raw)
        if isinstance(parsed, dict):
          overrides = {str(k): dict(v) for k, v in parsed.items() if isinstance(v, dict)}
      except (ValueError, TypeError):
        overrides = {}  # malformed overrides must not kill serving
    return cls(
      rps=_f("XOT_TPU_QOS_RPS", 0.0),
      tps=_f("XOT_TPU_QOS_TPS", 0.0),
      burst_s=max(_f("XOT_TPU_QOS_BURST_S", 2.0), 0.001),
      aging_s=_f("XOT_TPU_QOS_AGING_S", 30.0),
      shed_margin=max(_f("XOT_TPU_QOS_SHED_MARGIN", 1.0), 0.0),
      preempt=os.getenv("XOT_TPU_QOS_PREEMPT", "1") not in ("0", "false"),
      preempt_spill=os.getenv("XOT_TPU_QOS_PREEMPT_SPILL", "1") not in ("0", "false"),
      tenants=overrides,
    )


@dataclass
class QosTicket:
  """Per-request QoS identity attached at submit time."""

  priority: str
  tenant: str
  deadline_ms: float | None
  t_enqueue: float  # policy clock at submission
  cost: float  # prompt tokens (the fair-queueing charge)
  resumed: bool = False  # re-enqueued after preemption: front of its lane

  @property
  def rank(self) -> int:
    return _RANK[self.priority]


class _TenantState:
  __slots__ = ("name", "weight", "req_bucket", "tok_bucket", "vtime")

  def __init__(self, name: str, cfg: QosConfig, clock) -> None:
    self.name = name
    ov = cfg.tenants.get(name, {})

    def _num(key: str, default: float) -> float:
      try:
        return float(ov.get(key, default))
      except (TypeError, ValueError):
        return default

    rps = _num("rps", cfg.rps)
    tps = _num("tps", cfg.tps)
    self.weight = max(_num("weight", 1.0), 0.001)
    self.req_bucket = TokenBucket(rps, rps * cfg.burst_s, clock)
    self.tok_bucket = TokenBucket(tps, tps * cfg.burst_s, clock)
    self.vtime = 0.0


class QosPolicy:
  """Rate limiting, deadline admission, and fairness parameters — one per
  BatchedServer. ``clock`` is injectable for deterministic tests; histogram
  reads go through ``registry`` (the global metrics singleton by default)."""

  def __init__(self, cfg: QosConfig | None = None, *, clock=time.monotonic, registry=metrics) -> None:
    self.cfg = cfg or QosConfig()
    self.clock = clock
    self.registry = registry
    self._tenants: "OrderedDict[str, _TenantState]" = OrderedDict()
    self._lock = threading.Lock()
    # Measured admission drain: EWMA of the gap between
    # consecutive admissions taken WHILE work was still waiting — direct
    # evidence of how fast the queue actually drains. Under mixed ticks a
    # waiting request's prefill overlaps resident decode, so the historical
    # serial model (one median TTFT per waiting request per slot) overstates
    # drain time and sheds deadlines that would comfortably be met.
    self._t_last_admit: float | None = None
    self._admit_batch_n: int = 0  # admissions recorded at the current anchor
    self._admit_pass_seen: object = None  # boundary-pass id of the anchor
    self._admit_gap_ewma_s: float | None = None

  @classmethod
  def from_env(cls) -> "QosPolicy":
    return cls(QosConfig.from_env())

  def tenant(self, name: str) -> _TenantState:
    with self._lock:
      t = self._tenants.get(name)
      if t is None:
        t = self._tenants[name] = _TenantState(name, self.cfg, self.clock)
        while len(self._tenants) > MAX_TENANTS:
          self._tenants.popitem(last=False)
      self._tenants.move_to_end(name)
      return t

  def ticket(self, priority, tenant: str, deadline_ms, prompt_tokens: int) -> QosTicket:
    return QosTicket(
      priority=normalize_priority(priority),
      tenant=str(tenant or "default"),
      deadline_ms=float(deadline_ms) if deadline_ms is not None else None,
      t_enqueue=self.clock(),
      cost=max(float(prompt_tokens), 1.0),
    )

  # ------------------------------------------------------------ rate limits

  def check_rate(self, tenant_name: str, prompt_tokens: int) -> None:
    """Charge the tenant's buckets; raises ``RateLimitedError`` (with
    ``retry_after_ms``) when over budget. A request refused by the token
    bucket gives its request-bucket charge back — one refusal, one charge."""
    t = self.tenant(tenant_name)
    now = self.clock()
    if not t.req_bucket.try_take(1.0, now):
      raise RateLimitedError(
        f"tenant {tenant_name!r} over its request rate",
        retry_after_ms=t.req_bucket.retry_after_s(1.0, now) * 1e3,
      )
    if not t.tok_bucket.try_take(prompt_tokens, now):
      t.req_bucket.give_back(1.0)
      raise RateLimitedError(
        f"tenant {tenant_name!r} over its prompt-token rate",
        retry_after_ms=t.tok_bucket.retry_after_s(prompt_tokens, now) * 1e3,
      )

  def refund(self, tenant_name: str, prompt_tokens: int) -> None:
    """Undo a ``check_rate`` charge for a request refused AFTER it — a
    queue-full rejection or deadline shed consumed no service, and charging
    for it would make the client's compliant Retry-After backoff fail again
    as rate_limited (one refusal, one charge)."""
    t = self.tenant(tenant_name)
    t.req_bucket.give_back(1.0)
    t.tok_bucket.give_back(float(prompt_tokens))

  # ------------------------------------------------------ deadline admission

  def note_admission(self, waiting: int, pass_id: object = None) -> None:
    """Record one slot admission for the measured-drain estimate. Only gaps
    taken while ``waiting > 0`` count — an idle stretch between requests is
    not drain evidence, and folding it in would swing the estimate the
    over-eager-shed way the serial model already errs. Admission is BATCHED
    (one boundary pass admits K requests), so the cadence evidence is per
    BOUNDARY: the K intra-pass gaps must not enter the EWMA (they measure
    per-admission host work — page restores, validation — not drain, and
    would flip the estimator to under-shedding); instead the inter-boundary
    gap is split over the previous pass's K admissions. ``pass_id`` is the
    caller's boundary-pass identity (the scheduler passes its admission
    pass counter); callers without one fall back to a 1 ms same-instant
    heuristic."""
    now = self.clock()
    if waiting <= 0:
      # This admission came off an idle (or freshly drained) queue: the gap
      # behind it measures arrival spacing, not drain rate. Drop the anchor
      # so the NEXT backlogged admission starts a fresh gap.
      self._t_last_admit = None
      self._admit_batch_n = 0
      self._admit_pass_seen = None
      return
    if self._t_last_admit is None:
      self._t_last_admit = now
      self._admit_batch_n = 1
      self._admit_pass_seen = pass_id
      return
    gap = max(now - self._t_last_admit, 0.0)
    same_pass = (pass_id == self._admit_pass_seen) if pass_id is not None else gap < 1e-3
    if same_pass:
      # Same boundary pass: another row of the batch, not cadence evidence.
      self._admit_batch_n += 1
      return
    # A new boundary: the previous pass's admissions drained in ``gap`` —
    # per-request spacing is gap / batch size. Inline EWMA
    # (paging.ewma_update clamps to [0,1] — it is an acceptance fraction);
    # the 60 s cap bounds one stall's poisoning.
    per = min(gap, 60.0) / max(self._admit_batch_n, 1)
    self._admit_gap_ewma_s = per if self._admit_gap_ewma_s is None else 0.7 * self._admit_gap_ewma_s + 0.3 * per
    self._t_last_admit = now
    self._admit_batch_n = 1
    self._admit_pass_seen = pass_id

  def measured_drain_ms(self, queue_depth: int) -> float | None:
    """Queue-drain estimate from the MEASURED admission cadence (None until
    two backlogged admissions have been observed)."""
    if self._admit_gap_ewma_s is None:
      return None
    return float(queue_depth) * self._admit_gap_ewma_s * 1e3

  def estimate_completion_ms(self, *, queue_depth: int, n_slots: int, max_tokens: int) -> float | None:
    """Expected time-to-last-token for a request admitted NOW, from the live
    latency histograms: queue drain, plus this request's own prefill (median
    TTFT) and decode (``max_tokens`` median inter-token gaps). ``None`` when
    the histograms are empty (cold start: admit, never guess).

    The drain term historically modeled one median TTFT per waiting request
    per slot — a SERIAL model that is honest for the alternating scheduler
    but over-sheds under mixed ticks, where a queued request's
    prefill overlaps resident decode and admissions keep flowing during
    generation. When the measured admission cadence is available
    (``note_admission``) and mixed ticks are enabled, the drain term is the
    smaller of the two: measured evidence caps the model, and the serial
    model remains the cold-start fallback. The request's OWN prefill and
    decode stay serial — they are serial for the request itself."""
    ttft = self.registry.quantile("ttft_seconds", 0.5)
    itl = self.registry.quantile("itl_seconds", 0.5)
    if ttft is None and itl is None:
      return None
    ttft_ms = (ttft or 0.0) * 1e3
    itl_ms = (itl or 0.0) * 1e3
    drain_ms = ttft_ms * (queue_depth / max(n_slots, 1))
    from .paging import mixed_tick_enabled

    measured = self.measured_drain_ms(queue_depth) if mixed_tick_enabled() else None
    if measured is not None:
      drain_ms = min(drain_ms, measured)
    return drain_ms + ttft_ms + max(int(max_tokens), 0) * itl_ms

  def should_shed(self, deadline_ms: float, estimate_ms: float) -> bool:
    return estimate_ms * self.cfg.shed_margin > float(deadline_ms)

  def deadline_expired(self, ticket: QosTicket) -> bool:
    """Has the request's deadline already passed while it waited?"""
    if ticket.deadline_ms is None:
      return False
    return (self.clock() - ticket.t_enqueue) * 1e3 > ticket.deadline_ms

  def retry_after_ms(self, queue_depth: int, n_slots: int) -> float:
    """Backoff hint for rejected/shed requests, from the measured drain
    rate: the median TTFT is how fast a slot turns over, so a queue of depth
    d over s slots drains in about ``ttft * d / s``. 1 s floor when the
    histograms are empty (cold overload — something is still wrong)."""
    ttft = self.registry.quantile("ttft_seconds", 0.5)
    if ttft is None:
      return 1000.0
    return max(ttft * 1e3 * (1.0 + queue_depth / max(n_slots, 1)), 50.0)


# ------------------------------------------------------------- fair queue


class _ClassLane:
  """One priority class: per-tenant FIFO deques + the class virtual clock."""

  __slots__ = ("by_tenant", "vclock", "n")

  def __init__(self) -> None:
    self.by_tenant: "OrderedDict[str, deque]" = OrderedDict()
    self.vclock = 0.0
    self.n = 0

  def oldest_enqueue(self) -> float | None:
    heads = [d[0] for d in self.by_tenant.values() if d]
    if not heads:
      return None
    return min(r.qos.t_enqueue for r in heads)


class _QosStore:
  """The internal container ``QosQueue`` installs as ``asyncio.Queue``'s
  ``_queue``: ``append`` classifies, ``popleft`` runs the class/tenant
  selection. Requests without a ticket (direct scheduler users) ride the
  ``standard`` class, ``default`` tenant."""

  def __init__(self, policy: QosPolicy) -> None:
    self.policy = policy
    self.lanes: dict[str, _ClassLane] = {name: _ClassLane() for name in PRIORITY_CLASSES}
    self._n = 0

  def __len__(self) -> int:
    return self._n

  def _lane_of(self, req) -> tuple[_ClassLane, QosTicket]:
    ticket = getattr(req, "qos", None)
    if ticket is None:
      ticket = self.policy.ticket(DEFAULT_PRIORITY, "default", None, 1)
      req.qos = ticket
    return self.lanes[ticket.priority], ticket

  def append(self, req) -> None:
    lane, ticket = self._lane_of(req)
    dq = lane.by_tenant.get(ticket.tenant)
    if dq is None:
      dq = lane.by_tenant[ticket.tenant] = deque()
    # Preemption resume goes to the FRONT of its lane: the request already
    # earned its position (and paid its virtual-time charge) the first time.
    if ticket.resumed:
      dq.appendleft(req)
    else:
      dq.append(req)
    lane.n += 1
    self._n += 1

  def _select(self) -> tuple[_ClassLane, str] | None:
    """(lane, tenant) of the next request: lowest ``rank - wait/aging``
    class, then the smallest-virtual-time tenant inside it."""
    now = self.policy.clock()
    aging = self.policy.cfg.aging_s
    best_lane: tuple[float, int, _ClassLane] | None = None
    for name, lane in self.lanes.items():
      oldest = lane.oldest_enqueue()
      if oldest is None:
        continue
      rank = _RANK[name]
      score = float(rank) - ((now - oldest) / aging if aging > 0 else 0.0)
      key = (score, rank)
      if best_lane is None or key < best_lane[:2]:
        best_lane = (score, rank, lane)
    if best_lane is None:
      return None
    lane = best_lane[2]
    best_tenant: tuple[float, str] | None = None
    for tname, dq in lane.by_tenant.items():
      if not dq:
        continue
      vt = self.policy.tenant(tname).vtime
      if best_tenant is None or (vt, tname) < best_tenant:
        best_tenant = (vt, tname)
    return lane, best_tenant[1]

  def popleft(self):
    picked = self._select()
    if picked is None:
      raise IndexError("pop from empty QosStore")
    lane, tname = picked
    dq = lane.by_tenant[tname]
    req = dq.popleft()
    if not dq:
      del lane.by_tenant[tname]
    lane.n -= 1
    self._n -= 1
    ticket = req.qos
    tenant = self.policy.tenant(tname)
    if ticket.resumed:
      ticket.resumed = False  # charge was paid on first admission
    else:
      # Start-time fair queueing: lag behind the class clock is forgiven (a
      # quiet tenant cannot bank unbounded credit), service advances the
      # tenant clock by its weighted cost.
      start = max(tenant.vtime, lane.vclock)
      tenant.vtime = start + ticket.cost / tenant.weight
      lane.vclock = start
    return req

  def peek(self):
    picked = self._select()
    if picked is None:
      return None
    return picked[0].by_tenant[picked[1]][0]

  def shed_lowest(self, max_rank_exclusive: int):
    """Remove and return the YOUNGEST waiting request of the lowest-priority
    nonempty class whose rank is strictly greater than
    ``max_rank_exclusive`` — the overload victim that frees queue space for
    higher-priority work. Requests that already streamed tokens (preempted
    and re-enqueued to resume: non-empty ``carry_tokens``) are never shed —
    a mid-stream 429 would break the resume guarantee their client was
    given. None when no sheddable strictly-lower-priority work waits."""
    for name in reversed(PRIORITY_CLASSES):
      if _RANK[name] <= max_rank_exclusive:
        break
      lane = self.lanes[name]
      if lane.n == 0:
        continue
      victim_dq = None
      victim_tenant = None
      victim = None
      victim_t = -1.0
      for tname, dq in lane.by_tenant.items():
        for r in dq:
          if getattr(r, "carry_tokens", None):
            continue  # resumed mid-stream: not a shed candidate
          # >= so equal timestamps resolve to the LATER entry (deques are
          # FIFO, so the last qualifying entry is the youngest).
          if r.qos.t_enqueue >= victim_t:
            victim_dq, victim_tenant, victim, victim_t = dq, tname, r, r.qos.t_enqueue
      if victim is None:
        continue  # this class holds only resumed work: look higher
      victim_dq.remove(victim)
      if not victim_dq:
        del lane.by_tenant[victim_tenant]
      lane.n -= 1
      self._n -= 1
      return victim
    return None

  def class_depths(self) -> dict[str, int]:
    return {name: lane.n for name, lane in self.lanes.items()}


class QosQueue(asyncio.Queue):
  """asyncio.Queue whose internal container applies the QoS policy. Only
  ``_init`` is overridden — put/get/qsize/empty and all waiter machinery are
  the stock implementation, so the scheduler's queue protocol is unchanged."""

  def __init__(self, policy: QosPolicy) -> None:
    self._policy = policy
    super().__init__()

  def _init(self, maxsize: int) -> None:
    self._queue = _QosStore(self._policy)

  def peek(self):
    return self._queue.peek()

  def shed_lowest(self, max_rank_exclusive: int):
    return self._queue.shed_lowest(max_rank_exclusive)

  def class_depths(self) -> dict[str, int]:
    return self._queue.class_depths()
