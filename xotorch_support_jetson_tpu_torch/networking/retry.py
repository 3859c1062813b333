"""RPC timeouts, retries and per-peer circuit breakers (own copy of the
reference's ``networking/retry.py``).

- Timeouts per method (the reference's table), overridable per method with
  ``XOT_TPU_RPC_TIMEOUT_<METHOD>_S`` and, for the bounded methods only,
  capped by ``XOT_TPU_RPC_TIMEOUT_S``. SendPrompt / SendTensor stay
  unbounded: on a ring their latency is the whole awaited downstream
  generation. The reference also caps the forward path at a request's QoS
  deadline through its wire registry; the port has no such registry yet.
- Retries, with full-jitter exponential backoff, only for the idempotent
  methods (SendResult, deduped by absolute position; SendOpaqueStatus;
  CollectTopology), charged to a per-request budget
  (``XOT_TPU_RPC_RETRY_BUDGET``). The data plane never retries here: the
  node's replay (orchestration/node.py ``_retry_request``) owns it.
- Circuit breakers per (peer id, address): ``XOT_TPU_CB_FAILS`` failures in
  a row open it (calls fail fast with ``PeerCircuitOpenError``), after
  ``XOT_TPU_CB_OPEN_S`` it goes half-open and the next health check probes.
  State is the gauge ``peer_circuit_state{peer}`` (0 closed, 1 half-open, 2
  open).
- Health flap damping: ``peer_health`` counts failed health checks in a
  row; discovery drops a peer only at ``XOT_TPU_HEALTH_FAILS`` (default 3).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict

from ..utils.helpers import env_float
from ..utils.metrics import metrics

# Per-method defaults in seconds. None: unbounded.
METHOD_TIMEOUT_DEFAULTS: dict[str, float | None] = {
  "Connect": 10.0,
  "HealthCheck": 5.0,
  "SendPrompt": None,
  "SendTensor": None,
  "SendExample": None,
  "SendLoss": None,
  "SendResult": 15.0,
  "SendOpaqueStatus": 15.0,
  "SendKvPages": 15.0,
  "CollectTopology": 5.0,
}

# Methods whose duplicate delivery is harmless (deduped, nonce'd or reads).
RETRYABLE_METHODS = frozenset({"SendResult", "SendOpaqueStatus", "CollectTopology"})

_OPEN, _HALF_OPEN, _CLOSED = 2, 1, 0


def rpc_timeout(method: str) -> float | None:
  """The per-method env override wins outright; the global
  ``XOT_TPU_RPC_TIMEOUT_S`` caps the finite defaults and leaves the
  unbounded data-plane methods alone; else the default."""
  default = METHOD_TIMEOUT_DEFAULTS.get(method)
  per = os.getenv(f"XOT_TPU_RPC_TIMEOUT_{method.upper()}_S")
  if per is not None:
    try:
      v = float(per)
      return v if v > 0 else None
    except ValueError:
      pass
  if default is not None:
    return min(default, env_float("XOT_TPU_RPC_TIMEOUT_S", default))
  return default


def rpc_retries(method: str) -> int:
  if method not in RETRYABLE_METHODS:
    return 0
  try:
    return max(int(os.getenv("XOT_TPU_RPC_RETRIES", "2") or 2), 0)
  except ValueError:
    return 2


_rng = random.Random()


def backoff_s(attempt: int, rng: random.Random | None = None) -> float:
  """Full-jitter backoff for retry ``attempt`` (1-based): uniform in
  (0, min(base·2^(attempt-1), cap)]."""
  base = env_float("XOT_TPU_RPC_RETRY_BASE_S", 0.05)
  cap = env_float("XOT_TPU_RPC_RETRY_MAX_S", 2.0)
  span = min(base * (2 ** max(attempt - 1, 0)), cap)
  return span * max((rng or _rng).random(), 0.01)


class RetryBudget:
  """Per-request retry allowance across methods (LRU-bounded)."""

  MAX_ENTRIES = 4096

  def __init__(self) -> None:
    self._spent: "OrderedDict[str, int]" = OrderedDict()
    self._lock = threading.Lock()

  def take(self, request_id: str) -> bool:
    """Charge one retry; False once the request's budget is spent. Calls
    without a request id (control broadcasts) are uncapped."""
    if not request_id:
      return True
    limit = int(env_float("XOT_TPU_RPC_RETRY_BUDGET", 8))
    with self._lock:
      spent = self._spent.get(request_id, 0)
      if spent >= limit:
        return False
      self._spent[request_id] = spent + 1
      self._spent.move_to_end(request_id)
      while len(self._spent) > self.MAX_ENTRIES:
        self._spent.popitem(last=False)
    return True

retry_budget = RetryBudget()


class PeerCircuitOpenError(ConnectionError):
  """The peer's circuit is open: the call was not attempted."""


class CircuitBreaker:
  def __init__(self, peer_id: str) -> None:
    self.peer_id = peer_id
    self.state = _CLOSED
    self.failures = 0
    self.opened_at = 0.0
    self._lock = threading.Lock()

  def _set_state(self, state: int) -> None:
    self.state = state
    metrics.set_gauge("peer_circuit_state", state, labels={"peer": self.peer_id})

  def allow(self) -> bool:
    """May a call that is not a probe go ahead? An open circuit fails fast
    until its window lapses, then turns half-open."""
    with self._lock:
      if self.state != _OPEN:
        return True
      if time.monotonic() - self.opened_at >= env_float("XOT_TPU_CB_OPEN_S", 10.0):
        self._set_state(_HALF_OPEN)
        return True
      return False

  def record_success(self) -> None:
    with self._lock:
      self.failures = 0
      if self.state != _CLOSED:
        self._set_state(_CLOSED)

  def record_failure(self) -> None:
    with self._lock:
      self.failures += 1
      threshold = max(int(env_float("XOT_TPU_CB_FAILS", 5)), 1)
      # A failed half-open probe re-opens at once (a fresh window).
      if self.state == _HALF_OPEN or self.failures >= threshold:
        self.opened_at = time.monotonic()
        if self.state != _OPEN:
          self._set_state(_OPEN)

  @property
  def is_open(self) -> bool:
    return self.state == _OPEN


class BreakerRegistry:
  """Breakers keyed by (peer id, address): a restarted peer at a new
  address starts closed; the same dead address keeps its open circuit."""

  def __init__(self) -> None:
    self._by_key: dict[tuple[str, str], CircuitBreaker] = {}
    self._lock = threading.Lock()

  def get(self, peer_id: str, address: str = "") -> CircuitBreaker:
    with self._lock:
      b = self._by_key.get((peer_id, address))
      if b is None:
        b = self._by_key[(peer_id, address)] = CircuitBreaker(peer_id)
      return b

  def forget(self, peer_id: str) -> None:
    with self._lock:
      for key in [k for k in self._by_key if k[0] == peer_id]:
        del self._by_key[key]
    metrics.set_gauge("peer_circuit_state", _CLOSED, labels={"peer": peer_id})


breakers = BreakerRegistry()


class PeerHealth:
  """Failed health checks in a row per peer, recorded by the peer handle's
  ``health_check`` (the one probe every discovery calls)."""

  def __init__(self) -> None:
    self._consecutive: dict[str, int] = {}
    self._lock = threading.Lock()

  def record(self, peer_id: str, ok: bool) -> None:
    with self._lock:
      if ok:
        self._consecutive.pop(peer_id, None)
      else:
        self._consecutive[peer_id] = self._consecutive.get(peer_id, 0) + 1

  def consecutive_failures(self, peer_id: str) -> int:
    with self._lock:
      return self._consecutive.get(peer_id, 0)

  def is_dead(self, peer_id: str) -> bool:
    """Dead: ``XOT_TPU_HEALTH_FAILS`` failed checks in a row (default 3)."""
    return self.consecutive_failures(peer_id) >= max(int(env_float("XOT_TPU_HEALTH_FAILS", 3)), 1)

  def forget(self, peer_id: str) -> None:
    with self._lock:
      self._consecutive.pop(peer_id, None)


peer_health = PeerHealth()
