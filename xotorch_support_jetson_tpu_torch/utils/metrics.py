"""Metrics registry with Prometheus text exposition — counters, gauges and
bucketed histograms, each optionally labelled (one level, e.g.
``{"class": "interactive"}``).

Own copy of the local half of the reference's ``utils/metrics.py``: the
batched server records its latencies here (TTFT, inter-token latency, queue
wait, chunk times), the QoS deadline estimator and the mixed-tick budget
read them back (``quantile``, ``gauge_value``), the SLO engine windows them
with ``snapshot``/``snapshot_delta``, and ``GET /metrics`` renders them.
The host KV tier (inference/kv_tier.py) records its traffic under the
reference's names (``kv_tier_spilled_pages_total``, ``_restored_pages_total``,
``_host_pages`` ...) plus two counters of its own,
``kv_tier_spill_failures_total`` and ``kv_tier_restore_failures_total``
(labelled with the exception's class). Batched speculation records the
reference's series: ``spec_accepted_tokens_total{proposer}`` and
``spec_proposed_tokens_total{proposer}``, the ``spec_acceptance_ewma``
histogram (``FRACTION_BUCKETS``), the ``spec_gamma{row}`` and
``spec_proposer{row}`` gauges (0 plain, 1 n-gram, 2 model draft), the
``kv_draft_bytes`` / ``kv_draft_slots`` / ``kv_draft_pages_equivalent``
gauges (0 on a draft-free server) and the ``path="spec"`` label of
``decode_chunks_total`` and ``decode_tokens_total``. The program ledger
(utils/programs.py) records the reference's ``program_compiles_total``,
``program_dispatch_total`` and ``program_steady_compiles_total``
(``{family}``), the ``program_compile_seconds`` / ``program_device_seconds``
histograms, the ``programs_steady`` and ``warmup_programs`` gauges and
``warmup_compile_seconds``, plus one series of its own,
``program_captures_total{family}`` (CUDA graphs captured).
The cluster merge of peer snapshots is not ported (the ring's cluster
pulls wait for a later slice).
"""

from __future__ import annotations

import threading
from collections import defaultdict

# Latency ladder in SECONDS: 1 ms .. 60 s (+Inf implicit). Dense at the low
# end where decode cadence lives, sparse at the top where only stragglers land.
DEFAULT_BUCKETS = (
  0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Count ladder for size-valued histograms (pages per KV-tier restore).
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

# Unit-interval ladder for fraction-valued histograms.
FRACTION_BUCKETS = (0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.55, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0)


def _label_key(labels: dict | None) -> tuple:
  return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _label_str(key: tuple) -> str:
  if not key:
    return ""
  return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Histogram:
  __slots__ = ("buckets", "counts", "sum", "count")

  def __init__(self, buckets: tuple = DEFAULT_BUCKETS) -> None:
    self.buckets = tuple(float(b) for b in buckets)
    self.counts = [0] * (len(self.buckets) + 1)  # last slot = +Inf
    self.sum = 0.0
    self.count = 0

  def observe(self, value: float, n: int = 1) -> None:
    """Record ``n`` identical observations of ``value`` in one pass (a
    decode chunk's wall-clock spread over its k tokens is k observations of
    the same value)."""
    if n <= 0:
      return
    value = float(value)
    i = 0
    for i, edge in enumerate(self.buckets):  # noqa: B007 — 16 edges; bisect buys nothing
      if value <= edge:
        break
    else:
      i = len(self.buckets)
    self.counts[i] += n
    self.sum += value * n
    self.count += n

  def quantile(self, q: float) -> float | None:
    """Approximate quantile by linear interpolation inside the landing
    bucket (Prometheus' ``histogram_quantile`` estimate). None when empty;
    values in the +Inf bucket clamp to the last finite edge."""
    if self.count == 0:
      return None
    q = min(max(float(q), 0.0), 1.0)
    rank = q * self.count
    cum = 0.0
    for i, n in enumerate(self.counts):
      prev_cum = cum
      cum += n
      if cum >= rank and n > 0:
        if i >= len(self.buckets):
          return self.buckets[-1]
        lo = 0.0 if i == 0 else self.buckets[i - 1]
        hi = self.buckets[i]
        frac = (rank - prev_cum) / n
        return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return self.buckets[-1]


class Metrics:
  def __init__(self) -> None:
    self._lock = threading.Lock()
    self.counters: dict[str, float] = defaultdict(float)
    self.gauges: dict[str, float] = {}
    # Labelled variants: name -> {label-key-tuple -> value}.
    self._labeled_counters: dict[str, dict[tuple, float]] = defaultdict(lambda: defaultdict(float))
    self._labeled_gauges: dict[str, dict[tuple, float]] = defaultdict(dict)
    self._hists: dict[str, _Histogram] = {}
    self._labeled_hists: dict[str, dict[tuple, _Histogram]] = defaultdict(dict)

  def inc(self, name: str, value: float = 1.0, labels: dict | None = None) -> None:
    with self._lock:
      if labels:
        self._labeled_counters[name][_label_key(labels)] += value
      else:
        self.counters[name] += value

  def set_gauge(self, name: str, value: float, labels: dict | None = None) -> None:
    with self._lock:
      if labels:
        self._labeled_gauges[name][_label_key(labels)] = value
      else:
        self.gauges[name] = value

  def observe_hist(self, name: str, value: float, buckets: tuple = DEFAULT_BUCKETS, n: int = 1, labels: dict | None = None) -> None:
    """Record ``value`` into the named histogram (created on first use; the
    bucket ladder is fixed at creation), ``n`` times under one lock."""
    with self._lock:
      if labels:
        series = self._labeled_hists[name]
        key = _label_key(labels)
        hist = series.get(key)
        if hist is None:
          hist = series[key] = _Histogram(buckets)
      else:
        hist = self._hists.get(name)
        if hist is None:
          hist = self._hists[name] = _Histogram(buckets)
      hist.observe(value, n)

  def _hist_view_locked(self, name: str, labels: dict | None) -> _Histogram | None:
    """A specific labelled series, the unlabelled histogram, or — labels
    omitted on a family with labelled series — their aggregate across every
    series sharing the family's bucket ladder."""
    if labels:
      return self._labeled_hists.get(name, {}).get(_label_key(labels))
    hist = self._hists.get(name)
    series = self._labeled_hists.get(name)
    if not series:
      return hist
    agg = _Histogram(hist.buckets if hist is not None else next(iter(series.values())).buckets)
    for h in ([hist] if hist is not None else []) + list(series.values()):
      if h.buckets != agg.buckets:
        continue
      for i, c in enumerate(h.counts):
        agg.counts[i] += c
      agg.sum += h.sum
      agg.count += h.count
    return agg

  def quantile(self, name: str, q: float, labels: dict | None = None) -> float | None:
    """Estimated q-quantile (0..1) of a histogram; None if absent or empty."""
    with self._lock:
      hist = self._hist_view_locked(name, labels)
      return hist.quantile(q) if hist is not None else None

  def hist_count(self, name: str, labels: dict | None = None) -> int:
    with self._lock:
      hist = self._hist_view_locked(name, labels)
      return hist.count if hist is not None else 0

  def counter_value(self, name: str, labels: dict | None = None) -> float:
    with self._lock:
      if labels:
        return self._labeled_counters.get(name, {}).get(_label_key(labels), 0.0)
      return self.counters.get(name, 0.0)

  def counter_sum(self, name: str) -> float:
    """Total across a counter family: the unlabelled value plus every
    labelled series."""
    with self._lock:
      return self.counters.get(name, 0.0) + sum(self._labeled_counters.get(name, {}).values())

  def gauge_value(self, name: str, labels: dict | None = None) -> float | None:
    """Current value of a gauge series (None when never set)."""
    with self._lock:
      if labels:
        series = self._labeled_gauges.get(name)
        if series is None:
          return None
        return series.get(_label_key(labels))
      return self.gauges.get(name)

  # ---------------------------------------------------------------- render

  def render_prometheus(self) -> str:
    lines: list[str] = []
    with self._lock:
      for name in sorted(set(self.counters) | set(self._labeled_counters)):
        lines.append(f"# TYPE xot_tpu_{name} counter")
        if name in self.counters:
          lines.append(f"xot_tpu_{name} {self.counters[name]}")
        for key, value in sorted(self._labeled_counters.get(name, {}).items()):
          lines.append(f"xot_tpu_{name}{_label_str(key)} {value}")
      for name in sorted(set(self.gauges) | set(self._labeled_gauges)):
        lines.append(f"# TYPE xot_tpu_{name} gauge")
        if name in self.gauges:
          lines.append(f"xot_tpu_{name} {self.gauges[name]}")
        for key, value in sorted(self._labeled_gauges.get(name, {}).items()):
          lines.append(f"xot_tpu_{name}{_label_str(key)} {value}")

      def hist_lines(name: str, hist: _Histogram, key: tuple) -> None:
        prefix = ",".join(f'{k}="{v}"' for k, v in key)
        sep = "," if prefix else ""
        suffix = "{" + prefix + "}" if prefix else ""
        cum = 0
        for edge, n in zip(hist.buckets, hist.counts):
          cum += n
          lines.append(f'xot_tpu_{name}_bucket{{{prefix}{sep}le="{edge}"}} {cum}')
        lines.append(f'xot_tpu_{name}_bucket{{{prefix}{sep}le="+Inf"}} {hist.count}')
        lines.append(f"xot_tpu_{name}_sum{suffix} {hist.sum}")
        lines.append(f"xot_tpu_{name}_count{suffix} {hist.count}")

      for name in sorted(set(self._hists) | set(self._labeled_hists)):
        lines.append(f"# TYPE xot_tpu_{name} histogram")
        if name in self._hists:
          hist_lines(name, self._hists[name], ())
        for key, hist in sorted(self._labeled_hists.get(name, {}).items()):
          hist_lines(name, hist, key)
    return "\n".join(lines) + "\n"

  def snapshot(self) -> dict:
    """JSON-safe dump of the whole registry (what the SLO engine's window
    ring holds)."""
    with self._lock:
      return {
        "counters": dict(self.counters),
        "labeled_counters": {name: [[list(map(list, key)), value] for key, value in series.items()] for name, series in self._labeled_counters.items()},
        "gauges": dict(self.gauges),
        "labeled_gauges": {name: [[list(map(list, key)), value] for key, value in series.items()] for name, series in self._labeled_gauges.items()},
        "histograms": {name: {"buckets": list(h.buckets), "counts": list(h.counts), "sum": h.sum} for name, h in self._hists.items()},
        "labeled_histograms": {
          name: [[list(map(list, key)), {"buckets": list(h.buckets), "counts": list(h.counts), "sum": h.sum}] for key, h in series.items()]
          for name, series in self._labeled_hists.items()
        },
      }


def snapshot_delta(prev: dict, cur: dict) -> dict:
  """Growth between two ``snapshot()`` dicts, in snapshot shape:

  - counters / labelled counters: ``cur - prev`` floored at 0 (a series
    that shrank — a restarted registry — never yields a negative rate);
  - histograms: per-bucket count deltas when the ladders match, else
    ``cur`` as-is (an incompatible prev cannot be subtracted);
  - gauges: ``cur``'s value verbatim (gauges are levels, not totals)."""
  prev = prev or {}
  cur = cur or {}

  def c_delta(p: float | None, c: float) -> float:
    return max(float(c) - float(p or 0.0), 0.0)

  def h_delta(ph: dict | None, ch: dict) -> dict:
    cb = list(ch.get("buckets", []))
    cc = [int(x) for x in ch.get("counts", [])]
    if ph and list(ph.get("buckets", [])) == cb and len(ph.get("counts", [])) == len(cc):
      pc = [int(x) for x in ph["counts"]]
      return {"buckets": cb, "counts": [max(a - b, 0) for a, b in zip(cc, pc)], "sum": c_delta(ph.get("sum", 0.0), ch.get("sum", 0.0))}
    return {"buckets": cb, "counts": cc, "sum": float(ch.get("sum", 0.0))}

  prev_lc = {name: {tuple(map(tuple, k)): v for k, v in series} for name, series in (prev.get("labeled_counters") or {}).items()}
  prev_lh = {name: {tuple(map(tuple, k)): h for k, h in series} for name, series in (prev.get("labeled_histograms") or {}).items()}
  return {
    "counters": {name: c_delta((prev.get("counters") or {}).get(name), v) for name, v in (cur.get("counters") or {}).items()},
    "labeled_counters": {
      name: [[list(map(list, tuple(map(tuple, k)))), c_delta(prev_lc.get(name, {}).get(tuple(map(tuple, k))), v)] for k, v in series]
      for name, series in (cur.get("labeled_counters") or {}).items()
    },
    "gauges": dict(cur.get("gauges") or {}),
    "labeled_gauges": {name: [[list(map(list, k)), v] for k, v in series] for name, series in (cur.get("labeled_gauges") or {}).items()},
    "histograms": {name: h_delta((prev.get("histograms") or {}).get(name), h) for name, h in (cur.get("histograms") or {}).items()},
    "labeled_histograms": {
      name: [[list(map(list, tuple(map(tuple, k)))), h_delta(prev_lh.get(name, {}).get(tuple(map(tuple, k))), h)] for k, h in series]
      for name, series in (cur.get("labeled_histograms") or {}).items()
    },
  }


metrics = Metrics()
