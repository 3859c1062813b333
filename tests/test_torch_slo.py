"""The port's metrics registry and local SLO engine against the JAX
package's, on the same histogram and counter fixtures: quantiles, gauge
reads, ``snapshot_delta``, the Prometheus text, ``hist_over_threshold`` /
``hist_family`` / ``counter_family``, burn rates and attainment over
windows, and the exported ``slo_burn_rate`` gauges; then ``GET /metrics``
and ``GET /v1/slo`` on the port's daemon after a batched request, and the
node's SLO tick task between ``start`` and ``stop``."""

import asyncio
import json
import urllib.request

import numpy as np
import pytest

from test_torch_engine import make_tiny_llama
from xotorch_support_jetson_tpu.orchestration import slo as jslo
from xotorch_support_jetson_tpu.utils import metrics as jmetrics
from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch.orchestration import slo as tslo
from xotorch_support_jetson_tpu_torch.utils import metrics as tmetrics
from xotorch_support_jetson_tpu_torch.utils.helpers import env_float, find_available_port

PACKAGES = {"jax": (jslo, jmetrics), "port": (tslo, tmetrics)}


def _observe(reg, seed: int, scale: float = 1.0) -> None:
  """Seeded per-class TTFT / ITL observations, counters and gauges."""
  rng = np.random.default_rng(seed)
  for cls in ("interactive", "standard", "batch"):
    for v in rng.lognormal(-1.0, 1.2, 40) * scale:
      reg.observe_hist("qos_ttft_seconds", float(v), buckets=jslo.SLO_LATENCY_BUCKETS, labels={"class": cls})
      reg.observe_hist("ttft_seconds", float(v))
    for v in rng.lognormal(-3.0, 1.0, 30) * scale:
      reg.observe_hist("qos_itl_seconds", float(v), buckets=jslo.SLO_LATENCY_BUCKETS, n=int(rng.integers(1, 9)), labels={"class": cls})
    reg.inc("slo_requests_good_total", float(rng.integers(5, 50)), labels={"class": cls})
    reg.inc("slo_requests_bad_total", float(rng.integers(0, 4)), labels={"class": cls, "reason": "shed"})
    reg.inc("slo_tokens_total", float(rng.integers(100, 900)), labels={"class": cls, "tenant": "t"})
    reg.inc("slo_good_tokens_total", float(rng.integers(0, 100)), labels={"class": cls, "tenant": "t"})
  reg.inc("scheduler_admissions_total", 3)
  reg.set_gauge("scheduler_queue_depth", float(seed))
  reg.set_gauge("mixed_budget_tokens", 512, labels={"pool": "a"})


def test_metrics_registry_matches_reference():
  regs = {pkg: m.Metrics() for pkg, (_, m) in PACKAGES.items()}
  snaps = {}
  for pkg, reg in regs.items():
    _observe(reg, 1)
    first = reg.snapshot()
    _observe(reg, 2, scale=3.0)
    snaps[pkg] = (first, reg.snapshot())
  j, t = regs["jax"], regs["port"]
  for q in (0.0, 0.5, 0.95, 0.99, 1.0):
    for labels in (None, {"class": "interactive"}, {"class": "batch"}):
      assert t.quantile("qos_ttft_seconds", q, labels) == j.quantile("qos_ttft_seconds", q, labels)
      assert t.quantile("qos_itl_seconds", q, labels) == j.quantile("qos_itl_seconds", q, labels)
    assert t.quantile("ttft_seconds", q) == j.quantile("ttft_seconds", q)
  assert t.quantile("absent", 0.5) is None and t.hist_count("qos_itl_seconds") == j.hist_count("qos_itl_seconds")
  assert t.gauge_value("mixed_budget_tokens", {"pool": "a"}) == 512 and t.gauge_value("nope") is None
  assert t.counter_sum("slo_requests_bad_total") == j.counter_sum("slo_requests_bad_total")
  assert t.render_prometheus() == j.render_prometheus()  # the reference's registry holds no summaries here
  for key in ("counters", "labeled_counters", "gauges", "labeled_gauges", "histograms", "labeled_histograms"):
    assert tmetrics.snapshot_delta(*snaps["port"])[key] == jmetrics.snapshot_delta(*snaps["jax"])[key], key
  assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS and tmetrics.FRACTION_BUCKETS == jmetrics.FRACTION_BUCKETS


@pytest.mark.parametrize("threshold", [0.0, 0.1, 0.25, 0.3, 1.5, 2.0, 100.0])
def test_delta_helpers_match_reference(threshold):
  delta = {}
  for pkg, (slo, m) in PACKAGES.items():
    reg = m.Metrics()
    _observe(reg, 3)
    base = reg.snapshot()
    _observe(reg, 4, scale=2.0)
    d = m.snapshot_delta(base, reg.snapshot())
    out = []
    for where in (None, {"class": "standard"}, {"class": "nobody"}):
      for fam in ("qos_ttft_seconds", "qos_itl_seconds", "ttft_seconds"):
        h = slo.hist_family(d, fam, where)
        out.append((h, slo.hist_over_threshold(h, threshold) if h else None))
      for fam in ("slo_requests_bad_total", "slo_tokens_total", "scheduler_admissions_total"):
        out.append(slo.counter_family(d, fam, where))
    delta[pkg] = out
  assert delta["port"] == delta["jax"]
  assert any(v[1] and v[1][1] for v in delta["port"] if isinstance(v, tuple))  # the fixtures reach every family


def _engine_run(pkg: str, monkeypatch) -> list:
  """Three ticks of an engine over a fresh registry with traffic between
  them: every report minus the wall-clock fields, and the exported gauges."""
  slo, m = PACKAGES[pkg]
  reg = m.Metrics()
  monkeypatch.setattr(slo, "metrics", reg)
  eng = slo.SloEngine(tick_s=0.5, windows_s=(60.0, 600.0))
  out = []
  for seed in (5, 6, 7):
    _observe(reg, seed, scale=0.5 * seed)
    eng.tick()
    rep = eng.report()
    for cls in slo.QOS_CLASSES:
      c = rep["classes"][cls]
      out.append((cls, c["objectives"], c["goodput_cum"], c["attainment"]))
      for wk, w in sorted(c["windows"].items()):
        out.append((wk, {o: w[o] for o in ("ttft", "itl", "availability")}, w["goodput"]["tokens"], w["goodput"]["good_tokens"]))
      for window in ("60s", "600s"):
        out.append(reg.gauge_value("slo_burn_rate", labels={"class": cls, "window": window}))
      out.append(reg.gauge_value("slo_attainment", labels={"class": cls}))
  assert rep["scope"] == "local" and rep["enabled"] and rep["windows_s"] == [60, 600]
  return out


def test_slo_engine_reports_match_reference(monkeypatch):
  monkeypatch.setenv("XOT_TPU_SLO_INTERACTIVE_ITL_P99_MS", "50")
  monkeypatch.setenv("XOT_TPU_SLO_BATCH_AVAILABILITY", "1.5")
  want = _engine_run("jax", monkeypatch)
  got = _engine_run("port", monkeypatch)
  assert got == want
  assert any(isinstance(x, float) and x > 1.0 for x in got)  # something burns


def test_slo_knobs_and_accounting_match_reference(monkeypatch):
  for spec in ("", "30, 90,x,-1", "bad"):
    monkeypatch.setenv("XOT_TPU_SLO_WINDOWS_S", spec)
    assert tslo.slo_windows_s() == jslo.slo_windows_s()
  for cls in ("interactive", "standard", "batch", "other"):
    assert tslo.objectives(cls) == jslo.objectives(cls)
    for ttft, itl in ((None, None), (0.3, 0.05), (0.6, 0.05), (0.1, 0.3), (20.0, None)):
      assert tslo.within_slo(cls, ttft, itl) == jslo.within_slo(cls, ttft, itl)
  assert tslo.SLO_LATENCY_BUCKETS == jslo.SLO_LATENCY_BUCKETS and tslo.DEFAULT_OBJECTIVES == jslo.DEFAULT_OBJECTIVES
  assert tslo.attainment({}, "600") is None
  monkeypatch.setenv("XOT_TPU_X", "oops")
  assert env_float("XOT_TPU_X", 2.5) == 2.5 and env_float("XOT_TPU_UNSET_KNOB", 1.0) == 1.0
  monkeypatch.setenv("XOT_TPU_SLO", "0")
  reg = tmetrics.Metrics()
  monkeypatch.setattr(tslo, "metrics", reg)
  tslo.observe_ttft("interactive", 1.0)
  tslo.note_bad("batch", "shed")
  assert reg.snapshot()["labeled_histograms"] == {} and reg.snapshot()["labeled_counters"] == {}
  assert tslo.SloEngine().report() == {"scope": "local", "enabled": False} and not tslo.SloEngine().maybe_tick()


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_slo"))


def _get(port, path):
  with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
    return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def test_daemon_serves_metrics_and_slo(tiny_dir, monkeypatch):
  for k in ("XOT_TPU_SLO", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_KV_TIER", "XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM"):
    monkeypatch.delenv(k, raising=False)
  for k, v in {"XOT_TPU_MODEL_DIR": str(tiny_dir), "XOT_TPU_PLATFORM": "cpu", "XOT_TPU_BATCHED": "1"}.items():
    monkeypatch.setenv(k, v)
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--temp", "0.0", "--max-generate-tokens", "6", "--node-id", "test"])
  body = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "hello world"}], "priority": "interactive"}

  async def run():
    node, api, engine, _ = tmain.build_components(args)
    server = await api.run(host="127.0.0.1", port=port)
    try:
      req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
      status = await asyncio.to_thread(lambda: urllib.request.urlopen(req, timeout=120).status)
      return status, await asyncio.to_thread(_get, port, "/metrics"), await asyncio.to_thread(_get, port, "/v1/slo")
    finally:
      server.close()
      await server.wait_closed()

  status, (m_status, m_type, text), (s_status, _, slo_body) = asyncio.run(run())
  assert status == 200 and m_status == 200 and m_type.startswith("text/plain")
  for line in ("# TYPE xot_tpu_ttft_seconds histogram", 'xot_tpu_qos_ttft_seconds_count{class="interactive"}', "xot_tpu_scheduler_admissions_total", 'xot_tpu_slo_requests_good_total{class="interactive"}'):
    assert line in text, line
  report = json.loads(slo_body)
  assert s_status == 200 and report["scope"] == "local" and report["enabled"] and report["node_id"] == "test"
  assert set(report["classes"]) == {"interactive", "standard", "batch"}
  assert report["classes"]["interactive"]["goodput_cum"]["tokens"] >= 1


@pytest.mark.parametrize("enabled", [True, False])
def test_node_start_runs_the_slo_tick_task(monkeypatch, enabled):
  """``Node.start`` (what the daemon's main awaits) offers the SLO engine a
  tick every ``SLO_POLL_S`` off the event loop, so the ``slo_burn_rate``
  gauge the mixed budget reads exists once the first tick ran; ``stop``
  ends the task. With ``XOT_TPU_SLO=0`` no task starts."""
  from xotorch_support_jetson_tpu_torch.orchestration import node as tnode

  monkeypatch.setenv("XOT_TPU_SLO", "1" if enabled else "0")
  monkeypatch.setattr(tnode, "SLO_POLL_S", 0.02)
  engine = tslo.SloEngine(tick_s=0.5)
  monkeypatch.setattr(tnode, "slo_engine", engine)
  calls = []
  tick = engine.maybe_tick
  monkeypatch.setattr(engine, "maybe_tick", lambda: calls.append(1) or tick())

  async def run():
    node = tnode.Node("n", None)
    await node.start()
    await asyncio.sleep(0.3)
    started = node._slo_task is not None
    await node.stop()
    n = len(calls)
    await asyncio.sleep(0.1)
    return started, n, len(calls)

  started, n, after = asyncio.run(run())
  assert started is enabled
  if enabled:
    assert n >= 3 and after == n  # polled while running, not after stop
    fast = f"{int(min(tslo.slo_windows_s()))}s"
    assert tmetrics.metrics.gauge_value("slo_burn_rate", labels={"class": "interactive", "window": fast}) is not None
  else:
    assert n == 0
