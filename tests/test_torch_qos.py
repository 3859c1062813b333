"""The port's QoS layer against the JAX package's, on the CPU:

- ``QosPolicy`` / ``QosQueue`` on a fake clock: the same scenario gives the
  same decisions — pop and peek order (priority lanes, aging, weighted
  tenant fairness, resumed requests at the front), overload sheds, rate
  limit refusals with their ``retry_after_ms``, refunds, the deadline
  estimator (measured drain, completion estimate, shed verdict, expiry);
- the ``BatchedServer`` at the defaults with QoS on (speculation included;
  2 layers, width 64, f32 weights from ``params_from_jax``): admission order, sheds and rejections under a
  saturated queue, deadline sheds at submit and at the slot boundary, and
  priority preemption with a token-identical resume, lookahead on and off,
  each against the JAX ``BatchedServer``;
- the API: QoS body fields and headers parse as the reference's
  ``parse_qos_fields`` does, a bad value is a 400, a rate-limited request
  a structured 429 with ``Retry-After``, and the fields reach the batched
  server."""

import asyncio
import json
import urllib.request

import jax
import numpy as np
import pytest

from test_torch_engine import make_tiny_llama
from xotorch_support_jetson_tpu.api.chatgpt_api import parse_qos_fields as jparse_qos_fields
from xotorch_support_jetson_tpu.inference import qos as jqos
from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.models import config as jconfig, decoder as jdec
from xotorch_support_jetson_tpu.utils import metrics as jmetrics
from xotorch_support_jetson_tpu_torch import main as tmain
from xotorch_support_jetson_tpu_torch.api.chatgpt_api import parse_qos_fields
from xotorch_support_jetson_tpu_torch.inference import qos as tqos
from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer
from xotorch_support_jetson_tpu_torch.inference.engine import ServerOverloadedError
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import config as tconfig
from xotorch_support_jetson_tpu_torch.models.convert import params_from_jax
from xotorch_support_jetson_tpu_torch.utils import metrics as tmetrics
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

PS = 8
PACKAGES = {"jax": (jqos, jmetrics), "port": (tqos, tmetrics)}


class Clock:
  def __init__(self) -> None:
    self.t = 1000.0

  def __call__(self) -> float:
    return self.t


class Req:
  """What the queue needs of a request: its id, tokens, ticket and carry."""

  def __init__(self, rid: str, ticket, n_tokens: int, carry=()) -> None:
    self.request_id, self.qos, self.tokens, self.carry_tokens = rid, ticket, np.zeros(n_tokens, np.int32), list(carry)


def _registry(mod, ttft=(0.4, 0.6, 0.5), itl=(0.02, 0.03, 0.05)):
  reg = mod.Metrics()
  for v in ttft:
    reg.observe_hist("ttft_seconds", v)
  for v in itl:
    reg.observe_hist("itl_seconds", v, n=4)
  return reg


# --------------------------------------------------------------- fake clock


def _queue_script(pkg: str, seed: int, aging_s: float) -> list:
  """A seeded run of puts (three classes, three tenants, one weighted),
  resumed re-puts, pops, peeks and overload sheds with the clock moving
  between them; returns every observable decision."""
  qos, metrics = PACKAGES[pkg]
  clock = Clock()
  cfg = qos.QosConfig(aging_s=aging_s, tenants={"b": {"weight": 3}, "c": {"weight": 0.5}})
  policy = qos.QosPolicy(cfg, clock=clock, registry=metrics.Metrics())
  queue = qos.QosQueue(policy)
  rng = np.random.default_rng(seed)
  out, n = [], 0
  for _ in range(120):
    clock.t += float(rng.choice([0.0, 0.5, 3.0, 11.0]))
    op = rng.choice(["put", "put", "put", "pop", "pop", "peek", "shed", "resume"])
    if op in ("put", "resume"):
      prio = ["interactive", "standard", "batch", "STANDARD", None, "bogus"][int(rng.integers(6))]
      tenant = ["a", "b", "c", None][int(rng.integers(4))]
      cost = int(rng.integers(1, 500))
      ticket = policy.ticket(prio, tenant, None, cost)
      if op == "resume":
        ticket.resumed = True
      queue.put_nowait(Req(f"r{n}", ticket, cost, carry=[1] if op == "resume" else ()))
      out.append(("put", f"r{n}", ticket.priority, ticket.tenant, ticket.cost))
      n += 1
    elif op == "pop":
      out.append(("pop", queue.get_nowait().request_id if queue.qsize() else None))
    elif op == "peek":
      head = queue.peek()
      out.append(("peek", head.request_id if head is not None else None))
    else:
      victim = queue.shed_lowest(int(rng.integers(0, 2)))
      out.append(("shed", victim.request_id if victim is not None else None))
    out.append(("depths", queue.class_depths(), queue.qsize()))
  return out


@pytest.mark.parametrize("seed,aging_s", [(0, 30.0), (1, 10.0), (2, 0.0), (3, 4.0)])
def test_qos_queue_decisions_match_reference(seed, aging_s):
  want = _queue_script("jax", seed, aging_s)
  assert _queue_script("port", seed, aging_s) == want
  assert any(e[0] == "pop" and e[1] for e in want) and any(e[0] == "shed" and e[1] for e in want)


def _rate_script(pkg: str) -> list:
  qos, metrics = PACKAGES[pkg]
  clock = Clock()
  cfg = qos.QosConfig(rps=2.0, tps=60.0, burst_s=1.5, tenants={"vip": {"rps": 10, "tps": 1000}, "odd": {"rps": "x"}})
  policy = qos.QosPolicy(cfg, clock=clock, registry=metrics.Metrics())
  rng = np.random.default_rng(5)
  out = []
  for i in range(80):
    clock.t += float(rng.choice([0.0, 0.05, 0.3, 1.0]))
    tenant = ["a", "vip", "odd", "a"][i % 4]
    tokens = int(rng.integers(1, 120))
    try:
      policy.check_rate(tenant, tokens)
      out.append(("ok", tenant, tokens))
      if i % 7 == 0:
        policy.refund(tenant, tokens)
        out.append(("refund", tenant))
    except qos.RateLimitedError as e:
      out.append(("limited", tenant, str(e), round(e.retry_after_ms, 6)))
  return out


def test_rate_limits_match_reference():
  want = _rate_script("jax")
  assert _rate_script("port") == want
  assert any(e[0] == "limited" for e in want) and any(e[0] == "ok" for e in want)


def test_token_bucket_and_tenant_bound_match_reference():
  for mod in (jqos, tqos):
    b = mod.TokenBucket(2.0, 4.0, clock=Clock())
    assert b.try_take(10) and not b.try_take(1, now=1000.1)
  assert tqos.MAX_TENANTS == jqos.MAX_TENANTS and tqos.PRIORITY_CLASSES == jqos.PRIORITY_CLASSES
  sizes = []
  for mod in (jqos, tqos):
    policy = mod.QosPolicy(mod.QosConfig(), clock=Clock())
    for i in range(mod.MAX_TENANTS + 7):
      policy.tenant(f"t{i}")
    sizes.append((len(policy._tenants), next(iter(policy._tenants))))
  assert sizes[0] == sizes[1] == (tqos.MAX_TENANTS, "t7")


def _deadline_script(pkg: str, mixed: str, monkeypatch) -> list:
  monkeypatch.setenv("XOT_TPU_MIXED_TICK", mixed)
  qos, metrics = PACKAGES[pkg]
  clock = Clock()
  policy = qos.QosPolicy(qos.QosConfig(shed_margin=1.2), clock=clock, registry=_registry(metrics))
  out = [policy.estimate_completion_ms(queue_depth=3, n_slots=2, max_tokens=10), policy.measured_drain_ms(4)]
  for waiting, pass_id, dt in [(0, 1, 0.1), (3, 2, 0.2), (3, 2, 0.0), (2, 3, 0.9), (1, 4, 0.4), (0, 5, 2.0), (4, 6, 0.3), (3, 7, 0.25)]:
    clock.t += dt
    policy.note_admission(waiting=waiting, pass_id=pass_id)
    out.append((policy.measured_drain_ms(4), policy.estimate_completion_ms(queue_depth=4, n_slots=2, max_tokens=12)))
  est = policy.estimate_completion_ms(queue_depth=6, n_slots=4, max_tokens=32)
  out += [est, policy.should_shed(1000.0, est), policy.should_shed(1e6, est), policy.retry_after_ms(5, 2)]
  ticket = policy.ticket("interactive", "t", 250.0, 40)
  clock.t += 0.2
  out.append(policy.deadline_expired(ticket))
  clock.t += 0.1
  out.append(policy.deadline_expired(ticket))
  empty = qos.QosPolicy(qos.QosConfig(), clock=clock, registry=metrics.Metrics())
  out += [empty.estimate_completion_ms(queue_depth=1, n_slots=1, max_tokens=1), empty.retry_after_ms(9, 1)]
  return out


@pytest.mark.parametrize("mixed", ["1", "0"])
def test_deadline_estimator_matches_reference(monkeypatch, mixed):
  want = _deadline_script("jax", mixed, monkeypatch)
  assert _deadline_script("port", mixed, monkeypatch) == want
  assert want[0] is not None and want[-2] is None and want[-1] == 1000.0


def test_qos_config_from_env_matches_reference(monkeypatch):
  for k, v in {"XOT_TPU_QOS_RPS": "3.5", "XOT_TPU_QOS_TPS": "bad", "XOT_TPU_QOS_BURST_S": "0", "XOT_TPU_QOS_AGING_S": "12", "XOT_TPU_QOS_SHED_MARGIN": "-1", "XOT_TPU_QOS_PREEMPT": "0", "XOT_TPU_QOS_TENANTS": '{"a": {"rps": 1}, "b": 3}'}.items():
    monkeypatch.setenv(k, v)
  j, t = jqos.QosConfig.from_env(), tqos.QosConfig.from_env()
  for f in ("rps", "tps", "burst_s", "aging_s", "shed_margin", "preempt", "tenants"):
    assert getattr(t, f) == getattr(j, f), f
  for value, on in ((None, True), ("1", True), ("0", False), ("false", False)):
    if value is None:
      monkeypatch.delenv("XOT_TPU_QOS", raising=False)
    else:
      monkeypatch.setenv("XOT_TPU_QOS", value)
    assert tqos.qos_enabled() is on and jqos.qos_enabled() is on
  for p in ("Interactive", "batch", None, "nope", 3):
    assert tqos.normalize_priority(p) == jqos.normalize_priority(p) and tqos.priority_rank(p) == jqos.priority_rank(p)


# ------------------------------------------------------------------ server


@pytest.fixture(scope="module")
def model():
  jc = jconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  tc = tconfig.tiny_test_config(n_layers=2, max_seq_len=128)
  jshard, tshard = JShard("tiny", 0, 1, 2), Shard("tiny", 0, 1, 2)
  jp = jdec.init_shard_params(jax.random.PRNGKey(8), jc, jshard)
  tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, tshard)
  return jc, tc, jshard, tshard, jp, tp


@pytest.fixture
def knobs(monkeypatch):
  for k in ("XOT_TPU_KV_TIER", "XOT_TPU_QOS", "XOT_TPU_MIXED_TICK", "XOT_TPU_MIXED_BUDGET", "XOT_TPU_KV_QUANT", "XOT_TPU_QOS_PREEMPT", "XOT_TPU_SPEC_BATCH", "XOT_TPU_SPEC_NGRAM"):
    monkeypatch.delenv(k, raising=False)
  for k, v in {"XOT_TPU_PAGE_SIZE": str(PS), "XOT_TPU_PREFILL_CHUNK": "16", "XOT_TPU_MIXED_BUDGET": "8"}.items():
    monkeypatch.setenv(k, v)
  return monkeypatch


def _servers(model, pkg_policy, n_slots, **kw):
  """The JAX and the port server, each with its package's QosPolicy built
  by ``pkg_policy(pkg)`` (a policy argument, or None for the env's)."""
  jc, tc, js, ts, jp, tp = model
  jengine = JaxShardedInferenceEngine(use_local_mesh=False)
  jengine.load_test_model(js, jc, jp)
  tengine = TorchShardedInferenceEngine(device="cpu")
  tengine.load_test_model(ts, tc, tp)
  return {
    "jax": JaxBatchedServer(jengine, n_slots=n_slots, chunk=3, qos=pkg_policy("jax"), **kw),
    "port": BatchedServer(tengine, n_slots=n_slots, chunk=3, qos=pkg_policy("port"), **kw),
  }


def _prompt(i, n=10):
  return np.random.default_rng(100 + i).integers(0, 256, n).astype(np.int32)


async def _submit_all(server, specs, order, streams):
  """Submit every spec in one gather (all enqueued before the loop's first
  pass); returns each outcome: tokens, or (exception type, retry_after_ms)."""

  def emit(rid, toks, fin):
    if toks and rid not in order:
      order.append(rid)
    streams.setdefault(rid, []).extend(toks)

  async def one(rid, prompt, max_tokens, prio, tenant, deadline):
    try:
      return await server.submit(rid, prompt, max_tokens=max_tokens, temp=0.0, top_k=35, eos_ids=(), emit=emit, priority=prio, tenant=tenant, deadline_ms=deadline)
    except ServerOverloadedError as e:  # the JAX package's own type is a different class
      return (type(e).__name__, getattr(e, "retry_after_ms", None))
    except RuntimeError as e:
      return (type(e).__name__, getattr(e, "retry_after_ms", None))

  return await asyncio.gather(*(one(*s) for s in specs))


def _outcome(x):
  return x if isinstance(x, tuple) else list(x)


def test_saturated_queue_admission_order_matches_jax(model, knobs):
  """One slot, a queue of four: eight requests arrive at once. The first
  four (batch) fill the queue; the interactive and standard arrivals shed
  the youngest batch requests; a later batch arrival is rejected. The one
  slot then serves by class, tenants taking turns by weighted cost."""
  specs = [
    ("b0", _prompt(0), 4, "batch", "a", None), ("b1", _prompt(1), 4, "batch", "b", None), ("b2", _prompt(2), 4, "batch", "a", None),
    ("b3", _prompt(3), 4, "batch", "b", None), ("i0", _prompt(4), 3, "interactive", "a", None), ("s0", _prompt(5, 30), 3, "standard", "a", None),
    ("b4", _prompt(6), 4, "batch", "a", None), ("i1", _prompt(7), 5, "interactive", "b", None),
  ]

  def policy(pkg):
    qos, metrics = PACKAGES[pkg]
    return qos.QosPolicy(qos.QosConfig(aging_s=1e6, preempt=False, tenants={"b": {"weight": 2}}), registry=_registry(metrics))

  results = {}
  for pkg, server in _servers(model, policy, 1, max_queue=4).items():
    order, streams = [], {}
    outs = asyncio.run(_submit_all(server, specs, order, streams))
    results[pkg] = (order, [_outcome(o) for o in outs])
  assert results["port"] == results["jax"]
  order, outs = results["port"]
  refused = [s[0] for s, o in zip(specs, outs) if isinstance(o, tuple)]
  assert order[:2] == ["i0", "i1"] and refused and all(o[1] is not None for o in outs if isinstance(o, tuple))


def test_deadline_sheds_match_jax(model, knobs):
  """A deadline the measured latencies cannot meet is shed at submit (with
  the reference's retry hint); a deadline that lapses while the request
  waits behind a resident row is shed at the slot boundary; a meetable one
  is served."""

  clocks = {pkg: Clock() for pkg in PACKAGES}

  def policy(pkg):
    qos, metrics = PACKAGES[pkg]
    return qos.QosPolicy(qos.QosConfig(preempt=False), clock=clocks[pkg], registry=_registry(metrics))

  specs = [("hold", _prompt(10), 6, "standard", "a", None), ("late", _prompt(11), 3, "standard", "a", 5000.0), ("tight", _prompt(12), 3, "standard", "a", 100.0), ("ok", _prompt(13), 3, "standard", "a", 1e7)]
  results = {}
  for pkg, server in _servers(model, policy, 1).items():
    order, streams = [], {}

    async def run(server=server, pkg=pkg, order=order, streams=streams):
      hold = asyncio.ensure_future(_submit_all(server, specs[:2], order, streams))
      while "hold" not in order:
        await asyncio.sleep(0.001)
      clocks[pkg].t += 10.0  # "late" has waited past its deadline
      rest = await _submit_all(server, specs[2:], order, streams)
      return list(await hold) + list(rest)

    results[pkg] = (order, [_outcome(o) for o in asyncio.run(run())])
  assert results["port"] == results["jax"]
  outs = results["port"][1]
  assert outs[1][0] == outs[2][0] == "DeadlineUnmeetableError" and len(outs[3]) == 3 and len(outs[0]) == 6


@pytest.mark.parametrize("lookahead", [True, False])
def test_preempted_request_resumes_token_identically(model, knobs, lookahead):
  """Two batch rows stream; an interactive request arriving then preempts
  one (no free slot), which re-enqueues and resumes: every transcript —
  the preempted one whole — equals the JAX server's and the unpreempted
  run's (QoS off), and no client stream repeats a token."""
  specs = [("b0", _prompt(20, 12), 24, "batch", "a", None), ("b1", _prompt(21, 9), 24, "batch", "a", None)]
  late = ("i0", _prompt(22, 14), 6, "interactive", "a", None)
  results = {}
  for pkg, server in _servers(model, lambda pkg: None, 2, lookahead=lookahead).items():
    victims = []
    orig = server._preempt_resume

    def spy(row, server=server, orig=orig, victims=victims):
      victims.append(server.slots[row].req.request_id)
      orig(row)

    server._preempt_resume = spy
    order, streams = [], {}

    async def run(server=server, order=order, streams=streams):
      first = asyncio.ensure_future(_submit_all(server, specs, order, streams))
      while "b1" not in order:
        await asyncio.sleep(0.001)
      second = await _submit_all(server, [late], order, streams)
      return list(await first) + list(second)

    outs = asyncio.run(run())
    assert [streams[s[0]] for s in specs + [late]] == [list(o) for o in outs]  # no duplicate tokens in the stream
    results[pkg] = (victims, [list(o) for o in outs])
  assert results["port"] == results["jax"]
  victims, outs = results["port"]
  assert victims and len(outs[0]) == len(outs[1]) == 24
  # The same requests with QoS off: nothing is preempted, the tokens agree.
  _, tc, _, ts, _, tp = model
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(ts, tc, tp)
  plain = BatchedServer(engine, n_slots=2, chunk=3, qos=False, lookahead=lookahead)
  solo = asyncio.run(_submit_all(plain, specs + [late], [], {}))
  assert [list(o) for o in solo] == outs


def test_qos_and_mixed_knobs_build(model, knobs):
  """``XOT_TPU_QOS`` and ``XOT_TPU_MIXED_TICK`` no longer refuse: set to 1
  (or unset) they turn the features on, set to 0 off."""
  _, tc, _, ts, _, tp = model
  engine = TorchShardedInferenceEngine(device="cpu")
  engine.load_test_model(ts, tc, tp)
  for value, on in (("1", True), ("0", False), (None, True)):
    for knob in ("XOT_TPU_QOS", "XOT_TPU_MIXED_TICK"):
      if value is None:
        knobs.delenv(knob, raising=False)
      else:
        knobs.setenv(knob, value)
    server = BatchedServer(engine, n_slots=2)
    assert (server.qos is not None) is on and isinstance(server.queue, tqos.QosQueue) is on and server._mixed_active() is on


# --------------------------------------------------------------------- API


QOS_CASES = [
  ({}, {}), ({"priority": "Interactive"}, {}), ({}, {"x-priority": "batch"}), ({"priority": "batch"}, {"x-priority": "interactive"}),
  ({"priority": "urgent"}, {}), ({}, {"x-priority": "1"}), ({"deadline_ms": 250}, {}), ({}, {"x-deadline-ms": "1500.5"}),
  ({"deadline_ms": 0}, {}), ({"deadline_ms": -3}, {}), ({"deadline_ms": True}, {}), ({}, {"x-deadline-ms": "soon"}), ({"deadline_ms": [1]}, {}),
  ({"tenant": "acme"}, {}), ({}, {"x-tenant-id": "t" * 100}), ({}, {"authorization": "Bearer sk-123"}),
  ({"tenant": ""}, {"authorization": "Bearer x"}), ({"tenant": 42}, {}), ({}, {"x-tenant-id": "h", "authorization": "Bearer y"}),
]


@pytest.mark.parametrize("body,headers", QOS_CASES)
def test_parse_qos_fields_matches_reference(body, headers):
  def run(fn):
    try:
      return fn(body, headers)
    except ValueError as e:
      return ("ValueError", str(e))

  assert run(parse_qos_fields) == run(jparse_qos_fields)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_qos"))


def _post(port, body, headers=None):
  req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json", **(headers or {})})
  try:
    with urllib.request.urlopen(req, timeout=120) as resp:
      return resp.status, dict(resp.headers), resp.read().decode()
  except urllib.error.HTTPError as e:
    return e.code, dict(e.headers), e.read().decode()


def test_daemon_qos_fields_400_and_structured_429(tiny_dir, knobs):
  """Through main → node → API with XOT_TPU_BATCHED=1 and one request per
  ~17 minutes for each tenant: a good request is served and its QoS
  identity reaches the batched server; a bad priority or deadline is a
  400; a second request of the same tenant is a 429 with ``type
  rate_limited``, ``retry_after_ms`` and ``Retry-After``."""
  for k, v in {"XOT_TPU_MODEL_DIR": str(tiny_dir), "XOT_TPU_PLATFORM": "cpu", "XOT_TPU_BATCHED": "1", "XOT_TPU_QOS_RPS": "0.001"}.items():
    knobs.setenv(k, v)
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--temp", "0.0", "--max-generate-tokens", "6", "--node-id", "test"])
  msg = [{"role": "user", "content": "hello world"}]

  async def run():
    node, api, engine, _ = tmain.build_components(args)
    server = await api.run(host="127.0.0.1", port=port)
    seen = []
    try:
      await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
      batched = engine.get_batched_server()
      orig = batched.submit

      async def spy(*a, **kw):
        seen.append((kw["priority"], kw["tenant"], kw["deadline_ms"]))
        return await orig(*a, **kw)

      batched.submit = spy
      ok = await asyncio.to_thread(_post, port, {"model": "llama-3.2-1b", "messages": msg, "priority": "interactive", "deadline_ms": 600000}, {"x-tenant-id": "acme"})
      bad = [
        await asyncio.to_thread(_post, port, {"model": "llama-3.2-1b", "messages": msg, "priority": "urgent"}),
        await asyncio.to_thread(_post, port, {"model": "llama-3.2-1b", "messages": msg}, {"x-deadline-ms": "-5"}),
      ]
      limited = await asyncio.to_thread(_post, port, {"model": "llama-3.2-1b", "messages": msg, "stream": True}, {"x-tenant-id": "acme"})
    finally:
      server.close()
      await server.wait_closed()
    return ok, bad, limited, seen

  ok, bad, limited, seen = asyncio.run(run())
  assert ok[0] == 200 and json.loads(ok[2])["choices"][0]["finish_reason"] in ("stop", "length")
  assert seen[0] == ("interactive", "acme", 600000.0)
  assert [b[0] for b in bad] == [400, 400] and "priority" in bad[0][2] and "deadline_ms" in bad[1][2]
  status, headers, body = limited
  err = json.loads(body)["error"]
  assert status == 429 and err["type"] == "rate_limited" and err["retry_after_ms"] > 9e5
  assert int(headers["Retry-After"]) == int(np.ceil(err["retry_after_ms"] / 1e3))
